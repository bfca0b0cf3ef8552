"""Device ms per frame on the stream that the tracking step replays on,
from the profiled slice.  Serves ``vo.busy_ms_per_frame.offline`` and
``.live``."""


def read(ctx):
    tr = ctx["trace"]
    if not tr or not ctx["slice_frames"]:
        return None
    return 1e3 * tr["vo_busy_s"] / ctx["slice_frames"]
