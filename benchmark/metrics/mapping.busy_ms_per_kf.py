"""Device ms per keyframe mapped in the profiled slice, on every stream but
the tracking step's (the mapping worker's).  Serves
``mapping.busy_ms_per_kf.offline``."""


def read(ctx):
    tr = ctx["trace"]
    if not tr or ctx["slice_keyframes"] <= 0:
        return None
    return 1e3 * tr["map_busy_s"] / ctx["slice_keyframes"]
