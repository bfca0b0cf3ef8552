"""Share of the profiled slice with no device activity on any stream.
Serves ``device.idle_pct.offline`` and ``.live``."""


def read(ctx):
    tr = ctx["trace"]
    if not tr or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
