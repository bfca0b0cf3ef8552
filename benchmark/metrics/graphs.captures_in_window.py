"""CUDA-graph captures made inside the window, every program of the
process (``graphs.stats()``).  Serves ``graphs.captures_in_window.offline``
and ``.live``."""


def read(ctx):
    return float(ctx["captures_in_window"])
