"""The three hand-written kernels on the tracking step's stream: the least
time the card could take for their launches in the profiled slice (bytes
over the memory rate or operations over their peaks, from the launch
shapes, ``benchmark/work.py``) over their device time, in %.  Serves
``kernels.roofline_pct.live``."""

from benchmark import work


def read(ctx):
    tr = ctx["trace"]
    if not tr or not ctx["slice_frames"] or not ctx["kernel_launches"]:
        return None
    bound = 0.0
    for name, shapes in ctx["kernel_launches"]:
        nbytes, ops = work.work(name, shapes)
        bound += work.bound_s(nbytes, ops, ctx["card"])
    seconds = sum(tr["kernel_s_on_vo"].values())
    if seconds <= 0:
        return None
    return 100.0 * bound * ctx["slice_frames"] / seconds
