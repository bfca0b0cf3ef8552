"""The control of the correctness check.  The configurations state no
arithmetic precision (the upstream files do not), so the control breaks a
guarantee that they do state: the tracking solve's Gauss-Newton trips
(``max_iters`` 5, ``max_iters_ref`` 10 in both deployments), cut as the
cell's ``control`` entry says, the step that a faster tracker would be
tempted to take.  The control is the program run through the harness with
that one change, judged as the benchmark judges the program; it has to
come out not correct, and its readings set the upper end of each limit.

    python3 -m benchmark.faults --workload <cell> --seed <n> --fault control

prints the control's readings beside the cell's limits (one seed a
process, as a benchmark run).  The benchmark's own runs never run it.
"""

from __future__ import annotations

import copy


def broken(cell):
    """The cell with the control's change applied to its configuration."""
    cell = copy.deepcopy(cell)
    cell.config["plslam"].update(cell.spec["control"]["plslam"])
    return cell
