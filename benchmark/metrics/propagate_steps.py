"""propagate_steps (steps; layer: LSH tail; moves cluster_rows_per_s).

Label-propagation steps a clustering call: the program's
``tse1m.lsh.step`` regions (one a step, ``cluster/lsh.py``) over the
calls.  Each step is two ``pmin`` collectives and a host sync, so a
change in the step count moves the call's time without any gain in the
code.  None where the trace holds no such region.
"""


def read(view):
    steps = sum(1 for _, _, name in view.host if name == "tse1m.lsh.step")
    if not view.calls or not steps:
        return None
    return steps / view.calls
