"""K3's share of its roofline, in %: the least time for the backward's own
work on these inputs (``work/k3.py``) over its device time a launch (the
backward and its gradient sum)."""

from metrics._common import per_launch_s
from work import peaks


def read(run):
    s = per_launch_s(run, "k3")
    if s is None or "k3_ops" not in run.layer:
        return None
    bound, _ = peaks.bound_s(run.layer["k3_ops"], run.layer["k3_bytes"],
                             peaks.F32_SPLIT_TF32_FLOPS)
    return 100.0 * bound / s
