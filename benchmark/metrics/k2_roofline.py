"""K2's share of its roofline, in %: the least time for a launch
(``work/k2.py`` on the real edges of the reference's graphs of the first
steps, at the float32 split-TF32 peak) over its device time a launch."""

from metrics._common import per_launch_s
from work import peaks


def read(run):
    s = per_launch_s(run, "k2")
    if s is None or "k2_ops" not in run.layer:
        return None
    bound, _ = peaks.bound_s(run.layer["k2_ops"], run.layer["k2_bytes"],
                             peaks.F32_SPLIT_TF32_FLOPS)
    return 100.0 * bound / s
