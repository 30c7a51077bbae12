"""K1's share of its roofline, in %: the least time the card could take for
a launch (``work/k1.py``'s operations and bytes, from the edges and
substeps the reference counted on the checked solves' chunks, at the bf16
peak) over its device time a launch."""

from metrics._common import per_launch_s
from work import peaks


def read(run):
    s = per_launch_s(run, "k1")
    if s is None or "k1_ops_per_launch" not in run.layer:
        return None
    bound, _ = peaks.bound_s(run.layer["k1_ops_per_launch"], run.layer["k1_bytes_per_launch"],
                             peaks.BF16_FLOPS)
    return 100.0 * bound / s
