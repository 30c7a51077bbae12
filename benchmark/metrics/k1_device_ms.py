"""K1's device milliseconds a launch in the traced window (``torch.profiler``
time of ``rollout_chunk_kernel`` over its records, all cards)."""

from metrics._common import per_launch_s


def read(run):
    s = per_launch_s(run, "k1")
    return None if s is None else s * 1e3
