"""The solve's time outside K1, in ms a solve: the traced window less K1's
device time on the busiest card, over the solves (sampling, sorting, the
chunk loop, reward, update, argmax and the host)."""

from metrics._common import per_launch_s


def read(run):
    if per_launch_s(run, "k1") is None:
        return None
    layer = run.layer
    return (layer["trace_window_s"] - layer["k1_busiest_s"]) * 1e3 / layer["trace_units"]
