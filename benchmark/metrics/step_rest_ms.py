"""A train step's time outside K2 and K3, in ms: the traced window's time a
step less K2's and K3's device time a step (graph replay, augmentation, the
graph build, the loss, Adam, the prefetcher's copies, the host)."""

from metrics._common import per_launch_s


def read(run):
    if per_launch_s(run, "k2") is None or per_launch_s(run, "k3") is None:
        return None
    layer = run.layer
    kernels = layer["k2_device_s"] + layer["k3_device_s"]
    return (layer["trace_window_s"] - kernels) * 1e3 / layer["trace_units"]
