"""What several readers share: the kernel records of the traced window,
trusted only where the profiler saw every launch the port counted."""


def per_launch_s(run, prefix):
    """Device seconds a launch of kernel ``prefix`` (k1, k2, k3) in the
    traced window, or None where the profiler's records of it are not the
    launches the port's counter counted (CUPTI can lose records) or none."""
    layer = run.layer
    records, launches = layer.get(prefix + "_records"), layer.get(prefix + "_launches")
    if not records or records != launches:
        return None
    return layer[prefix + "_device_s"] / records
