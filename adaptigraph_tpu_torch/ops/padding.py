"""Static-shape padding helpers (a copy of ``adaptigraph_tpu/ops/padding.py``).

Capacities are static by construction, so padding is a plain fixed-size copy
plus a mask; nothing can overflow (an oversized input is truncated).
"""

import numpy as np


def pad_axis0(x, max_dim, dtype=np.float32):
    """Zero-pad ``x`` (n, ...) to (max_dim, ...). Truncates if oversized."""
    n = min(x.shape[0], max_dim)
    out = np.zeros((max_dim,) + x.shape[1:], dtype=dtype)
    out[:n] = x[:n]
    return out


def pad_axis1(x, max_dim, dtype=np.float32):
    """Zero-pad ``x`` (b, n, ...) to (b, max_dim, ...)."""
    n = min(x.shape[1], max_dim)
    out = np.zeros((x.shape[0], max_dim) + x.shape[2:], dtype=dtype)
    out[:, :n] = x[:, :n]
    return out
