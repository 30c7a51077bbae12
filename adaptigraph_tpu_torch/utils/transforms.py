"""Quaternion helpers (numpy copies of ``quat_to_rotmat`` and
``quat_from_yaw`` from ``adaptigraph_tpu/utils/transforms.py``; xyzw
convention), the ones ``dynamics.preprocess`` and ``sim.env`` need."""

import numpy as np


def quat_to_rotmat(q):
    """(..., 4) xyzw quaternion(s) -> (..., 3, 3) rotation matrices."""
    q = np.asarray(q, np.float64)
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    out = np.empty(q.shape[:-1] + (3, 3), np.float64)
    out[..., 0, 0] = 1 - 2 * (y * y + z * z)
    out[..., 0, 1] = 2 * (x * y - z * w)
    out[..., 0, 2] = 2 * (x * z + y * w)
    out[..., 1, 0] = 2 * (x * y + z * w)
    out[..., 1, 1] = 1 - 2 * (x * x + z * z)
    out[..., 1, 2] = 2 * (y * z - x * w)
    out[..., 2, 0] = 2 * (x * z - y * w)
    out[..., 2, 1] = 2 * (y * z + x * w)
    out[..., 2, 2] = 1 - 2 * (x * x + y * y)
    return out


def quat_from_yaw(theta):
    """Rotation about +y by theta as an xyzw quaternion."""
    return np.array([0.0, np.sin(theta / 2), 0.0, np.cos(theta / 2)])
