"""Quaternion and rotation helpers (numpy copy of
``adaptigraph_tpu/utils/transforms.py``; xyzw convention, matching the
reference's ``quaternion_to_rotation_matrix``, ``src/dynamics/utils.py:71-95``).
"""

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


def quat_mul(q1, q2):
    """Hamilton product of xyzw quaternions (..., 4) x (..., 4) -> (..., 4)."""
    q1 = np.asarray(q1, np.float64)
    q2 = np.asarray(q2, np.float64)
    x1, y1, z1, w1 = q1[..., 0], q1[..., 1], q1[..., 2], q1[..., 3]
    x2, y2, z2, w2 = q2[..., 0], q2[..., 1], q2[..., 2], q2[..., 3]
    return np.stack([
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
    ], axis=-1)


def quat_conjugate(q):
    q = np.asarray(q, np.float64)
    return np.concatenate([-q[..., :3], q[..., 3:]], axis=-1)


def quat_from_axis_angle(axis, angle):
    """xyzw quaternion rotating by ``angle`` about ``axis`` (3,)."""
    axis = np.asarray(axis, np.float64)
    axis = axis / np.linalg.norm(axis)
    s = np.sin(angle / 2)
    return np.array([axis[0] * s, axis[1] * s, axis[2] * s, np.cos(angle / 2)])


def quat_from_rotmat(R):
    """(3, 3) rotation matrix -> xyzw quaternion (Shepperd's method —
    numerically stable for all branches; the role of the vendored
    tf.transformations quaternion_from_matrix, sim_env/transformations.py)."""
    R = np.asarray(R, np.float64)
    t = np.trace(R)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        w = 0.25 * s
        x = (R[2, 1] - R[1, 2]) / s
        y = (R[0, 2] - R[2, 0]) / s
        z = (R[1, 0] - R[0, 1]) / s
    elif R[0, 0] > R[1, 1] and R[0, 0] > R[2, 2]:
        s = np.sqrt(1.0 + R[0, 0] - R[1, 1] - R[2, 2]) * 2
        w = (R[2, 1] - R[1, 2]) / s
        x = 0.25 * s
        y = (R[0, 1] + R[1, 0]) / s
        z = (R[0, 2] + R[2, 0]) / s
    elif R[1, 1] > R[2, 2]:
        s = np.sqrt(1.0 + R[1, 1] - R[0, 0] - R[2, 2]) * 2
        w = (R[0, 2] - R[2, 0]) / s
        x = (R[0, 1] + R[1, 0]) / s
        y = 0.25 * s
        z = (R[1, 2] + R[2, 1]) / s
    else:
        s = np.sqrt(1.0 + R[2, 2] - R[0, 0] - R[1, 1]) * 2
        w = (R[1, 0] - R[0, 1]) / s
        x = (R[0, 2] + R[2, 0]) / s
        y = (R[1, 2] + R[2, 1]) / s
        z = 0.25 * s
    q = np.array([x, y, z, w])
    return q / np.linalg.norm(q)


def euler_to_quat(roll, pitch, yaw):
    """Intrinsic xyz Euler angles -> xyzw quaternion."""
    qx = quat_from_axis_angle([1, 0, 0], roll)
    qy = quat_from_axis_angle([0, 1, 0], pitch)
    qz = quat_from_axis_angle([0, 0, 1], yaw)
    return quat_mul(quat_mul(qz, qy), qx)


def rotate_vec(q, v):
    """Rotate vectors (..., 3) by xyzw quaternion(s)."""
    return np.einsum("...ij,...j->...i", quat_to_rotmat(q), np.asarray(v, np.float64))
