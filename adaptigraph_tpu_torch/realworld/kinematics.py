"""Serial-arm forward/inverse kinematics (numpy copy of
``adaptigraph_tpu/realworld/kinematics.py``).

The reference drives a simulated xArm6 through PyBullet's
``calculateInverseKinematics`` to execute pushes (reference:
``src/sim/sim_env/flex_env.py:308-481`` waypoint IK loop and
``src/sim/sim_env/robot_env.py:19-107`` URDF mirroring). This is a
dependency-free equivalent without PyBullet: modified-DH forward
kinematics and damped-least-squares IK with joint limits, parameterized for
the xArm6.

xArm6 modified-DH parameters (UFactory documentation): (alpha, a, d, offset).
"""

import numpy as np

# (alpha_{i-1}, a_{i-1}, d_i, theta_offset_i) — modified DH, xArm6
XARM6_MDH = np.array([
    [0.0,        0.0,      0.267,  0.0],
    [-np.pi / 2, 0.0,      0.0,   -1.3849179],  # offset = -atan(284.5/53.5)-ish
    [0.0,        0.28949,  0.0,    1.3849179],
    [-np.pi / 2, 0.0775,   0.3425, 0.0],
    [np.pi / 2,  0.0,      0.0,    0.0],
    [-np.pi / 2, 0.076,    0.097,  0.0],
])

XARM6_LIMITS = np.array([
    [-2 * np.pi, 2 * np.pi],
    [-2.059, 2.0944],
    [-3.927, 0.19198],
    [-2 * np.pi, 2 * np.pi],
    [-1.69297, np.pi],
    [-2 * np.pi, 2 * np.pi],
])


def _mdh_transform(alpha, a, d, theta):
    ca, sa = np.cos(alpha), np.sin(alpha)
    ct, st = np.cos(theta), np.sin(theta)
    return np.array([
        [ct, -st, 0.0, a],
        [st * ca, ct * ca, -sa, -sa * d],
        [st * sa, ct * sa, ca, ca * d],
        [0.0, 0.0, 0.0, 1.0],
    ])


def forward_kinematics(q, mdh=XARM6_MDH, return_all=False):
    """Joint angles (6,) -> end-effector pose (4, 4) (optionally all link
    frames — the role of ``FlexRobotHelper.getRobotShapeStates``,
    robot_env.py:66)."""
    q = np.asarray(q, np.float64)
    T = np.eye(4)
    frames = []
    for i in range(len(mdh)):
        alpha, a, d, off = mdh[i]
        T = T @ _mdh_transform(alpha, a, d, q[i] + off)
        frames.append(T.copy())
    return frames if return_all else T


def jacobian(q, mdh=XARM6_MDH, eps=1e-6):
    """Geometric Jacobian (6, n) by central differences on FK (position +
    rotation-vector rows)."""
    q = np.asarray(q, np.float64)
    n = len(q)
    J = np.zeros((6, n))
    T0 = forward_kinematics(q, mdh)
    for i in range(n):
        dq = np.zeros(n)
        dq[i] = eps
        Tp = forward_kinematics(q + dq, mdh)
        Tm = forward_kinematics(q - dq, mdh)
        J[:3, i] = (Tp[:3, 3] - Tm[:3, 3]) / (2 * eps)
        dR = (Tp[:3, :3] - Tm[:3, :3]) / (2 * eps) @ T0[:3, :3].T
        J[3:, i] = [dR[2, 1], dR[0, 2], dR[1, 0]]
    return J


def _pose_error(T, target_pos, target_R=None):
    e = np.zeros(6)
    e[:3] = target_pos - T[:3, 3]
    if target_R is not None:
        dR = target_R @ T[:3, :3].T
        e[3:] = 0.5 * np.array([dR[2, 1] - dR[1, 2], dR[0, 2] - dR[2, 0],
                                dR[1, 0] - dR[0, 1]])
    return e


def inverse_kinematics(target_pos, target_R=None, q0=None, mdh=XARM6_MDH,
                       limits=XARM6_LIMITS, max_iter=200, tol=1e-5,
                       damping=0.05):
    """Damped-least-squares IK (the role of PyBullet's
    calculateInverseKinematics in the reference's push execution).

    target_pos: (3,) position; target_R: optional (3, 3) orientation.
    Returns (q (6,), converged bool).
    """
    q = np.array(q0 if q0 is not None else np.zeros(len(mdh)), np.float64)
    mask = slice(0, 6) if target_R is not None else slice(0, 3)
    for _ in range(max_iter):
        T = forward_kinematics(q, mdh)
        e = _pose_error(T, np.asarray(target_pos, np.float64), target_R)[mask]
        if np.linalg.norm(e) < tol:
            return q, True
        J = jacobian(q, mdh)[mask]
        JJt = J @ J.T + (damping**2) * np.eye(J.shape[0])
        dq = J.T @ np.linalg.solve(JJt, e)
        q = q + np.clip(dq, -0.3, 0.3)
        if limits is not None:
            q = np.clip(q, limits[:, 0], limits[:, 1])
    T = forward_kinematics(q, mdh)
    e = _pose_error(T, np.asarray(target_pos, np.float64), target_R)[mask]
    return q, bool(np.linalg.norm(e) < 10 * tol)


def push_waypoints(start_xy, end_xy, height, n_steps, approach_height=0.15):
    """Cartesian waypoints of a push primitive: descend above the start,
    sweep to the end, retreat (reference: flex_env.py:308-380 waypoint loop
    and real_env.py:212-241 approach->push->retreat)."""
    s = np.asarray(start_xy, np.float64)
    e = np.asarray(end_xy, np.float64)
    pts = []
    pts.append([s[0], s[1], height + approach_height])
    pts.append([s[0], s[1], height])
    for t in np.linspace(0.0, 1.0, n_steps)[1:]:
        p = s + (e - s) * t
        pts.append([p[0], p[1], height])
    pts.append([e[0], e[1], height + approach_height])
    return np.asarray(pts)
