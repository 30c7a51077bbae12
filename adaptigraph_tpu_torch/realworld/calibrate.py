"""Camera/robot calibration: rigid-transform estimation + board poses (a copy
of ``adaptigraph_tpu/realworld/calibrate.py``).

The geometric core of the reference's ArUco calibration flow
(reference: ``src/planning/real_world/real_env.py:327-539`` — fixed-camera
board calibration and robot hand-eye). The ArUco detection itself is a thin
cv2 call (gated helper below); everything that can go numerically wrong — the
rigid-transform fits — is plain numpy and unit-tested:

- ``kabsch``: best-fit R, t between corresponded 3D point sets (board
  corners seen in two frames).
- ``hand_eye_tsai``: AX = XB hand-eye calibration from pose pairs
  (Tsai-Lenz), used when the board is mounted on the gripper.
"""

import numpy as np


def kabsch(src, dst, with_scale=False):
    """Rigid transform mapping src -> dst (least squares).

    src, dst: (N, 3) corresponded points. Returns (R (3,3), t (3,), s):
    dst ~= s * src @ R.T + t. Umeyama variant when with_scale.
    """
    src = np.asarray(src, np.float64)
    dst = np.asarray(dst, np.float64)
    mu_s = src.mean(axis=0)
    mu_d = dst.mean(axis=0)
    X = src - mu_s
    Y = dst - mu_d
    H = X.T @ Y
    U, S, Vt = np.linalg.svd(H)
    d = np.sign(np.linalg.det(Vt.T @ U.T))
    D = np.diag([1.0, 1.0, d])
    R = Vt.T @ D @ U.T
    if with_scale:
        var = (X * X).sum()
        s = (S * np.diag(D)).sum() / var
    else:
        s = 1.0
    t = mu_d - s * R @ mu_s
    return R, t, s


def _skew(v):
    return np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]])


def _rot_to_rodrigues(R):
    theta = np.arccos(np.clip((np.trace(R) - 1) / 2, -1.0, 1.0))
    if theta < 1e-9:
        return np.zeros(3)
    axis = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    axis = axis / (2 * np.sin(theta))
    return axis * theta


def _rodrigues_to_rot(r):
    theta = np.linalg.norm(r)
    if theta < 1e-12:
        return np.eye(3)
    k = r / theta
    K = _skew(k)
    return np.eye(3) + np.sin(theta) * K + (1 - np.cos(theta)) * (K @ K)


def hand_eye_tsai(A_list, B_list):
    """Tsai-Lenz AX = XB: A = gripper motion (base frame), B = board motion
    (camera frame); X = camera pose in the gripper frame.

    A_list/B_list: lists of (4, 4) homogeneous relative motions.
    Returns (4, 4) X.
    """
    assert len(A_list) == len(B_list) >= 2
    # rotation part: least squares on modified Rodrigues vectors
    M_rows, v_rows = [], []
    for A, B in zip(A_list, B_list):
        ra = _rot_to_rodrigues(A[:3, :3])
        rb = _rot_to_rodrigues(B[:3, :3])
        # Tsai's modified vectors
        pa = 2 * np.sin(np.linalg.norm(ra) / 2 + 1e-18) * ra / (np.linalg.norm(ra) + 1e-18)
        pb = 2 * np.sin(np.linalg.norm(rb) / 2 + 1e-18) * rb / (np.linalg.norm(rb) + 1e-18)
        M_rows.append(_skew(pa + pb))
        v_rows.append(pb - pa)
    M = np.concatenate(M_rows, axis=0)
    v = np.concatenate(v_rows, axis=0)
    p, *_ = np.linalg.lstsq(M, v, rcond=None)
    p = 2 * p / np.sqrt(1 + p @ p)
    Rx = ((1 - p @ p / 2) * np.eye(3)
          + 0.5 * (np.outer(p, p) + np.sqrt(max(4 - p @ p, 0.0)) * _skew(p)))
    # translation part: (Ra - I) tx = Rx tb - ta
    C_rows, d_rows = [], []
    for A, B in zip(A_list, B_list):
        C_rows.append(A[:3, :3] - np.eye(3))
        d_rows.append(Rx @ B[:3, 3] - A[:3, 3])
    C = np.concatenate(C_rows, axis=0)
    d = np.concatenate(d_rows, axis=0)
    tx, *_ = np.linalg.lstsq(C, d, rcond=None)
    X = np.eye(4)
    X[:3, :3] = Rx
    X[:3, 3] = tx
    return X


def detect_aruco_board(rgb, intr, board_size=(6, 9), marker_len=0.03,
                       square_len=0.04):
    """Board pose from an image via cv2.aruco (gated — the geometric fits
    above are the tested core; this is the thin detection shim,
    reference: real_env.py:327-430)."""
    import cv2

    if not hasattr(cv2, "aruco"):
        raise ImportError("cv2 built without aruco; provide poses directly")
    aruco = cv2.aruco
    dictionary = aruco.getPredefinedDictionary(aruco.DICT_4X4_50)
    board = aruco.CharucoBoard(board_size, square_len, marker_len, dictionary)
    detector = aruco.CharucoDetector(board)
    corners, ids, _, _ = detector.detectBoard(rgb)
    if corners is None or len(corners) < 4:
        return None
    fx, fy, cx, cy = intr
    K = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], np.float64)
    obj_pts = board.getChessboardCorners()[ids.flatten()]
    ok, rvec, tvec = cv2.solvePnP(obj_pts, corners, K, None)
    if not ok:
        return None
    T = np.eye(4)
    T[:3, :3] = _rodrigues_to_rot(rvec.flatten())
    T[:3, 3] = tvec.flatten()
    return T
