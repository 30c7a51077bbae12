"""The port's calibration fits, hardware gates and small helpers against the
JAX package's: ``kabsch`` (with and without scale) and ``hand_eye_tsai``
within 1e-6, the cv2, xArm and RealSense gates raising the same
``ImportError`` where their modules are missing, ``utils/seed.py`` and
``ops/padding.py``."""

import sys

import numpy as np
import pytest
import torch

from adaptigraph_tpu.ops import padding as jax_padding
from adaptigraph_tpu.realworld import calibrate as jax_calibrate
from adaptigraph_tpu.realworld import camera as jax_camera
from adaptigraph_tpu.realworld import xarm as jax_xarm
from adaptigraph_tpu_torch.ops import padding
from adaptigraph_tpu_torch.realworld import calibrate, camera, xarm
from adaptigraph_tpu_torch.utils import seed


@pytest.mark.parametrize("with_scale", [False, True])
def test_kabsch_matches_jax(with_scale):
    rng = np.random.RandomState(0)
    src = rng.randn(30, 3)
    R_true = calibrate._rodrigues_to_rot(np.array([0.3, -0.2, 0.5]))
    t_true = np.array([0.1, -0.4, 0.7])
    s_true = 2.0 if with_scale else 1.0
    dst = s_true * src @ R_true.T + t_true + rng.randn(30, 3) * 1e-3
    R, t, s = calibrate.kabsch(src, dst, with_scale=with_scale)
    Rj, tj, sj = jax_calibrate.kabsch(src, dst, with_scale=with_scale)
    np.testing.assert_allclose(R, Rj, atol=1e-6)
    np.testing.assert_allclose(t, tj, atol=1e-6)
    assert abs(s - sj) < 1e-6
    np.testing.assert_allclose(R, R_true, atol=1e-3)
    assert abs(s - s_true) < 1e-3


def test_hand_eye_tsai_matches_jax():
    rng = np.random.RandomState(1)
    X = np.eye(4)
    X[:3, :3] = calibrate._rodrigues_to_rot(np.array([0.2, 0.4, -0.3]))
    X[:3, 3] = [0.05, -0.02, 0.1]
    A_list, B_list = [], []
    for _ in range(6):
        A = np.eye(4)
        A[:3, :3] = calibrate._rodrigues_to_rot(rng.randn(3) * 0.6)
        A[:3, 3] = rng.randn(3) * 0.2
        A_list.append(A)
        B_list.append(np.linalg.inv(X) @ A @ X)  # AX = XB
    got = calibrate.hand_eye_tsai(A_list, B_list)
    np.testing.assert_allclose(got, jax_calibrate.hand_eye_tsai(A_list, B_list), atol=1e-6)
    np.testing.assert_allclose(got, X, atol=1e-6)
    r = rng.randn(3)
    np.testing.assert_allclose(calibrate._rot_to_rodrigues(calibrate._rodrigues_to_rot(r)),
                               jax_calibrate._rot_to_rodrigues(jax_calibrate._rodrigues_to_rot(r)),
                               atol=1e-9)


def _gate_message(fn, monkeypatch, missing):
    with monkeypatch.context() as m:
        m.setitem(sys.modules, missing, None)
        with pytest.raises(ImportError) as info:
            fn()
    return str(info.value)


@pytest.mark.parametrize("gate", ["aruco", "xarm", "realsense"])
def test_hardware_gates_raise_as_jax(monkeypatch, gate):
    """Without cv2, the xArm SDK or pyrealsense2 (their ``sys.modules``
    entries set to None, as on a host that lacks them) the port's gated
    entry points raise the JAX package's ``ImportError``."""
    img, intr = np.zeros((8, 8, 3), np.uint8), (1.0, 1.0, 4.0, 4.0)
    calls = {
        "aruco": ("cv2", lambda m: m.detect_aruco_board(img, intr)),
        "xarm": ("xarm.wrapper", lambda m: m.XARM6()),
        "realsense": ("pyrealsense2", lambda m: m.RealsenseCameraProcess()),
    }
    missing, call = calls[gate]
    port = {"aruco": calibrate, "xarm": xarm, "realsense": camera}[gate]
    ref = {"aruco": jax_calibrate, "xarm": jax_xarm, "realsense": jax_camera}[gate]
    if gate == "xarm":
        monkeypatch.setitem(sys.modules, "xarm", None)
    got = _gate_message(lambda: call(port), monkeypatch, missing)
    assert got == _gate_message(lambda: call(ref), monkeypatch, missing)
    if gate != "aruco":
        assert "SimRealEnv" in got or "SyntheticCameraProcess" in got


def test_seed_and_padding_match_jax():
    seed.set_seed(3)
    a = (np.random.rand(), torch.rand(1).item())
    seed.set_seed(3)
    assert (np.random.rand(), torch.rand(1).item()) == a
    assert seed.np_rng(5).random() == np.random.default_rng(5).random()
    x = np.random.RandomState(0).randn(3, 5, 2).astype(np.float32)
    for n in (2, 7):
        np.testing.assert_array_equal(padding.pad_axis0(x, n), jax_padding.pad_axis0(x, n))
        np.testing.assert_array_equal(padding.pad_axis1(x, n), jax_padding.pad_axis1(x, n))
