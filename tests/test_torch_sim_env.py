"""The port's simulator, push environment and sim-backed real environment
against the JAX package's: the same seed gives the same particles and the
same camera images, bit for bit."""

import filecmp
import os

import numpy as np
import pytest

from adaptigraph_tpu.realworld.env import SimRealEnv as JaxSimRealEnv
from adaptigraph_tpu.sim.env import PushEnv as JaxPushEnv
from adaptigraph_tpu_torch.realworld import env as port_env
from adaptigraph_tpu_torch.realworld.env import SimRealEnv, sim_to_board
from adaptigraph_tpu_torch.sim import engine
from adaptigraph_tpu_torch.sim.env import PushEnv
from test_torch_jaxsim import jax_sim_built_here  # noqa: F401  (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PUSHES = [[0.02, -0.03, -0.06, 0.05], [-0.05, 0.04, 0.04, -0.02], [0.0, 0.06, 0.0, -0.06]]


@pytest.mark.parametrize("name", ["xpbd.cpp", "xpbd.h"])
def test_simulator_source_is_a_copy(name):
    assert filecmp.cmp(os.path.join(ROOT, "adaptigraph_tpu", "sim", "cpp", name),
                       os.path.join(ROOT, "adaptigraph_tpu_torch", "sim", "cpp", name),
                       shallow=False)


def test_port_loads_its_own_simulator_build():
    """The library comes from the port's build directory, named by the hash of
    its sources and flags, never from the JAX package's build."""
    path = engine._load()._name
    assert os.path.dirname(path) == os.path.join(ROOT, "build", "torch_sim")
    assert path == engine.library_path() and os.path.exists(path)
    assert os.path.join("build", "sim") not in path


def test_simulator_built_without_openmp_matches_jax(monkeypatch, tmp_path):
    """A compiler without OpenMP builds the simulator without -fopenmp; its
    OpenMP loops are per particle, so the particles stay bit-identical."""
    monkeypatch.setattr(engine, "_flags", lambda: list(engine.CXX_FLAGS))
    monkeypatch.setattr(engine, "BUILD_DIR", str(tmp_path))
    engine._load.cache_clear()
    try:
        assert os.path.dirname(engine._load()._name) == str(tmp_path)
        assert "-fopenmp" not in engine.CXX_FLAGS
        want, got = JaxSimRealEnv("granular", seed=2, img_size=8), SimRealEnv("granular", seed=2,
                                                                              img_size=8)
        for act in PUSHES[:2]:
            want.step(np.asarray(act, np.float32))
            got.step(np.asarray(act, np.float32))
        np.testing.assert_array_equal(got.get_particles_sim(), want.get_particles_sim())
    finally:
        engine._load.cache_clear()


def _same_obs(a, b):
    oa, ob = a.get_obs(), b.get_obs()
    assert sorted(oa) == sorted(ob) and len(oa) == 2 * a.n_cameras
    for k in oa:
        assert oa[k].dtype == ob[k].dtype, k
        np.testing.assert_array_equal(ob[k], oa[k], err_msg=k)


@pytest.mark.parametrize("material", ["rope", "granular"])
def test_sim_real_env_matches_jax(material):
    """Initial particles, the particles after three pushes and every camera's
    depth and color images, bit for bit."""
    want, got = JaxSimRealEnv(material, seed=3, img_size=96), SimRealEnv(material, seed=3,
                                                                         img_size=96)
    np.testing.assert_array_equal(got.get_particles_sim(), want.get_particles_sim())
    np.testing.assert_array_equal(got.env.get_fixed_mask(), want.env.get_fixed_mask())
    assert got.env.properties == want.env.properties
    _same_obs(want, got)
    for act in PUSHES:
        want.step(np.asarray(act, np.float32))
        got.step(np.asarray(act, np.float32))
        np.testing.assert_array_equal(got.get_particles_sim(), want.get_particles_sim())
    _same_obs(want, got)
    for k in ("intr", "R", "t"):
        for g, w in zip(getattr(got.cams[0], k), getattr(want.cams[0], k)):
            np.testing.assert_array_equal(g, w)


def test_cloth_grasp_matches_jax():
    want, got = JaxSimRealEnv("cloth", seed=1, img_size=64), SimRealEnv("cloth", seed=1,
                                                                        img_size=64)
    np.testing.assert_array_equal(got.get_particles_sim(), want.get_particles_sim())
    pts = got.get_particles_sim()
    corner = pts[np.argmax(pts[:, 0])]
    act = np.array([corner[0], corner[2], corner[0] + 0.6, corner[2]], np.float32) / 10.0
    want.step_gripper(act)
    got.step_gripper(act)
    assert got.env._n_grasped == want.env._n_grasped > 0
    np.testing.assert_array_equal(got.get_particles_sim(), want.get_particles_sim())
    got.step(np.asarray(PUSHES[0], np.float32))
    want.step(np.asarray(PUSHES[0], np.float32))
    np.testing.assert_array_equal(got.get_particles_sim(), want.get_particles_sim())
    _same_obs(want, got)


def test_push_env_frames_and_robot_push_match_jax():
    """PushEnv's captured frames and eef states, and the robot-driven push
    through the arm's IK (with multi-view capture), on pushes the JAX
    environment samples."""
    want = JaxPushEnv("rope", seed=5, capture_depth=True, n_cameras=2, img_size=48)
    got = PushEnv("rope", seed=5, capture_depth=True, n_cameras=2, img_size=48)
    np.testing.assert_array_equal(got.reset(), want.reset())
    act = want.sample_push()
    for a, b in zip(got.execute_push(act), want.execute_push(act)):
        np.testing.assert_array_equal(a, b)
    for cam in ("cam_0", "cam_1"):
        for kind in ("color", "depth"):
            np.testing.assert_array_equal(got.last_observations()[kind][cam],
                                          want.last_observations()[kind][cam])
    want.robot = got.robot = True
    act = want.sample_push()
    for a, b in zip(got.execute_push(act), want.execute_push(act)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(got.last_robot_trace, want.last_robot_trace):
        np.testing.assert_array_equal(a, b)


def test_sim_to_board_matches_jax():
    from adaptigraph_tpu.realworld.env import sim_to_board as jax_sim_to_board

    pts = np.random.RandomState(0).randn(30, 3).astype(np.float32)
    np.testing.assert_array_equal(sim_to_board(pts, 10.0), jax_sim_to_board(pts, 10.0))


def test_real_env_hardware_tier_is_not_ported(monkeypatch):
    """The hardware ``RealEnv`` is JAX's stub: without pyrealsense2 it raises
    JAX's ImportError, with it JAX's NotImplementedError. The I/O tier beneath
    it is ported, and the package exports what the JAX package's does: the
    shared-memory ring and queue and the timestamp accumulators at import,
    perception, the point clouds, the cameras and ``SimRealEnv`` lazily."""
    import sys
    import types

    import adaptigraph_tpu.realworld as jax_rw
    import adaptigraph_tpu.realworld.env as jax_env
    import adaptigraph_tpu_torch.realworld as rw

    monkeypatch.setitem(sys.modules, "pyrealsense2", None)
    for mod in (jax_env, port_env):
        with pytest.raises(ImportError, match="RealEnv needs pyrealsense2"):
            mod.RealEnv()
    monkeypatch.setitem(sys.modules, "pyrealsense2", types.ModuleType("pyrealsense2"))
    msgs = []
    for mod in (jax_env, port_env):
        with pytest.raises(NotImplementedError) as exc:
            mod.RealEnv()
        msgs.append(str(exc.value))
    assert msgs[1] == msgs[0]
    want = sorted(n for n, v in vars(jax_rw).items()
                  if not n.startswith("__") and not isinstance(v, types.ModuleType))
    assert len(want) == 18
    assert [n for n in want if not hasattr(rw, n)] == []
    assert rw.SimRealEnv is port_env.SimRealEnv
    here = os.listdir(os.path.dirname(rw.__file__))
    for name in ("shm.py", "accumulate.py", "camera.py", "xarm.py", "calibrate.py", "cpp"):
        assert name in here
