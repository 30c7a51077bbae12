"""The port's public helpers against the JAX package's, checked as JAX's own
tests check them (``tests/test_graph.py``, ``test_model.py``,
``test_fps.py``, ``test_viz.py``, ``test_pipeline.py``): the single-sample
``forward`` and ``count_params``, the one-state graph build and its edge set,
gather and aggregate, ``fps_rad_numpy_from``, the quaternion helpers,
``save_pytree``/``load_pytree`` across the packages, ``draw_graph``,
``table_axis_for_frame``, ``RealEnv`` and the package exports. Inputs come
from numpy seeds; float32 model outputs agree within 2e-4, numpy helpers
exactly."""

import importlib
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from adaptigraph_tpu.models import gnn as jax_gnn
from adaptigraph_tpu.ops import fps as jax_fps
from adaptigraph_tpu.ops import graph as jax_graph
from adaptigraph_tpu.realworld import cameras as jax_cameras
from adaptigraph_tpu.realworld import env as jax_env
from adaptigraph_tpu.utils import checkpoint as jax_ckpt
from adaptigraph_tpu.utils import transforms as jax_tf
from adaptigraph_tpu.utils import viz as jax_viz
from adaptigraph_tpu_torch.models import gnn
from adaptigraph_tpu_torch.ops import fps, graph
from adaptigraph_tpu_torch.realworld import cameras, env
from adaptigraph_tpu_torch.utils import checkpoint as ckpt
from adaptigraph_tpu_torch.utils import transforms as tf
from adaptigraph_tpu_torch.utils import viz

torch.set_num_threads(2)
TOL = 2e-4
GNN_KW = dict(n_his=4, max_nobj=40, max_neef=2, nf_particle=32, nf_relation=32, nf_effect=32,
              pstep=3)
POLICIES = [("none", {}), ("tools_all", {"gate_on_contact": True}), ("non_fixed", {}),
            ("surface", {"surface_ratio": 0.9})]


def make_scene(rng, max_nobj=40, max_neef=3, n_obj=30, n_eef=2, scale=1.0):
    """``tests/test_graph.py``'s scene: n_obj objects and n_eef tools."""
    N = max_nobj + max_neef
    states = np.zeros((N, 3), np.float32)
    states[:n_obj] = rng.uniform(-scale, scale, size=(n_obj, 3))
    states[max_nobj:max_nobj + n_eef] = rng.uniform(-scale, scale, size=(n_eef, 3))
    node_mask = np.zeros(N, bool)
    node_mask[:n_obj] = True
    node_mask[max_nobj:max_nobj + n_eef] = True
    tool_mask = np.zeros(N, bool)
    tool_mask[max_nobj:max_nobj + n_eef] = True
    return states, node_mask, tool_mask


def make_graph(seed, per_particle_phys=False):
    """``tests/test_model.py``'s single-sample graph, as numpy arrays."""
    cfg = jax_gnn.GNNConfig(**GNN_KW)
    rng = np.random.RandomState(seed)
    n_obj, n_eef, N = 30, cfg.max_neef, cfg.n_nodes
    state = np.zeros((cfg.n_his, N, 3), np.float32)
    state[:, :n_obj] = rng.uniform(-1, 1, (1, n_obj, 3)) + 0.05 * rng.randn(cfg.n_his, n_obj, 3)
    state[:, cfg.max_nobj:] = rng.uniform(-1, 1, (1, n_eef, 3))
    node_mask = np.zeros(N, bool)
    node_mask[:n_obj] = node_mask[cfg.max_nobj:] = True
    tool_mask = np.zeros(N, bool)
    tool_mask[cfg.max_nobj:] = True
    ecfg = jax_graph.EdgeConfig(max_nobj=cfg.max_nobj, max_neef=n_eef, topk=6)
    nbrs, mask = jax_graph.build_neighbor_graph(state[-1], node_mask, tool_mask, 0.7, ecfg)
    attrs = np.zeros((N, 2), np.float32)
    attrs[:n_obj, 0] = attrs[cfg.max_nobj:, 1] = 1
    action = np.zeros((N, 3), np.float32)
    action[cfg.max_nobj:] = 0.1 * rng.randn(n_eef, 3)
    p_instance = np.zeros((cfg.max_nobj, 1), np.float32)
    p_instance[:n_obj, 0] = 1
    phys = rng.rand(cfg.max_nobj if per_particle_phys else cfg.phys_dim).astype(np.float32)
    return {"state": state, "attrs": attrs, "neighbors": np.array(nbrs),
            "nbr_mask": np.array(mask), "action": action, "p_instance": p_instance,
            "physics_param": phys}


@pytest.fixture(scope="module")
def weights():
    jp = jax.tree_util.tree_map(np.asarray, jax_gnn.init_params(jax.random.PRNGKey(0),
                                                                jax_gnn.GNNConfig(**GNN_KW)))
    return jp, gnn.params_from_numpy(jp, "cpu")


@pytest.mark.parametrize("seed,per_particle", [(0, False), (1, False), (2, True)])
def test_forward_matches_jax_and_forward_batch(weights, seed, per_particle):
    jp, tp = weights
    g = make_graph(seed, per_particle)
    want_pos, want_motion = jax_gnn.forward(jax.tree_util.tree_map(jnp.asarray, jp),
                                            {k: jnp.asarray(v) for k, v in g.items()},
                                            jax_gnn.GNNConfig(**GNN_KW))
    tg = {k: torch.as_tensor(v) for k, v in g.items()}
    pos, motion = gnn.forward(tp, tg, gnn.GNNConfig(**GNN_KW))
    assert pos.shape == motion.shape == (GNN_KW["max_nobj"], 3)
    np.testing.assert_allclose(pos.numpy(), np.asarray(want_pos), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(motion.numpy(), np.asarray(want_motion), rtol=TOL, atol=TOL)
    bpos, bmotion = gnn.forward_batch(tp, {k: v[None] for k, v in tg.items()},
                                      gnn.GNNConfig(**GNN_KW))
    np.testing.assert_array_equal(pos.numpy(), bpos[0].numpy())
    np.testing.assert_array_equal(motion.numpy(), bmotion[0].numpy())


def test_count_params_matches_jax(weights):
    jp, tp = weights
    assert gnn.count_params(tp) == gnn.count_params(jp) == jax_gnn.count_params(jp)
    rope = jax_gnn.GNNConfig(n_his=4, max_nobj=100, max_neef=1)
    tp_rope = gnn.init_params(torch.Generator().manual_seed(0), gnn.GNNConfig(n_his=4,
                                                                              max_nobj=100,
                                                                              max_neef=1))
    want = jax_gnn.count_params(jax_gnn.init_params(jax.random.PRNGKey(0), rope))
    assert gnn.count_params(tp_rope) == want


@pytest.mark.parametrize("seed", range(2))
@pytest.mark.parametrize("policy,kw", POLICIES, ids=[p for p, _ in POLICIES])
def test_build_neighbor_graph_matches_jax(seed, policy, kw):
    """One state under each edge policy: JAX's mask, and its senders where the
    mask is set; the same edge set; row 0 of the batch build."""
    rng = np.random.RandomState(seed)
    states, node_mask, tool_mask = make_scene(rng, scale=0.8)
    states[:30, 1] += 1.0
    states[40:, 1] += 1.0
    ekw = dict(max_nobj=40, max_neef=3, topk=8, policy=policy, **kw)
    knn_frac = 0.6 if policy == "non_fixed" else 1.0
    want_n, want_m = (np.asarray(x) for x in jax_graph.build_neighbor_graph(
        states, node_mask, tool_mask, 0.7, jax_graph.EdgeConfig(**ekw), knn_frac=knn_frac))
    args = (torch.tensor(states), torch.tensor(node_mask), torch.tensor(tool_mask))
    got_n, got_m = graph.build_neighbor_graph(*args, 0.7, graph.EdgeConfig(**ekw),
                                              knn_frac=knn_frac)
    assert got_n.shape == want_n.shape and got_n.dtype == torch.int32
    np.testing.assert_array_equal(got_m.numpy(), want_m)
    np.testing.assert_array_equal(got_n.numpy()[want_m], want_n[want_m])
    assert graph.graph_to_edge_set(got_n, got_m) == jax_graph.graph_to_edge_set(want_n, want_m)
    assert len(graph.graph_to_edge_set(got_n, got_m)) > 0
    bn, bm = graph.build_neighbor_graph_batch(*(a[None] for a in args), 0.7,
                                              graph.EdgeConfig(**ekw), knn_frac)
    np.testing.assert_array_equal(bn[0].numpy(), got_n.numpy())
    np.testing.assert_array_equal(bm[0].numpy(), got_m.numpy())


def test_gather_and_aggregate_match_jax():
    """Unbatched against JAX and the dense receiver-sum oracle; batched
    against the index oracle."""
    rng = np.random.RandomState(3)
    states, node_mask, tool_mask = make_scene(rng)
    cfg = jax_graph.EdgeConfig(max_nobj=40, max_neef=3, topk=6)
    nbrs, mask = (np.asarray(x) for x in jax_graph.build_neighbor_graph(
        states, node_mask, tool_mask, 0.5, cfg))
    x = rng.randn(43, 5).astype(np.float32)
    got_s = graph.neighbor_gather(torch.tensor(x), torch.tensor(nbrs))
    np.testing.assert_array_equal(got_s.numpy(),
                                  np.asarray(jax_graph.neighbor_gather(jnp.asarray(x),
                                                                       jnp.asarray(nbrs))))
    got = graph.neighbor_aggregate(got_s, torch.tensor(mask)).numpy()
    want = np.asarray(jax_graph.neighbor_aggregate(jnp.asarray(got_s.numpy()),
                                                   jnp.asarray(mask)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    dense = np.zeros((43, 5), np.float32)
    for r, s in sorted(graph.graph_to_edge_set(nbrs, mask)):
        dense[r] += x[s]
    np.testing.assert_allclose(got, dense, rtol=1e-5, atol=1e-5)
    xb = rng.randn(2, 10, 4).astype(np.float32)
    nb = rng.randint(0, 10, size=(2, 10, 3)).astype(np.int32)
    out = graph.neighbor_gather(torch.tensor(xb), torch.tensor(nb)).numpy()
    np.testing.assert_array_equal(out, xb[np.arange(2)[:, None, None], nb])
    np.testing.assert_array_equal(out, np.asarray(jax_graph.neighbor_gather(jnp.asarray(xb),
                                                                            jnp.asarray(nb))))


@pytest.mark.parametrize("radius", [0.05, 0.2, 0.6])
def test_fps_rad_numpy_from_matches_jax(radius):
    pcd = np.random.RandomState(5).uniform(-1, 1, (300, 3)).astype(np.float32)
    for start in (0, 17):
        got = fps.fps_rad_numpy_from(pcd, radius, start=start)
        np.testing.assert_array_equal(got, jax_fps.fps_rad_numpy_from(pcd, radius, start=start))
        assert got[0] == start
    idx1 = fps.fps_numpy(pcd, 50, start_idx=3)
    np.testing.assert_array_equal(fps.fps_downsample(pcd, 50, radius, start_idx=3),
                                  idx1[fps.fps_rad_numpy_from(pcd[idx1], radius, start=0)])


unit = st.floats(-1.0, 1.0, allow_nan=False)
angle = st.floats(-np.pi, np.pi, allow_nan=False)


def _unit_quat(xyzw):
    q = np.asarray(xyzw, np.float64)
    n = np.linalg.norm(q)
    return q / n if n > 1e-3 else np.array([0.0, 0.0, 0.0, 1.0])


@settings(max_examples=60, deadline=None)
@given(st.tuples(unit, unit, unit, unit), st.tuples(unit, unit, unit, unit),
       st.tuples(unit, unit, unit), angle, st.tuples(angle, angle, angle))
def test_quaternion_helpers_match_jax(qa, qb, axis, ang, euler):
    q1, q2 = _unit_quat(qa), _unit_quat(qb)
    ax = np.asarray(axis) if np.linalg.norm(axis) > 1e-3 else np.array([0.0, 1.0, 0.0])
    v = np.asarray(axis) * 3.0
    for name, args in (("quat_mul", (q1, q2)), ("quat_conjugate", (q1,)),
                       ("quat_from_axis_angle", (ax, ang)), ("euler_to_quat", euler),
                       ("rotate_vec", (q1, v)), ("quat_to_rotmat", (q1,)),
                       ("quat_from_rotmat", (jax_tf.quat_to_rotmat(q1),))):
        np.testing.assert_array_equal(getattr(tf, name)(*args), getattr(jax_tf, name)(*args),
                                      err_msg=name)
    R = tf.quat_to_rotmat(tf.quat_from_axis_angle(ax, ang))
    q = tf.quat_from_rotmat(R)
    np.testing.assert_allclose(tf.quat_to_rotmat(q), R, atol=1e-9)
    np.testing.assert_allclose(tf.quat_to_rotmat(tf.quat_mul(q1, q2)),
                               tf.quat_to_rotmat(q1) @ tf.quat_to_rotmat(q2), atol=1e-9)
    np.testing.assert_allclose(tf.rotate_vec(tf.quat_conjugate(q1), tf.rotate_vec(q1, v)), v,
                               atol=1e-9)


def test_euler_yaw_is_quat_from_yaw():
    np.testing.assert_allclose(tf.euler_to_quat(0.0, 0.7, 0.0), tf.quat_from_yaw(0.7),
                               atol=1e-12)


def test_pytree_files_cross_between_packages(weights, tmp_path):
    """JAX reads the port's parameter file and the port JAX's; another
    nesting round-trips through the port's own structure record."""
    jp, tp = weights
    ckpt.save_pytree(str(tmp_path / "port.npz"), tp)
    got = jax_ckpt.load_pytree(str(tmp_path / "port.npz"))
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(jp)
    for a, b in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(jp)):
        np.testing.assert_array_equal(a, b)
    jax_ckpt.save_pytree(str(tmp_path / "jax.npz"), jp)
    back = ckpt.load_pytree(str(tmp_path / "jax.npz"))
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(jp)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(jp)):
        np.testing.assert_array_equal(a, b)
    other = {"mu": [np.arange(3.0), (torch.ones(2, 2), None)], "count": np.int32(7)}
    ckpt.save_pytree(str(tmp_path / "other.npz"), other)
    again = ckpt.load_pytree(str(tmp_path / "other.npz"))
    assert isinstance(again["mu"][1], tuple) and again["mu"][1][1] is None
    np.testing.assert_array_equal(again["mu"][0], other["mu"][0])
    np.testing.assert_array_equal(again["mu"][1][0], np.ones((2, 2), np.float32))
    assert int(again["count"]) == 7
    jax_ckpt.save_pytree(str(tmp_path / "jax_other.npz"), {"a": [np.zeros(2)]})
    with pytest.raises(ValueError, match="only JAX can read it"):
        ckpt.load_pytree(str(tmp_path / "jax_other.npz"))


@pytest.mark.parametrize("with_edges", [False, True], ids=["points", "edges"])
def test_draw_graph_pixel_equal_to_jax(with_edges):
    intr, extr = viz.topdown_camera()
    rng = np.random.RandomState(2)
    pts = rng.uniform(-2.5, 2.5, (25, 3))
    pts[3, 1] = 20.0  # above the camera: not drawn, nor its edges
    nbrs = rng.randint(0, 27, (25, 4))  # some senders past the points
    mask = rng.rand(25, 4) > 0.3
    kw = {"neighbors": nbrs, "nbr_mask": mask} if with_edges else {}
    img = np.full((360, 360, 3), 255, np.uint8)
    got = viz.draw_graph(img.copy(), pts, intr, extr, color=(0, 0, 255), **kw)
    want = jax_viz.draw_graph(img.copy(), pts, intr, extr, color=(0, 0, 255), **kw)
    np.testing.assert_array_equal(got, want)
    assert (got != img).any()
    nb2 = np.array([[1], [0]])
    two = np.zeros((360, 360, 3), np.uint8)
    two_pts = np.array([[0.0, 0.0, 0.0], [0.5, 0.0, 0.5]])
    np.testing.assert_array_equal(viz.draw_graph(two.copy(), two_pts, intr, extr, neighbors=nb2),
                                  jax_viz.draw_graph(two.copy(), two_pts, intr, extr,
                                                     neighbors=nb2))


def test_table_axis_for_frame_matches_jax():
    for frame in ("y_up", "z_down", "other"):
        assert cameras.table_axis_for_frame(frame) == jax_cameras.table_axis_for_frame(frame)
    assert cameras.table_axis_for_frame("y_up") == 1


def test_real_env_raises_as_jax(monkeypatch):
    """Without pyrealsense2 an ImportError, with it NotImplementedError, with
    JAX's messages."""
    monkeypatch.setitem(sys.modules, "pyrealsense2", None)
    for cls in (jax_env.RealEnv, env.RealEnv):
        with pytest.raises(ImportError, match="RealEnv needs pyrealsense2 \\+ an xArm SDK; "
                                              "use SimRealEnv for hardware-free operation"):
            cls("rope")
    monkeypatch.setitem(sys.modules, "pyrealsense2", types.ModuleType("pyrealsense2"))
    msgs = []
    for cls in (jax_env.RealEnv, env.RealEnv):
        with pytest.raises(NotImplementedError) as exc:
            cls()
        msgs.append(str(exc.value))
    assert msgs[0] == msgs[1] and "SimRealEnv" in msgs[1]


RENAMED = {"fps_jax": "fps_device"}


@pytest.mark.parametrize("package", ["models", "ops", "utils", "dynamics", "realworld",
                                     "planning", "parallel"])
def test_package_exports_match_jax(package):
    """Every name a JAX package's ``__init__`` exports is exported by the
    port's, the renamed ones under the port's names, and resolves to the
    module attribute of that name."""
    jax_pkg = importlib.import_module(f"adaptigraph_tpu.{package}")
    port = importlib.import_module(f"adaptigraph_tpu_torch.{package}")
    names = [n for n in vars(jax_pkg) if not n.startswith("_")
             and not isinstance(getattr(jax_pkg, n), types.ModuleType)]
    assert names
    for name in names:
        obj = getattr(port, RENAMED.get(name, name))
        assert not isinstance(obj, types.ModuleType), name
        assert obj.__module__.startswith(f"adaptigraph_tpu_torch.{package}"), name
        assert RENAMED.get(name, name) in dir(port), name
