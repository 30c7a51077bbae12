"""Port checkpoint loading and the plain GNN forward against the JAX package."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adaptigraph_tpu.models.gnn import GNNConfig as JaxGNNConfig
from adaptigraph_tpu.models.gnn import forward_batch as jax_forward_batch
from adaptigraph_tpu.models.gnn import init_params
from adaptigraph_tpu.ops.graph import EdgeConfig as JaxEdgeConfig
from adaptigraph_tpu.ops.graph import build_neighbor_graph_batch as jax_build
from adaptigraph_tpu.utils.checkpoint import load_pytree
from adaptigraph_tpu_torch.models.gnn import GNNConfig, forward_batch, params_from_numpy
from adaptigraph_tpu_torch.utils.checkpoint import latest_name, load_checkpoint

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def to_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.mark.parametrize("fixture", ["rope_demo", "granular_demo"])
def test_load_checkpoint_matches_load_pytree(fixture):
    from adaptigraph_tpu_torch.cli import _dyn_objects
    from adaptigraph_tpu_torch.utils.config import load_dynamics_config

    d = os.path.join(ROOT, "fixtures", fixture)
    gnn, _ = _dyn_objects(load_dynamics_config(fixture.split("_")[0]))
    got = load_checkpoint(d, cfg=gnn)
    want = load_pytree(latest_name(d))
    got_leaves, got_def = jax.tree_util.tree_flatten(got)
    want_leaves, want_def = jax.tree_util.tree_flatten(want)
    assert got_def == want_def
    assert len(got_leaves) == 22
    for g, w in zip(got_leaves, want_leaves):
        np.testing.assert_array_equal(g, np.asarray(w))


def test_load_checkpoint_rejects_wrong_config():
    d = os.path.join(ROOT, "fixtures", "rope_demo")
    with pytest.raises(ValueError, match="shape"):
        load_checkpoint(d, cfg=GNNConfig(nf_particle=64, nf_relation=64, nf_effect=64))


def _graphs(cfg, B, seed, per_particle_phys):
    rng = np.random.RandomState(seed)
    N = cfg.n_nodes
    state = (rng.randn(B, cfg.n_his, N, 3) * 0.4).astype(np.float32)
    node_mask = np.ones((B, N), bool)
    node_mask[:, cfg.max_nobj - 4:cfg.max_nobj] = False
    tool_mask = np.zeros((B, N), bool)
    tool_mask[:, cfg.max_nobj:] = True
    ecfg = JaxEdgeConfig(max_nobj=cfg.max_nobj, max_neef=cfg.max_neef, topk=6)
    nbrs, mask = jax_build(jnp.asarray(state[:, -1]), jnp.asarray(node_mask),
                           jnp.asarray(tool_mask), 0.6, ecfg)
    attrs = np.zeros((B, N, 2), np.float32)
    attrs[:, :cfg.max_nobj - 4, 0] = 1.0
    attrs[:, cfg.max_nobj:, 1] = 1.0
    p_inst = np.zeros((B, cfg.max_nobj, 1), np.float32)
    p_inst[:, :cfg.max_nobj - 4] = 1.0
    action = np.zeros((B, N, 3), np.float32)
    action[:, cfg.max_nobj:] = rng.randn(B, cfg.max_neef, 3) * 0.1
    phys_shape = (B, cfg.max_nobj) if per_particle_phys else (B, cfg.phys_dim)
    return {"state": state, "attrs": attrs, "neighbors": np.asarray(nbrs),
            "nbr_mask": np.asarray(mask), "action": action, "p_instance": p_inst,
            "physics_param": rng.rand(*phys_shape).astype(np.float32)}


@pytest.mark.parametrize("per_particle_phys", [False, True])
def test_forward_batch_matches_jax(per_particle_phys):
    kw = dict(n_his=4, max_nobj=24, max_neef=2, nf_particle=32, nf_relation=32, nf_effect=32,
              pstep=3)
    jcfg, cfg = JaxGNNConfig(**kw), GNNConfig(**kw)
    params = to_np(init_params(jax.random.PRNGKey(0), jcfg))
    graphs = _graphs(cfg, 3, 1, per_particle_phys)
    want_pos, want_mot = jax_forward_batch(params, {k: jnp.asarray(v) for k, v in graphs.items()},
                                           jcfg)
    got_pos, got_mot = forward_batch(params_from_numpy(params, "cpu"),
                                     {k: torch.tensor(v) for k, v in graphs.items()}, cfg)
    np.testing.assert_allclose(got_pos.numpy(), np.asarray(want_pos), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got_mot.numpy(), np.asarray(want_mot), rtol=2e-4, atol=2e-4)


def test_forward_matches_golden_fixture():
    z = np.load(os.path.join(ROOT, "fixtures", "golden", "gnn_forward.npz"))
    kw = dict(n_his=4, max_nobj=20, max_neef=2, nf_particle=24, nf_relation=24, nf_effect=24,
              pstep=3, phys_dim=2)
    template = init_params(jax.random.PRNGKey(0), JaxGNNConfig(**kw))
    flat, treedef = jax.tree_util.tree_flatten(template)
    params = jax.tree_util.tree_unflatten(treedef, [z[f"param_{i}"] for i in range(len(flat))])
    keys = ("state", "attrs", "neighbors", "nbr_mask", "action", "p_instance", "physics_param")
    graphs = {k: torch.tensor(z[k])[None] for k in keys}
    pred, motion = forward_batch(params_from_numpy(to_np(params), "cpu"), graphs, GNNConfig(**kw))
    # the tolerance of tests/test_model.py's golden check
    np.testing.assert_allclose(pred[0].numpy(), z["pred"], rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(motion[0].numpy(), z["motion"], rtol=2e-3, atol=2e-3)
