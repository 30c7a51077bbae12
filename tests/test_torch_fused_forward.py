"""The port's single-step forward (K2) and its training backward (K3), on CPU
tensors (their plain versions), against the JAX kernels in interpret mode:
``fused_forward_batch`` at the tolerances of tests/test_fused.py (f32 2e-4,
bf16 0.05) and ``make_fused_train_forward``'s value and gradients at those of
tests/test_fused_train.py (value rtol 1e-5, gradients rtol 5e-4 / atol 1e-6)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adaptigraph_tpu.models.gnn import GNNConfig as JaxGNNConfig
from adaptigraph_tpu.models.gnn import init_params
from adaptigraph_tpu.ops.fused_gnn import fused_forward_batch as jax_fused_forward
from adaptigraph_tpu.ops.fused_gnn_train import make_fused_train_forward as jax_make_train
from adaptigraph_tpu.ops.graph import EdgeConfig as JaxEdgeConfig
from adaptigraph_tpu.ops.graph import build_neighbor_graph_batch
from adaptigraph_tpu_torch.models.gnn import GNNConfig, params_from_numpy
from adaptigraph_tpu_torch.ops import fused_gnn, fused_gnn_train
from adaptigraph_tpu_torch.ops.fused_gnn import fused_forward_batch
from adaptigraph_tpu_torch.ops.fused_gnn_train import make_fused_train_forward

torch.set_num_threads(2)

KW = dict(n_his=4, max_nobj=20, max_neef=1, nf_particle=32, nf_relation=32, nf_effect=32, pstep=3)
JCFG, CFG = JaxGNNConfig(**KW), GNNConfig(**KW)
ECFG = JaxEdgeConfig(max_nobj=20, max_neef=1, topk=6)
K_USED = ECFG.topk + ECFG.max_neef
B = 4


def make_inputs(seed=0):
    """A rope-like batch: some object slots invalid (padded to zero), edges
    built by the JAX graph builder with per-sample radii."""
    rng = np.random.RandomState(seed)
    N, n_p = CFG.n_nodes, CFG.max_nobj
    counts = np.array([n_p, n_p - 5, 9, 14])
    valid = np.arange(n_p)[None] < counts[:, None]
    state = (rng.randn(B, CFG.n_his, N, 3) * 0.3).astype(np.float32)
    state[:, :, :n_p] *= valid[:, None, :, None]
    node_mask = np.concatenate([valid, np.ones((B, 1), bool)], axis=1)
    tool_mask = np.zeros((B, N), bool)
    tool_mask[:, n_p] = True
    radius = rng.uniform(0.45, 0.9, B).astype(np.float32)
    nbrs, mask = build_neighbor_graph_batch(jnp.asarray(state[:, -1]), jnp.asarray(node_mask),
                                            jnp.asarray(tool_mask), jnp.asarray(radius), ECFG)
    attrs = np.zeros((B, N, 2), np.float32)
    attrs[:, :n_p, 0] = valid
    attrs[:, n_p:, 1] = 1.0
    return {
        "state": state,
        "action": (rng.randn(B, N, 3) * 0.05).astype(np.float32),
        "physics_param": rng.rand(B, 1).astype(np.float32),
        "attrs": attrs,
        "p_instance": valid[..., None].astype(np.float32),
        "neighbors": np.asarray(nbrs),
        "nbr_mask": np.asarray(mask),
    }


def params(seed=0):
    p = jax.tree_util.tree_map(np.asarray, init_params(jax.random.PRNGKey(seed), JCFG))
    return p, params_from_numpy(p, "cpu")


def torch_inputs(g):
    return {k: torch.tensor(v) for k, v in g.items()}


@pytest.mark.parametrize("dtype,tol", [("float32", 2e-4), ("bfloat16", 0.05)])
def test_forward_matches_jax_kernel(dtype, tol):
    g = make_inputs()
    jp, tp = params()
    jcd, tcd = getattr(jnp, dtype), getattr(torch, dtype)
    want_pred, want_mot = jax_fused_forward(jp, {k: jnp.asarray(v) for k, v in g.items()}, JCFG,
                                            compute_dtype=jcd, interpret=True, k_used=K_USED,
                                            samples_per_block=2, want_motion=True)
    launches = fused_gnn.gnn_forward.launches
    pred, mot = fused_forward_batch(tp, torch_inputs(g), CFG, compute_dtype=tcd, k_used=K_USED)
    assert fused_gnn.gnn_forward.launches == launches  # CPU tensors: the plain version
    np.testing.assert_allclose(pred.numpy(), np.asarray(want_pred), atol=tol, rtol=0)
    np.testing.assert_allclose(mot.numpy(), np.asarray(want_mot), atol=tol, rtol=0)
    _, none = fused_forward_batch(tp, torch_inputs(g), CFG, compute_dtype=tcd, k_used=K_USED,
                                  want_motion=False)
    assert none is None


def test_forward_honours_every_masked_slot():
    """An arbitrary mask (not a prefix of the slots, the eef slot real): the
    plain version matches the JAX kernel on it."""
    g = make_inputs(seed=2)
    rng = np.random.RandomState(5)
    mask = g["nbr_mask"].copy()
    mask[..., :K_USED] &= rng.rand(*mask[..., :K_USED].shape) > 0.3
    mask[:, :CFG.max_nobj, K_USED - 1] = True  # the eef slot, as tools_all makes it real
    g["neighbors"] = g["neighbors"].copy()
    g["neighbors"][:, :CFG.max_nobj, K_USED - 1] = CFG.max_nobj
    g["nbr_mask"] = mask
    jp, tp = params(1)
    want, _ = jax_fused_forward(jp, {k: jnp.asarray(v) for k, v in g.items()}, JCFG,
                                compute_dtype=jnp.float32, interpret=True, k_used=K_USED,
                                samples_per_block=2)
    got, _ = fused_forward_batch(tp, torch_inputs(g), CFG, compute_dtype=torch.float32,
                                 k_used=K_USED)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4, rtol=0)


@pytest.fixture(scope="module")
def train_setup():
    jp, tp = params(3)
    jf = jax_make_train(JCFG, K_USED, compute_dtype=jnp.float32, interpret=True,
                        samples_per_block_fwd=2, samples_per_block_bwd=2)
    return jp, tp, jf, make_fused_train_forward(CFG, K_USED), make_inputs(seed=1)


ORDER = ["state", "action", "physics_param", "attrs", "p_instance", "neighbors", "nbr_mask"]


def _assert_grads(got, want):
    np.testing.assert_allclose(got, np.asarray(want), rtol=5e-4, atol=1e-6)


@pytest.mark.parametrize("physics", ["per_sample", "per_particle"])
def test_train_forward_value_and_grads_match_jax(train_setup, physics):
    jp, tp, jf, tf, g = train_setup
    g = dict(g)
    if physics == "per_particle":
        g["physics_param"] = np.random.RandomState(4).rand(B, CFG.max_nobj).astype(np.float32)
    target = (np.random.RandomState(7).randn(B, CFG.max_nobj, 3) * 0.3).astype(np.float32)
    ins = [jnp.asarray(g[k]) for k in ORDER]

    def jloss(p, s, a, ph, pi):
        return jnp.mean((jf(p, s, a, ph, ins[3], pi, ins[5], ins[6]) - target) ** 2)

    jl, jg = jax.value_and_grad(jloss, argnums=(0, 1, 2, 3, 4))(jp, ins[0], ins[1], ins[2], ins[4])
    tleaves = jax.tree_util.tree_leaves(tp)  # same sorted-key order as JAX's
    for t in tleaves:
        t.requires_grad_(True)
    ts = {k: torch.tensor(g[k]) for k in ORDER}
    diff = [ts[k].requires_grad_(True) for k in ("state", "action", "physics_param", "p_instance")]
    launches = fused_gnn_train.gnn_train_bwd.launches
    loss = torch.mean((tf(tp, *[ts[k] for k in ORDER]) - torch.tensor(target)) ** 2)
    grads = torch.autograd.grad(loss, tleaves + diff)
    assert fused_gnn_train.gnn_train_bwd.launches == launches
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5)
    for got, want in zip(grads[:len(tleaves)], jax.tree_util.tree_leaves(jg[0])):
        _assert_grads(got.numpy(), want)
    for got, want in zip(grads[len(tleaves):], jg[1:]):
        assert got.shape == want.shape
        _assert_grads(got.numpy(), want)


def test_train_forward_autoregressive_chain_matches_jax(train_setup):
    """Two steps, the second reading the first's prediction through the state
    history: d_state must carry the chain (rtol 1e-3, as the JAX test)."""
    jp, tp, jf, tf, g = train_setup
    n_p = CFG.max_nobj
    ins = [jnp.asarray(g[k]) for k in ORDER]

    def jtwo(p):
        s = ins[0]
        p1 = jf(p, s, *ins[1:])
        nxt = s[:, -1].at[:, :n_p].set(p1)
        p2 = jf(p, jnp.concatenate([s[:, 1:], nxt[:, None]], axis=1), *ins[1:])
        return jnp.mean(p2 ** 2) + jnp.mean(p1 ** 2)

    want = jax.tree_util.tree_leaves(jax.grad(jtwo)(jp))
    tleaves = jax.tree_util.tree_leaves(tp)
    for t in tleaves:
        t.requires_grad_(True)
    ts = [torch.tensor(g[k]) for k in ORDER]
    p1 = tf(tp, *ts)
    nxt = torch.cat([p1, ts[0][:, -1, n_p:]], dim=1)
    p2 = tf(tp, torch.cat([ts[0][:, 1:], nxt[:, None]], dim=1), *ts[1:])
    grads = torch.autograd.grad(torch.mean(p2 ** 2) + torch.mean(p1 ** 2), tleaves)
    for got, w in zip(grads, want):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), rtol=1e-3, atol=1e-6)


def test_backward_taps_record_the_forward_and_change_nothing():
    """``taps`` records every relu layer's pre-activation (one entry per
    round for the messages and the effect update), bounded by the sum of its
    absolute terms; the motion head applied to the last one gives the
    forward's motion; the gradients are those without ``taps``. On CPU
    tensors the training forward keeps no activations (its backward
    recomputes them)."""
    g = make_inputs(seed=3)
    ts = torch_inputs(g)
    weights = fused_gnn.weight_list(params(2)[1], CFG, torch.float32)
    nodes, nbr, mask, last, _ = fused_gnn.pack_inputs(
        CFG, ts["state"], ts["action"], ts["physics_param"], ts["attrs"], ts["p_instance"],
        ts["neighbors"], ts["nbr_mask"], K_USED, torch.float32)
    dmot = torch.tensor(np.random.RandomState(1).randn(B, nodes.shape[1], 3).astype(np.float32))
    taps = {}
    got = fused_gnn_train.gnn_train_bwd_plain(nodes, nbr, mask, dmot, weights, CFG, taps=taps)
    want = fused_gnn_train.gnn_train_bwd_plain(nodes, nbr, mask, dmot, weights, CFG)
    assert all(torch.equal(a, b) for a, b in zip([got[0]] + got[1], [want[0]] + want[1]))
    one = ["pe0", "pe1", "pe2", "re0", "re1", "re2", "nr0", "nr1"]
    assert {k: len(v) for k, v in taps.items()} == {**dict.fromkeys(one, 1), "msg": CFG.pstep,
                                                    "eff": CFG.pstep}
    for entries in taps.values():
        for z, terms, rows in entries:
            assert bool((z.abs() <= terms * (1 + 1e-5) + 1e-6).all())
            assert rows.dtype == torch.bool and rows.dim() == z.dim()
    pred, motion, acts = fused_gnn_train.train_forward(nodes, nbr, mask, last, weights, CFG)
    assert acts is None
    head = torch.relu(taps["nr1"][0][0][:, :CFG.max_nobj]) @ weights[22] + weights[23]
    np.testing.assert_allclose(head.numpy(), motion.numpy(), atol=1e-6, rtol=0)
