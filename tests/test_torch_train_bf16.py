"""bfloat16 training on CPU tensors (the plain versions of K2 and K3) against
the JAX package's bf16 kernels in interpret mode, at a small width (20
objects, topk 6, nf 32, pstep 2, B 4):

- the plain bf16 backward against ``_bwd_pallas(compute_dtype=bfloat16)``:
  the node cotangents and each of the 24 weight gradients within 2e-2 of
  their norm, and no farther from the float32 backward than 1.25 times the
  JAX kernel is; and, since both round to bf16 at the same points and only
  the order of the float32 sums differs, within 1e-5 of the norm here;
- ``make_fused_train_forward(bfloat16)``'s value and gradients against
  ``jax.value_and_grad`` of the JAX bf16 one;
- one ``make_train_step(fused_fn=fused_train_fn(bfloat16))`` step against the
  JAX ``make_train_step`` with its bf16 ``fused_train_fn`` and optax Adam.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from adaptigraph_tpu.dynamics import train as jax_train
from adaptigraph_tpu.models.gnn import GNNConfig as JaxGNNConfig
from adaptigraph_tpu.models.gnn import init_params
from adaptigraph_tpu.ops.fused_gnn_train import _bwd_pallas, _pack_inputs
from adaptigraph_tpu.ops.fused_gnn_train import make_fused_train_forward as jax_make_train
from adaptigraph_tpu.ops.graph import EdgeConfig as JaxEdgeConfig
from adaptigraph_tpu.ops.graph import build_neighbor_graph_batch
from adaptigraph_tpu_torch.dynamics import train
from adaptigraph_tpu_torch.models.gnn import GNNConfig, params_from_numpy
from adaptigraph_tpu_torch.ops import fused_gnn, fused_gnn_train
from adaptigraph_tpu_torch.ops.graph import EdgeConfig
from adaptigraph_tpu_torch.utils import checkpoint as ckpt

torch.set_num_threads(2)

NO, TOPK, B = 20, 6, 4
KW = dict(n_his=4, max_nobj=NO, max_neef=1, nf_particle=32, nf_relation=32, nf_effect=32, pstep=2)
JCFG, CFG = JaxGNNConfig(**KW), GNNConfig(**KW)
JECFG, ECFG = (JaxEdgeConfig(max_nobj=NO, max_neef=1, topk=TOPK),
               EdgeConfig(max_nobj=NO, max_neef=1, topk=TOPK))
K_USED = TOPK + 1
ORDER = ["state", "action", "physics_param", "attrs", "p_instance", "neighbors", "nbr_mask"]


def make_inputs(seed=0):
    """A rope-like batch (some object slots invalid, zero), edges built by
    the JAX graph builder, future frames and eef rows for a train step."""
    rng = np.random.RandomState(seed)
    N = CFG.n_nodes
    counts = np.array([NO, NO - 5, 9, 14])
    valid = np.arange(NO)[None] < counts[:, None]
    state = (rng.randn(B, CFG.n_his, N, 3) * 0.3).astype(np.float32)
    state[:, :, :NO] *= valid[:, None, :, None]
    node_mask = np.concatenate([valid, np.ones((B, 1), bool)], axis=1)
    tool_mask = np.zeros((B, N), bool)
    tool_mask[:, NO] = True
    nbrs, mask = build_neighbor_graph_batch(jnp.asarray(state[:, -1]), jnp.asarray(node_mask),
                                            jnp.asarray(tool_mask), jnp.asarray(0.6), JECFG)
    attrs = np.zeros((B, N, 2), np.float32)
    attrs[:, :NO, 0] = valid
    attrs[:, NO:, 1] = 1.0
    return {"state": state, "action": (rng.randn(B, N, 3) * 0.05).astype(np.float32),
            "physics_param": rng.rand(B, 1).astype(np.float32), "attrs": attrs,
            "p_instance": valid[..., None].astype(np.float32), "neighbors": np.asarray(nbrs),
            "nbr_mask": np.asarray(mask), "node_mask": node_mask, "tool_mask": tool_mask}


def params(seed=0):
    p = jax.tree_util.tree_map(np.asarray, init_params(jax.random.PRNGKey(seed), JCFG))
    return p, params_from_numpy(p, "cpu")


def rel(a, b):
    a, b = np.asarray(a, np.float64).ravel(), np.asarray(b, np.float64).ravel()
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def test_plain_bf16_backward_matches_jax_kernel():
    g = make_inputs(0)
    jp, tp = params(0)
    ins = [jnp.asarray(g[k]) for k in ORDER]
    jnodes, jnbr, jmask = _pack_inputs(JCFG, *ins, K_USED, jnp.bfloat16)
    Np = jnodes.shape[1]
    dmot = np.random.RandomState(1).randn(B, Np, 3).astype(np.float32) * 0.1
    dmot[:, NO:] = 0
    jd, jgrads = _bwd_pallas(jp, jnodes, jnbr, jmask, jnp.asarray(dmot), JCFG, K_USED,
                             compute_dtype=jnp.bfloat16, samples_per_block=2, interpret=True)
    want = [np.asarray(jd)] + [np.asarray(x) for x in jgrads]

    nodes = torch.tensor(np.asarray(jnodes, np.float32)).to(torch.bfloat16)
    nbr = torch.tensor(np.asarray(jnbr)).reshape(B, -1).to(torch.int32)
    msk = torch.tensor(np.asarray(jmask, np.float32)).reshape(B, -1)
    ts = {k: torch.tensor(g[k]) for k in ORDER}
    ours_nodes = fused_gnn.pack_inputs(CFG, *[ts[k] for k in ORDER], K_USED, torch.bfloat16)[0]
    assert torch.equal(ours_nodes, nodes)  # the port packs as JAX does
    bf16 = torch.bfloat16
    d, grads = fused_gnn_train.gnn_train_bwd_plain(
        nodes, nbr, msk, torch.tensor(dmot), fused_gnn.weight_list(tp, CFG, bf16), CFG,
        compute_dtype=bf16)
    got = [d.numpy()] + [x.numpy() for x in grads]
    # the float32 backward on the float32 packing and weights
    d32, g32 = fused_gnn_train.gnn_train_bwd_plain(
        fused_gnn.pack_inputs(CFG, *[ts[k] for k in ORDER], K_USED, torch.float32)[0], nbr, msk,
        torch.tensor(dmot), fused_gnn.weight_list(tp, CFG, torch.float32), CFG)
    ref = [d32.numpy()] + [x.numpy() for x in g32]
    for i, (a, b, r) in enumerate(zip(got, want, ref)):
        assert a.size == b.size
        assert rel(a, b) <= 2e-2, (i, rel(a, b))
        assert rel(a, r) <= 1.25 * rel(b, r) + 1e-7, (i, rel(a, r), rel(b, r))
        # the same rounding points: only the order of float32 sums differs, which
        # here moves no bf16 rounding far (a missed or extra rounding moves ~1e-3)
        assert rel(a, b) <= 1e-5, (i, rel(a, b))
    # bf16 rounds: the two modes differ
    assert rel(got[1], ref[1]) > 1e-5


@pytest.fixture(scope="module")
def train_setup():
    jp, tp = params(3)
    jf = jax_make_train(JCFG, K_USED, compute_dtype=jnp.bfloat16, interpret=True,
                        samples_per_block_fwd=2, samples_per_block_bwd=2)
    tf = fused_gnn_train.make_fused_train_forward(CFG, K_USED, torch.bfloat16)
    return jp, tp, jf, tf, make_inputs(seed=1)


def test_bf16_train_forward_value_and_grads_match_jax(train_setup):
    jp, tp, jf, tf, g = train_setup
    target = (np.random.RandomState(7).randn(B, NO, 3) * 0.3).astype(np.float32)
    ins = [jnp.asarray(g[k]) for k in ORDER]

    def jloss(p, s, a, ph, pi):
        return jnp.mean((jf(p, s, a, ph, ins[3], pi, ins[5], ins[6]) - target) ** 2)

    jl, jg = jax.value_and_grad(jloss, argnums=(0, 1, 2, 3, 4))(jp, ins[0], ins[1], ins[2], ins[4])
    tleaves = jax.tree_util.tree_leaves(tp)
    for t in tleaves:
        t.requires_grad_(True)
    ts = {k: torch.tensor(g[k]) for k in ORDER}
    diff = [ts[k].requires_grad_(True) for k in ("state", "action", "physics_param", "p_instance")]
    launches = fused_gnn_train.gnn_train_bwd.launches
    loss = torch.mean((tf(tp, *[ts[k] for k in ORDER]) - torch.tensor(target)) ** 2)
    grads = torch.autograd.grad(loss, tleaves + diff)
    assert fused_gnn_train.gnn_train_bwd.launches == launches  # CPU tensors: the plain version
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-2)
    want = jax.tree_util.tree_leaves(jg[0]) + list(jg[1:])
    for got, w in zip(grads, want):
        assert got.dtype == torch.float32 and got.shape == w.shape
        assert rel(got.numpy(), w) <= 2e-2


def test_bf16_train_step_matches_jax():
    """One optimizer step, augmentation off: loss within 1e-2 relative, the
    updated parameters within 2e-2 of the norm of the JAX update."""
    g = make_inputs(seed=2)
    rng = np.random.RandomState(4)
    N, n_f = CFG.n_nodes, 3
    batch = {k: g[k] for k in ("state", "action", "physics_param", "attrs", "p_instance")}
    eef = np.zeros((B, n_f, N, 3), np.float32)
    eef[:, :, NO:] = g["state"][:, -1:, NO:] + np.arange(1, n_f + 1)[None, :, None, None] * 0.02
    batch.update(
        state_future=(g["state"][:, -1:, :NO] + rng.randn(B, n_f, NO, 3) * 0.02).astype(np.float32),
        eef_future=eef, action_future=np.repeat(g["action"][:, None], n_f, axis=1),
        state_mask=g["node_mask"], eef_mask=g["tool_mask"],
        adj_thresh=np.full(B, 0.6, np.float32), knn_frac=np.ones(B, np.float32))
    hyper_kw = dict(n_future=n_f, use_augmentation=False)
    jparams, tp = params(5)
    opt = optax.adam(1e-3)
    jstep = jax_train.make_train_step(
        JCFG, JECFG, jax_train.TrainHyper(**hyper_kw), opt,
        fused_fn=jax_train.fused_train_fn(JCFG, JECFG, compute_dtype=jnp.bfloat16, interpret=True))
    p0 = jax.tree_util.tree_map(jnp.array, jparams)
    p1, _, jloss = jstep(p0, opt.init(p0), {k: jnp.asarray(v) for k, v in batch.items()},
                         jax.random.PRNGKey(0))

    leaves = [t.requires_grad_(True) for t in ckpt.tree_leaves(tp)]
    start = [t.detach().clone() for t in leaves]
    state = train.adam_init(leaves)
    step = train.make_train_step(CFG, ECFG, train.TrainHyper(**hyper_kw),
                                 fused_fn=train.fused_train_fn(CFG, ECFG, torch.bfloat16))
    loss = step(leaves, state, {k: torch.tensor(v) for k, v in batch.items()}, None)
    assert loss.dtype == torch.float32
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-2)
    for got, want, p in zip(leaves, jax.tree_util.tree_leaves(p1), start):
        assert got.dtype == torch.float32
        update = np.asarray(want) - p.numpy()
        err = np.linalg.norm(got.detach().numpy() - np.asarray(want))
        assert err <= 2e-2 * np.linalg.norm(update), (got.shape, err, np.linalg.norm(update))
