"""K optimizer steps per call on CPU tensors (plain versions of K2 and K3):
``make_train_steps`` / ``make_eval_steps`` against K calls of the one-step
functions (bit for bit, augmentation on), against the JAX
``make_train_steps`` (augmentation off; the tolerances of
``test_train_steps_match_jax``), and the training loop with superbatches of
2 against the loop without. On the card the same functions replay a CUDA
graph; ``chip_smoke.py``'s ``train_steps`` phase holds that to the loop."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from adaptigraph_tpu.dynamics import train as jax_train
from adaptigraph_tpu.models.gnn import GNNConfig as JaxGNNConfig
from adaptigraph_tpu.models.gnn import init_params as jax_init_params
from adaptigraph_tpu.ops.graph import EdgeConfig as JaxEdgeConfig
from adaptigraph_tpu_torch.dynamics import dataset, train
from adaptigraph_tpu_torch.dynamics.graphs import GraphSpec
from adaptigraph_tpu_torch.dynamics.preprocess import preprocess_episodes
from adaptigraph_tpu_torch.models.gnn import GNNConfig, init_params, params_from_numpy
from adaptigraph_tpu_torch.ops.graph import EdgeConfig
from adaptigraph_tpu_torch.sim.synthetic import SYNTH_EEF_OFFSETS, simulate_rope_dataset
from adaptigraph_tpu_torch.utils import checkpoint as ckpt

torch.set_num_threads(2)

NO, TOPK, K = 24, 6, 3
KW = dict(n_his=4, max_nobj=NO, max_neef=1, nf_particle=32, nf_relation=32, nf_effect=32, pstep=2)
JCFG, CFG = JaxGNNConfig(**KW), GNNConfig(**KW)
JECFG = JaxEdgeConfig(max_nobj=NO, max_neef=1, topk=TOPK)
ECFG = EdgeConfig(max_nobj=NO, max_neef=1, topk=TOPK)
SPEC = GraphSpec(n_his=4, n_future=3, max_nobj=NO, max_neef=1, fps_radius_range=(0.18, 0.22),
                 adj_radius_range=(0.48, 0.52), topk=TOPK)
PHYS_SPECS = [{"name": "stiffness", "use": True, "min": 0.0, "max": 1.0}]


@pytest.fixture(scope="module")
def prep_dir(tmp_path_factory):
    prep = str(tmp_path_factory.mktemp("torchsteps") / "prep")
    preprocess_episodes(simulate_rope_dataset(n_episodes=4, n_pushes=2, seed=2, n_particles=40),
                        prep, SYNTH_EEF_OFFSETS, 4, 3, 0.1, PHYS_SPECS)
    return prep


def _superbatch(prep_dir, B=4, seed=3):
    """K compact batches stacked on a leading axis, as ``BatchLoader(...,
    stack_steps=K)`` yields them (numpy)."""
    ds = dataset.PackedDataset(prep_dir, SPEC, "train", {"train": [0, 1], "valid": [0, 1]},
                               compact=True)
    rng = np.random.RandomState(seed)
    parts = [ds.make_batch(rng.randint(0, len(ds), size=B), rng) for _ in range(K)]
    return {k: np.stack([p[k] for p in parts]) for k in parts[0]}


def _leaves(seed=0):
    return [p.requires_grad_(True)
            for p in ckpt.tree_leaves(init_params(torch.Generator().manual_seed(seed), CFG))]


def _torch(batch):
    return {k: torch.tensor(v) for k, v in batch.items()}


def test_train_steps_equal_the_loop(prep_dir):
    """K steps per call (augmentation on) give the losses, the leaves and the
    Adam state (moments and the int32 count) of K one-step calls from the
    same weights, state and generator, bit for bit; so do the eval steps."""
    hyper = train.TrainHyper(n_future=3, phys_noise_train=0.05, phys_noise_valid=0.02,
                             state_noise_valid=0.01)
    sb = _torch(_superbatch(prep_dir))
    results = []
    for stacked in (True, False):
        leaves, gen = _leaves(), torch.Generator().manual_seed(7)
        state = train.adam_init(leaves)
        if stacked:
            losses = train.make_train_steps(CFG, ECFG, hyper)(leaves, state, sb, gen)
            evals = train.make_eval_steps(CFG, ECFG, hyper)(leaves, sb, gen)
        else:
            step = train.make_train_step(CFG, ECFG, hyper)
            evaluate = train.make_eval_step(CFG, ECFG, hyper)
            losses = torch.stack([step(leaves, state, {k: v[i] for k, v in sb.items()}, gen)
                                  for i in range(K)])
            evals = torch.stack([evaluate(leaves, {k: v[i] for k, v in sb.items()}, gen)
                                 for i in range(K)])
        results.append((losses, evals, leaves, state))
    (l1, e1, p1, s1), (l2, e2, p2, s2) = results
    assert l1.shape == e1.shape == (K,)
    assert torch.equal(l1, l2) and torch.equal(e1, e2)
    assert all(torch.equal(a, b) for a, b in zip(p1, p2))
    assert s1["count"].dtype == torch.int32 and int(s1["count"]) == int(s2["count"]) == K
    for name in ("mu", "nu"):
        assert all(torch.equal(a, b) for a, b in zip(s1[name], s2[name]))


@pytest.mark.parametrize("clip", [0.0, 0.05])
def test_train_steps_match_jax_train_steps(prep_dir, clip):
    """One call of K = 3 steps against the JAX ``make_train_steps`` (its
    Pallas kernels in interpret mode) on the same superbatch, augmentation
    off: losses at rtol 1e-5, parameters at atol 2e-6, the Adam count 3."""
    sb = _superbatch(prep_dir, seed=5)
    hyper_kw = dict(n_future=3, use_augmentation=False, grad_clip_norm=clip)
    jparams = jax.tree_util.tree_map(np.asarray, jax_init_params(jax.random.PRNGKey(1), JCFG))
    opt = (optax.chain(optax.clip_by_global_norm(clip), optax.adam(1e-3)) if clip
           else optax.adam(1e-3))
    jsteps = jax_train.make_train_steps(
        JCFG, JECFG, jax_train.TrainHyper(**hyper_kw), opt,
        fused_fn=jax_train.fused_train_fn(JCFG, JECFG, interpret=True))
    p = jax.tree_util.tree_map(jnp.array, jparams)
    p, o, jlosses = jsteps(p, opt.init(p), sb, jax.random.split(jax.random.PRNGKey(0), K))

    leaves = [t.requires_grad_(True) for t in ckpt.tree_leaves(params_from_numpy(jparams, "cpu"))]
    state = train.adam_init(leaves)
    losses = train.make_train_steps(CFG, ECFG, train.TrainHyper(**hyper_kw))(
        leaves, state, _torch(sb), None)
    np.testing.assert_allclose(losses.numpy(), np.asarray(jlosses), rtol=1e-5)
    for got, want in zip(leaves, jax.tree_util.tree_leaves(p)):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=2e-6, rtol=0)
    assert int(state["count"]) == K


def test_train_loop_stacked_writes_the_same_curves(prep_dir, tmp_path):
    """``train`` with loaders that stack 2 steps per call (run by
    ``make_train_steps`` / ``make_eval_steps``) writes the loss curves and
    the parameters of the same run one step per call, logging every step."""
    ratio = {"train": [0, 0.75], "valid": [0.75, 1]}
    hyper = train.TrainHyper(n_future=3, n_epochs=2, n_iters_train=4, n_iters_valid=2)
    outs = []
    for stack in (2, 1):
        tr = dataset.BatchLoader(dataset.PackedDataset(prep_dir, SPEC, "train", ratio,
                                                       compact=True), 4, stack_steps=stack)
        va = dataset.BatchLoader(dataset.PackedDataset(prep_dir, SPEC, "valid", ratio,
                                                       compact=True), 4, stack_steps=stack)
        out = str(tmp_path / f"stack{stack}")
        try:
            params, curves = train.train(CFG, ECFG, hyper, tr, va, out, device="cpu",
                                         log_every=1)
        finally:
            tr.close()
            va.close()
        outs.append((params, curves, out))
    (p2, c2, o2), (p1, c1, o1) = outs
    assert c2 == c1 and len(c1["train"]) == 2
    for a, b in zip(ckpt.tree_leaves(p2), ckpt.tree_leaves(p1)):
        assert torch.equal(a, b)
    with np.load(os.path.join(o2, "loss_curves.npz")) as z2, \
            np.load(os.path.join(o1, "loss_curves.npz")) as z1:
        assert all(np.array_equal(z2[k], z1[k]) for k in ("train", "valid"))
    assert ckpt.load_optimizer(o2)["count"] == ckpt.load_optimizer(o1)["count"] == 8
