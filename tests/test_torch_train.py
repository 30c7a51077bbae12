"""The port's trainer on CPU tensors (plain versions of K2 and K3) against the
JAX trainer: the augmentation with the JAX random draws passed in, whole
optimizer steps (loss and updated parameters, with and without the
global-norm clip), parameter init, checkpoints that JAX ``load_checkpoint``
reads, and the epoch loop with ``resume``."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from adaptigraph_tpu.dynamics import train as jax_train
from adaptigraph_tpu.models.gnn import GNNConfig as JaxGNNConfig
from adaptigraph_tpu.models.gnn import forward_batch as jax_forward_batch
from adaptigraph_tpu.models.gnn import init_params as jax_init_params
from adaptigraph_tpu.ops.graph import EdgeConfig as JaxEdgeConfig
from adaptigraph_tpu.utils.checkpoint import load_checkpoint as jax_load_checkpoint
from adaptigraph_tpu_torch.dynamics import dataset, train
from adaptigraph_tpu_torch.dynamics.graphs import GraphSpec
from adaptigraph_tpu_torch.dynamics.preprocess import preprocess_episodes
from adaptigraph_tpu_torch.models.gnn import (GNNConfig, forward_batch, init_params,
                                              params_from_numpy, params_to_numpy)
from adaptigraph_tpu_torch.ops.graph import EdgeConfig
from adaptigraph_tpu_torch.sim.synthetic import SYNTH_EEF_OFFSETS, simulate_rope_dataset
from adaptigraph_tpu_torch.utils import checkpoint as ckpt

torch.set_num_threads(2)

NO, TOPK = 24, 6
KW = dict(n_his=4, max_nobj=NO, max_neef=1, nf_particle=32, nf_relation=32, nf_effect=32, pstep=2)
JCFG, CFG = JaxGNNConfig(**KW), GNNConfig(**KW)
JECFG, ECFG = JaxEdgeConfig(max_nobj=NO, max_neef=1, topk=TOPK), EdgeConfig(max_nobj=NO, max_neef=1,
                                                                             topk=TOPK)
SPEC = GraphSpec(n_his=4, n_future=3, max_nobj=NO, max_neef=1, fps_radius_range=(0.18, 0.22),
                 adj_radius_range=(0.48, 0.52), topk=TOPK)
PHYS_SPECS = [{"name": "stiffness", "use": True, "min": 0.0, "max": 1.0}]


@pytest.fixture(scope="module")
def prep_dir(tmp_path_factory):
    prep = str(tmp_path_factory.mktemp("torchtrain") / "prep")
    preprocess_episodes(simulate_rope_dataset(n_episodes=4, n_pushes=2, seed=1, n_particles=40),
                        prep, SYNTH_EEF_OFFSETS, 4, 3, 0.1, PHYS_SPECS)
    return prep


def _batches(prep_dir, n, B=4, compact=True):
    ds = dataset.PackedDataset(prep_dir, SPEC, "train", {"train": [0, 1], "valid": [0, 1]},
                               compact=compact)
    rng = np.random.RandomState(3)
    return [ds.make_batch(rng.randint(0, len(ds), size=B), rng) for _ in range(n)]


def _torch(batch):
    return {k: torch.tensor(v) for k, v in batch.items()}


def test_augment_matches_jax_with_its_draws(prep_dir):
    batch = _batches(prep_dir, 1, compact=False)[0]
    key, sn, pn = jax.random.PRNGKey(5), 0.05, 0.1
    want = jax_train._augment(batch, key, sn, pn, True)
    kn, kr, kp = jax.random.split(key, 3)
    draws = {"noise": jax.random.uniform(kn, batch["state"].shape, minval=-sn, maxval=sn),
             "theta": jax.random.uniform(kr, (4,), minval=-np.pi, maxval=np.pi),
             "phys_noise": jax.random.uniform(kp, batch["physics_param"].shape, minval=-pn,
                                              maxval=pn)}
    got = train.augment(_torch(batch), **{k: torch.tensor(np.asarray(v)) for k, v in draws.items()})
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=1e-6, rtol=0,
                                   err_msg=k)
    # the port's own draws: the shapes and ranges of the JAX ones
    gen = torch.Generator().manual_seed(0)
    mine = train.draw_augment(_torch(batch), gen, sn, pn)
    for k, v in draws.items():
        assert mine[k].shape == v.shape
        assert float(mine[k].abs().max()) <= float(np.abs(np.asarray(v)).max()) * 1.5 + 1e-6


@pytest.mark.parametrize("clip", [0.0, 0.05])
def test_train_steps_match_jax(prep_dir, clip):
    """Two optimizer steps from the same weights on the same batches,
    augmentation off: losses at rtol 1e-5, parameters after each step at
    atol 2e-6 (an Adam step moves each weight by ~lr = 1e-3)."""
    batches = _batches(prep_dir, 2)
    hyper_kw = dict(n_future=3, use_augmentation=False, grad_clip_norm=clip)
    jparams = jax.tree_util.tree_map(np.asarray, jax_init_params(jax.random.PRNGKey(0), JCFG))
    opt = (optax.chain(optax.clip_by_global_norm(clip), optax.adam(1e-3)) if clip
           else optax.adam(1e-3))
    jstep = jax_train.make_train_step(JCFG, JECFG, jax_train.TrainHyper(**hyper_kw), opt,
                                      fused_fn=jax_train.fused_train_fn(JCFG, JECFG, interpret=True))
    p = jax.tree_util.tree_map(jnp.array, jparams)
    o = opt.init(p)

    leaves = [t.requires_grad_(True) for t in ckpt.tree_leaves(params_from_numpy(jparams, "cpu"))]
    state = train.adam_init(leaves)
    step = train.make_train_step(CFG, ECFG, train.TrainHyper(**hyper_kw))
    for batch in batches:
        p, o, jloss = jstep(p, o, batch, jax.random.PRNGKey(0))
        loss = step(leaves, state, _torch(batch), None)
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
        for got, want in zip(leaves, jax.tree_util.tree_leaves(p)):
            np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=2e-6, rtol=0)
    assert state["count"] == 2


def test_init_params_shapes_and_scale():
    want = jax.tree_util.tree_map(np.asarray, jax_init_params(jax.random.PRNGKey(0), JCFG))
    got = params_to_numpy(init_params(torch.Generator().manual_seed(0), CFG))
    for g, w, shape in zip(ckpt.tree_leaves(got), ckpt.tree_leaves(want), ckpt.param_shapes(CFG)):
        assert g.shape == w.shape == shape and g.dtype == np.float32
        fan_in = shape[0] if len(shape) == 2 else None
        if fan_in:
            assert np.abs(g).max() <= 1 / np.sqrt(fan_in)
            assert np.abs(g).max() > 0.8 / np.sqrt(fan_in)


def test_checkpoint_is_read_by_jax(tmp_path):
    """A checkpoint written by the port loads with JAX ``load_checkpoint``
    (at the JAX cadence: model_10 after epoch 9), and the JAX forward of the
    loaded weights equals the port's forward of its own."""
    params = init_params(torch.Generator().manual_seed(4), CFG)
    out = str(tmp_path)
    leaves = ckpt.tree_leaves(params)
    opt = {"count": 3, "mu": [np.full(t.shape, 0.5, np.float32) for t in leaves],
           "nu": [np.full(t.shape, 0.25, np.float32) for t in leaves]}
    ckpt.save_checkpoint(out, 9, params_to_numpy(params), opt)
    assert os.path.exists(ckpt.checkpoint_name(out, 10))
    jp = jax_load_checkpoint(out)
    again = ckpt.load_optimizer(out)
    assert again["count"] == 3 and np.all(again["nu"][5] == 0.25)

    rng = np.random.RandomState(0)
    B, N = 3, CFG.n_nodes
    state = (rng.randn(B, 4, N, 3) * 0.3).astype(np.float32)
    nbrs = rng.randint(0, N, (B, N, 8)).astype(np.int32)
    g = {"state": state, "attrs": np.tile(np.eye(2, dtype=np.float32)[[0] * NO + [1]], (B, 1, 1)),
         "neighbors": nbrs, "nbr_mask": rng.rand(B, N, 8) > 0.3,
         "action": (rng.randn(B, N, 3) * 0.05).astype(np.float32),
         "p_instance": np.ones((B, NO, 1), np.float32),
         "physics_param": rng.rand(B, 1).astype(np.float32)}
    want, _ = jax_forward_batch(jp, {k: jnp.asarray(v) for k, v in g.items()}, JCFG)
    got, _ = forward_batch(params, _torch(g), CFG)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=0)


def test_train_loop_writes_and_resumes(prep_dir, tmp_path):
    spec_ratio = {"train": [0, 0.75], "valid": [0.75, 1]}

    def loaders():
        tr = dataset.BatchLoader(dataset.PackedDataset(prep_dir, SPEC, "train", spec_ratio,
                                                       compact=True), 4, stack_steps=2)
        va = dataset.BatchLoader(dataset.PackedDataset(prep_dir, SPEC, "valid", spec_ratio,
                                                       compact=True), 4)
        return tr, va

    hyper = train.TrainHyper(n_future=3, n_epochs=2, n_iters_train=4, n_iters_valid=2)
    out = str(tmp_path)
    tr, va = loaders()
    try:
        params, curves = train.train(CFG, ECFG, hyper, tr, va, out, device="cpu", log_every=2)
    finally:
        tr.close()
        va.close()
    assert len(curves["train"]) == 2 and np.all(np.isfinite(curves["valid"]))
    assert ckpt.load_optimizer(out)["count"] == 8
    saved = ckpt.load_checkpoint(out, cfg=CFG)
    for a, b in zip(ckpt.tree_leaves(saved), ckpt.tree_leaves(params_to_numpy(params))):
        np.testing.assert_array_equal(a, b)

    tr, va = loaders()
    try:
        train.train(CFG, ECFG, train.TrainHyper(n_future=3, n_epochs=1, n_iters_train=2,
                                                 n_iters_valid=1), tr, va, out, device="cpu",
                    resume=True)
    finally:
        tr.close()
        va.close()
    assert ckpt.load_optimizer(out)["count"] == 10
    with open(os.path.join(out, "metrics.jsonl")) as f:
        steps = [line for line in f if '"epoch"' in line]
    assert len(steps) == 3 and '"step": 2' in steps[-1]
