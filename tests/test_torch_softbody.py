"""Softbody, the widest configuration the JAX package trains, through the
port on the CPU (the plain versions of K2 and K3) against the JAX package:
the newly copied dynamics configs give JAX's config objects; a train step
at a narrowed softbody shape (5-point pusher, pstep 4, n_his 5 with the rest
frame pinned, policy ``non_fixed``) equals JAX's ``make_train_step``; at
full width (N 305, nf 128) the loss and gradients equal JAX's on generated
data; and the rollout evaluator equals JAX's ``rollout_dataset``."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from adaptigraph_tpu import cli as jax_cli
from adaptigraph_tpu.dynamics import rollout as jax_rollout
from adaptigraph_tpu.dynamics import train as jax_train
from adaptigraph_tpu.dynamics.preprocess import preprocess as jax_preprocess
from adaptigraph_tpu.models.gnn import init_params as jax_init_params
from adaptigraph_tpu.utils.config import load_dynamics_config as jax_load_dynamics_config
from adaptigraph_tpu_torch import cli
from adaptigraph_tpu_torch.dynamics import dataset, rollout, train
from adaptigraph_tpu_torch.models.gnn import params_from_numpy
from adaptigraph_tpu_torch.sim.datagen import generate
from adaptigraph_tpu_torch.utils import checkpoint as ckpt
from adaptigraph_tpu_torch.utils.config import load_dynamics_config

torch.set_num_threads(2)


def _configs(max_nobj=None, **model):
    """The softbody dynamics config through both packages' loaders, with
    max_nobj and model widths narrowed where given."""
    out = []
    for load in (jax_load_dynamics_config, load_dynamics_config):
        config = load("softbody")
        if max_nobj:
            config["dataset_config"]["datasets"][0]["max_nobj"] = max_nobj
        config["model_config"].update(model)
        out.append(config)
    return out


def _objects(jconfig, config):
    jspec, jgnn, jedge, jhyper = jax_cli._dyn_objects(jconfig)
    gnn, edge = cli._dyn_objects(config)
    spec, hyper = cli._train_objects(config)
    return (jspec, jgnn, jedge, jhyper), (spec, gnn, edge, hyper)


@pytest.mark.parametrize("name", ["softbody", "multiobj", "bunnybath", "rope_f8", "granular_f6"])
def test_copied_dynamics_config_objects_match_jax(name):
    """The port's GraphSpec, GNNConfig, EdgeConfig and TrainHyper from its
    copy of the config equal JAX's from the original, field by field."""
    (jspec, jgnn, jedge, jhyper), (spec, gnn, edge, hyper) = _objects(
        jax_load_dynamics_config(name), load_dynamics_config(name))
    for want, got in ((jspec, spec), (jgnn, gnn), (jedge, edge), (jhyper, hyper)):
        assert dataclasses.asdict(got) == dataclasses.asdict(want), type(got).__name__
    assert gnn.n_nodes == jgnn.n_nodes and edge.K == jedge.K


@pytest.fixture(scope="module")
def softbody_data(tmp_path_factory):
    """Two generated softbody episodes of two pushes (the port's generator),
    preprocessed by the JAX package with the softbody config's eef offsets,
    history, rest frame and physics parameters."""
    root = tmp_path_factory.mktemp("softbody")
    generate(str(root / "sim"), "softbody", 2, n_pushes=2, seed=0)
    dc = load_dynamics_config("softbody")["dataset_config"]
    config = load_dynamics_config("softbody")
    jax_preprocess(str(root / "sim"), str(root / "prep"), np.asarray(dc["eef"]["pos"], np.float32),
                   dc["n_his"], dc["n_future"], dc["dist_thresh"], cli._phys_specs(config),
                   store_rest_state=dc["store_rest_state"])
    return str(root / "prep")


ALL = {"train": [0, 1], "valid": [0, 1]}


def _batches(prep, spec, n, B, seed=3):
    ds = dataset.PackedDataset(prep, spec, "train", ALL, compact=True)
    rng = np.random.RandomState(seed)
    return [ds.make_batch(rng.randint(0, len(ds), size=B), rng) for _ in range(n)]


def _torch(batch):
    return {k: torch.tensor(v) for k, v in batch.items()}


def test_softbody_train_steps_match_jax(softbody_data):
    """Two optimizer steps at a narrowed softbody shape (nf 16, pstep 4,
    n_his 5, a 5-point pusher, 40 objects, ``non_fixed`` with a per-sample
    knn fraction, the rest frame pinned in the history), augmentation off,
    through the port's plain K2/K3 and JAX's ``make_train_step``: losses at
    rtol 1e-5, parameters after each step at atol 2e-6 (the tolerances of
    tests/test_torch_train.py)."""
    jconfig, config = _configs(max_nobj=40, nf_particle=16, nf_relation=16, nf_effect=16)
    (jspec, jgnn, jedge, _), (spec, gnn, edge, hyper) = _objects(jconfig, config)
    assert (gnn.pstep, gnn.n_his, gnn.max_neef, edge.policy, spec.store_rest_state) == (
        4, 5, 5, "non_fixed", True)
    batches = _batches(softbody_data, spec, 2, B=4)
    assert any(0.0 < k < 1.0 for b in batches for k in b["knn_frac"])
    hyper_kw = dict(n_future=3, use_augmentation=False, store_rest_state=True)
    jparams = jax.tree_util.tree_map(np.asarray, jax_init_params(jax.random.PRNGKey(0), jgnn))
    opt = optax.adam(1e-3)
    jstep = jax_train.make_train_step(jgnn, jedge, jax_train.TrainHyper(**hyper_kw), opt)
    p = jax.tree_util.tree_map(jnp.array, jparams)
    o = opt.init(p)
    leaves = [t.requires_grad_(True) for t in ckpt.tree_leaves(params_from_numpy(jparams, "cpu"))]
    state = train.adam_init(leaves)
    step = train.make_train_step(gnn, edge, train.TrainHyper(**hyper_kw))
    for batch in batches:
        p, o, jloss = jstep(p, o, batch, jax.random.PRNGKey(0))
        loss = step(leaves, state, _torch(batch), None)
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
        for got, want in zip(leaves, jax.tree_util.tree_leaves(p)):
            np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=2e-6, rtol=0)


def test_full_width_loss_and_grads_match_jax(softbody_data):
    """The published width (N 305 = 300 objects + 5 pusher points, nf 128,
    pstep 4, 15 slots) at B 2 on generated data: the multi-step loss through
    the port's plain K2/K3 and its gradients by autograd (K3's plain version)
    against JAX's ``multi_step_loss`` (XLA forward) and ``jax.grad``: the
    loss at rtol 1e-5, each gradient within 5e-4 of its norm (the rtol of
    tests/test_fused_train.py:86, taken on the norm as the card's K3 gate
    takes it: at this width a relu unit whose input lies within float32
    rounding of 0 falls on the other side in the port's plain forward than
    in JAX's and in float64, which moves that unit's weight-gradient column
    and, through it, every earlier layer's gradient by ~2e-5 of its norm)."""
    jconfig, config = _configs()
    (jspec, jgnn, jedge, _), (spec, gnn, edge, hyper) = _objects(jconfig, config)
    assert (gnn.n_nodes, gnn.nf_particle, edge.topk + edge.max_neef) == (305, 128, 15)
    batch = _batches(softbody_data, spec, 1, B=2, seed=5)[0]
    jparams = jax.tree_util.tree_map(np.asarray, jax_init_params(jax.random.PRNGKey(1), jgnn))
    jbatch = jax_train.expand_compact_batch({k: jnp.asarray(v) for k, v in batch.items()}, jgnn)

    def jloss_fn(params):
        return jax_train.multi_step_loss(params, jbatch, jgnn, jedge, 3, True)

    jloss, jgrads = jax.value_and_grad(jloss_fn)(jax.tree_util.tree_map(jnp.asarray, jparams))
    leaves = [t.requires_grad_(True) for t in ckpt.tree_leaves(params_from_numpy(jparams, "cpu"))]
    tbatch = train.expand_compact_batch(_torch(batch), gnn)
    assert float((tbatch["obj_mask"].sum(1))[0]) == 300  # every object slot filled
    loss = train.multi_step_loss(ckpt.tree_from_leaves(leaves), tbatch, gnn, edge, 3, True,
                                 train.fused_train_fn(gnn, edge))
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    for got, want in zip(grads, jax.tree_util.tree_leaves(jgrads)):
        want = np.asarray(want, np.float64)
        assert np.linalg.norm(got.numpy() - want) <= 5e-4 * np.linalg.norm(want)


def test_softbody_rollout_matches_jax(softbody_data, tmp_path):
    """The rollout evaluator at a narrowed softbody shape (40 objects, nf 16,
    pstep 4, n_his 5, 5-point pusher, ``non_fixed``) over the tiny prep dir:
    per-push error curves and their median within rtol 1e-4 / atol 1e-5 of
    JAX's ``rollout_dataset`` (which, like the port, keeps no rest frame in
    the evaluator's history)."""
    jconfig, config = _configs(max_nobj=40, nf_particle=16, nf_relation=16, nf_effect=16)
    (jspec, jgnn, jedge, _), (spec, gnn, edge, _) = _objects(jconfig, config)
    jparams = jax.tree_util.tree_map(np.asarray, jax_init_params(jax.random.PRNGKey(2), jgnn))
    kw = dict(phase_ratio=(0.0, 1.0), dist_thresh=0.1, max_steps=8)
    want = jax_rollout.rollout_dataset(jparams, jspec, jgnn, jedge, softbody_data, **kw)
    got = rollout.rollout_dataset(params_from_numpy(jparams, "cpu"), spec, gnn, edge,
                                  softbody_data, **kw)
    assert len(got["per_push"]) == len(want["per_push"]) == 4
    np.testing.assert_allclose(got["median"], want["median"], rtol=1e-4, atol=1e-5)
    for a, b in zip(got["per_push"], want["per_push"]):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)


def test_plain_backward_takes_given_relu_decisions(softbody_data):
    """``gnn_train_bwd_plain(decisions=...)`` at full width (B 2): given its
    own relu decisions it returns its own result bit for bit; float64 given
    float32's decisions lies within 1e-5 of the norm of float32's result;
    and a decision turned over moves the gradients."""
    from adaptigraph_tpu_torch.models.gnn import init_params
    from adaptigraph_tpu_torch.ops.fused_gnn import pack_inputs, weight_list
    from adaptigraph_tpu_torch.ops.fused_gnn_train import gnn_train_bwd_plain
    from adaptigraph_tpu_torch.ops.graph import build_neighbor_graph_batch

    _, config = _configs()
    gnn, edge = cli._dyn_objects(config)
    spec, _ = cli._train_objects(config)
    b = train.expand_compact_batch(_torch(_batches(softbody_data, spec, 1, B=2, seed=6)[0]), gnn)
    nbrs, nmask = build_neighbor_graph_batch(b["state"][:, -1], b["state_mask"], b["eef_mask"],
                                             b["adj_thresh"], edge, b["knn_frac"])
    params = init_params(torch.Generator().manual_seed(0), gnn)
    nodes, nbr, msk, _, _ = pack_inputs(gnn, b["state"], b["action"], b["physics_param"],
                                        b["attrs"], b["p_instance"], nbrs, nmask,
                                        edge.topk + edge.max_neef, torch.float32)
    w = weight_list(params, gnn, torch.float32)
    dmot = torch.randn(2, nodes.shape[1], 3, generator=torch.Generator().manual_seed(1)) * 1e-2
    dmot[:, gnn.max_nobj:] = 0
    taps = {}
    a = gnn_train_bwd_plain(nodes, nbr, msk, dmot, w, gnn, taps=taps)
    dec = {name: [z > 0 for z, _, _ in entries] for name, entries in taps.items()}
    same = gnn_train_bwd_plain(nodes, nbr, msk, dmot, w, gnn, decisions=dec)
    for x, y in zip([a[0]] + a[1], [same[0]] + same[1]):
        assert torch.equal(x, y)
    x64 = gnn_train_bwd_plain(nodes.double(), nbr, msk, dmot.double(), [t.double() for t in w],
                              gnn, decisions=dec)
    for x, y in zip([a[0]] + a[1], [x64[0]] + x64[1]):
        assert float((x.double() - y).norm()) <= 1e-5 * float(y.norm())
    dec["msg"][0] = ~dec["msg"][0]
    moved = gnn_train_bwd_plain(nodes, nbr, msk, dmot, w, gnn, decisions=dec)
    assert not torch.equal(moved[1][12], a[1][12])  # the message layer's weight gradient
