"""The port's whole-push rollout (``fused_rollout_chunk`` on CPU tensors, i.e.
the kernel's plain version) against the JAX rollout kernel in interpret mode
and against the JAX per-substep XLA path; the cases of tests/test_fused.py."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adaptigraph_tpu.models.gnn import GNNConfig as JaxGNNConfig
from adaptigraph_tpu.models.gnn import init_params
from adaptigraph_tpu.ops.fused_gnn import fused_rollout_chunk as jax_chunk
from adaptigraph_tpu.ops.graph import EdgeConfig as JaxEdgeConfig
from adaptigraph_tpu.planning import forward as jax_forward
from adaptigraph_tpu_torch.models.gnn import GNNConfig, params_from_numpy
from adaptigraph_tpu_torch.ops.fused_gnn import fused_rollout_chunk
from adaptigraph_tpu_torch.ops.graph import EdgeConfig
from adaptigraph_tpu_torch.planning import forward

torch.set_num_threads(2)


def _configs(n_eef, **dyn):
    kw = dict(n_his=4, max_nobj=24, max_neef=n_eef, nf_particle=32, nf_relation=32,
              nf_effect=32, pstep=2)
    ekw = dict(max_nobj=24, max_neef=n_eef, topk=6)
    dkw = dict(n_his=4, push_length=0.1, sim_real_ratio=10.0, max_repeat=8, adj_thresh=0.6, **dyn)
    jd = jax_forward.DynamicsConfig(gnn=JaxGNNConfig(**kw), edge=JaxEdgeConfig(**ekw), **dkw)
    td = forward.DynamicsConfig(gnn=GNNConfig(**kw), edge=EdgeConfig(**ekw), **dkw)
    return jd, td


def _params(jd, seed):
    p = jax.tree_util.tree_map(np.asarray, init_params(jax.random.PRNGKey(seed), jd.gnn))
    return p, params_from_numpy(p, "cpu")


def _actions(rng, B, L):
    return np.stack([rng.uniform(-1, 0, (B, L)), rng.uniform(-1, 1, (B, L)),
                     rng.uniform(-np.pi, np.pi, (B, L)), rng.uniform(2, 8, (B, L))],
                    axis=-1).astype(np.float32)


def _jax_chunks(jp, state, acts, phys, jd, cd):
    """Drive the JAX kernel (interpret mode) the way forward.py's whole-chunk path does."""
    B, L = acts.shape[:2]
    decoded, repeat = jax_forward.decode_action(jnp.asarray(acts), jd.push_length)
    obj = jnp.broadcast_to(jnp.asarray(state)[None], (B, jd.gnn.max_nobj, 3))
    outs = []
    for li in range(L):
        kp, delta = jax.vmap(lambda d, th, yy: jax_forward._pusher_keypoints(jd, d, th, yy))(
            decoded[:, li], jnp.asarray(acts[:, li, 2]), jnp.min(obj[..., 1], axis=1))
        obj = jax_chunk(jp, obj, kp, delta, repeat[:, li], jnp.asarray(phys), jd.gnn,
                        adj_radius=jd.adj_thresh, edge_topk=jd.edge.topk,
                        max_repeat=jd.max_repeat,
                        gripper_lift=0.01 * jd.sim_real_ratio if jd.gripper_enable else 0.0,
                        compute_dtype=cd, samples_per_block=2, interpret=True)
        outs.append(obj)
    return np.asarray(jnp.stack(outs, axis=1))


@pytest.mark.parametrize("case", ["point_pusher", "board_gripper"])
def test_rollout_matches_jax(case):
    if case == "point_pusher":
        jd, td = _configs(1)
        B, L, seed, phys = 8, 2, 0, np.asarray([0.5], np.float32)
    else:
        jd, td = _configs(5, pusher_offsets=(-0.05, -0.025, 0.0, 0.025, 0.05),
                          gripper_enable=True)
        B, L, seed, phys = 4, 1, 1, np.asarray([0.3], np.float32)
    jp, tp = _params(jd, seed)
    rng = np.random.RandomState(seed)
    state = (rng.randn(24, 3) * 0.4).astype(np.float32)
    acts = _actions(rng, B, L)
    launches = fused_rollout_chunk.launches
    got = forward.dynamics_rollout_batched(tp, torch.tensor(state), torch.tensor(acts),
                                           torch.tensor(phys), td,
                                           compute_dtype=torch.float32)["state_seqs"].numpy()
    assert fused_rollout_chunk.launches == launches  # CPU tensors take the plain version
    want_xla = jax_forward.dynamics_rollout_batched(
        jp, jnp.asarray(state), jnp.asarray(acts), jnp.asarray(phys), jd, use_fused=False,
        compute_dtype=jnp.float32, fused_substeps=False)["state_seqs"]
    want_kernel = _jax_chunks(jp, state, acts, phys, jd, jnp.float32)
    np.testing.assert_allclose(got, np.asarray(want_xla), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got, want_kernel, rtol=2e-4, atol=2e-4)


def test_masked_mean_y_per_sample_physics():
    """dynamics_masked (per-sample point clouds, mean-y re-sticking, one physics
    candidate per sample) against the JAX XLA dynamics_masked, at the graded
    tolerance of tests/test_fused.py: the per-substep reduction-order noise of
    two float32 implementations grows through the autoregressive loop."""
    jd, td = _configs(1)
    jp, tp = _params(jd, 3)
    rng = np.random.RandomState(3)
    B = 6
    state = (rng.randn(B, 24, 3) * 0.4).astype(np.float32)
    mask = np.zeros((B, 24), bool)
    for i in range(B):
        mask[i, :rng.randint(12, 25)] = True
    state = state * mask[..., None]
    phys = rng.rand(B, 1).astype(np.float32)
    for length, atol in ((1.0, 2e-3), (4.0, 8e-3), (8.0, 3e-2)):
        acts = np.stack([rng.uniform(-1, 0, B), rng.uniform(-1, 1, B),
                         rng.uniform(-np.pi, np.pi, B), np.full(B, length)],
                        axis=-1).astype(np.float32)
        want = np.asarray(jax_forward.dynamics_masked(jp, jnp.asarray(state), jnp.asarray(mask),
                                                      jnp.asarray(acts), jnp.asarray(phys), jd))
        got = forward.dynamics_masked(tp, torch.tensor(state), torch.tensor(mask),
                                      torch.tensor(acts), torch.tensor(phys), td,
                                      compute_dtype=torch.float32).numpy()
        m = mask[..., None]
        np.testing.assert_allclose(got * m, want * m, atol=atol)


def test_bf16_one_substep_matches_jax_kernel():
    """bf16: both sides round every layer to bf16 at the same places; atol
    0.05 as tests/test_fused.py allows bf16 against float32 positions."""
    jd, td = _configs(1)
    jd, td = dataclasses.replace(jd, max_repeat=1), dataclasses.replace(td, max_repeat=1)
    jp, tp = _params(jd, 4)
    rng = np.random.RandomState(4)
    state = (rng.randn(24, 3) * 0.4).astype(np.float32)
    acts = _actions(rng, 4, 1)
    acts[..., 3] = 1.5
    phys = np.asarray([0.5], np.float32)
    want = _jax_chunks(jp, state, acts, phys, jd, jnp.bfloat16)
    got = forward.dynamics_rollout_batched(tp, torch.tensor(state), torch.tensor(acts),
                                           torch.tensor(phys), td,
                                           compute_dtype=torch.bfloat16)["state_seqs"].numpy()
    np.testing.assert_allclose(got, want, atol=0.05)


def test_kernel_wrapper_rejects_unsupported_config():
    cfg = GNNConfig(n_his=4, max_nobj=8, max_neef=1, nf_particle=8, nf_relation=8, nf_effect=8,
                    density_dim=1)
    with pytest.raises(ValueError, match="not supported"):
        fused_rollout_chunk({}, torch.zeros(8, 3), torch.zeros(1, 1, 3), torch.zeros(1, 1, 3),
                            torch.ones(1), torch.zeros(1), cfg, 0.5, 4)


@pytest.mark.parametrize("Dp,reaches_library", [(32, True), (33, False)])
def test_bf16_kernel_wrapper_takes_at_most_32_node_inputs(Dp, reaches_library, monkeypatch):
    """The bfloat16 kernel's particle encoder reads its Dp inputs and first
    weight as float from one 32 KB node matrix in shared memory, so its
    wrapper refuses more than 32 node inputs before it builds or loads the
    kernels; 32 pass its checks (the library is the next step)."""
    from adaptigraph_tpu_torch.ops import kernels
    from adaptigraph_tpu_torch.ops.fused_gnn import _weight_shapes, rollout_chunk_cuda

    class Reached(Exception):
        pass

    def library(variant=None):
        raise Reached

    monkeypatch.setattr(kernels, "library", library)
    cfg = GNNConfig(n_his=4, max_nobj=7, max_neef=1, nf_particle=128, nf_relation=128,
                    nf_effect=128)
    bf16, B, Np = torch.bfloat16, 2, 8
    weights = [torch.zeros(shape, dtype=bf16) for shape in _weight_shapes(cfg, Dp)]
    args = (torch.zeros(B, Np, Dp, dtype=bf16), torch.zeros(B, Np, 6),
            torch.ones(B, dtype=torch.int32), torch.ones(B, Np), weights, cfg, 4, 0.5, 4, 0.0,
            False, bf16)
    if reaches_library:
        with pytest.raises(Reached):
            rollout_chunk_cuda(*args)
    else:
        with pytest.raises(ValueError, match="at most 32 node inputs"):
            rollout_chunk_cuda(*args)


def _published(name):
    """The port's task config of a material (``configs/dynamics`` and
    ``configs/planning``) and the JAX GNNConfig of the same widths."""
    from adaptigraph_tpu_torch.cli import _task_objects
    from adaptigraph_tpu_torch.utils.config import load_planning_config

    tcfg, _ = _task_objects(load_planning_config(name))
    return tcfg, JaxGNNConfig(**dataclasses.asdict(tcfg.dcfg.gnn))


def _fixture_state(name, n_p):
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with np.load(os.path.join(root, "fixtures", f"{name}_demo", "interaction_000.npz")) as z:
        state = z["state_init"].astype(np.float32)
    idx = np.random.RandomState(0).choice(len(state), n_p, replace=len(state) < n_p)
    return state[idx]


@pytest.mark.parametrize("substeps", [1, 2])
@pytest.mark.parametrize("masked", [False, True], ids=["min_y", "masked_mean_y"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["rope", "granular"])
def test_published_width_matches_jax_kernel(name, dtype, masked, substeps):
    """The plain version against the JAX rollout kernel (interpret mode) at the
    published widths the kernel runs on the card (rope: N 101, K 10; granular:
    N 105, K 20; nf 128, pstep 3), B 2 pushes from the fixture's recorded
    state, cut to one and two substeps: min-y, and masked mean-y with
    per-sample masks and physics. float32 within 2e-4 and bf16 within 0.05,
    the tolerances of the cases above. The pushes move the kept rows by up to
    0.035-0.11 here, which 0.05 alone would not tell from no motion, so the
    displacement (result minus start) is also held to 5% of the JAX kernel's
    largest displacement."""
    from adaptigraph_tpu_torch.planning.actions import decode_action
    from adaptigraph_tpu_torch.planning.forward import pusher_keypoints

    tcfg, jgnn = _published(name)
    dcfg = tcfg.dcfg
    gnn, K, n_p, B = dcfg.gnn, dcfg.edge.topk, dcfg.gnn.max_nobj, 2
    jp = jax.tree_util.tree_map(np.asarray, init_params(jax.random.PRNGKey(7), jgnn))
    tp = params_from_numpy(jp, "cpu")
    rng = np.random.RandomState(substeps + 2 * masked)
    act = torch.tensor(rng.uniform(tcfg.action_lower_lim, tcfg.action_upper_lim,
                                   (B, 4)).astype(np.float32))
    decoded, _ = decode_action(act, dcfg.push_length)
    obj = np.broadcast_to(_fixture_state(name, n_p), (B, n_p, 3)).copy()
    mask, phys = None, np.asarray([0.5], np.float32)
    if masked:
        mask = np.arange(n_p)[None] < rng.randint(n_p // 2, n_p + 1, B)[:, None]
        obj = obj * mask[..., None]
        phys = rng.uniform(0, 1, (B, 1)).astype(np.float32)
        y = (obj[..., 1] * mask).sum(1) / np.maximum(mask.sum(1), 1)
    else:
        y = obj[..., 1].min(1)
    kp, delta = pusher_keypoints(dcfg, decoded, act[:, 2], torch.tensor(y))
    repeat = np.full(B, substeps, np.int32)
    cd_t, cd_j = (torch.float32, jnp.float32) if dtype == "float32" else (torch.bfloat16,
                                                                           jnp.bfloat16)
    got = fused_rollout_chunk(
        tp, torch.tensor(obj), kp, delta, torch.tensor(repeat), torch.tensor(phys), gnn,
        dcfg.adj_thresh, K, dcfg.max_repeat, dcfg.gripper_lift, cd_t,
        obj_mask=None if mask is None else torch.tensor(mask), mean_y=masked).numpy()
    want = np.asarray(jax_chunk(
        jp, jnp.asarray(obj), jnp.asarray(kp.numpy()), jnp.asarray(delta.numpy()),
        jnp.asarray(repeat), jnp.asarray(phys), jgnn, adj_radius=dcfg.adj_thresh, edge_topk=K,
        max_repeat=dcfg.max_repeat, gripper_lift=dcfg.gripper_lift, compute_dtype=cd_j,
        samples_per_block=2, interpret=True,
        obj_mask=None if mask is None else jnp.asarray(mask), mean_y=masked))
    keep = np.ones((B, n_p, 1), bool) if mask is None else mask[..., None]
    assert np.isfinite(got).all()
    if dtype == "float32":
        np.testing.assert_allclose(got * keep, want * keep, rtol=2e-4, atol=2e-4)
    else:
        np.testing.assert_allclose(got * keep, want * keep, atol=0.05)
    moved = np.abs((want - obj) * keep).max()
    assert moved > 0.03
    np.testing.assert_allclose((got - obj) * keep, (want - obj) * keep, rtol=0, atol=0.05 * moved)
