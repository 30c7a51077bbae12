"""The per-substep MPPI forward on CPU tensors (the plain versions of the
kernels) against the JAX package, its Pallas kernels in interpret mode as
tests/test_fused.py runs them, at a small width (20 objects, nf 32, pstep 2,
B 4):

- the single-step forward with its graph built in the kernel (K2e's plain
  version) against ``fused_forward_batch(build_edges=True)``: float32 2e-4,
  bfloat16 0.05 (tests/test_fused.py's bounds);
- every branch of ``dynamics_rollout_batched`` (whole-push K1, per-substep
  K2e, ``tools_all`` through the graph build and K2 with the gripper lift)
  against the JAX one, and the per-substep path against the JAX
  ``use_fused=False`` branch (the plain ``forward_batch``): float32 2e-4;
- a cloth chunk's rewards on the same actions;
- the profiling variants of K2e (``profiling/kernel_parts.py``) against the
  JAX kernel under ``FUSED_ABLATE``, which the JAX module reads at import,
  so each runs in a subprocess.
"""

import dataclasses
import os
import subprocess
import sys
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import adaptigraph_tpu.cli as jax_cli
from adaptigraph_tpu.models.gnn import GNNConfig as JaxGNNConfig
from adaptigraph_tpu.models.gnn import init_params
from adaptigraph_tpu.ops.fused_gnn import fused_forward_batch as jax_fused_forward
from adaptigraph_tpu.ops.graph import EdgeConfig as JaxEdgeConfig
from adaptigraph_tpu.planning import closed_loop as jax_closed_loop
from adaptigraph_tpu.planning import forward as jax_forward
from adaptigraph_tpu.utils.config import load_planning_config as jax_load_planning_config
from adaptigraph_tpu_torch import cli
from adaptigraph_tpu_torch.models.gnn import GNNConfig, params_from_numpy
from adaptigraph_tpu_torch.ops import fused_gnn
from adaptigraph_tpu_torch.ops.fused_gnn import fused_forward_batch, pack_node_inputs, pad_last
from adaptigraph_tpu_torch.ops.graph import EdgeConfig, build_neighbor_graph_batch
from adaptigraph_tpu_torch.planning import closed_loop, forward
from adaptigraph_tpu_torch.profiling import kernel_parts
from adaptigraph_tpu_torch.sim.synthetic import cloth_sheet
from adaptigraph_tpu_torch.utils.config import load_planning_config

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

KW = dict(n_his=4, max_nobj=20, max_neef=1, nf_particle=32, nf_relation=32, nf_effect=32, pstep=2)
JCFG, CFG = JaxGNNConfig(**KW), GNNConfig(**KW)
TOPK, ADJ, B = 6, 0.6, 4


def _params(seed):
    p = jax.tree_util.tree_map(np.asarray, init_params(jax.random.PRNGKey(seed), JCFG))
    return p, params_from_numpy(p, "cpu")


def _graph(seed):
    """One step's inputs without edges: a rope-like state history (all
    objects valid), the pusher's action on the eef row, per-sample physics."""
    rng = np.random.RandomState(seed)
    N, n_p = CFG.n_nodes, CFG.max_nobj
    attrs = np.zeros((B, N, 2), np.float32)
    attrs[:, :n_p, 0] = 1.0
    attrs[:, n_p:, 1] = 1.0
    action = np.zeros((B, N, 3), np.float32)
    action[:, n_p:] = rng.randn(B, 1, 3) * 0.05
    return {"state": (rng.randn(B, CFG.n_his, N, 3) * 0.4).astype(np.float32),
            "attrs": attrs, "action": action,
            "p_instance": np.ones((B, n_p, 1), np.float32),
            "physics_param": rng.rand(B, 1).astype(np.float32)}


@pytest.mark.parametrize("dtype,tol", [("float32", 2e-4), ("bfloat16", 0.05)])
def test_in_kernel_edges_match_jax_kernel(dtype, tol):
    g = _graph(0)
    jp, tp = _params(0)
    want_pred, want_mot = jax_fused_forward(
        jp, {k: jnp.asarray(v) for k, v in g.items()}, JCFG, compute_dtype=getattr(jnp, dtype),
        interpret=True, build_edges=True, adj_radius=ADJ, edge_topk=TOPK, samples_per_block=2)
    launches = fused_gnn.gnn_forward_edges.launches
    pred, mot = fused_forward_batch(tp, {k: torch.tensor(v) for k, v in g.items()}, CFG,
                                    compute_dtype=getattr(torch, dtype), build_edges=True,
                                    adj_radius=ADJ, edge_topk=TOPK)
    assert fused_gnn.gnn_forward_edges.launches == launches  # CPU tensors: the plain version
    np.testing.assert_allclose(pred.numpy(), np.asarray(want_pred), atol=tol, rtol=0)
    np.testing.assert_allclose(mot.numpy(), np.asarray(want_mot), atol=tol, rtol=0)


def test_in_kernel_edges_are_the_plain_graph():
    """K2e's plain version is K2's on the tables of the plain graph build
    with policy ``none`` and all slots valid (what the card checks bit for
    bit): the same function, so equal here too."""
    g = {k: torch.tensor(v) for k, v in _graph(1).items()}
    tp = _params(1)[1]
    n_p, N = CFG.max_nobj, CFG.n_nodes
    ecfg = EdgeConfig(max_nobj=n_p, max_neef=1, topk=TOPK)
    tool = torch.arange(N) >= n_p
    nbrs, mask = build_neighbor_graph_batch(g["state"][:, -1], torch.ones(B, N, dtype=bool),
                                            tool.expand(B, N), np.float32(ADJ), ecfg)
    got = fused_forward_batch(tp, g, CFG, torch.float32, build_edges=True, adj_radius=ADJ,
                              edge_topk=TOPK)
    want = fused_forward_batch(tp, dict(g, neighbors=nbrs, nbr_mask=mask), CFG, torch.float32,
                               k_used=TOPK)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def _configs(policy="none", **dyn):
    ekw = dict(max_nobj=20, max_neef=1, topk=TOPK, policy=policy,
               gate_on_contact=policy == "tools_all")
    dkw = dict(n_his=4, push_length=0.1, sim_real_ratio=10.0, max_repeat=3, adj_thresh=ADJ, **dyn)
    jd = jax_forward.DynamicsConfig(gnn=JCFG, edge=JaxEdgeConfig(**ekw), **dkw)
    td = forward.DynamicsConfig(gnn=CFG, edge=EdgeConfig(**ekw), **dkw)
    return jd, td


def _actions(rng, n, lo=1.5, hi=4.0):
    """n pushes starting within 0.6 of the origin, repeats 1..3 at the
    default lengths."""
    return np.stack([rng.uniform(-0.6, 0.6, n), rng.uniform(-0.6, 0.6, n),
                     rng.uniform(-np.pi, np.pi, n), rng.uniform(lo, hi, n)],
                    axis=-1).astype(np.float32)[:, None]


# branch -> (policy, JAX use_fused, fused_substeps, gripper); the port has no
# use_fused switch: on CPU tensors every kernel runs its plain version
BRANCHES = {"k1": ("none", True, True, False), "substep": ("none", True, False, False),
            "tools_all": ("tools_all", True, False, True), "plain": ("none", False, False, False)}


@pytest.mark.parametrize("branch", list(BRANCHES))
def test_rollout_branch_matches_jax(branch):
    policy, use_fused, fused_substeps, gripper = BRANCHES[branch]
    jd, td = _configs(policy, gripper_enable=gripper)
    jp, tp = _params(2)
    rng = np.random.RandomState(3)
    state = (rng.randn(20, 3) * 0.3).astype(np.float32)
    acts = _actions(rng, B, hi=3.99)
    phys = np.asarray([0.4], np.float32)
    want = jax_forward.dynamics_rollout_batched(
        jp, jnp.asarray(state), jnp.asarray(acts), jnp.asarray(phys), jd,
        compute_dtype=jnp.float32, interpret=True, use_fused=use_fused,
        fused_substeps=fused_substeps)["state_seqs"]
    counts = (fused_gnn.fused_rollout_chunk.launches, fused_gnn.gnn_forward.launches,
              fused_gnn.gnn_forward_edges.launches)
    got = forward.dynamics_rollout_batched(tp, torch.tensor(state), torch.tensor(acts),
                                           torch.tensor(phys), td, compute_dtype=torch.float32,
                                           fused_substeps=fused_substeps)["state_seqs"]
    assert counts == (fused_gnn.fused_rollout_chunk.launches, fused_gnn.gnn_forward.launches,
                      fused_gnn.gnn_forward_edges.launches)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("policy", ["none", "tools_all"])
def test_substeps_run_to_the_chunk_max_repeat(policy):
    """Each look-ahead step runs min(largest repeat in the chunk, max_repeat)
    single-step forwards, whatever the other samples' repeats."""
    td = _configs(policy)[1]
    tp = _params(7)[1]
    rng = np.random.RandomState(7)
    state = torch.tensor((rng.randn(20, 3) * 0.3).astype(np.float32))
    acts = np.concatenate([_actions(rng, B, lo=1.0, hi=2.0), _actions(rng, B, lo=2.0, hi=2.9),
                           _actions(rng, B, lo=9.0, hi=9.5)], axis=1)
    n_calls = []
    real = forward.fused_forward_batch

    def counted(*a, **kw):
        n_calls.append(1)
        return real(*a, **kw)

    with mock.patch.object(forward, "fused_forward_batch", counted):
        forward.dynamics_rollout_batched(tp, state, torch.tensor(acts), torch.tensor([0.4]), td,
                                         compute_dtype=torch.float32, fused_substeps=False)
    repeat = forward.decode_action(torch.tensor(acts), td.push_length)[1]
    want = sum(min(int(repeat[:, li].max()), td.max_repeat) for li in range(acts.shape[1]))
    assert len(n_calls) == want == 1 + 2 + 3


def test_tools_all_weight_list_and_masked_refusal():
    """The tool branch takes ``weight_list``'s output as the solver passes
    it; ``dynamics_masked`` no longer refuses a tool policy: it takes the
    parameter dict and float32 weights alike, and refuses only weights in
    another dtype (its tool branch is the float32 forward)."""
    jd, td = _configs("tools_all", gripper_enable=True)
    tp = _params(4)[1]
    rng = np.random.RandomState(4)
    state = torch.tensor((rng.randn(20, 3) * 0.3).astype(np.float32))
    acts = torch.tensor(_actions(rng, B))
    phys = torch.tensor([0.4])
    a = forward.dynamics_rollout_batched(tp, state, acts, phys, td, compute_dtype=torch.float32)
    w = fused_gnn.weight_list(tp, CFG, torch.float32)
    b = forward.dynamics_rollout_batched(w, state, acts, phys, td, compute_dtype=torch.float32)
    assert torch.equal(a["state_seqs"], b["state_seqs"])
    masked = (state[None].expand(B, 20, 3), torch.ones(B, 20, dtype=bool), acts[:, 0], phys, td)
    assert torch.equal(forward.dynamics_masked(tp, *masked), forward.dynamics_masked(w, *masked))
    with pytest.raises(ValueError, match="float32"):
        forward.dynamics_masked(fused_gnn.weight_list(tp, CFG, torch.bfloat16), *masked)


def _cloth_task(jax_side):
    """The cloth task cut to the small width, max_repeat 3."""
    if jax_side:
        tcfg = jax_cli._task_objects(jax_load_planning_config("cloth"))[0]
    else:
        tcfg = cli._task_objects(load_planning_config("cloth"))[0]
    d = tcfg.dcfg
    gnn = dataclasses.replace(d.gnn, nf_particle=32, nf_relation=32, nf_effect=32, pstep=2,
                              max_nobj=20)
    tcfg.dcfg = dataclasses.replace(d, gnn=gnn, edge=dataclasses.replace(d.edge, max_nobj=20),
                                    max_repeat=3)
    return tcfg


def test_cloth_task_objects_match_jax():
    """``load_planning_config("cloth")`` and ``_task_objects`` give the JAX
    objects' fields: the tools_all policy gated on contact, gripper lift, the
    published width and the solve budget."""
    jt = jax_cli._task_objects(jax_load_planning_config("cloth"))[0]
    tt = cli._task_objects(load_planning_config("cloth"))[0]
    assert dataclasses.asdict(tt.dcfg) == dataclasses.asdict(jt.dcfg)
    assert dataclasses.asdict(tt.mcfg) == dataclasses.asdict(jt.mcfg)
    for f in dataclasses.fields(tt):
        if f.name not in ("dcfg", "mcfg"):
            np.testing.assert_equal(getattr(tt, f.name), getattr(jt, f.name))
    assert (tt.dcfg.edge.policy, tt.dcfg.edge.gate_on_contact) == ("tools_all", True)
    assert (tt.dcfg.gnn.n_nodes, tt.dcfg.edge.topk, tt.dcfg.gnn.nf_effect) == (101, 5, 128)
    assert (tt.dcfg.adj_thresh, tt.dcfg.max_repeat, tt.dcfg.gripper_enable) == (0.75, 10, True)
    assert tt.penalty_type == "cloth"


def test_cloth_chunk_rewards_match_jax():
    """A cloth chunk through the tool branch (graph build gated on contact,
    K2's plain version, gripper lift) and the cloth reward, against the JAX
    chunk (fused, interpret mode) and reward on the same actions."""
    jt, tt = _cloth_task(True), _cloth_task(False)
    jp, tp = _params(5)
    state = cloth_sheet(5, 4, 5)
    target = state + np.asarray([0.3, 0.0, 0.2], np.float32)
    rng = np.random.RandomState(5)
    acts = np.stack([rng.uniform(-0.9, 0.9, 8), rng.uniform(-0.9, 0.9, 8),
                     rng.uniform(-np.pi, np.pi, 8), rng.uniform(2.0, 3.99, 8)],
                    axis=-1).astype(np.float32)[:, None]
    phys = np.asarray([0.5], np.float32)
    jout = jax_forward.dynamics_rollout_batched(jp, jnp.asarray(state), jnp.asarray(acts),
                                                jnp.asarray(phys), jt.dcfg,
                                                compute_dtype=jnp.float32, interpret=True)
    want = jax_closed_loop.make_reward_fn(jt, target)(jout["state_seqs"], jnp.asarray(acts),
                                                      jnp.asarray(state))
    tout = forward.dynamics_rollout_batched(tp, torch.tensor(state), torch.tensor(acts),
                                            torch.tensor(phys), tt.dcfg,
                                            compute_dtype=torch.float32)
    got = closed_loop.make_reward_fn(tt, target, "cpu")(tout["state_seqs"], torch.tensor(acts),
                                                        torch.tensor(state))
    np.testing.assert_allclose(tout["state_seqs"].numpy(), np.asarray(jout["state_seqs"]),
                               rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=2e-4)
    assert np.isfinite(got.numpy()).all()


JAX_ABLATED = """
import jax
jax.config.update("jax_platforms", "cpu")
import sys
import numpy as np
import jax.numpy as jnp
from adaptigraph_tpu.models.gnn import GNNConfig, init_params
from adaptigraph_tpu.ops import fused_gnn
inp, out, kw, seed, adj, topk = sys.argv[1], sys.argv[2], eval(sys.argv[3]), int(sys.argv[4]), float(sys.argv[5]), int(sys.argv[6])
cfg = GNNConfig(**kw)
with np.load(inp) as z:
    g = {k: jnp.asarray(z[k]) for k in z.files}
pred, _ = fused_gnn.fused_forward_batch(init_params(jax.random.PRNGKey(seed), cfg), g, cfg,
                                        compute_dtype=jnp.float32, interpret=True,
                                        build_edges=True, adj_radius=adj, edge_topk=topk,
                                        samples_per_block=2, want_motion=False)
np.save(out, np.asarray(pred))
print(",".join(sorted(fused_gnn._ABLATE)))
"""


@pytest.mark.parametrize("variant,ablate", [("no_edge", "noedge"), ("no_gather", "nogather"),
                                            ("mlp_only", "noedge,nogather")])
def test_kernel_parts_plain_match_jax_ablations(tmp_path, variant, ablate):
    g = _graph(6)
    inp, out = str(tmp_path / "graph.npz"), str(tmp_path / "pred.npy")
    np.savez(inp, **g)
    env = dict(os.environ, FUSED_ABLATE=ablate, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join(filter(None, [ROOT, os.environ.get("PYTHONPATH")])))
    res = subprocess.run([sys.executable, "-c", JAX_ABLATED, inp, out, repr(KW), "6", str(ADJ),
                          str(TOPK)], cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.strip().splitlines()[-1] == ",".join(sorted(ablate.split(",")))
    tg = {k: torch.tensor(v) for k, v in g.items()}
    nodes, _ = pack_node_inputs(CFG, tg["state"], tg["action"], tg["physics_param"], tg["attrs"],
                                tg["p_instance"], torch.float32)
    weights = fused_gnn.weight_list(_params(6)[1], CFG, torch.float32)
    got = kernel_parts.run_variant(variant, nodes, pad_last(CFG, tg["state"]), weights, cfg=CFG,
                                   compute_dtype=torch.float32, K=TOPK, adj_radius=ADJ)
    full = kernel_parts.run_variant("full", nodes, pad_last(CFG, tg["state"]), weights, cfg=CFG,
                                    compute_dtype=torch.float32, K=TOPK, adj_radius=ADJ)
    np.testing.assert_allclose(got.numpy(), np.load(out), rtol=0, atol=2e-4)
    assert not torch.allclose(got, full, atol=1e-3)  # the ablation changes the result
