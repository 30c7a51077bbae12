"""The port's multi-device paths on CPU devices (``["cpu"] * n``): the mesh
helpers (the per-shard stream ones no-ops there), the sharded MPPI solve
(rope, and cloth's tool policy with its substep counts read once per
iteration) and the data-parallel train and eval steps (the flat-buffer
``pmean`` equal to the per-leaf one)
against the JAX package's ``shard_map`` versions on the conftest's virtual
CPU devices (the shapes and tolerances of ``tests/test_fused_multichip.py``),
the sharded paths against the port's own unsharded ones, ``train
--n_devices`` and ``plan --mesh``'s chunk sizing against the JAX command's.
On the card ``chip_smoke.py``'s ``mesh`` phase runs the same paths through
K1, K2 and K3."""

import dataclasses
import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import adaptigraph_tpu.cli as jax_cli
import adaptigraph_tpu.planning.mppi_solve as jax_mppi
from adaptigraph_tpu.dynamics import train as jax_train
from adaptigraph_tpu.models.gnn import GNNConfig as JaxGNNConfig
from adaptigraph_tpu.models.gnn import init_params as jax_init_params
from adaptigraph_tpu.ops.graph import EdgeConfig as JaxEdgeConfig
from adaptigraph_tpu.parallel import mesh as jax_mesh
from adaptigraph_tpu.planning import closed_loop as jax_closed_loop
from adaptigraph_tpu.utils.config import load_planning_config as jax_load_planning_config
import adaptigraph_tpu_torch.planning.mppi_solve as mppi
from adaptigraph_tpu_torch import cli
from adaptigraph_tpu_torch.dynamics import train
from adaptigraph_tpu_torch.models.gnn import GNNConfig, params_from_numpy
from adaptigraph_tpu_torch.ops.graph import EdgeConfig
from adaptigraph_tpu_torch.models.gnn import init_params
from adaptigraph_tpu_torch.parallel.mesh import (count_launches, fork, join, launch_tallies,
                                                 make_mesh, replicate, run_shards, shard_batch,
                                                 shard_scope, shard_streams, split_batch, used_on)
from adaptigraph_tpu_torch.planning import forward
from adaptigraph_tpu_torch.planning import closed_loop
from adaptigraph_tpu_torch.sim.synthetic import cloth_sheet
from adaptigraph_tpu_torch.utils import checkpoint as ckpt
from adaptigraph_tpu_torch.utils.config import load_planning_config
from test_torch_jaxsim import jax_sim_built_here  # noqa: F401  (autouse)

torch.set_num_threads(2)

# tests/test_fused_multichip.py's model, edges and solve
KW = dict(n_his=4, max_nobj=20, max_neef=1, nf_particle=16, nf_relation=16, nf_effect=16,
          pstep=2)
JGNN, GNN = JaxGNNConfig(**KW), GNNConfig(**KW)
JEDGE, EDGE = JaxEdgeConfig(max_nobj=20, max_neef=1, topk=5), EdgeConfig(max_nobj=20, max_neef=1,
                                                                         topk=5)
LOWER = np.asarray([-2.0, -2.0, -np.pi, 1.0], np.float32)
UPPER = np.asarray([2.0, 2.0, np.pi, 3.0], np.float32)


def cpus(n):
    return make_mesh(devices=["cpu"] * n)


# ---------------------------------------------------------------------------
# the mesh helpers
# ---------------------------------------------------------------------------

def test_make_mesh_lists_devices_and_never_falls_back(monkeypatch):
    assert make_mesh(devices=["cpu", "cpu", "cpu"]) == [torch.device("cpu")] * 3
    assert make_mesh(2, devices=["cpu"] * 3) == [torch.device("cpu")] * 2
    assert make_mesh(device_type="cpu") == [torch.device("cpu")]
    with pytest.raises(RuntimeError, match="a mesh of 4 needs 4"):
        make_mesh(4, devices=["cpu"] * 3)
    with pytest.raises(RuntimeError, match="a mesh of 2 needs 2"):
        make_mesh(2, device_type="cpu")
    # the card is the default: no card, no mesh (never the CPU instead)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="0 cuda device"):
        make_mesh()
    # two cards asked for, one there
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert make_mesh() == [torch.device("cuda", 0)]
    with pytest.raises(RuntimeError, match="a mesh of 2 needs 2"):
        make_mesh(2)
    with pytest.raises(SystemExit, match="--n_devices 2"):
        cli.device_mesh(2, torch.device("cuda"))


def test_shard_batch_splits_evenly_and_replicate_copies():
    rng = np.random.RandomState(0)
    batch = {"a": rng.randn(6, 3).astype(np.float32), "b": rng.randn(2, 6, 4).astype(np.float32)}
    parts = shard_batch({"a": batch["a"]}, cpus(3))
    assert len(parts) == 3 and all(p["a"].shape == (2, 3) for p in parts)
    np.testing.assert_array_equal(torch.cat([p["a"] for p in parts]).numpy(), batch["a"])
    parts = shard_batch({"b": batch["b"]}, cpus(2), batch_axis=1)
    assert all(p["b"].shape == (2, 3, 4) and p["b"].is_contiguous() for p in parts)
    np.testing.assert_array_equal(torch.cat([p["b"] for p in parts], 1).numpy(), batch["b"])
    with pytest.raises(ValueError, match="does not split evenly over 4"):
        shard_batch(batch, cpus(4))
    with pytest.raises(ValueError, match="does not split evenly"):
        split_batch(torch.zeros(5, 2), 2)
    leaves = [torch.ones(3, requires_grad=True), torch.zeros(2)]
    reps = replicate({"w": leaves, "n": 3}, cpus(2))
    assert len(reps) == 2 and reps[0]["n"] == 3
    for rep in reps:
        assert rep["w"][0].requires_grad and not rep["w"][1].requires_grad
        assert rep["w"][0].data_ptr() != leaves[0].data_ptr()
        assert torch.equal(rep["w"][0], leaves[0])
    assert reps[0]["w"][0].data_ptr() != reps[1]["w"][0].data_ptr()


def test_count_launches_adds_a_blocks_launches_to_one_tally():
    """``count_launches`` adds to one shard's tally the launches each
    wrapper made inside the block, also when the block raises."""
    def k1():
        pass

    def k2():
        pass

    k1.launches, k2.launches = 5, 0
    tallies = launch_tallies((k1, k2), 2)
    assert tallies == [{"k1": 0, "k2": 0}] * 2
    with count_launches((k1, k2), tallies[1]):
        k1.launches += 2
        k2.launches += 3
    with pytest.raises(RuntimeError), count_launches((k1, k2), tallies[0]):
        k2.launches += 1
        raise RuntimeError("a launch failed")
    assert tallies == [{"k1": 0, "k2": 1}, {"k1": 2, "k2": 3}]


def test_shard_stream_helpers_are_no_ops_on_cpu():
    """On a CPU mesh there is no stream: ``shard_streams`` gives None per
    entry, ``fork``, ``join``, ``used_on`` and ``shard_scope`` do nothing,
    and ``run_shards`` runs every work item in the order given, returns
    their outputs in that order (None stays None) and tallies each item's
    launches to its shard."""
    mesh = cpus(2)
    streams = shard_streams(mesh)
    assert streams == [None, None]
    x = torch.arange(4.0)
    fork(streams, mesh[0])
    join(streams, mesh[0])
    used_on({"a": [x, 3], "b": None}, streams[0])
    with shard_scope(mesh[1], streams[1]):
        assert torch.equal(x * 2, torch.tensor([0.0, 2.0, 4.0, 6.0]))

    def k():
        pass

    k.launches, order = 0, []

    def fn(i, t):
        order.append(i)
        k.launches += i + 1
        return t * i

    tallies = launch_tallies((k,), 2)
    outs = run_shards(mesh, streams, [(0, fn, (0, x)), (1, fn, (1, x))], (k,), tallies)
    assert order == [0, 1] and tallies == [{"k": 1}, {"k": 2}]
    assert torch.equal(outs[0], x * 0) and torch.equal(outs[1], x)
    assert run_shards(mesh, streams, [(s, lambda: None, ()) for s in (0, 1)], (k,),
                      tallies) == [None, None]
    # items go in the order given, each tallied to its own shard
    order.clear()
    outs = run_shards(mesh, streams, [(1, fn, (2, x)), (0, fn, (1, x)), (1, fn, (0, x))], (k,),
                      tallies)
    assert order == [2, 1, 0] and tallies == [{"k": 3}, {"k": 6}]
    assert [o.tolist() for o in outs] == [(x * 2).tolist(), x.tolist(), (x * 0).tolist()]


# ---------------------------------------------------------------------------
# the sharded MPPI solve
# ---------------------------------------------------------------------------

def _solve_case(monkeypatch, n_sample=32, chunk=4, iters=2):
    """Both packages' solvers on the same sampled actions (one draw per
    iteration, handed to every solver), the multichip file's model and
    budget."""
    rng = np.random.RandomState(0)
    state = rng.uniform(-0.5, 0.5, size=(20, 3)).astype(np.float32)
    target = state + np.asarray([0.3, 0.0, 0.2], np.float32)
    samples = {it: rng.uniform(LOWER, UPPER, (n_sample, 1, 4)).astype(np.float32)
               for it in range(2)}
    monkeypatch.setattr(jax_mppi, "sample_action_seq",
                        lambda key, act_seq, lo, hi, n, iter_index=0, **kw:
                        jnp.asarray(samples[iter_index]))
    monkeypatch.setattr(mppi, "sample_action_seq",
                        lambda gen, act_seq, lo, hi, n, iter_index=0, **kw:
                        torch.tensor(samples[iter_index]))
    jt, _ = jax_cli._task_objects(jax_load_planning_config("rope"))
    tt, _ = cli._task_objects(load_planning_config("rope"))
    for t in (jt, tt):
        d = t.dcfg
        t.dcfg = dataclasses.replace(d, gnn=dataclasses.replace(d.gnn, **KW),
                                     edge=dataclasses.replace(d.edge, max_nobj=20, topk=5),
                                     max_repeat=3)
        t.action_lower_lim, t.action_upper_lim = LOWER, UPPER
    jm = jax_mppi.MPPIConfig(n_sample=n_sample, n_sample_chunk=chunk, n_look_ahead=1,
                             n_update_iter=iters, reward_weight=50.0, noise_level=0.5)
    jt.mcfg, tt.mcfg = jm, mppi.MPPIConfig(**dataclasses.asdict(jm))
    jp = jax.tree_util.tree_map(np.asarray, jax_init_params(jax.random.PRNGKey(0), jt.dcfg.gnn))
    act0 = np.asarray([[0.0, 0.0, 0.0, 2.0]], np.float32)
    return SimpleNamespace(jt=jt, tt=tt, jp=jp, state=state, target=target, act0=act0,
                           phys=np.asarray([0.5], np.float32), samples=samples)


def _port_solver(c, mesh):
    return mppi.make_mppi_solver(c.tt.dcfg, c.tt.mcfg,
                                 closed_loop.make_reward_fn(c.tt, c.target, "cpu"),
                                 LOWER, UPPER, device="cpu", compute_dtype=torch.float32,
                                 mesh=mesh)


def _port_solve(c, mesh):
    return _port_solver(c, mesh)(params_from_numpy(c.jp, "cpu"), c.state, c.act0,
                                 torch.Generator(), c.phys)


@pytest.mark.parametrize("n", [2, 8])
def test_sharded_solve_matches_jax_sharded_solve(monkeypatch, n):
    """The port's solve on n CPU shards against JAX's ``make_mppi_solver(
    mesh=make_mesh(n))`` (its plain path under ``shard_map``) on the same
    samples: the multichip file's tolerances."""
    c = _solve_case(monkeypatch)
    jsolve = jax_mppi.make_mppi_solver(c.jt.dcfg, c.jt.mcfg,
                                       jax_closed_loop.make_reward_fn(c.jt, c.target),
                                       LOWER, UPPER, mesh=jax_mesh.make_mesh(n))
    want = jsolve(c.jp, jnp.asarray(c.state), jnp.asarray(c.act0), jax.random.PRNGKey(2),
                  jnp.asarray(c.phys))
    got = _port_solve(c, cpus(n))
    np.testing.assert_allclose(float(got["best_reward"]), float(want["best_reward"]), rtol=1e-5)
    for key in ("act_seq", "mppi_seq", "best_final_state"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), rtol=1e-4, atol=1e-5,
                                   err_msg=key)


def test_sharded_solve_equals_the_unsharded_solve(monkeypatch):
    """Each chunk keeps its members and its place in the sample order under
    the deal (chunk c on shard c % n), so the sharded solve equals the
    unsharded one bit for bit: the update sums in the unsharded order. A
    one-entry mesh is the unsharded solve. On 4 shards the rollouts take the
    sorted chunks in order, chunk c with shard c % 4's copy of the weights."""
    c = _solve_case(monkeypatch)
    one = _port_solve(c, None)
    for mesh in (cpus(1), cpus(2), cpus(4), cpus(8)):
        got = _port_solve(c, mesh)
        for key in ("best_reward", "act_seq", "mppi_seq", "best_final_state"):
            assert torch.equal(got[key], one[key]), (len(mesh), key)
    seen = []
    real = mppi.dynamics_rollout_batched
    monkeypatch.setattr(mppi, "dynamics_rollout_batched",
                        lambda w, s, acts, *a, **k: seen.append((acts.clone(), w[0].data_ptr()))
                        or real(w, s, acts, *a, **k))
    _port_solve(c, cpus(4))
    chunks = mppi.sort_by_repeat(torch.tensor(c.samples[0]), 0.1).reshape(8, 4, 1, 4)
    assert all(torch.equal(seen[i][0], chunks[i]) for i in range(8))
    shard_of = [ptr for _, ptr in seen[:8]]
    assert len(set(shard_of[:4])) == 4 and shard_of[4:] == shard_of[:4]
    # the launches each shard's chunks made: one launch of K1 a chunk, as on
    # the card (a stand-in counts it here), 8 chunks an iteration
    def one_launch(*a, **k):
        mppi.fused_rollout_chunk.launches += 1
        return real(*a, **k)

    monkeypatch.setattr(mppi, "dynamics_rollout_batched", one_launch)
    for mesh, per_shard in ((None, [16]), (cpus(1), [16]), (cpus(4), [4] * 4)):
        solve = _port_solver(c, mesh)
        solve(params_from_numpy(c.jp, "cpu"), c.state, c.act0, torch.Generator(), c.phys)
        assert [t["fused_rollout_chunk"] for t in solve.shard_launches] == per_shard
    with pytest.raises(ValueError, match="8 chunks do not divide evenly over 3"):
        mppi.make_mppi_solver(c.tt.dcfg, c.tt.mcfg, lambda *a: None, LOWER, UPPER,
                              mesh=cpus(3))


def test_tool_policy_sharded_solve_reads_repeats_once_per_iteration(monkeypatch):
    """Cloth (``tools_all``, K2 per substep) cut to a small width, two
    look-ahead steps: the solve on 2 CPU shards equals the unsharded one bit
    for bit, and each reads every chunk's substep counts on the host once
    per iteration (``mppi_solve``'s ``substep_counts``), none per chunk
    (``forward``'s); each chunk gets, per look-ahead step, its largest
    repeat capped at ``max_repeat``, and its rollout equals the one that
    reads the count itself."""
    tt = cli._task_objects(load_planning_config("cloth"))[0]
    d = tt.dcfg
    gnn = dataclasses.replace(d.gnn, nf_particle=16, nf_relation=16, nf_effect=16, pstep=2,
                              max_nobj=20)
    tt.dcfg = dcfg = dataclasses.replace(d, gnn=gnn, edge=dataclasses.replace(d.edge, max_nobj=20),
                                         max_repeat=3)
    iters, L = 2, 2
    tt.mcfg = mppi.MPPIConfig(n_sample=16, n_sample_chunk=4, n_look_ahead=L, n_update_iter=iters,
                              reward_weight=50.0, noise_level=0.5)
    rng = np.random.RandomState(6)
    samples = {it: np.stack([rng.uniform(-0.9, 0.9, (16, L)), rng.uniform(-0.9, 0.9, (16, L)),
                             rng.uniform(-np.pi, np.pi, (16, L)), rng.uniform(1.0, 4.5, (16, L))],
                            axis=-1).astype(np.float32) for it in range(2)}
    monkeypatch.setattr(mppi, "sample_action_seq",
                        lambda gen, act_seq, lo, hi, n, iter_index=0, **kw:
                        torch.tensor(samples[iter_index]))
    reads = {"per_iteration": 0, "per_chunk": 0}
    real = forward.substep_counts

    def counted(key):
        def read(*a):
            reads[key] += 1
            return real(*a)
        return read

    monkeypatch.setattr(mppi, "substep_counts", counted("per_iteration"))
    monkeypatch.setattr(forward, "substep_counts", counted("per_chunk"))
    chunks = []
    rollout = mppi.dynamics_rollout_batched
    monkeypatch.setattr(mppi, "dynamics_rollout_batched",
                        lambda w, s, acts, *a, **k: chunks.append((w, s, acts, a, k))
                        or rollout(w, s, acts, *a, **k))
    state = cloth_sheet(5, 4, 5)
    reward = closed_loop.make_reward_fn(tt, state + np.asarray([0.3, 0.0, 0.2], np.float32), "cpu")
    params = init_params(torch.Generator().manual_seed(0), gnn)
    lo, hi = (np.asarray(x, np.float32) for x in (tt.action_lower_lim, tt.action_upper_lim))
    out = {}
    for name, mesh in (("unsharded", None), ("two_shards", cpus(2))):
        reads.update(per_iteration=0, per_chunk=0)
        solve = mppi.make_mppi_solver(dcfg, tt.mcfg, reward, lo, hi, device="cpu",
                                      compute_dtype=torch.float32, mesh=mesh)
        out[name] = solve(params, state, np.tile((lo + hi) / 2, (L, 1)), torch.Generator(),
                          np.asarray([0.5], np.float32))
        assert reads == {"per_iteration": iters, "per_chunk": 0}, name
    for key in out["unsharded"]:
        assert torch.equal(out["two_shards"][key], out["unsharded"][key]), key
    assert len(chunks) == 2 * iters * 4
    w, s, acts, a, k = chunks[-1]
    _, repeat = mppi.decode_action(acts, dcfg.push_length)
    want = [min(int(repeat[:, li].max()), dcfg.max_repeat) for li in range(L)]
    assert k["n_substeps"] == want and len(set(c[4]["n_substeps"][0] for c in chunks)) > 1
    reads["per_chunk"] = 0
    itself = rollout(w, s, acts, *a, **dict(k, n_substeps=None))
    assert reads["per_chunk"] == L
    assert torch.equal(itself["state_seqs"], rollout(w, s, acts, *a, **k)["state_seqs"])
    assert real(torch.tensor([[1, 5, 2], [3, 0, 9]], dtype=torch.int32), 4) == [4, 4]
    assert real(torch.tensor([1, 5, 2], dtype=torch.int32), 10) == 5


# ---------------------------------------------------------------------------
# the data-parallel train and eval steps
# ---------------------------------------------------------------------------

def _batch(rng, B, masks=False):
    """tests/test_fused_multichip.py's batch; with ``masks`` each sample
    keeps a different number of objects, so the shards' masks differ."""
    N, No = GNN.n_nodes, GNN.max_nobj
    batch = {
        "state": rng.randn(B, 4, N, 3).astype(np.float32) * 0.3,
        "action": np.zeros((B, N, 3), np.float32),
        "eef_future": np.zeros((B, 2, N, 3), np.float32),
        "action_future": np.zeros((B, 2, N, 3), np.float32),
        "state_future": rng.randn(B, 3, No, 3).astype(np.float32) * 0.3,
        "attrs": np.zeros((B, N, 2), np.float32),
        "p_instance": np.ones((B, No, 1), np.float32),
        "state_mask": np.ones((B, N), bool),
        "eef_mask": np.zeros((B, N), bool),
        "obj_mask": np.ones((B, No), bool),
        "physics_param": np.full((B, 1), 0.5, np.float32),
        "adj_thresh": np.full(B, 0.5, np.float32),
        "knn_frac": np.ones(B, np.float32),
    }
    batch["eef_mask"][:, No] = True
    batch["attrs"][:, :No, 0] = 1.0
    batch["attrs"][:, No, 1] = 1.0
    batch["action"][:, No:] = 0.05
    if masks:
        for b in range(B):
            keep = No - 2 * b
            batch["obj_mask"][b, keep:] = False
            batch["state_mask"][b, keep:No] = False
            batch["attrs"][b, keep:No, 0] = 0.0
            batch["p_instance"][b, keep:] = 0.0
    return batch


@pytest.fixture(scope="module")
def jax_fused():
    fn = jax_train.fused_train_fn(JGNN, JEDGE, interpret=True)
    assert fn is not None
    return fn


def _jparams():
    return jax.tree_util.tree_map(np.asarray, jax_init_params(jax.random.PRNGKey(0), JGNN))


def _replicas(jparams, mesh):
    leaves = [t.requires_grad_(True) for t in ckpt.tree_leaves(params_from_numpy(jparams, "cpu"))]
    return replicate(leaves, mesh), replicate(train.adam_init(leaves), mesh)


def _torch(batch):
    return {k: torch.tensor(v) for k, v in batch.items()}


def _assert_replicas_equal(replicas, states):
    for rep, st in zip(replicas[1:], states[1:]):
        assert all(torch.equal(a, b) for a, b in zip(rep, replicas[0]))
        assert all(torch.equal(a, b) for a, b in zip(st["mu"], states[0]["mu"]))
        assert all(torch.equal(a, b) for a, b in zip(st["nu"], states[0]["nu"]))
        assert int(st["count"]) == int(states[0]["count"])


@pytest.mark.parametrize("masks", [False, True], ids=["full", "masks_differ"])
def test_sharded_train_step_matches_jax_sharded_step(jax_fused, masks):
    """One step on 8 CPU shards against JAX's ``make_train_step(mesh=
    make_mesh(8))`` with its fused kernels in interpret mode, augmentation
    off: loss rtol 1e-5, parameters rtol 1e-4 / atol 1e-6, the replicas
    equal. With ``masks`` each sample keeps another number of objects: both
    take the plain mean of the shard means (JAX's ``pmean``)."""
    batch = _batch(np.random.RandomState(1), 8, masks)
    hyper = dict(n_future=3, use_augmentation=False)
    opt = optax.adam(1e-3)
    jmesh = jax_mesh.make_mesh(8)
    jp = _jparams()
    jstep = jax_train.make_train_step(JGNN, JEDGE, jax_train.TrainHyper(**hyper), opt,
                                      fused_fn=jax_fused, mesh=jmesh)
    p8, _, jloss = jstep(jax_mesh.replicate(jp, jmesh), jax_mesh.replicate(opt.init(jp), jmesh),
                         jax_mesh.shard_batch(batch, jmesh), jax.random.PRNGKey(7))
    mesh = cpus(8)
    replicas, states = _replicas(jp, mesh)
    step = train.make_train_step(GNN, EDGE, train.TrainHyper(**hyper), mesh=mesh)
    loss = step(replicas, states, shard_batch(batch, mesh), None)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    for got, want in zip(replicas[0], jax.tree_util.tree_leaves(p8)):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-4, atol=1e-6)
    _assert_replicas_equal(replicas, states)
    assert step.shard_launches == [{"gnn_forward": 0, "gnn_train_bwd": 0}] * 8  # CPU: none
    jeval = jax_train.make_eval_step(JGNN, JEDGE, jax_train.TrainHyper(**hyper),
                                     fused_fn=jax_fused, mesh=jmesh)
    evaluate = train.make_eval_step(GNN, EDGE, train.TrainHyper(**hyper), mesh=mesh)
    np.testing.assert_allclose(
        float(evaluate(replicas, shard_batch(batch, mesh), None)),
        float(jeval(p8, jax_mesh.shard_batch(batch, jmesh), jax.random.PRNGKey(3))), rtol=1e-5)


def test_two_shard_train_step_matches_jax_sharded_step(jax_fused):
    """One step on 2 CPU shards (each shard's work through ``run_shards``)
    against JAX's ``make_train_step(mesh=make_mesh(2))``, augmentation off:
    loss rtol 1e-5, parameters rtol 1e-4 / atol 1e-6, the replicas equal."""
    batch = _batch(np.random.RandomState(8), 4, masks=True)
    hyper = dict(n_future=2, use_augmentation=False)
    opt = optax.adam(1e-3)
    jmesh = jax_mesh.make_mesh(2)
    jp = _jparams()
    jstep = jax_train.make_train_step(JGNN, JEDGE, jax_train.TrainHyper(**hyper), opt,
                                      fused_fn=jax_fused, mesh=jmesh)
    p2, _, jloss = jstep(jax_mesh.replicate(jp, jmesh), jax_mesh.replicate(opt.init(jp), jmesh),
                         jax_mesh.shard_batch(batch, jmesh), jax.random.PRNGKey(7))
    mesh = cpus(2)
    replicas, states = _replicas(jp, mesh)
    step = train.make_train_step(GNN, EDGE, train.TrainHyper(**hyper), mesh=mesh)
    loss = step(replicas, states, shard_batch(batch, mesh), None)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    for got, want in zip(replicas[0], jax.tree_util.tree_leaves(p2)):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-4, atol=1e-6)
    _assert_replicas_equal(replicas, states)


def test_sharded_step_on_prefetched_parts_equals_shard_batch_parts():
    """A two-shard step on the parts that ``DevicePrefetcher(mesh=...)``
    stages from a host batch equals, bit for bit, the same step on
    ``shard_batch``'s parts of that batch: the loss and every replica's
    leaves and Adam state. (On the cards each shard's stream is ordered
    after its own card's copy by ``fork``; ``chip_smoke.py``'s ``mesh``
    phase holds that ordering.)"""
    batch = _batch(np.random.RandomState(9), 4, masks=True)
    hyper = train.TrainHyper(n_future=2, use_augmentation=False)
    mesh = cpus(2)
    stage = train.DevicePrefetcher(iter([batch]), "cpu", mesh=mesh)
    try:
        staged = next(stage)
    finally:
        stage.close()
    runs = []
    for parts in (shard_batch(batch, mesh), staged):
        replicas, states = _replicas(_jparams(), mesh)
        step = train.make_train_step(GNN, EDGE, hyper, mesh=mesh)
        runs.append((step(replicas, states, parts, None), replicas, states))
    (loss_a, reps_a, states_a), (loss_b, reps_b, states_b) = runs
    assert torch.equal(loss_a, loss_b)
    for a, b in zip(reps_a + [s["mu"] for s in states_a] + [s["nu"] for s in states_a],
                    reps_b + [s["mu"] for s in states_b] + [s["nu"] for s in states_b]):
        assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("n", [2, 3, 8])
def test_flat_pmean_equals_per_leaf_pmean(n):
    """The mean of the shards' flat buffers (loss first, then every leaf's
    gradient) equals JAX's ``pmean`` of each leaf and of the loss, bit for
    bit, on values of mixed magnitudes whose sums round."""
    rng = np.random.RandomState(n)
    shapes = [(3, 4), (4,), (16, 16), (1,), (5, 3)]

    def draw(*shape):
        return torch.tensor((rng.randn(*shape) * 10.0 ** rng.randint(-4, 4, shape))
                            .astype(np.float32))

    losses = [draw() for _ in range(n)]
    grads = [[draw(*s) for s in shapes] for _ in range(n)]
    flats = [train.flat_loss_grads(l, g) for l, g in zip(losses, grads)]
    mean = train.pmean(flats, "cpu")
    assert torch.equal(mean[0], train.pmean(losses, "cpu"))
    like = [torch.empty(s) for s in shapes]
    for got, leaf in zip(train.unflat_grads(mean, like), zip(*grads)):
        want = train.pmean(list(leaf), "cpu")
        assert got.shape == want.shape and torch.equal(got, want)


def test_sharded_train_steps_match_jax_sharded_scan(jax_fused):
    """K = 2 steps per call over a (K, B, ...) superbatch on 8 CPU shards
    (a loop of sharded steps) against JAX's sharded ``make_train_steps``."""
    K, B = 2, 8
    sb = _batch(np.random.RandomState(3), K * B)
    sb = {k: v.reshape((K, B) + v.shape[1:]) for k, v in sb.items()}
    hyper = dict(n_future=2, use_augmentation=False)
    opt = optax.adam(1e-3)
    jmesh = jax_mesh.make_mesh(8)
    jp = _jparams()
    jsteps = jax_train.make_train_steps(JGNN, JEDGE, jax_train.TrainHyper(**hyper), opt,
                                        fused_fn=jax_fused, mesh=jmesh)
    p8, _, jl = jsteps(jax_mesh.replicate(jp, jmesh), jax_mesh.replicate(opt.init(jp), jmesh),
                       jax_mesh.shard_batch(sb, jmesh, batch_axis=1),
                       jax.random.split(jax.random.PRNGKey(5), K))
    mesh = cpus(8)
    replicas, states = _replicas(jp, mesh)
    steps = train.make_train_steps(GNN, EDGE, train.TrainHyper(**hyper), mesh=mesh)
    losses = steps(replicas, states, shard_batch(sb, mesh, batch_axis=1), None)
    np.testing.assert_allclose(losses.numpy(), np.asarray(jl), rtol=1e-5)
    for got, want in zip(replicas[0], jax.tree_util.tree_leaves(p8)):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-4, atol=1e-6)
    _assert_replicas_equal(replicas, states)
    assert int(states[0]["count"]) == K


class _RerunGraph:
    """A stand-in for ``dynamics.train._Replay`` on the CPU, where no CUDA
    graph can be captured: it keeps its own copies of the inputs, runs
    nothing at capture, and each call copies its inputs into the copies and
    runs ``fn`` on them, which is what a replay computes."""

    def __init__(self, fn, inputs, device, generator=None):
        self.fn, self.counted = fn, [0, 0]
        self.static = [None if x is None else
                       {k: v.clone() for k, v in x.items()} if isinstance(x, dict) else x.clone()
                       for x in inputs]

    def __call__(self, *inputs):
        train._copy_into(self.static, inputs)
        return self.fn(*self.static)


@pytest.mark.parametrize("n", [2, 4])
def test_sharded_graphs_equal_the_eager_sharded_steps(monkeypatch, n):
    """``ShardedGraphs`` (the K steps on a card mesh) with each replay
    stood in for by a rerun on its captured inputs (``_RerunGraph``): two
    calls of K = 3 train steps and one of eval steps, augmentation on,
    equal bit for bit 6 eager sharded steps and 3 eager evals; the first
    call runs slice 0 eagerly and captures, the second only replays, 2
    graphs a shard and slice (train) or 1 (eval)."""
    monkeypatch.setattr(train, "_Replay", _RerunGraph)
    K = 3
    batch = _batch(np.random.RandomState(5), K * 4, masks=True)
    sb = {k: v.reshape((K, 4) + v.shape[1:]) for k, v in batch.items()}
    hyper = train.TrainHyper(n_future=2, state_noise_train=0.05, phys_noise_train=0.05,
                             state_noise_valid=0.02)
    mesh = cpus(n)
    parts = shard_batch(sb, mesh, batch_axis=1)
    jp = _jparams()
    runs = []
    for graphed in (True, False):
        replicas, states = _replicas(jp, mesh)
        gen = torch.Generator().manual_seed(4)
        step = train.make_train_step(GNN, EDGE, hyper, mesh=mesh)
        evaluate = train.make_eval_step(GNN, EDGE, hyper, mesh=mesh)
        if graphed:
            steps, evals = train.ShardedGraphs(step.sharded), train.ShardedGraphs(evaluate.sharded)
            losses = [steps(replicas, states, parts, gen) for _ in range(2)]
            assert steps.replays == (K - 1 + K) * 2 * n  # the second call captures nothing
            valid = evals(replicas, parts, gen)
            assert evals.replays == (K - 1) * n
        else:
            slices = [[{k: v[i] for k, v in p.items()} for p in parts] for i in range(K)]
            losses = [torch.stack([step(replicas, states, sl, gen) for sl in slices])
                      for _ in range(2)]
            valid = torch.stack([evaluate(replicas, sl, gen) for sl in slices])
        runs.append((torch.cat(losses), valid, replicas, states))
    (l1, v1, r1, s1), (l2, v2, r2, s2) = runs
    assert torch.equal(l1, l2) and torch.equal(v1, v2)
    for a, b in zip(r1, r2):
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    _assert_replicas_equal(r1, s1)
    assert int(s1[0]["count"]) == int(s2[0]["count"]) == 2 * K


@pytest.mark.parametrize("n", [2, 3])
def test_one_step_sharded_graphs_equal_the_eager_sharded_step(monkeypatch, n):
    """``make_train_step(mesh=...)`` and ``make_eval_step(mesh=...)`` on a
    mesh of cards (forced here on CPU entries through ``_on_cards``, each
    replay stood in for by ``_RerunGraph``): three train calls and three
    eval calls, each on a new batch, augmentation on, equal bit for bit the
    eager sharded step (``ShardedStep.eager_step``) call for call, the
    replicas and Adam states too; the first call of each captures and runs
    eagerly, the later ones only replay, 2 graphs a shard and call (train)
    or 1 (eval)."""
    monkeypatch.setattr(train, "_Replay", _RerunGraph)
    monkeypatch.setattr(train, "_on_cards", lambda mesh: True)
    hyper = train.TrainHyper(n_future=2, state_noise_train=0.05, phys_noise_train=0.05,
                             state_noise_valid=0.02)
    mesh = cpus(n)
    batches = [shard_batch(_batch(np.random.RandomState(20 + i), 6, masks=True), mesh)
               for i in range(6)]
    jp = _jparams()
    runs = []
    for graphed in (True, False):
        replicas, states = _replicas(jp, mesh)
        gen = torch.Generator().manual_seed(11)
        step = train.make_train_step(GNN, EDGE, hyper, mesh=mesh)
        evaluate = train.make_eval_step(GNN, EDGE, hyper, mesh=mesh)
        assert step.graphed is not None and evaluate.graphed is not None
        if not graphed:
            step, evaluate = step.sharded.eager_step, evaluate.sharded.eager_step
        losses, valid = [], []
        for i in range(3):
            losses.append(step(replicas, states, batches[2 * i], gen))
            valid.append(evaluate(replicas, batches[2 * i + 1], gen))
            if graphed:
                assert step.graphed.replays == 2 * n * i
                assert evaluate.graphed.replays == n * i
        runs.append((torch.stack(losses), torch.stack(valid), replicas, states))
    (l1, v1, r1, s1), (l2, v2, r2, s2) = runs
    assert torch.equal(l1, l2) and torch.equal(v1, v2)
    for a, b in zip(r1 + [s["mu"] for s in s1] + [s["nu"] for s in s1],
                    r2 + [s["mu"] for s in s2] + [s["nu"] for s in s2]):
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    _assert_replicas_equal(r1, s1)
    assert int(s1[0]["count"]) == int(s2[0]["count"]) == 3


def test_one_step_sharded_call_is_eager_on_cpu_meshes():
    """On a mesh of CPU entries the sharded steps have no graphs: every call
    is the eager sharded step."""
    hyper = train.TrainHyper(n_future=2)
    for make in (train.make_train_step, train.make_eval_step):
        assert make(GNN, EDGE, hyper, mesh=cpus(2)).graphed is None
    assert train.make_train_steps(GNN, EDGE, hyper, mesh=cpus(2)).graphed is None
    assert train._on_cards(["cuda:0", "cuda:1"]) and not train._on_cards(["cuda:0", "cpu"])


@pytest.mark.parametrize("n", [None, 1, 2], ids=["unsharded", "one_entry", "two_entries"])
def test_step_functions_free_their_graphs_without_the_collector(n):
    """Every train and eval function, one step or K a call, unsharded or on
    a mesh, is freed with its graphs (``.graphed``) as soon as the last
    reference to it goes, with Python's cyclic collector off: none lies in a
    reference cycle. (A one-entry mesh's K-step function referred to itself;
    its CUDA graph was then destroyed whenever the collector ran, once
    during another capture, which that invalidates.)"""
    import gc
    import weakref

    hyper = train.TrainHyper(n_future=2)
    mesh = None if n is None else cpus(n)
    collecting = gc.isenabled()
    gc.disable()
    try:
        for make in (train.make_train_steps, train.make_eval_steps, train.make_train_step,
                     train.make_eval_step):
            fn = make(GNN, EDGE, hyper, mesh=mesh)
            refs = [weakref.ref(fn)]
            if getattr(fn, "graphed", None) is not None:
                refs.append(weakref.ref(fn.graphed))
            del fn
            assert all(r() is None for r in refs), make.__name__
    finally:
        if collecting:
            gc.enable()


def test_capture_runs_without_the_cyclic_collector(monkeypatch):
    """``_Replay`` captures with Python's cyclic collector off (a graph that
    the collector freed during the capture would invalidate it) and restores
    it afterwards, after a failed capture too; a collector that was off
    stays off. The CUDA graph calls are stood in for on the CPU."""
    import contextlib
    import gc

    seen = []

    class FakeGraph:
        def register_generator_state(self, generator):
            pass

    @contextlib.contextmanager
    def fake_capture(graph, stream=None, capture_error_mode=None):
        seen.append(("enter", gc.isenabled(), capture_error_mode))
        yield

    monkeypatch.setattr(torch.cuda, "CUDAGraph", FakeGraph)
    monkeypatch.setattr(torch.cuda, "graph", fake_capture)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: None)

    def fn(x):
        seen.append(("fn", gc.isenabled()))
        return x + 1

    def broken(x):
        raise RuntimeError("capture failed")

    collecting = gc.isenabled()
    try:
        gc.enable()
        replay = train._Replay(fn, (torch.zeros(3),), "cpu")
        assert seen == [("enter", False, "thread_local"), ("fn", False)] and gc.isenabled()
        assert torch.equal(replay.out, torch.ones(3))
        with pytest.raises(RuntimeError, match="capture failed"):
            train._Replay(broken, (torch.zeros(3),), "cpu")
        assert gc.isenabled()
        gc.disable()
        train._Replay(fn, (torch.zeros(3),), "cpu")
        assert not gc.isenabled()
    finally:
        (gc.enable if collecting else gc.disable)()


def test_smoke_replica_check_finds_any_difference():
    """``chip_smoke.py::replicas_equal``, the card check that a mesh's
    replicas stay equal, on three CPU replicas: equal after ``replicate``,
    and unequal after one element of a leaf, of the Adam moments or the step
    count changes on one replica."""
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from chip_smoke import replicas_equal

    def fresh():
        return _replicas(_jparams(), cpus(3))

    reps, states = fresh()
    assert replicas_equal(reps, states)
    for change in ("leaf", "mu", "count"):
        reps, states = fresh()
        with torch.no_grad():
            if change == "leaf":
                reps[2][3].view(-1)[0] += 1.0
            elif change == "mu":
                states[1]["mu"][0].view(-1)[-1] = 1e-30
            else:
                states[2]["count"] += 1
        assert not replicas_equal(reps, states), change


def test_sharded_step_with_augmentation_is_the_unsharded_step():
    """Augmentation on: the sharded step draws the whole batch's noise and
    rotation from the caller's generator and splits them, so on 2 and 4
    shards it is the unsharded step up to the mean's order (loss rtol 1e-5,
    leaves rtol 1e-4 / atol 1e-6), and on a one-entry mesh the same bit for
    bit; the K-step and eval functions likewise."""
    batch = _batch(np.random.RandomState(4), 8, masks=True)
    hyper = train.TrainHyper(n_future=3, state_noise_train=0.05, phys_noise_train=0.05,
                             state_noise_valid=0.02)
    jp = _jparams()
    leaves = [t.requires_grad_(True) for t in ckpt.tree_leaves(params_from_numpy(jp, "cpu"))]
    state = train.adam_init(leaves)
    want = train.make_train_step(GNN, EDGE, hyper)(leaves, state, _torch(batch),
                                                   torch.Generator().manual_seed(9))
    want_eval = train.make_eval_step(GNN, EDGE, hyper)(leaves, _torch(batch),
                                                       torch.Generator().manual_seed(9))
    for n in (1, 2, 4):
        mesh = cpus(n)
        replicas, states = _replicas(jp, mesh)
        loss = train.make_train_step(GNN, EDGE, hyper, mesh=mesh)(
            replicas, states, shard_batch(batch, mesh), torch.Generator().manual_seed(9))
        evaluated = train.make_eval_step(GNN, EDGE, hyper, mesh=mesh)(
            replicas, shard_batch(batch, mesh), torch.Generator().manual_seed(9))
        if n == 1:
            assert torch.equal(loss, want)
            assert all(torch.equal(a, b) for a, b in zip(replicas[0], leaves))
        np.testing.assert_allclose(float(loss), float(want), rtol=1e-5)
        np.testing.assert_allclose(float(evaluated), float(want_eval), rtol=1e-5)
        for got, ref in zip(replicas[0], leaves):
            np.testing.assert_allclose(got.detach().numpy(), ref.detach().numpy(), rtol=1e-4,
                                       atol=1e-6)
        _assert_replicas_equal(replicas, states)
    # K steps per call: on a one-entry mesh the unsharded steps, on two a
    # loop of the sharded step
    sb = {k: np.stack([v, v[::-1].copy()]) for k, v in batch.items()}
    results = []
    for mesh in (None, cpus(1), cpus(2)):
        if mesh is None:
            reps = [[t.detach().clone().requires_grad_(True) for t in ckpt.tree_leaves(
                params_from_numpy(jp, "cpu"))]]
            sts = [train.adam_init(reps[0])]
            out = train.make_train_steps(GNN, EDGE, hyper)(reps[0], sts[0], _torch(sb),
                                                           torch.Generator().manual_seed(2))
        else:
            reps, sts = _replicas(jp, mesh)
            out = train.make_train_steps(GNN, EDGE, hyper, mesh=mesh)(
                reps, sts, shard_batch(sb, mesh, batch_axis=1), torch.Generator().manual_seed(2))
        results.append((out, reps[0]))
    (l0, p0), (l1, p1), (l2, p2) = results
    assert torch.equal(l1, l0) and all(torch.equal(a, b) for a, b in zip(p1, p0))
    np.testing.assert_allclose(l2.numpy(), l0.numpy(), rtol=1e-5)
    for a, b in zip(p2, p0):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(), rtol=1e-4, atol=1e-6)


# ---------------------------------------------------------------------------
# the CLI: train --n_devices, plan --mesh
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def prep_dir(tmp_path_factory):
    from adaptigraph_tpu_torch.dynamics.preprocess import preprocess_episodes
    from adaptigraph_tpu_torch.sim.synthetic import SYNTH_EEF_OFFSETS, simulate_rope_dataset
    from adaptigraph_tpu_torch.utils.config import load_dynamics_config

    config = load_dynamics_config("rope")
    dc = config["dataset_config"]
    prep = str(tmp_path_factory.mktemp("torchmesh") / "prep")
    preprocess_episodes(simulate_rope_dataset(n_episodes=4, n_pushes=2, seed=3, n_particles=40),
                        prep, SYNTH_EEF_OFFSETS, dc["n_his"], dc["n_future"], dc["dist_thresh"],
                        cli._phys_specs(config))
    return prep


def test_train_cli_n_devices_on_cpu_shards(prep_dir, tmp_path):
    """``train --n_devices 2 --device cpu`` at the rope config's width: two
    data-parallel CPU shards, K = 2 steps per call, against the same run on
    one device (augmentation on: the same draws, split)."""
    runs = {}
    for n in (2, 1):
        out = str(tmp_path / f"n{n}")
        params, curves = cli.main(["train", "--config", "rope", "--prep_dir", prep_dir,
                                   "--out_dir", out, "--device", "cpu", "--batch_size", "4",
                                   "--epochs", "1", "--iters", "4", "--steps_per_call", "2",
                                   "--n_devices", str(n)])
        runs[n] = (params, curves)
        assert os.path.exists(ckpt.latest_name(out))
    (p2, c2), (p1, c1) = runs[2], runs[1]
    np.testing.assert_allclose(c2["train"], c1["train"], rtol=1e-5)
    np.testing.assert_allclose(c2["valid"], c1["valid"], rtol=1e-5)
    for a, b in zip(ckpt.tree_leaves(p2), ckpt.tree_leaves(p1)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4, atol=1e-6)


class _StubEnv:
    """What ``plan`` reads of the environment before the loop."""

    def __init__(self, *a, **kw):
        self.env = SimpleNamespace(properties={})

    def get_particles_sim(self):
        return np.zeros((30, 3), np.float32)


def _plan_mcfg(main, monkeypatch, closed_loop_mod, env_mod, argv):
    """The solve budget and mesh size one CLI's ``plan`` hands ``run_plan``
    (the loop itself stubbed), or the SystemExit it raises."""
    seen = {}

    def fake_run_plan(env, params, tcfg, target, **kw):
        seen["mcfg"], seen["mesh"] = tcfg.mcfg, kw.get("mesh")
        return {"errors": []}

    monkeypatch.setattr(closed_loop_mod, "run_plan", fake_run_plan)
    monkeypatch.setattr(env_mod, "SimRealEnv", _StubEnv)
    try:
        main(argv)
    except SystemExit as e:
        return str(e)
    mesh = seen["mesh"]
    n = 1 if mesh is None else mesh.devices.size if hasattr(mesh, "devices") else len(mesh)
    return seen["mcfg"].n_sample, seen["mcfg"].n_sample_chunk, n


@pytest.mark.parametrize("n_sample,chunk,mesh", [(None, None, "4"), (None, None, "3"),
                                                 (300, 100, "2"), (30, 7, "4"), (64, 8, "8"),
                                                 (20000, 2000, "5")])
def test_plan_mesh_sizes_chunks_as_jax(monkeypatch, n_sample, chunk, mesh):
    """``plan --mesh N`` on the same config values in both CLIs (the JAX one
    on N of its 8 virtual CPU devices, the port's on N CPU shards): the same
    resized chunk, or the same error when n_sample is not a multiple of N."""
    import adaptigraph_tpu.realworld.env as jax_env
    import adaptigraph_tpu_torch.realworld.env as torch_env

    extra = ["--n_sample", str(n_sample), "--n_sample_chunk", str(chunk)] if n_sample else []
    argv = ["plan", "--config", "rope", "--n_actions", "1", "--mesh", mesh] + extra
    want = _plan_mcfg(jax_cli.main, monkeypatch, jax_closed_loop, jax_env, argv)
    got = _plan_mcfg(cli.main, monkeypatch, closed_loop, torch_env, argv + ["--device", "cpu"])
    assert got == want
    if isinstance(want, tuple):
        assert want[2] == int(mesh) and (want[0] // want[1]) % int(mesh) == 0
    else:
        assert "must be divisible by the device count" in want
