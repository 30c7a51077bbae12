"""Port actions, costs, reward and the MPPI solve against the JAX package."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import adaptigraph_tpu.cli as jax_cli
import adaptigraph_tpu.planning.mppi_solve as jax_mppi
from adaptigraph_tpu.models.gnn import init_params
from adaptigraph_tpu.ops import costs as jax_costs
from adaptigraph_tpu.planning import actions as jax_actions
from adaptigraph_tpu.planning import closed_loop as jax_closed_loop
from adaptigraph_tpu.utils.config import load_planning_config as jax_load_planning_config
import adaptigraph_tpu_torch.planning.mppi_solve as mppi
from adaptigraph_tpu_torch import cli
from adaptigraph_tpu_torch.models.gnn import params_from_numpy
from adaptigraph_tpu_torch.ops import costs
from adaptigraph_tpu_torch.planning import actions, closed_loop
from adaptigraph_tpu_torch.utils.config import load_planning_config

torch.set_num_threads(2)
LOWER = np.asarray([-2.0, -2.0, -np.pi, 2.0], np.float32)
UPPER = np.asarray([2.0, 2.0, np.pi, 4.0], np.float32)


def close(got, want, tol=1e-5):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol, atol=tol)


def test_action_functions_match_jax():
    rng = np.random.RandomState(0)
    act = rng.uniform(-5, 5, (7, 3, 4)).astype(np.float32)
    act[..., 3] = rng.uniform(0, 12, (7, 3))
    for got, want in zip(actions.decode_action(torch.tensor(act), 0.2),
                         jax_actions.decode_action(jnp.asarray(act), 0.2)):
        close(got, want)
    close(actions.angle_normalize(torch.tensor(act[..., 2])),
          jax_actions.angle_normalize(jnp.asarray(act[..., 2])))
    lo, hi = torch.tensor(LOWER), torch.tensor(UPPER)
    close(actions.clip_actions(torch.tensor(act), lo, hi),
          jax_actions.clip_actions(jnp.asarray(act), LOWER, UPPER))
    rewards = rng.randn(7).astype(np.float32) * 0.01
    close(actions.optimize_action_mppi(torch.tensor(act), torch.tensor(rewards), 50.0, lo, hi),
          jax_actions.optimize_action_mppi(jnp.asarray(act), jnp.asarray(rewards), 50.0,
                                           LOWER, UPPER))


def test_sampler_shapes_and_bounds():
    g = torch.Generator()
    g.manual_seed(0)
    lo, hi = torch.tensor(LOWER), torch.tensor(UPPER)
    seq = torch.tensor([[0.5, -0.5, 1.0, 3.0], [0.0, 0.0, -1.0, 2.5]])
    s0 = actions.sample_action_seq(g, seq, lo, hi, 64, iter_index=0)
    s1 = actions.sample_action_seq(g, seq, lo, hi, 64, iter_index=1, noise_level=0.5)
    for s in (s0, s1):
        assert s.shape == (64, 2, 4)
        assert bool((s >= lo).all() and (s <= hi).all())
    assert torch.equal(s1[0], seq)


def test_costs_match_jax():
    rng = np.random.RandomState(1)
    x = rng.randn(3, 2, 12, 3).astype(np.float32)
    y = rng.randn(3, 12, 3).astype(np.float32)
    xm, ym = rng.rand(3, 12) > 0.3, rng.rand(3, 12) > 0.3
    close(costs.chamfer(torch.tensor(x[:, 1]), torch.tensor(y)),
          jax_costs.chamfer(jnp.asarray(x[:, 1]), jnp.asarray(y)))
    close(costs.masked_chamfer(torch.tensor(x[:, 1]), torch.tensor(y), torch.tensor(xm),
                               torch.tensor(ym)),
          jax_costs.masked_chamfer(jnp.asarray(x[:, 1]), jnp.asarray(y), jnp.asarray(xm),
                                   jnp.asarray(ym)))
    box = np.asarray([[-0.5, 0.2], [-0.1, 0.4]], np.float32)
    close(costs.box_loss(torch.tensor(x), torch.tensor(box)),
          jax_costs.box_loss(jnp.asarray(x), jnp.asarray(box)))
    close(costs.box_loss(torch.tensor(x[:, 0]), torch.tensor(box), torch.tensor(xm)),
          jax_costs.box_loss(jnp.asarray(x[:, 0]), jnp.asarray(box), jnp.asarray(xm)))
    act = rng.uniform(-1, 1, (3, 2, 4)).astype(np.float32)
    init = y[0]
    for name in ("rope_penalty", "cloth_penalty", "granular_penalty"):
        close(getattr(costs, name)(torch.tensor(x), torch.tensor(act), torch.tensor(init)),
              getattr(jax_costs, name)(jnp.asarray(x), jnp.asarray(act), jnp.asarray(init)))
    close(costs.bbox_penalty(torch.tensor(x), torch.tensor(box)),
          jax_costs.bbox_penalty(jnp.asarray(x), jnp.asarray(box)))


@pytest.mark.parametrize("name", ["rope", "granular"])
def test_reward_fn_matches_jax(name):
    tcfg, _ = cli._task_objects(load_planning_config(name))
    jtcfg, _ = jax_cli._task_objects(jax_load_planning_config(name))
    rng = np.random.RandomState(2)
    B, L, n = 9, 2, tcfg.dcfg.gnn.max_nobj
    seqs = rng.randn(B, L, n, 3).astype(np.float32)
    act = rng.uniform(tcfg.action_lower_lim, tcfg.action_upper_lim, (B, L, 4)).astype(np.float32)
    cur = rng.randn(n, 3).astype(np.float32)
    if tcfg.target_type == "box":
        target = np.asarray(tcfg.target_path, np.float32).reshape(2, 2) * tcfg.sim_real_ratio
    else:
        target = cur + np.asarray([0.5, 0.0, 0.3], np.float32)
    got = closed_loop.make_reward_fn(tcfg, target, device="cpu")(
        torch.tensor(seqs), torch.tensor(act), torch.tensor(cur))
    want = jax_closed_loop.make_reward_fn(jtcfg, target)(
        jnp.asarray(seqs), jnp.asarray(act), jnp.asarray(cur))
    close(got, want)


def _tiny_task(jax_side):
    """The rope task cut to a tiny model: nf 16, pstep 2, 20 objects, topk 5."""
    if jax_side:
        tcfg, _ = jax_cli._task_objects(jax_load_planning_config("rope"))
    else:
        tcfg, _ = cli._task_objects(load_planning_config("rope"))
    d = tcfg.dcfg
    gnn = dataclasses.replace(d.gnn, nf_particle=16, nf_relation=16, nf_effect=16, pstep=2,
                              max_nobj=20)
    edge = dataclasses.replace(d.edge, max_nobj=20, topk=5)
    tcfg.dcfg = dataclasses.replace(d, gnn=gnn, edge=edge, max_repeat=4)
    tcfg.action_lower_lim, tcfg.action_upper_lim = LOWER, UPPER
    return tcfg


@pytest.mark.parametrize("ties", [False, True])
def test_solve_matches_jax_with_identical_samples(monkeypatch, ties):
    """Both solvers get the same sampled actions. With ``ties`` every push
    length lies in [2, 3.2): the summed repeats take two values, so chunk
    membership hangs on the sort keeping the sampled order among ties."""
    n_sample, chunk, L, iters = 64, 16, 1, 2
    jt, tt = _tiny_task(True), _tiny_task(False)
    jm = jax_mppi.MPPIConfig(n_sample=n_sample, n_sample_chunk=chunk, n_look_ahead=L,
                             n_update_iter=iters, reward_weight=50.0, noise_level=0.5)
    tm = mppi.MPPIConfig(**dataclasses.asdict(jm))
    jt.mcfg, tt.mcfg = jm, tm
    rng = np.random.RandomState(5)
    samples = {}
    for it in range(2):
        s = rng.uniform(LOWER, UPPER, (n_sample, L, 4)).astype(np.float32)
        if ties:
            s[..., 3] = rng.uniform(2.0, 3.2, (n_sample, L))
        samples[it] = s
    monkeypatch.setattr(jax_mppi, "sample_action_seq",
                        lambda key, act_seq, lo, hi, n, iter_index=0, **kw:
                        jnp.asarray(samples[iter_index]))
    monkeypatch.setattr(mppi, "sample_action_seq",
                        lambda gen, act_seq, lo, hi, n, iter_index=0, **kw:
                        torch.tensor(samples[iter_index]))

    jp = jax.tree_util.tree_map(np.asarray, init_params(jax.random.PRNGKey(0), jt.dcfg.gnn))
    state = rng.uniform(-0.5, 0.5, (20, 3)).astype(np.float32)
    target = state + np.asarray([0.3, 0.0, 0.2], np.float32)
    act0 = np.asarray([[0.0, 0.0, 0.0, 3.0]], np.float32)
    phys = np.asarray([0.5], np.float32)
    jsolve = jax_mppi.make_mppi_solver(jt.dcfg, jm, jax_closed_loop.make_reward_fn(jt, target),
                                       LOWER, UPPER)
    want = jsolve(jp, jnp.asarray(state), jnp.asarray(act0), jax.random.PRNGKey(1),
                  jnp.asarray(phys))
    tsolve = mppi.make_mppi_solver(tt.dcfg, tm, closed_loop.make_reward_fn(tt, target, "cpu"),
                                   LOWER, UPPER, device="cpu", compute_dtype=torch.float32)
    got = tsolve(params_from_numpy(jp, "cpu"), state, act0, torch.Generator(), phys)
    for key in ("mppi_seq", "best_reward", "act_seq", "best_final_state"):
        close(got[key], want[key], 1e-4)


def test_sort_by_repeat_is_stable():
    acts = torch.tensor([[[0.0, 0, 0, 3.5]], [[1.0, 0, 0, 2.2]], [[2.0, 0, 0, 3.1]],
                         [[3.0, 0, 0, 2.9]]])
    order = mppi.sort_by_repeat(acts, 0.1)[:, 0, 0].tolist()
    assert order == [1.0, 3.0, 0.0, 2.0]


def test_cuda_solver_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    tt = _tiny_task(False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mppi.make_mppi_solver(tt.dcfg, tt.mcfg, lambda *a: None, LOWER, UPPER)
