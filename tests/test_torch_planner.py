"""The Planner slice of the port on CPU tensors against the JAX package: the
correlated sampler (given JAX's normals), ``fps_action_grid``, the
Hausdorff and EMD costs, the device FPS, the differentiable
``dynamics_rollout`` (states and the gradient of the reward with respect to
the actions, through plain autograd and through the training forward's plain
K2/K3), and the ``Planner`` (the JAX ``tests/test_planning.py`` cases, and
MPPI and gradient descent on a GNN with the same injected samples)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adaptigraph_tpu.models.gnn import GNNConfig as JaxGNNConfig
from adaptigraph_tpu.models.gnn import init_params as jax_init_params
from adaptigraph_tpu.ops import costs as jax_costs
from adaptigraph_tpu.ops.fps import fps_jax
from adaptigraph_tpu.ops.graph import EdgeConfig as JaxEdgeConfig
from adaptigraph_tpu.planning import actions as jax_actions
from adaptigraph_tpu.planning.forward import DynamicsConfig as JaxDynamicsConfig
from adaptigraph_tpu.planning.forward import dynamics_rollout as jax_dynamics_rollout
from adaptigraph_tpu.planning.planner import Planner as JaxPlanner
from adaptigraph_tpu.planning.planner import PlannerConfig as JaxPlannerConfig
from adaptigraph_tpu_torch.models.gnn import GNNConfig, forward_batch, params_from_numpy
from adaptigraph_tpu_torch.ops import costs
from adaptigraph_tpu_torch.ops.fps import fps_device
from adaptigraph_tpu_torch.ops.graph import EdgeConfig
from adaptigraph_tpu_torch.planning import (DynamicsConfig, Planner, PlannerConfig, actions,
                                            dynamics_rollout, sample_action_seq_correlated)

torch.set_num_threads(2)
LOWER = np.asarray([-4.5, -2.5, -np.pi, 2.0], np.float32)
UPPER = np.asarray([0.0, 4.5, np.pi, 10.0], np.float32)

NO = 20
KW = dict(n_his=4, max_nobj=NO, max_neef=1, nf_particle=32, nf_relation=32, nf_effect=32, pstep=2)
JGNN, GNN = JaxGNNConfig(**KW), GNNConfig(**KW)
DKW = dict(n_his=4, max_repeat=6, adj_thresh=0.5)
JDCFG = JaxDynamicsConfig(gnn=JGNN, edge=JaxEdgeConfig(max_nobj=NO, max_neef=1, topk=5), **DKW)
DCFG = DynamicsConfig(gnn=GNN, edge=EdgeConfig(max_nobj=NO, max_neef=1, topk=5), **DKW)
PHYS = np.array([0.4], np.float32)
ACT_LO = np.array([-1.0, -1.0, -np.pi, 2.0], np.float32)
ACT_HI = np.array([1.0, 1.0, np.pi, 5.0], np.float32)


def close(got, want, tol=1e-5):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("beta_filter", [0.7, 0.3])
def test_correlated_sampler_matches_jax_with_its_normals(beta_filter):
    key = jax.random.PRNGKey(4)
    act = np.asarray([[-2.0, 1.0, 0.5, 5.0], [-1.0, 0.0, -0.5, 3.0], [-3.0, 2.0, 2.5, 9.5]],
                     np.float32)
    n, L = 64, act.shape[0]
    want = jax_actions.sample_action_seq_correlated(key, jnp.asarray(act), LOWER, UPPER, n,
                                                    noise_level=0.5, beta_filter=beta_filter)
    normals = np.stack([np.asarray(jax.random.normal(k, (n, 4))) for k in jax.random.split(key, L)])
    got = actions.correlated_action_seqs(torch.tensor(normals), torch.tensor(act),
                                         torch.tensor(LOWER), torch.tensor(UPPER), 0.5, beta_filter)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)
    # the port's own draws: the shape, the bounds and sample spread
    g = torch.Generator().manual_seed(0)
    mine = sample_action_seq_correlated(g, torch.tensor(act), torch.tensor(LOWER),
                                        torch.tensor(UPPER), n, 0.5, beta_filter)
    assert mine.shape == (n, L, 4)
    assert (mine >= torch.tensor(LOWER)).all() and (mine <= torch.tensor(UPPER)).all()
    assert float(mine.std(dim=0).min()) > 0


def test_fps_action_grid_matches_jax():
    lo, hi = [-0.1, -0.1, 0.0, 0.02], [0.1, 0.1, 0.1, 0.1]
    got = actions.fps_action_grid(lo, hi, 24)
    want = jax_actions.fps_action_grid(lo, hi, 24)
    assert got.shape == (24, 4)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("masked", [False, True])
def test_hausdorff_and_emd_hungarian_match_jax(masked):
    rng = np.random.RandomState(1 + masked)
    x = rng.randn(3, 17, 3).astype(np.float32)
    y = rng.randn(3, 17, 3).astype(np.float32)
    kw, jkw = {}, {}
    if masked:
        xm, ym = rng.rand(3, 17) > 0.3, rng.rand(3, 17) > 0.3
        kw = dict(x_mask=torch.tensor(xm), y_mask=torch.tensor(ym))
        jkw = dict(x_mask=jnp.asarray(xm), y_mask=jnp.asarray(ym))
    close(costs.hausdorff(torch.tensor(x), torch.tensor(y), **kw),
          jax_costs.hausdorff(jnp.asarray(x), jnp.asarray(y), **jkw))
    close(costs.emd_hungarian(torch.tensor(x), torch.tensor(y)), jax_costs.emd_hungarian(x, y))


def test_emd_sinkhorn_value_and_gradient_match_jax():
    rng = np.random.RandomState(3)
    x = (rng.randn(2, 12, 3) * 0.2).astype(np.float32)
    y = (rng.randn(2, 12, 3) * 0.2).astype(np.float32)
    want = jax_costs.emd_sinkhorn(jnp.asarray(x), jnp.asarray(y))
    want_g = jax.grad(lambda a: jnp.sum(jax_costs.emd_sinkhorn(a, jnp.asarray(y))))(jnp.asarray(x))
    xt = torch.tensor(x, requires_grad=True)
    got = costs.emd_sinkhorn(xt, torch.tensor(y))
    got_g, = torch.autograd.grad(got.sum(), xt)
    close(got.detach(), want)
    want_g = np.asarray(want_g)
    assert np.abs(got_g.numpy() - want_g).max() <= 1e-4 * np.abs(want_g).max()
    # it approaches the exact assignment's cost as epsilon falls
    exact = costs.emd_hungarian(x, y)
    assert np.all(got.detach().numpy() >= exact - 1e-4)


@pytest.mark.parametrize("seed,n,num", [(0, 40, 12), (1, 64, 64), (2, 30, 40)])
def test_fps_device_matches_fps_jax(seed, n, num):
    rng = np.random.RandomState(seed)
    pcd = rng.randn(n, 3).astype(np.float32)
    mask = rng.rand(n) > 0.25
    start = int(np.flatnonzero(mask)[0])
    want_i, want_v = fps_jax(jnp.asarray(pcd), jnp.asarray(mask), num, start_idx=start)
    got_i, got_v = fps_device(torch.tensor(pcd), torch.tensor(mask), num, start_idx=start)
    assert got_i.dtype == torch.int32 and got_v.dtype == torch.bool
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))


# --- the differentiable rollout ------------------------------------------

def _params(seed=0):
    jp = jax.tree_util.tree_map(np.asarray, jax_init_params(jax.random.PRNGKey(seed), JGNN))
    return jp, params_from_numpy(jp, "cpu")


def _state(padded, seed=0):
    """Object particles; with ``padded`` the last 6 rows zero, as a perceived
    state padded to max_nobj, so the eef re-sticks to tied minima (y 0)."""
    rng = np.random.RandomState(seed)
    s = rng.uniform(-0.4, 0.4, (NO, 3)).astype(np.float32)
    if padded:
        s[:, 1] = np.abs(s[:, 1]) + 0.05
        s[-6:] = 0.0
    return s


def _actions(n, L, seed=1):
    rng = np.random.RandomState(seed)
    a = rng.uniform(ACT_LO, ACT_HI, (n, L, 4)).astype(np.float32)
    a[..., :2] *= 0.4
    return a


TARGET = np.random.RandomState(9).uniform(-0.4, 0.4, (NO, 3)).astype(np.float32)


def _jax_reward(state_seqs, act_seqs, state_cur=None):
    final = state_seqs[:, -1]
    err = jax_costs.chamfer(final, jnp.broadcast_to(jnp.asarray(TARGET), final.shape))
    pen = jax_costs.rope_penalty(state_seqs, act_seqs, state_cur, sim_real_ratio=1.0)
    return {"reward_seqs": -err - pen.mean(axis=1)}


def _reward(state_seqs, act_seqs, state_cur=None):
    final = state_seqs[:, -1]
    err = costs.chamfer(final, torch.tensor(TARGET).expand(final.shape))
    pen = costs.rope_penalty(state_seqs, act_seqs, state_cur, sim_real_ratio=1.0)
    return {"reward_seqs": -err - pen.mean(dim=1)}


def plain_autograd_step(params, state, action, physics, attrs, p_instance, neighbors, nbr_mask):
    """The single step as the plain model forward, differentiated by autograd."""
    return forward_batch(params, {"state": state, "action": action, "physics_param": physics,
                                  "attrs": attrs, "p_instance": p_instance,
                                  "neighbors": neighbors, "nbr_mask": nbr_mask}, GNN)[0]


@pytest.mark.parametrize("route", ["training_forward", "plain_autograd"])
@pytest.mark.parametrize("padded", [False, True])
def test_dynamics_rollout_states_and_action_gradient_match_jax(route, padded):
    """state_seqs at rtol/atol 1e-5; the gradient of sum(reward) with
    respect to the actions within 1e-4 of its largest entry, over two
    look-ahead pushes (the second starting from the first's prediction)."""
    jp, params = _params()
    state, acts = _state(padded), _actions(6, 2)
    step_fn = plain_autograd_step if route == "plain_autograd" else None

    def jax_obj(a):
        out = jax_dynamics_rollout(jp, jnp.asarray(state), a, jnp.asarray(PHYS), JDCFG)
        return jnp.sum(_jax_reward(out["state_seqs"], a, jnp.asarray(state))["reward_seqs"]), out

    (_, want), want_g = jax.value_and_grad(jax_obj, has_aux=True)(jnp.asarray(acts))
    a = torch.tensor(acts, requires_grad=True)
    got = dynamics_rollout(params, torch.tensor(state), a, torch.tensor(PHYS), DCFG,
                           step_fn=step_fn)
    got_g, = torch.autograd.grad(_reward(got["state_seqs"], a, torch.tensor(state))
                                 ["reward_seqs"].sum(), a)
    close(got["state_seqs"].detach(), want["state_seqs"])
    close(got["action_seqs"].detach(), want["action_seqs"], 1e-6)
    want_g = np.asarray(want_g)
    assert np.abs(want_g).max() > 0
    assert np.abs(got_g.numpy() - want_g).max() <= 1e-4 * np.abs(want_g).max()


# --- the Planner ---------------------------------------------------------

def toy_rollout(state_cur, act_seqs):
    """Analytic model: a point at ``state_cur`` shifts by each push vector
    times its repeats."""
    dec, rep = actions.decode_action(act_seqs, push_length=0.1)
    delta = torch.stack([dec[..., 2] - dec[..., 0], dec[..., 3] - dec[..., 1]], dim=-1)
    pos = state_cur[None, None, :2] + torch.cumsum(delta * rep[..., None], dim=1)
    return {"state_seqs": pos[..., None, :]}


def jax_toy_rollout(state_cur, act_seqs):
    dec, rep = jax_actions.decode_action(act_seqs, push_length=0.1)
    delta = jnp.stack([dec[..., 2] - dec[..., 0], dec[..., 3] - dec[..., 1]], axis=-1)
    pos = state_cur[None, None, :2] + jnp.cumsum(delta * rep[..., None], axis=1)
    return {"state_seqs": pos[..., None, :]}


def _toy_planner(target, **kw):
    def evaluate(state_seqs, act_seqs, state_cur=None):
        return {"reward_seqs": -torch.linalg.norm(state_seqs[:, -1, 0] - target, dim=-1)}

    cfg = PlannerConfig(action_dim=4, model_rollout_fn=toy_rollout, evaluate_traj_fn=evaluate,
                        n_look_ahead=1, reward_weight=50.0,
                        action_lower_lim=[-3.0, -3.0, -np.pi, 2.0],
                        action_upper_lim=[3.0, 3.0, np.pi, 10.0], noise_level=0.5, device="cpu",
                        **kw)
    return Planner(cfg)


def test_mppi_planner_converges_to_target():
    target = torch.tensor([0.5, 0.3])
    planner = _toy_planner(target, n_sample=256, n_update_iter=5)
    act0 = torch.zeros(1, 4)
    act0[0, 3] = 5.0
    res = planner.trajectory_optimization(torch.zeros(2), act0, torch.Generator().manual_seed(0))
    final = toy_rollout(torch.zeros(2), res["act_seq"][None])["state_seqs"][0, -1, 0]
    assert float(torch.linalg.norm(final - target)) < 0.2
    assert float(res["best_reward"]) > -0.25
    assert res["best_eval_output"]["reward_seqs"].shape == (1,)


def test_gd_planner_improves_reward():
    """The JAX case (Adam through the toy model from 64 correlated samples)
    on the samples the JAX planner draws from its key: the result within 0.3
    of the target, as there, and within 1e-4 of the JAX planner's."""
    target = torch.tensor([0.4, 0.2])
    lo, hi = np.array([-3.0, -3.0, -np.pi, 2.0], np.float32), np.array([3.0, 3.0, np.pi, 10.0],
                                                                        np.float32)
    act0 = np.array([[0.0, 0.0, 0.0, 5.0]], np.float32)
    key = jax.random.PRNGKey(2)
    samples = jax_actions.sample_action_seq_correlated(jax.random.split(key)[1], jnp.asarray(act0),
                                                       lo, hi, 64, noise_level=0.5)
    want = JaxPlanner(JaxPlannerConfig(
        action_dim=4, model_rollout_fn=jax_toy_rollout,
        evaluate_traj_fn=lambda s, a, state_cur=None: {
            "reward_seqs": -jnp.linalg.norm(s[:, -1, 0] - jnp.asarray(target.numpy()), axis=-1)},
        n_sample=64, n_look_ahead=1, n_update_iter=40, reward_weight=50.0,
        action_lower_lim=jnp.asarray(lo), action_upper_lim=jnp.asarray(hi), noise_level=0.5,
        planner_type="GD", lr=3e-2)).trajectory_optimization(jnp.zeros(2), jnp.asarray(act0), key)
    planner = _toy_planner(target, n_sample=64, n_update_iter=40, planner_type="GD", lr=3e-2,
                           sampling_action_seq_fn=lambda g, a, iter_index=0: torch.tensor(
                               np.asarray(samples)))
    res = planner.trajectory_optimization(torch.zeros(2), act0, torch.Generator().manual_seed(2))
    final = toy_rollout(torch.zeros(2), res["act_seq"][None])["state_seqs"][0, -1, 0]
    assert float(torch.linalg.norm(final - target)) < 0.3
    np.testing.assert_allclose(res["act_seq"].numpy(), np.asarray(want["act_seq"]), atol=1e-4,
                               rtol=0)


def test_merge_res_picks_best_chunk():
    res = [{"act_seq": torch.tensor([1.0]), "best_eval_output": {"reward_seqs": torch.tensor([-3.0])}},
           {"act_seq": torch.tensor([2.0]), "best_eval_output": {"reward_seqs": torch.tensor([-1.0])}}]
    assert float(Planner.merge_res(res)["act_seq"][0]) == 2.0


@pytest.mark.parametrize("planner_type", ["MPPI", "GD"])
def test_planner_on_the_gnn_matches_jax(planner_type):
    """MPPI (2 iterations) and gradient descent (4 Adam steps) through the
    GNN rollout, with the same injected samples on both sides: the chosen
    act_seq within 1e-4 of JAX's, the best reward within 1e-5."""
    jp, params = _params(3)
    state = _state(False, seed=3)
    n, L, iters = 12, 2, 2 if planner_type == "MPPI" else 4
    samples = [_actions(n, L, seed=10 + i) for i in range(iters)]
    common = dict(action_dim=4, n_sample=n, n_look_ahead=L, n_update_iter=iters,
                  reward_weight=20.0, planner_type=planner_type, lr=1e-2)

    def jax_model(s, a):
        return jax_dynamics_rollout(jp, s, a, jnp.asarray(PHYS), JDCFG)

    jplanner = JaxPlanner(JaxPlannerConfig(
        model_rollout_fn=jax_model, evaluate_traj_fn=_jax_reward,
        action_lower_lim=jnp.asarray(ACT_LO), action_upper_lim=jnp.asarray(ACT_HI),
        sampling_action_seq_fn=lambda k, a, iter_index=0: jnp.asarray(samples[iter_index]),
        **common))
    want = jplanner.trajectory_optimization(jnp.asarray(state), jnp.asarray(samples[0][0]),
                                            jax.random.PRNGKey(0))

    def model(s, a):
        return dynamics_rollout(params, s, a, torch.tensor(PHYS), DCFG)

    planner = Planner(PlannerConfig(
        model_rollout_fn=model, evaluate_traj_fn=_reward, action_lower_lim=ACT_LO,
        action_upper_lim=ACT_HI, device="cpu",
        sampling_action_seq_fn=lambda g, a, iter_index=0: torch.tensor(samples[iter_index]),
        **common))
    got = planner.trajectory_optimization(torch.tensor(state), samples[0][0],
                                          torch.Generator().manual_seed(0))
    np.testing.assert_allclose(got["act_seq"].numpy(), np.asarray(want["act_seq"]), atol=1e-4,
                               rtol=0)
    close(got["best_reward"], want["best_reward"])
    close(got["best_model_output"]["state_seqs"], want["best_model_output"]["state_seqs"])
