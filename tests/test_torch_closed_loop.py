"""The port's closed loop (``run_plan``, ``run_random_interact``) and its CLI
against the JAX package, on fresh sim-backed environments with a tiny model
on the CPU (float32, the plain versions; JAX through its XLA path)."""

import dataclasses
import glob
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import adaptigraph_tpu.planning.mppi_solve as jax_mppi
from adaptigraph_tpu.models.gnn import GNNConfig as JaxGNNConfig
from adaptigraph_tpu.models.gnn import init_params
from adaptigraph_tpu.ops.graph import EdgeConfig as JaxEdgeConfig
from adaptigraph_tpu.planning import closed_loop as jax_closed_loop
from adaptigraph_tpu.planning.forward import DynamicsConfig as JaxDynamicsConfig
from adaptigraph_tpu.realworld.env import SimRealEnv as JaxSimRealEnv
import adaptigraph_tpu_torch.planning.mppi_solve as mppi
from adaptigraph_tpu_torch import cli
from adaptigraph_tpu_torch.models.gnn import GNNConfig, params_from_numpy
from adaptigraph_tpu_torch.ops.graph import EdgeConfig
from adaptigraph_tpu_torch.planning import closed_loop
from adaptigraph_tpu_torch.planning.forward import DynamicsConfig
from adaptigraph_tpu_torch.realworld import detect
from adaptigraph_tpu_torch.realworld.env import SimRealEnv
from test_torch_jaxsim import jax_sim_built_here  # noqa: F401  (autouse)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from chip_smoke import colour_box_detector  # noqa: E402  (the smoke's detector, at the repo root)

torch.set_num_threads(2)
LOWER = np.asarray([-3.0, -3.0, -np.pi, 1.0], np.float32)
UPPER = np.asarray([3.0, 3.0, np.pi, 3.0], np.float32)
GNN_KW = dict(n_his=2, max_nobj=20, max_neef=1, nf_particle=16, nf_relation=16, nf_effect=16,
              pstep=2)
TOL = 1e-4


def make_task(jax_side=False, n_sample=8, chunk=4, **kw):
    """The tiny rope task of tests/test_closed_loop.py, on either side."""
    G, E, D, M, T = ((JaxGNNConfig, JaxEdgeConfig, JaxDynamicsConfig, jax_mppi.MPPIConfig,
                      jax_closed_loop.TaskConfig) if jax_side else
                     (GNNConfig, EdgeConfig, DynamicsConfig, mppi.MPPIConfig,
                      closed_loop.TaskConfig))
    dcfg = D(gnn=G(**GNN_KW), edge=E(max_nobj=20, max_neef=1, topk=5), n_his=2,
             push_length=0.1, max_repeat=3, adj_thresh=0.8)
    mcfg = M(n_sample=n_sample, n_sample_chunk=chunk, n_look_ahead=1, n_update_iter=1,
             reward_weight=50.0)
    extra = {"use_fused": False} if jax_side else {}
    return T(dcfg=dcfg, mcfg=mcfg, action_lower_lim=LOWER, action_upper_lim=UPPER, n_actions=2,
             fps_radius=0.35, ppo_iterations=6, **extra, **kw)


@pytest.fixture(scope="module")
def weights():
    jp = jax.tree_util.tree_map(np.asarray,
                                init_params(jax.random.PRNGKey(0), JaxGNNConfig(**GNN_KW)))
    return jp, params_from_numpy(jp, "cpu")


def target_near(env, offset=(0.3, 0.0, 0.2)):
    return env.get_particles_sim().mean(0)[None] + np.array([offset], np.float32)


def test_sim_action_to_board_matches_jax():
    rng = np.random.RandomState(0)
    for act in rng.uniform([-4, -4, -np.pi, 1], [4, 4, np.pi, 10], (16, 4)).astype(np.float32):
        np.testing.assert_allclose(closed_loop.sim_action_to_board(act, 10.0),
                                   jax_closed_loop.sim_action_to_board(act, 10.0),
                                   rtol=1e-6, atol=1e-7)
    act = np.array([1.0, -0.5, 0.3, 2.0], np.float32)
    b = closed_loop.sim_action_to_board(act, 10.0)
    np.testing.assert_allclose(b[:2] * 10.0, act[:2], rtol=1e-5)
    d = np.array([b[2] - b[0], b[3] - b[1]])
    np.testing.assert_allclose(np.arctan2(-d[1], -d[0]), act[2], atol=1e-4)


def test_pad_state_matches_jax():
    st = np.random.RandomState(1).randn(7, 3).astype(np.float32)
    for n in (5, 7, 20):
        got, want = closed_loop._pad_state(st, n), jax_closed_loop._pad_state(st, n)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1] == want[1]


def _sample_keys(seed, n_solves):
    """The key each of the JAX loop's first solve iterations samples with:
    ``run_plan`` splits its key once per solve, the solve once per iteration."""
    key, out = jax.random.PRNGKey(seed), []
    for _ in range(n_solves):
        key, k = jax.random.split(key)
        out.append(jax.random.split(k)[1])
    return out


def _uniform_samples(key, n, L):
    u = jax.random.uniform(key, (n, L, 4), jnp.float32)
    return LOWER + (UPPER - LOWER) * u


def run_plans_with_identical_samples(monkeypatch, tmp_path, weights, use_ppo, n_steps=3,
                                     pm_factory=None, **task_kw):
    """Both loops on fresh environments with the same seed; the k-th solve of
    each gets the same samples (uniform over the action box, drawn with the
    key the JAX loop gives its k-th solve). ``pm_factory(jax_side)`` gives
    each side's PerceptionModule. Returns (JAX's history, the port's)."""
    jp, tp = weights
    seed, n_sample = 2, 16
    keys = _sample_keys(seed, n_steps)
    calls = []

    def port_sampler(gen, act_seq, lo, hi, n, iter_index=0, **kw):
        calls.append(n)
        return torch.tensor(np.asarray(_uniform_samples(keys[len(calls) - 1], n,
                                                        act_seq.shape[0])))

    monkeypatch.setattr(jax_mppi, "sample_action_seq",
                        lambda key, act_seq, lo, hi, n, iter_index=0, **kw:
                        _uniform_samples(key, n, act_seq.shape[0]))
    monkeypatch.setattr(mppi, "sample_action_seq", port_sampler)

    hists = []
    for jax_side in (True, False):
        task = make_task(jax_side, n_sample=n_sample, chunk=8, penalty_type="rope", **task_kw)
        task.n_actions = n_steps
        Env, run = ((JaxSimRealEnv, jax_closed_loop.run_plan) if jax_side else
                    (SimRealEnv, closed_loop.run_plan))
        env = Env("rope", seed=seed, img_size=240)
        kw = {} if jax_side else {"device": "cpu"}
        if pm_factory is not None:
            kw["pm"] = pm_factory(jax_side)
        hists.append(run(env, jp if jax_side else tp, task, target_near(env),
                         save_dir=str(tmp_path / ("jax" if jax_side else "port")), seed=seed,
                         use_ppo=use_ppo, verbose=False, true_phys=np.array([0.4], np.float32),
                         **kw))
    assert len(calls) == n_steps
    return hists


def assert_plans_agree(want, got, tmp_path, use_ppo, n_steps=3):
    """Per step the executed actions, errors, predicted errors and estimates
    agree, and so do the files the two loops wrote."""
    assert len(got["errors"]) == len(want["errors"]) == n_steps
    for a, b in zip(got["actions"], want["actions"]):
        np.testing.assert_allclose(a, b, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got["errors"], want["errors"], rtol=TOL, atol=TOL)
    assert got["initial_error"] == pytest.approx(want["initial_error"], rel=TOL, abs=TOL)
    np.testing.assert_allclose(got["true_phys"], want["true_phys"])
    if use_ppo:
        np.testing.assert_allclose(np.stack(got["phys"]), np.stack(want["phys"]),
                                   rtol=TOL, atol=TOL)
        np.testing.assert_allclose(got["final_phys"], want["final_phys"], rtol=TOL, atol=TOL)
    else:
        assert got["final_phys"] is None and want["final_phys"] is None
    names = sorted(os.listdir(tmp_path / "jax"))
    assert sorted(os.listdir(tmp_path / "port")) == names
    for name in names:
        with np.load(tmp_path / "jax" / name) as w, np.load(tmp_path / "port" / name) as g:
            assert sorted(g.files) == sorted(w.files), name
            for k in w.files:
                if g[k].dtype == bool:
                    np.testing.assert_array_equal(g[k], w[k], err_msg=f"{name}:{k}")
                else:
                    np.testing.assert_allclose(g[k], w[k], rtol=TOL, atol=TOL,
                                               err_msg=f"{name}:{k}")


@pytest.mark.parametrize("use_ppo", [True, False], ids=["ppo", "no_ppo"])
def test_run_plan_matches_jax_with_identical_samples(monkeypatch, tmp_path, weights, use_ppo):
    """The two loops with identical samples per solve agree step by step."""
    want, got = run_plans_with_identical_samples(monkeypatch, tmp_path, weights, use_ppo)
    assert_plans_agree(want, got, tmp_path, use_ppo)


def test_run_plan_closed_loop(tmp_path, weights):
    env = SimRealEnv("rope", seed=0, img_size=320)
    hist = closed_loop.run_plan(env, weights[1], make_task(), target_near(env),
                                save_dir=str(tmp_path), seed=0, use_ppo=True, verbose=False,
                                device="cpu")
    assert len(hist["errors"]) == 2
    assert all(np.isfinite(hist["errors"]))
    assert hist["final_phys"] is not None and hist["final_phys"].shape == (1,)
    assert np.isfinite(hist["initial_error"])
    for name in ("step_000.npz", "interaction_000.npz", "ppo_1.npz"):
        assert os.path.exists(tmp_path / name)
    assert float(np.load(tmp_path / "initial.npz")["error"]) == pytest.approx(
        hist["initial_error"])


def test_run_plan_resume(tmp_path, weights):
    """A second run with resume re-hydrates the completed steps and
    interactions and executes only the remaining actions."""
    env = SimRealEnv("rope", seed=0, img_size=320)
    target = target_near(env)
    h1 = closed_loop.run_plan(env, weights[1], make_task(), target, save_dir=str(tmp_path),
                              seed=0, use_ppo=True, verbose=False, device="cpu")
    assert len(h1["errors"]) == 2
    task3 = make_task()
    task3.n_actions = 3
    h2 = closed_loop.run_plan(env, weights[1], task3, target, save_dir=str(tmp_path), seed=0,
                              use_ppo=True, verbose=False, resume=True, device="cpu")
    assert len(h2["errors"]) == 3
    np.testing.assert_allclose(h2["errors"][:2], h1["errors"], rtol=1e-6)
    assert h2["initial_error"] == pytest.approx(h1["initial_error"])
    assert len(h2["phys"]) == 3
    assert os.path.exists(tmp_path / "step_002.npz")


def test_run_random_interact(tmp_path, weights):
    env = SimRealEnv("granular", seed=1, img_size=320)
    task = make_task(penalty_type="granular")
    ppo = closed_loop.run_random_interact(env, weights[1], task, save_dir=str(tmp_path), seed=1,
                                          n_actions=2, verbose=False, device="cpu")
    assert len(ppo._interactions) == 2
    ppo2 = closed_loop.run_random_interact(env, weights[1], task, save_dir=str(tmp_path),
                                           seed=1, n_actions=3, verbose=False, resume=True,
                                           device="cpu")
    assert len(ppo2._interactions) == 3
    est, err, err0 = ppo.optimize(iterations=6)
    assert np.isfinite(err) and est.shape == (1,)


def test_run_random_interact_matches_jax_with_identical_samples(monkeypatch, tmp_path, weights):
    """Both exploration loops with the same samples per solve record the same
    interactions (JAX keys its loop with seed + 1)."""
    jp, tp = weights
    seed, n = 1, 2
    keys = _sample_keys(seed + 1, n)
    calls = []

    def port_sampler(gen, act_seq, lo, hi, n_s, iter_index=0, **kw):
        calls.append(n_s)
        return torch.tensor(np.asarray(_uniform_samples(keys[len(calls) - 1], n_s,
                                                        act_seq.shape[0])))

    monkeypatch.setattr(jax_mppi, "sample_action_seq",
                        lambda key, act_seq, lo, hi, n_s, iter_index=0, **kw:
                        _uniform_samples(key, n_s, act_seq.shape[0]))
    monkeypatch.setattr(mppi, "sample_action_seq", port_sampler)
    want = jax_closed_loop.run_random_interact(
        JaxSimRealEnv("granular", seed=seed, img_size=240), jp,
        make_task(True, penalty_type="granular"), save_dir=str(tmp_path / "jax"), seed=seed,
        n_actions=n, verbose=False)
    got = closed_loop.run_random_interact(
        SimRealEnv("granular", seed=seed, img_size=240), tp, make_task(penalty_type="granular"),
        save_dir=str(tmp_path / "port"), seed=seed, n_actions=n, verbose=False, device="cpu")
    assert len(calls) == n
    for w, g in zip(want._interactions, got._interactions):
        for k in ("act", "state_init", "state_real", "state_pred"):
            np.testing.assert_allclose(g[k], w[k], rtol=TOL, atol=TOL, err_msg=k)


def test_plan_improvement_gate_stops_regression(tmp_path, weights):
    """verify_improvement: with the target at the current state no push can
    improve, so the loop stops instead of executing regressing pushes."""
    env = SimRealEnv("rope", seed=0, img_size=320)
    task = make_task(verify_improvement=True, verify_retries=1, converge_tolerance=1e9)
    task.n_actions = 4
    hist = closed_loop.run_plan(env, weights[1], task, env.get_particles_sim().copy(),
                                save_dir=str(tmp_path), seed=0, use_ppo=False, verbose=False,
                                device="cpu")
    assert len(hist["errors"]) <= 3


def test_gripper_dispatch(tmp_path, weights):
    """gripper_enable tasks execute through env.step_gripper, not env.step."""
    env = SimRealEnv("rope", seed=0, img_size=320)
    calls = {"push": 0, "grasp": 0}
    orig_push, orig_grasp = env.step, env.step_gripper
    env.step = lambda a: (calls.__setitem__("push", calls["push"] + 1), orig_push(a))[1]
    env.step_gripper = lambda a: (calls.__setitem__("grasp", calls["grasp"] + 1),
                                  orig_grasp(a))[1]
    task = make_task()
    task.dcfg = dataclasses.replace(task.dcfg, gripper_enable=True)
    task.n_actions = 1
    closed_loop.run_plan(env, weights[1], task, target_near(env), save_dir=str(tmp_path), seed=0,
                         use_ppo=False, verbose=False, device="cpu")
    assert calls == {"push": 0, "grasp": 1}


def test_run_plan_adaptation_arms(tmp_path, weights):
    """true_phys is recorded, phys_override plans with a fixed parameter, and
    ppo_warmup records excitation pushes before the plan steps."""
    env = SimRealEnv("rope", seed=3, img_size=320)
    target = target_near(env)
    task = make_task()
    truth = np.array([0.7], np.float32)
    hist = closed_loop.run_plan(env, weights[1], task, target, save_dir=str(tmp_path / "a"),
                                seed=3, use_ppo=True, verbose=False, true_phys=truth,
                                ppo_warmup=2, device="cpu")
    np.testing.assert_allclose(hist["true_phys"], truth)
    np.testing.assert_allclose(np.load(tmp_path / "a" / "initial.npz")["true_phys"], truth)
    # 2 warm-up pushes + 2 plan steps
    assert len(glob.glob(str(tmp_path / "a" / "interaction_*.npz"))) == 4
    step = np.load(tmp_path / "a" / "step_000.npz")
    assert np.isfinite(float(step["pred_error"]))
    assert step["pred_state"].shape[1] == 3

    env2 = SimRealEnv("rope", seed=3, img_size=320)
    hist2 = closed_loop.run_plan(env2, weights[1], task, target, save_dir=str(tmp_path / "b"),
                                 seed=3, use_ppo=False, verbose=False, phys_override=truth,
                                 device="cpu")
    assert hist2["final_phys"] is None
    assert len(hist2["errors"]) == 2


def _tiny_cli_task(monkeypatch):
    """The port CLI's task objects cut to the tiny model and a tiny budget."""
    real = cli._task_objects

    def tiny(task):
        tcfg, config = real(task)
        d = tcfg.dcfg
        gnn = dataclasses.replace(d.gnn, nf_particle=16, nf_relation=16, nf_effect=16, pstep=2,
                                  max_nobj=20)
        tcfg.dcfg = dataclasses.replace(d, gnn=gnn, edge=dataclasses.replace(d.edge, max_nobj=20,
                                                                             topk=5),
                                        max_repeat=3)
        tcfg.action_lower_lim, tcfg.action_upper_lim = LOWER, UPPER
        tcfg.mcfg = dataclasses.replace(tcfg.mcfg, n_sample=8, n_sample_chunk=4)
        tcfg.ppo_iterations = 4
        return tcfg, config

    monkeypatch.setattr(cli, "_task_objects", tiny)


def test_plan_cli_cpu(monkeypatch, tmp_path, capsys):
    """``plan`` through the port's CLI on the CPU (random weights, the
    colour-mask perception path): the files and the true parameter."""
    _tiny_cli_task(monkeypatch)
    save = tmp_path / "plan"
    hist = cli.main(["plan", "--config", "rope", "--n_actions", "2", "--seed", "0",
                     "--save_dir", str(save), "--sim_mask", "--device", "cpu"])
    assert "plan done" in capsys.readouterr().out
    assert len(hist["errors"]) == 2 and all(np.isfinite(hist["errors"]))
    assert hist["true_phys"].shape == (1,)
    for name in ("initial.npz", "step_000.npz", "step_001.npz", "ppo_1.npz"):
        assert os.path.exists(save / name), name
    assert np.load(save / "initial.npz")["true_phys"].shape == (1,)


def test_plan_cli_target_matches_jax(monkeypatch):
    """The default point-cloud target, resampled to max_nobj points with the
    seed, is the JAX command's."""
    import adaptigraph_tpu.cli as jax_cli
    from adaptigraph_tpu.utils.config import load_planning_config as jax_load

    from adaptigraph_tpu_torch.utils.config import load_planning_config

    args = cli.build_parser().parse_args(["plan", "--config", "rope", "--seed", "4"])
    tcfg, _ = cli._task_objects(load_planning_config("rope"))
    got = cli._plan_target(args, tcfg, SimRealEnv("rope", seed=4, img_size=16))
    jtcfg, _ = jax_cli._task_objects(jax_load("rope"))
    env = JaxSimRealEnv("rope", seed=4, img_size=16)
    target = env.get_particles_sim() + np.array([0.5, 0.0, 0.3], np.float32)
    idx = np.random.RandomState(4).choice(len(target), jtcfg.dcfg.gnn.max_nobj,
                                          replace=len(target) < jtcfg.dcfg.gnn.max_nobj)
    np.testing.assert_array_equal(got, target[idx])


def test_random_interact_cli_cpu(monkeypatch, tmp_path, capsys):
    _tiny_cli_task(monkeypatch)
    est, err, err0 = cli.main(["random-interact", "--config", "rope", "--n_actions", "2",
                               "--save_dir", str(tmp_path), "--device", "cpu"])
    assert "random-interact done" in capsys.readouterr().out
    assert est.shape == (1,) and np.isfinite(err) and err <= err0 + 1e-9
    assert len(glob.glob(str(tmp_path / "interaction_*.npz"))) == 2


@pytest.mark.parametrize("flag", ["--mesh", "--learned_perception"])
def test_plan_cli_refuses_left_out_flags(monkeypatch, tmp_path, capsys, flag):
    """``--mesh``: a mesh of more cards than there are is refused before
    anything runs. ``--learned_perception`` parses and plans, with
    ``make_mask_fn`` giving a GroundedSAMMask whose detector is driven by the
    render (``chip_smoke.py``'s) and whose segmenter is ``boxes_to_masks`` (no
    weights loaded):
    every perception goes through its keep-mask, once per camera."""
    if flag == "--mesh":
        monkeypatch.setattr("torch.cuda.is_available", lambda: True)
        monkeypatch.setattr("torch.cuda.device_count", lambda: 1)
        with pytest.raises(SystemExit, match="a mesh of 2 needs 2"):
            cli.main(["plan", "--config", "rope", "--mesh", "2"])
        return
    _tiny_cli_task(monkeypatch)
    made, calls = [], []

    def make_mask_fn(obj_prompts, max_n=1, box_threshold=0.5, device="cuda"):
        made.append((tuple(obj_prompts), max_n, str(device)))
        gm = detect.GroundedSAMMask(obj_prompts, max_n=max_n, detector=colour_box_detector(),
                                    segmenter=detect.boxes_to_masks, device=device)
        return lambda rgb: calls.append(1) or gm(rgb)

    perceptions = []
    real_perceive = closed_loop.get_state_cur

    def perceive(env, *a, **k):
        perceptions.append(env.n_cameras)
        return real_perceive(env, *a, **k)

    monkeypatch.setattr(detect, "make_mask_fn", make_mask_fn)
    monkeypatch.setattr(closed_loop, "get_state_cur", perceive)
    hist = cli.main(["plan", "--config", "rope", "--n_actions", "2", "--seed", "0",
                     "--save_dir", str(tmp_path), "--learned_perception", "--device", "cpu"])
    assert "plan done" in capsys.readouterr().out
    assert made == [(("rope",), 1, "cpu")]
    assert len(hist["errors"]) == 2 and all(np.isfinite(hist["errors"]))
    assert perceptions and set(perceptions) == {4}
    assert len(calls) == sum(perceptions)


@pytest.mark.parametrize("argv", [["plan", "--config", "rope"],
                                  ["random-interact", "--config", "rope"],
                                  ["perception", "--calibrate"]], ids=lambda a: a[0])
def test_plan_commands_default_to_cuda(monkeypatch, argv):
    assert cli.build_parser().parse_args(argv).device == "cuda"
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        cli.main(argv)


def test_loops_default_to_cuda():
    import inspect

    for fn in (closed_loop.run_plan, closed_loop.run_random_interact):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
