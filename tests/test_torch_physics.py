"""Port physics-parameter estimation against the JAX package: the population
error, the optimizer on recorded interactions, and the demo-ppo CLI."""

import dataclasses
import os

import jax
import numpy as np
import pytest
import torch
import yaml

import adaptigraph_tpu.cli as jax_cli
from adaptigraph_tpu.models.gnn import init_params
from adaptigraph_tpu.planning.forward import dynamics_masked as jax_dynamics_masked
from adaptigraph_tpu.planning.physics_optimizer import \
    PhysicsParamOnlineOptimizer as JaxOptimizer
from adaptigraph_tpu.planning.physics_optimizer import \
    dynamics_error_population as jax_error_population
from adaptigraph_tpu.utils.checkpoint import save_checkpoint
from adaptigraph_tpu.utils.config import load_planning_config as jax_load_planning_config
from adaptigraph_tpu_torch import cli
from adaptigraph_tpu_torch.models.gnn import params_from_numpy
from adaptigraph_tpu_torch.planning.physics_optimizer import (PhysicsParamOnlineOptimizer,
                                                              dynamics_error_population)
from adaptigraph_tpu_torch.utils.config import load_planning_config

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(nf_particle=16, nf_relation=16, nf_effect=16, pstep=2, max_nobj=20)


def _tiny_dcfg(jax_side):
    """The rope dynamics cut to a tiny model, as tests/test_cli.py does."""
    if jax_side:
        d = jax_cli._task_objects(jax_load_planning_config("rope"))[0].dcfg
    else:
        d = cli._task_objects(load_planning_config("rope"))[0].dcfg
    return dataclasses.replace(d, gnn=dataclasses.replace(d.gnn, **TINY),
                               edge=dataclasses.replace(d.edge, max_nobj=20, topk=5),
                               max_repeat=3)


def _record(jd, jp, save_dir, n=2, phys=0.3):
    """Interactions whose real outcome is the JAX model's at ``phys``."""
    ppo = JaxOptimizer(jd, jp, phys_dim=1, save_dir=save_dir)
    rng = np.random.RandomState(0)
    for _ in range(n):
        k = 15
        st = rng.randn(k, 3).astype(np.float32) * 0.3
        act = np.array([-1.0, 0.0, 0.0, 2.0], np.float32)
        sp = np.zeros((20, 3), np.float32)
        sp[:k] = st
        m = np.zeros(20, bool)
        m[:k] = True
        real = np.asarray(jax_dynamics_masked(jp, sp[None], m[None], act[None],
                                              np.asarray([[phys]], np.float32), jd)[0])
        ppo.add_interaction(act, st, real[:k], real[:k])
    return ppo


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    jd, td = _tiny_dcfg(True), _tiny_dcfg(False)
    jp = jax.tree_util.tree_map(np.asarray, init_params(jax.random.PRNGKey(0), jd.gnn))
    d = str(tmp_path_factory.mktemp("ppo"))
    ppo = _record(jd, jp, d)
    return jd, td, jp, d, ppo


def test_error_population_matches_jax(tiny):
    jd, td, jp, _, ppo = tiny
    inter = ppo._stacked()
    cand = np.linspace(-0.2, 1.2, 11, dtype=np.float32)[:, None]
    want = np.asarray(jax_error_population(jp, inter, cand, jd))
    got = dynamics_error_population(params_from_numpy(jp, "cpu"), inter, cand, td, device="cpu",
                                    compute_dtype=torch.float32).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_optimizer_matches_jax_estimate(tiny):
    jd, td, jp, d, _ = tiny
    want_ppo = JaxOptimizer(jd, jp, phys_dim=1)
    want_ppo.load_interactions(d)
    want_est, _, _ = want_ppo.optimize(iterations=10)
    ppo = PhysicsParamOnlineOptimizer(td, params_from_numpy(jp, "cpu"), phys_dim=1, device="cpu",
                                      compute_dtype=torch.float32)
    ppo.load_interactions(d)
    est, err, err0 = ppo.optimize(iterations=10)
    assert err <= err0 + 1e-9
    assert abs(float(est[0]) - float(want_est[0])) <= 0.02


def _tiny_config_files(tmp, jd, jp):
    """A planning and a dynamics yaml for the tiny model, and its checkpoint."""
    with open(os.path.join(ROOT, "adaptigraph_tpu", "configs", "dynamics", "rope.yaml")) as f:
        dyn = yaml.safe_load(f)
    dyn["model_config"].update(nf_particle=16, nf_relation=16, nf_effect=16, pstep=2)
    dyn["dataset_config"]["datasets"][0].update(max_nobj=20, topk=5)
    dyn_path = os.path.join(tmp, "tiny_rope_dynamics.yaml")
    with open(dyn_path, "w") as f:
        yaml.safe_dump(dyn, f)
    with open(os.path.join(ROOT, "adaptigraph_tpu", "configs", "planning", "rope.yaml")) as f:
        plan = yaml.safe_load(f)
    plan["task_config"].update(config=dyn_path, action_lower_lim=[-4.5, -4.5, -3.14, 2],
                               action_upper_lim=[4.5, 4.5, 3.14, 3])
    plan_path = os.path.join(tmp, "tiny_rope_planning.yaml")
    with open(plan_path, "w") as f:
        yaml.safe_dump(plan, f)
    save_checkpoint(tmp, 0, jp)
    return plan_path


def test_demo_ppo_cli_cpu(tiny, tmp_path, capsys):
    """demo-ppo through the port's CLI with --device cpu on the same files as
    the JAX CLI, in float32 as the JAX package runs on the CPU: the error
    does not grow and the estimates agree."""
    jd, _, jp, d, _ = tiny
    plan = _tiny_config_files(str(tmp_path), jd, jp)
    jax_cli.main(["demo-ppo", "--config", plan, "--load_dir", d, "--ckpt_dir", str(tmp_path),
                  "--iterations", "10"])
    want = capsys.readouterr().out
    est, err, err0 = cli.main(["demo-ppo", "--config", plan, "--load_dir", d,
                               "--ckpt_dir", str(tmp_path), "--iterations", "10",
                               "--device", "cpu"])
    assert "physics estimate" in capsys.readouterr().out
    want_est = float(want.split("[")[1].split("]")[0])
    assert err <= err0 + 1e-9
    assert abs(float(est[0]) - want_est) <= 0.02


def test_cli_cuda_without_card_exits(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(SystemExit, match="no CUDA device"):
        cli.main(["demo-ppo", "--config", "rope", "--load_dir", str(tmp_path),
                  "--ckpt_dir", str(tmp_path)])


def test_granular_fixture_curve_matches_jax():
    """The granular demo fixture at its full width (its 5 recorded
    interactions, the trained checkpoint, 105 nodes, K 20): the port's error
    curve over 9 candidates in [0, 0.5] against the JAX optimizer's
    ``evaluate``, float32 on both sides, and the same argmin."""
    from adaptigraph_tpu.utils.checkpoint import load_checkpoint as jax_load_checkpoint

    fixture = os.path.join(ROOT, "fixtures", "granular_demo")
    jt, _ = jax_cli._task_objects(jax_load_planning_config("granular"))
    tt, _ = cli._task_objects(load_planning_config("granular"))
    assert (tt.dcfg.gnn.n_nodes, tt.dcfg.edge.topk, tt.dcfg.gnn.nf_effect) == (105, 20, 128)
    grid = np.linspace(0.0, 0.5, 9, dtype=np.float32)[:, None]
    # no padding rows: the padded rows repeat real ones and leave the means as they are
    want_ppo = JaxOptimizer(jt.dcfg, jax_load_checkpoint(fixture), phys_dim=1, pad_i=1, pad_p=1)
    want_ppo.load_interactions(fixture)
    ppo = PhysicsParamOnlineOptimizer(tt.dcfg, cli.load_params(fixture, tt.dcfg.gnn, "cpu"),
                                      phys_dim=1, pad_i=1, pad_p=1, device="cpu",
                                      compute_dtype=torch.float32)
    ppo.load_interactions(fixture)
    assert len(ppo._interactions) == len(want_ppo._interactions) == 5
    want, got = want_ppo.evaluate(grid), ppo.evaluate(grid)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=0)
    assert int(np.argmin(got)) == int(np.argmin(want))
