"""``dynamics_masked`` for a tool edge policy (cloth's ``tools_all``, gated on
contact, with the gripper lift) on CPU tensors (the graph build and K2's
plain version, float32) against the JAX ``dynamics_masked`` (the vmapped
per-sample XLA rollout), at a small width (20 objects, topk 5, nf 32,
pstep 2, max_repeat 3), per-sample masks and physics; each sample's error
held to the float32 whole-push bound graded by its repeat (2e-3 / 8e-3 /
3e-2, tests/test_fused.py's); and the physics optimizer's population error
on the cloth task through it."""

import dataclasses
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import adaptigraph_tpu.cli as jax_cli
from adaptigraph_tpu.models.gnn import init_params
from adaptigraph_tpu.planning import forward as jax_forward
from adaptigraph_tpu.planning.physics_optimizer import \
    dynamics_error_population as jax_error_population
from adaptigraph_tpu.utils.config import load_planning_config as jax_load_planning_config
from adaptigraph_tpu_torch import cli
from adaptigraph_tpu_torch.models.gnn import params_from_numpy
from adaptigraph_tpu_torch.ops import fused_gnn
from adaptigraph_tpu_torch.planning import forward
from adaptigraph_tpu_torch.planning.physics_optimizer import (PhysicsParamOnlineOptimizer,
                                                              dynamics_error_population)
from adaptigraph_tpu_torch.sim.synthetic import cloth_sheet
from adaptigraph_tpu_torch.utils.config import load_planning_config

torch.set_num_threads(2)
B = 8


def graded(r):
    return 2e-3 if r <= 1 else 8e-3 if r <= 4 else 3e-2


def _cloth_dcfg(jax_side):
    """The cloth task's dynamics cut to the small width, max_repeat 3."""
    if jax_side:
        d = jax_cli._task_objects(jax_load_planning_config("cloth"))[0].dcfg
    else:
        d = cli._task_objects(load_planning_config("cloth"))[0].dcfg
    gnn = dataclasses.replace(d.gnn, nf_particle=32, nf_relation=32, nf_effect=32, pstep=2,
                              max_nobj=20)
    return dataclasses.replace(d, gnn=gnn, edge=dataclasses.replace(d.edge, max_nobj=20),
                               max_repeat=3)


@pytest.fixture(scope="module")
def setup():
    jd, td = _cloth_dcfg(True), _cloth_dcfg(False)
    assert (td.edge.policy, td.edge.gate_on_contact, td.gripper_enable) == ("tools_all", True, True)
    jp = jax.tree_util.tree_map(np.asarray, init_params(jax.random.PRNGKey(0), jd.gnn))
    rng = np.random.RandomState(0)
    sheet = cloth_sheet(1, 4, 5)
    counts = rng.randint(10, 21, B)
    mask = np.arange(20)[None] < counts[:, None]
    state = (sheet[None] + rng.randn(B, 20, 3) * 0.01).astype(np.float32) * mask[..., None]
    acts = np.stack([rng.uniform(-0.6, 0.6, B), rng.uniform(-0.6, 0.6, B),
                     rng.uniform(-np.pi, np.pi, B), rng.uniform(1.0, 3.99, B)], -1).astype(np.float32)
    phys = rng.rand(B, 1).astype(np.float32)
    return jd, td, jp, state, mask, acts, phys


def test_masked_tool_policy_matches_jax(setup):
    jd, td, jp, state, mask, acts, phys = setup
    want = np.asarray(jax_forward.dynamics_masked(jp, jnp.asarray(state), jnp.asarray(mask),
                                                  jnp.asarray(acts), jnp.asarray(phys), jd))
    launches = (fused_gnn.gnn_forward.launches, fused_gnn.fused_rollout_chunk.launches)
    tp = params_from_numpy(jp, "cpu")
    got = forward.dynamics_masked(tp, torch.tensor(state), torch.tensor(mask), torch.tensor(acts),
                                  torch.tensor(phys), td)
    assert launches == (fused_gnn.gnn_forward.launches, fused_gnn.fused_rollout_chunk.launches)
    repeat = forward.decode_action(torch.tensor(acts)[:, None], td.push_length)[1][:, 0].numpy()
    assert sorted(set(repeat.tolist())) == [1, 2, 3]
    err = (np.abs(got.numpy() - want) * mask[..., None]).reshape(B, -1).max(1)
    assert (err <= [graded(min(int(r), td.max_repeat)) for r in repeat]).all(), err
    # float32 weights from weight_list give the same; other dtypes are refused
    w = fused_gnn.weight_list(tp, td.gnn, torch.float32)
    again = forward.dynamics_masked(w, torch.tensor(state), torch.tensor(mask), torch.tensor(acts),
                                    torch.tensor(phys), td)
    assert torch.equal(got, again)
    with pytest.raises(ValueError, match="float32"):
        forward.dynamics_masked(fused_gnn.weight_list(tp, td.gnn, torch.bfloat16),
                                torch.tensor(state), torch.tensor(mask), torch.tensor(acts),
                                torch.tensor(phys), td)


def test_masked_tool_push_runs_to_the_largest_repeat(setup):
    _, td, jp, state, mask, acts, phys = setup
    calls = []
    real = forward.fused_forward_batch

    def counted(*a, **kw):
        calls.append(kw.get("k_used"))
        return real(*a, **kw)

    acts = acts.copy()
    acts[:, 3] = 1.5  # every push two substeps long at push_length 0.1 x sim_real_ratio 10
    with mock.patch.object(forward, "fused_forward_batch", counted):
        forward.dynamics_masked(params_from_numpy(jp, "cpu"), torch.tensor(state),
                                torch.tensor(mask), torch.tensor(acts), torch.tensor(phys), td)
    repeat = forward.decode_action(torch.tensor(acts)[:, None], td.push_length)[1]
    assert len(calls) == int(repeat.max()) and calls[0] == td.edge.topk + td.edge.max_neef


def test_cloth_population_error_matches_jax(setup):
    """The physics optimizer's population error on cloth interactions: the
    port's, with the optimizer's default (bf16) dtype, which a tool policy's
    float32 forward does not use, against JAX's."""
    jd, td, jp, state, mask, acts, _ = setup
    real = np.array(jax_forward.dynamics_masked(jp, jnp.asarray(state), jnp.asarray(mask),
                                                  jnp.asarray(acts),
                                                  jnp.full((B, 1), 0.3, jnp.float32), jd))
    inter = {"state_init": state, "init_mask": mask, "state_real": real, "real_mask": mask,
             "act": acts}
    cand = np.linspace(-0.2, 1.2, 5, dtype=np.float32)[:, None]
    want = np.asarray(jax_error_population(jp, inter, cand, jd))
    ppo = PhysicsParamOnlineOptimizer(td, params_from_numpy(jp, "cpu"), device="cpu")
    assert ppo.compute_dtype == torch.bfloat16
    got = dynamics_error_population(ppo.params, inter, cand, td, device="cpu",
                                    compute_dtype=ppo.compute_dtype).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4)
    assert int(np.argmin(got)) == int(np.argmin(want))
