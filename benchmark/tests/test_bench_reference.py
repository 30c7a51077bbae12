"""The reference against the port's plain versions at a tiny size, on the
CPU. Only this test imports both."""

import copy

import numpy as np
import pytest
import torch

from harness import spec as specs
from reference import gnn



def _tiny(name, width=16):
    config = copy.deepcopy(specs.load_json(f"{specs.BENCH_DIR}/configs/{name}.json"))
    for key in ("nf_particle", "nf_relation", "nf_effect"):
        config["dynamics"]["model_config"][key] = width
    return config["dynamics"]


def _weights(m, seed=0):
    g = torch.Generator().manual_seed(seed)
    return gnn.tree_from_leaves([(torch.rand(s, generator=g) * 2 - 1) / np.sqrt(s[0])
                                 for s in gnn.leaf_shapes(m)])


def _rollout_inputs(m, cfg, dtype=torch.float32):
    from adaptigraph_tpu_torch.ops.fused_gnn import chunk_inputs

    B, n_p = 6, m["max_nobj"]
    g = torch.Generator().manual_seed(1)
    obj = torch.rand(B, n_p, 3, generator=g) * torch.tensor([2.0, 0.1, 0.5])
    kp = torch.rand(B, 1, 3, generator=g)
    delta = torch.rand(B, 1, 3, generator=g) * 0.1
    repeat = torch.randint(1, 5, (B,), generator=g, dtype=torch.int32)
    phys = torch.rand(B, 1, generator=g)
    return (obj, kp, delta, repeat, phys), chunk_inputs(obj, kp, delta, repeat, phys, cfg, dtype)


# 16: the tiny width; 150: the published width, which the port's card path
# refuses (below) and its plain path, the second witness, runs
@pytest.mark.parametrize("width", [16, 150])
def test_rollout_equals_the_ports_plain_rollout(width):
    from adaptigraph_tpu_torch.cli import _dyn_objects
    from adaptigraph_tpu_torch.ops.fused_gnn import rollout_chunk_plain, weight_list

    dyn = _tiny("rope_nf128", width)
    m = gnn.model_sizes(dyn)
    cfg, _ = _dyn_objects(dyn)
    params = _weights(m)
    (obj, kp, delta, repeat, phys), (pin, sa, rep, valid) = _rollout_inputs(m, cfg)
    theirs_stats, ours_stats = {}, {}
    theirs = rollout_chunk_plain(pin, sa, rep, valid, weight_list(params, cfg, torch.float32), cfg,
                                 m["topk"], 0.5, 10, compute_dtype=torch.float32,
                                 stats=theirs_stats)
    ours = gnn.rollout(params, m, obj, kp, delta, repeat, phys, 0.5, 10, stats=ours_stats)
    assert ours_stats == theirs_stats
    torch.testing.assert_close(ours, theirs, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("width", [16, 150])
@pytest.mark.parametrize("name", ["rope_nf128", "softbody_nf128"])
def test_graph_and_step_equal_the_ports_plain_versions(name, width):
    from adaptigraph_tpu_torch.cli import _dyn_objects
    from adaptigraph_tpu_torch.ops.fused_gnn import gnn_forward_plain, pack_inputs, weight_list
    from adaptigraph_tpu_torch.ops.graph import build_neighbor_graph_batch

    dyn = _tiny(name, width)
    m = gnn.model_sizes(dyn)
    cfg, edge = _dyn_objects(dyn)
    policy = edge.policy
    B, N, n_p, H = 4, m["n_nodes"], m["max_nobj"], m["n_his"]
    g = torch.Generator().manual_seed(2)
    state = torch.rand(B, H, N, 3, generator=g) * 1.5
    node_mask = torch.ones(B, N, dtype=torch.bool)
    node_mask[0, n_p - 3:n_p] = False
    tool = (torch.arange(N) >= n_p).expand(B, N)
    radius = torch.full((B,), 0.5)
    frac = torch.tensor([1.0, 0.5, 0.7, 0.4])[:B]
    nbrs, mask = build_neighbor_graph_batch(state[:, -1], node_mask, tool, radius, edge, frac)
    r_nbrs, r_mask = gnn.neighbor_graph(state[:, -1], node_mask, tool, radius, m, policy, frac)
    slots = m["topk"] + m["max_neef"]
    assert torch.equal(mask[..., :slots], r_mask)
    assert torch.equal(torch.where(r_mask, r_nbrs, 0), torch.where(mask[..., :slots],
                                                                   nbrs[..., :slots].long(), 0))
    params = _weights(m, 3)
    action = torch.rand(B, N, 3, generator=g) * 0.1
    physics = torch.rand(B, 1, generator=g)
    attrs = torch.stack([(~tool).float() * node_mask, tool.float()], -1)
    p_inst = node_mask[:, :n_p, None].float()
    nodes, nbr, msk, last, _ = pack_inputs(cfg, state, action, physics, attrs, p_inst, nbrs, mask,
                                           slots, torch.float32)
    theirs, _ = gnn_forward_plain(nodes, nbr, msk, last, weight_list(params, cfg, torch.float32),
                                  cfg, torch.float32)
    ours = gnn.step_forward(params, m, state, action, physics, attrs, p_inst, r_nbrs, r_mask)
    torch.testing.assert_close(ours, theirs, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_the_ports_card_path_refuses_the_published_width(dtype):
    """Why the configurations stand in at width 128: the port's kernel
    wrappers refuse the published 150 before any launch (checked here on CPU
    tensors, which reach the checks alike)."""
    from adaptigraph_tpu_torch.cli import _dyn_objects
    from adaptigraph_tpu_torch.ops import fused_gnn

    dyn = _tiny("rope_nf128", 150)
    m = gnn.model_sizes(dyn)
    cfg, _ = _dyn_objects(dyn)
    _, (pin, sa, rep, valid) = _rollout_inputs(m, cfg, dtype)
    weights = fused_gnn.weight_list(_weights(m), cfg, dtype)
    with pytest.raises(ValueError, match="divisible by (16|4), got 150"):
        fused_gnn.rollout_chunk_cuda(pin, sa, rep, valid, weights, cfg, m["topk"], 0.5, 10, 0.0,
                                     False, dtype)
    with pytest.raises(ValueError, match="multiples of 8 up to 128"):
        fused_gnn.check_gnn_inputs(pin, None, None, weights, cfg, dtype, K=m["topk"])


def test_a_sound_tiny_solve_agrees_with_the_reference():
    from bench_tiny import run_tiny

    run = run_tiny("rope_nf128.solve")
    values = {k: v["value"] for k, v in run.checks.items()}
    assert values["best_mismatch"] == 0.0 and values["state_err"] < 0.05
    assert values["state_err_chunk"] < 0.1 and values["reward_err"] < 1e-5
    assert run.attempted >= 1 and run.layer["k1_ops_per_launch"] > 0


@pytest.mark.parametrize("workload", ["rope_nf128.train", "softbody_nf128.train"])
def test_a_sound_tiny_train_run_agrees_with_the_reference(workload):
    from bench_tiny import run_tiny

    run = run_tiny(workload)
    values = {k: v["value"] for k, v in run.checks.items()}
    assert values["first_loss_gap"] < 1e-4 and values["grad_gap"] < 1e-4
    assert values["update_gap"] < 1e-3
    assert values["call_loss_gap"] < 1e-4
    assert run.layer["call_grad_gaps"] and max(run.layer["call_grad_gaps"]) < 1e-3
    assert values["call_update_gap"] < 1e-3
    assert run.layer["edges_per_sample"] > 0 and run.failed == 0
