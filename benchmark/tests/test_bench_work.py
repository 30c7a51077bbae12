"""The kernels' operation and byte counts (``work/``) against counts made
independently at a tiny configuration: torch's FLOP counter over the
reference's own products, and the byte sizes of the tensors the kernels
take."""

import torch
from torch.utils.flop_counter import FlopCounterMode

from reference import gnn
from work import gnn_step, k1, k2, k3

M = dict(n_his=4, max_nobj=4, max_neef=1, n_nodes=5, topk=3, nf_particle=8, nf_relation=8,
         nf_effect=8, pstep=2, phys_dim=1, action_dim=3, attr_dim=2, particle_input_dim=6,
         relation_input_dim=17, motion_clamp=100.0)


def _params():
    shapes = gnn.leaf_shapes(M)
    g = torch.Generator().manual_seed(0)
    return gnn.tree_from_leaves([torch.rand(s, generator=g) * 0.02 - 0.01 for s in shapes])


def _flops(fn):
    counter = FlopCounterMode(display=False)
    with counter:
        fn()
    return counter.get_total_flops()


def test_forward_ops_equal_the_counted_products_of_every_slot():
    B, N, n_p, K = 2, M["n_nodes"], M["max_nobj"], 4
    state = torch.rand(B, M["n_his"], N, 3)
    nbrs = torch.randint(0, N, (B, N, K))
    mask = torch.ones(B, N, K, dtype=torch.bool)
    counted = _flops(lambda: gnn.step_forward(
        _params(), M, state, torch.rand(B, N, 3), torch.rand(B, 1), torch.rand(B, N, 2),
        torch.rand(B, n_p, 1), nbrs, mask))
    assert gnn_step.forward_ops(M, B, B * N * K) == counted
    assert k3.work(M, B, B * N * K, K)[0] == 2 * counted
    assert k2.work(M, B, B * N * K, K)[0] == counted


def test_k1_ops_equal_the_counted_products_less_the_hoisted_first_round():
    B, N, n_p, R, nf = 3, M["n_nodes"], M["max_nobj"], 2, M["nf_effect"]
    obj = torch.rand(B, n_p, 3) * 0.1  # every pair within the radius: every slot an edge
    kp, delta = torch.rand(B, 1, 3) * 0.1, torch.rand(B, 1, 3) * 0.01
    repeat = torch.full((B,), R, dtype=torch.int32)
    stats = {}
    counted = _flops(lambda: gnn.rollout(_params(), M, obj, kp, delta, repeat,
                                         torch.rand(B, 1), 10.0, 10, stats=stats))
    assert stats == {"sample_steps": B * R, "edges": B * R * N * M["topk"]}
    # the kernel computes round 1's receiver|sender product and the
    # propagator's base once a sample (both start from the particle
    # encoding); the reference does every substep
    once = 2 * N * nf * 2 * nf + 2 * N * nf * nf
    ops, _ = k1.work(M, B, stats["sample_steps"], stats["edges"])
    assert ops + (B * R - B) * once == counted


def test_bytes_are_the_inputs_read_once_and_the_outputs_written_once():
    B, K = 2, 4
    N, n_p, Np = M["n_nodes"], M["max_nobj"], 8
    weights = sum(t.numel() for t in gnn.tree_leaves(_params()))
    assert gnn_step.n_weights(M) == weights
    nodes = B * Np * (M["particle_input_dim"] + 12 + 3) * 4
    tables = 2 * B * K * Np * 4
    assert gnn_step.table_bytes(M, B, K) == nodes + tables + weights * 4
    grads = B * Np * (M["particle_input_dim"] + 15) * 4 + weights * 4
    assert k3.work(M, B, 10, K)[1] == nodes + tables + weights * 4 + B * Np * 3 * 4 + grads
    pin, sa, out = B * Np * 6 * 2, B * Np * 6 * 4, B * n_p * 3 * 4
    assert k1.work(M, B, 0, 0)[1] == pin + sa + out + weights * 2 + B * 4 + B * Np * 4
