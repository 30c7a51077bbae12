"""Port radius∧topk graph (policy none) against the JAX graph construction."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adaptigraph_tpu.ops.graph import EdgeConfig as JaxEdgeConfig
from adaptigraph_tpu.ops.graph import build_neighbor_graph_batch as jax_build
from adaptigraph_tpu_torch.ops.graph import EdgeConfig, build_neighbor_graph_batch

torch.set_num_threads(2)


def _case(seed, duplicates):
    rng = np.random.RandomState(seed)
    B, n_obj, n_eef = 4, 24, 2
    N = n_obj + n_eef
    states = (rng.randn(B, N, 3) * 0.3).astype(np.float32)
    if duplicates:
        # exact ties: repeated points and a grid with equal spacings
        states[:, 1] = states[:, 0]
        states[:, 2] = states[:, 0]
        states[:, 5:13] = np.stack(np.meshgrid([0.0, 0.1], [0.0, 0.1], [0.0, 0.1]),
                                   -1).reshape(8, 3)
        states[:, n_obj] = states[:, 3]  # a tool on top of an object
    node_mask = np.ones((B, N), bool)
    node_mask[1, 18:n_obj] = False
    node_mask[2, ::3] = False
    tool_mask = np.zeros((B, N), bool)
    tool_mask[:, n_obj:] = True
    return states, node_mask, tool_mask, n_obj, n_eef


@pytest.mark.parametrize("duplicates", [False, True])
@pytest.mark.parametrize("radius", [0.35, 0.6])
def test_policy_none_matches_jax(duplicates, radius):
    states, node_mask, tool_mask, n_obj, n_eef = _case(0, duplicates)
    jcfg = JaxEdgeConfig(max_nobj=n_obj, max_neef=n_eef, topk=6)
    cfg = EdgeConfig(max_nobj=n_obj, max_neef=n_eef, topk=6)
    want_n, want_m = jax_build(jnp.asarray(states), jnp.asarray(node_mask), jnp.asarray(tool_mask),
                               radius, jcfg)
    got_n, got_m = build_neighbor_graph_batch(torch.tensor(states), torch.tensor(node_mask),
                                              torch.tensor(tool_mask), radius, cfg)
    want_n, want_m = np.asarray(want_n), np.asarray(want_m)
    np.testing.assert_array_equal(got_m.numpy(), want_m)
    # senders are compared where the slot is an edge
    np.testing.assert_array_equal(np.where(want_m, got_n.numpy(), -1), np.where(want_m, want_n, -1))
    assert got_n.shape == want_n.shape == (4, n_obj + n_eef, cfg.K)


def test_other_policies_raise():
    """Every policy of the JAX package is ported (tests/test_torch_graph_policies.py);
    a policy it does not know raises, as the JAX graph construction does."""
    cfg = EdgeConfig(max_nobj=4, max_neef=1, topk=2, policy="tools_some")
    x = torch.zeros(1, 5, 3)
    m = torch.ones(1, 5, dtype=torch.bool)
    with pytest.raises(ValueError, match="tools_some"):
        build_neighbor_graph_batch(x, m, m, 0.5, cfg)
