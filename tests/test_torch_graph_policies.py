"""The port's ``build_neighbor_graph_batch`` against the JAX one for every
edge policy: ``none``, ``tools_all`` (gated on contact and not), ``non_fixed``
(``knn_frac`` 1.0 and 0.5) and ``surface`` (``surface_ratio`` 1.0 and 0.9),
on seeded states with random node masks and 1 or 5 end-effector points. The
edge sets must be equal: the masks equal, and the senders wherever the mask
is set."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adaptigraph_tpu.ops.graph import EdgeConfig as JaxEdgeConfig
from adaptigraph_tpu.ops.graph import build_neighbor_graph_batch as jax_build
from adaptigraph_tpu_torch.ops.graph import EdgeConfig, build_neighbor_graph_batch

torch.set_num_threads(2)

POLICIES = [("none", {}, 1.0), ("tools_all", {"gate_on_contact": True}, 1.0),
            ("tools_all", {"gate_on_contact": False}, 1.0), ("non_fixed", {}, 1.0),
            ("non_fixed", {}, 0.5), ("surface", {"surface_ratio": 1.0}, 1.0),
            ("surface", {"surface_ratio": 0.9}, 1.0)]


def _case(seed, n_eef):
    """B 6 samples of 20 objects and n_eef tools: random object masks, the
    objects on a coarse grid (so the bounding planes hold several of them and
    distances tie exactly: the spacing is a power of 2, so every squared
    distance is exact whatever the order of its sum), the tools near the objects in most samples (so the
    contact tests fire) and far away in the last (so they do not)."""
    rng = np.random.RandomState(seed)
    B, n_obj = 6, 20
    N = n_obj + n_eef
    states = (np.round(rng.randn(B, N, 3) * 2) * 0.125).astype(np.float32)
    states[:, n_obj:] = states[:, :n_eef] + rng.randn(B, n_eef, 3).astype(np.float32) * 0.05
    states[-1, n_obj:] += 5.0
    node_mask = rng.rand(B, N) > 0.2
    node_mask[:, n_obj:] = True
    node_mask[0, n_obj:] = rng.rand(n_eef) > 0.3  # some invalid tools
    tool_mask = np.zeros((B, N), bool)
    tool_mask[:, n_obj:] = node_mask[:, n_obj:]
    return states, node_mask, tool_mask, n_obj


@pytest.mark.parametrize("n_eef", [1, 5])
@pytest.mark.parametrize("policy,kw,knn_frac", POLICIES,
                         ids=["none", "tools_all_gated", "tools_all", "non_fixed",
                              "non_fixed_knn0.5", "surface", "surface_0.9"])
def test_policy_matches_jax(policy, kw, knn_frac, n_eef):
    states, node_mask, tool_mask, n_obj = _case(3, n_eef)
    ekw = dict(max_nobj=n_obj, max_neef=n_eef, topk=6, policy=policy, **kw)
    radius = 0.45
    want_n, want_m = jax_build(jnp.asarray(states), jnp.asarray(node_mask), jnp.asarray(tool_mask),
                               radius, JaxEdgeConfig(**ekw), knn_frac)
    got_n, got_m = build_neighbor_graph_batch(torch.tensor(states), torch.tensor(node_mask),
                                              torch.tensor(tool_mask), radius, EdgeConfig(**ekw),
                                              knn_frac)
    want_n, want_m = np.asarray(want_n), np.asarray(want_m)
    assert got_n.shape == want_n.shape and got_n.dtype == torch.int32
    np.testing.assert_array_equal(got_m.numpy(), want_m)
    np.testing.assert_array_equal(np.where(want_m, got_n.numpy(), -1), np.where(want_m, want_n, -1))
    if policy != "none":  # the case exercises the tool slots
        assert want_m[:, :, 6:6 + n_eef].any()


def test_per_sample_radius_and_knn_frac():
    """(B,) radii and kNN fractions, one per sample, as the batched JAX call takes them."""
    states, node_mask, tool_mask, n_obj = _case(7, 5)
    B = states.shape[0]
    radius = np.linspace(0.35, 0.6, B).astype(np.float32)
    frac = np.array([1.0, 0.5, 0.25, 0.0, 0.75, 0.5], np.float32)
    ekw = dict(max_nobj=n_obj, max_neef=5, topk=6, policy="non_fixed")
    want_n, want_m = jax_build(jnp.asarray(states), jnp.asarray(node_mask), jnp.asarray(tool_mask),
                               jnp.asarray(radius), JaxEdgeConfig(**ekw), jnp.asarray(frac))
    got_n, got_m = build_neighbor_graph_batch(torch.tensor(states), torch.tensor(node_mask),
                                              torch.tensor(tool_mask), torch.tensor(radius),
                                              EdgeConfig(**ekw), torch.tensor(frac))
    want_m = np.asarray(want_m)
    np.testing.assert_array_equal(got_m.numpy(), want_m)
    np.testing.assert_array_equal(np.where(want_m, got_n.numpy(), -1),
                                  np.where(want_m, np.asarray(want_n), -1))
