"""Static-degree neighbor graphs (counterpart of ``adaptigraph_tpu/ops/graph.py``).

A graph is a pair ``(neighbors, mask)`` of shape ``(N, K)``: row ``i`` lists
the senders of the edges that node ``i`` receives. Node layout: indices
``[0, max_nobj)`` are object particles, ``[max_nobj, max_nobj + max_neef)``
end-effector (tool) particles.

Only policy ``none`` (rope, granular) is ported in this slice; the tool
policies come with cloth planning.
"""

import dataclasses

import torch

BIG = 1e10

POLICY_NONE = "none"


@dataclasses.dataclass(frozen=True)
class EdgeConfig:
    """Static edge-construction parameters (same fields as the JAX ``EdgeConfig``)."""

    max_nobj: int
    max_neef: int
    topk: int
    policy: str = POLICY_NONE
    gate_on_contact: bool = False
    fixed_bottom_frac: float = 0.1
    surface_ratio: float = 1.0
    # the slot axis is padded to a multiple of this (masked slots), so the
    # (N, K) tables have the JAX package's shape
    k_multiple: int = 8

    @property
    def n_nodes(self):
        return self.max_nobj + self.max_neef

    @property
    def K(self):
        k = self.topk + self.max_neef
        m = self.k_multiple
        return ((k + m - 1) // m) * m


def pairwise_sq_dists(x):
    """(B, N, 3) -> (B, N, N) squared distances, summed over x, y, z in that
    order in float32 (receiver minus sender), each product and sum rounded on
    its own so the kernel in ``csrc/`` can reproduce it bit for bit."""
    diff = x[:, :, None, :] - x[:, None, :, :]
    sq = diff * diff
    return (sq[..., 0] + sq[..., 1]) + sq[..., 2]


def smallest_k(dis, k):
    """Per-row ``k`` smallest values and their column indices, ties to the
    smallest index (``lax.top_k`` order). ``torch.topk`` promises no tie
    order, so this is a stable sort."""
    vals, idx = torch.sort(dis, dim=-1, stable=True)
    return vals[..., :k], idx[..., :k]


def build_neighbor_graph_batch(states, node_mask, tool_mask, adj_radius, cfg: EdgeConfig):
    """Batched radius∧topk graph (semantics of the JAX ``build_neighbor_graph``).

    states (B, N, 3) f32; node_mask, tool_mask (B, N) bool; adj_radius a float
    or (B,) tensor. Returns neighbors (B, N, K) int32 and mask (B, N, K) bool.
    Invalid and tool-tool pairs are excluded, self-edges kept, and a selected
    pair is an edge when its squared distance is strictly below radius².
    """
    if cfg.policy != POLICY_NONE:
        raise NotImplementedError(f"edge policy {cfg.policy!r} is not ported yet")
    B, N, _ = states.shape
    if N != cfg.n_nodes:
        raise ValueError(f"states have {N} nodes, the EdgeConfig {cfg.n_nodes}")
    dis = pairwise_sq_dists(states.float())
    valid_pair = node_mask[:, :, None] & node_mask[:, None, :]
    tool_pair = tool_mask[:, :, None] & tool_mask[:, None, :]
    dis_eff = torch.where(valid_pair & ~tool_pair, dis, torch.full_like(dis, BIG))

    # radius² in float32, as the JAX graph construction squares a float32 radius
    r = torch.as_tensor(adj_radius, dtype=torch.float32, device=states.device)
    thresh = (r * r).reshape(-1, 1, 1) if r.dim() else r * r
    topk_dis, topk_idx = smallest_k(dis_eff, cfg.topk)
    topk_mask = (topk_dis < thresh) & (topk_dis < BIG * 0.5) & node_mask[:, :, None]

    tool_ids = cfg.max_nobj + torch.arange(cfg.max_neef, device=states.device)
    tool_slot_idx = tool_ids.expand(B, N, cfg.max_neef)
    tool_slot_mask = torch.zeros(B, N, cfg.max_neef, dtype=torch.bool, device=states.device)
    neighbors = torch.cat([topk_idx, tool_slot_idx], dim=-1).to(torch.int32)
    mask = torch.cat([topk_mask, tool_slot_mask], dim=-1)
    pad = cfg.K - neighbors.shape[-1]
    if pad > 0:
        neighbors = torch.cat([neighbors, neighbors.new_zeros(B, N, pad)], dim=-1)
        mask = torch.cat([mask, mask.new_zeros(B, N, pad)], dim=-1)
    return neighbors, mask
