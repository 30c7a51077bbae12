"""Static-degree neighbor graphs (counterpart of ``adaptigraph_tpu/ops/graph.py``).

A graph is a pair ``(neighbors, mask)`` of shape ``(N, K)``: row ``i`` lists
the senders of the edges that node ``i`` receives. Node layout: indices
``[0, max_nobj)`` are object particles, ``[max_nobj, max_nobj + max_neef)``
end-effector (tool) particles. The first ``topk`` slots hold the radius∧topk
edges; the next ``max_neef`` the tool slots of the tool-connection policies
(``tools_all``, ``non_fixed``, ``surface``); the rest are padding.
"""

import dataclasses

import torch

BIG = 1e10

POLICY_NONE = "none"
POLICY_TOOLS_ALL = "tools_all"
POLICY_NON_FIXED = "non_fixed"
POLICY_SURFACE = "surface"
POLICIES = (POLICY_NONE, POLICY_TOOLS_ALL, POLICY_NON_FIXED, POLICY_SURFACE)


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


def build_neighbor_graph_batch(states, node_mask, tool_mask, adj_radius, cfg: EdgeConfig,
                               knn_frac=1.0):
    """Batched radius∧topk graph with the config's tool-connection policy
    (semantics of the JAX ``build_neighbor_graph``, one graph per sample).

    states (B, N, 3) f32; node_mask, tool_mask (B, N) bool; adj_radius and
    knn_frac floats or (B,) tensors. Returns neighbors (B, N, K) int32 and
    mask (B, N, K) bool. Invalid and tool-tool pairs are excluded, self-edges
    kept, and a selected pair is an edge when its squared distance is
    strictly below radius². The policies:

    - ``tools_all``: every valid object receiver gets every valid tool in the
      tool slots, tool receivers lose their edges and tool senders leave the
      topk slots; with ``gate_on_contact``, only in samples where some tool
      receiver has an object among its topk edges.
    - ``non_fixed``: in samples where some object receives a topk edge from a
      tool, the tools connect to the objects above the bottom
      ``fixed_bottom_frac`` of the object y-range (only the ``knn_frac``
      nearest such pairs when 0 < knn_frac < 1), which drop their topk tool
      senders, and the tools drop them as senders.
    - ``surface``: as ``non_fixed``, for the objects on the two bounding
      planes nearest to the tool-adjacent objects (planes scaled by
      ``surface_ratio``).

    Ranks and plane orders use stable sorts, so ties resolve as JAX's
    ``argsort`` resolves them.
    """
    if cfg.policy not in POLICIES:
        raise ValueError(f"unknown edge policy: {cfg.policy}")
    B, N, _ = states.shape
    if N != cfg.n_nodes:
        raise ValueError(f"states have {N} nodes, the EdgeConfig {cfg.n_nodes}")
    dev, n_p, n_eef = states.device, cfg.max_nobj, cfg.max_neef
    states = states.float()
    dis = pairwise_sq_dists(states)
    valid_pair = node_mask[:, :, None] & node_mask[:, None, :]
    tool_pair = tool_mask[:, :, None] & tool_mask[:, None, :]
    dis_eff = torch.where(valid_pair & ~tool_pair, dis, torch.full_like(dis, BIG))

    # radius² in float32, as the JAX graph construction squares a float32 radius
    r = _f32_on(adj_radius, dev)
    thresh = (r * r).reshape(-1, 1, 1) if r.dim() else r * r
    topk_dis, topk_idx = smallest_k(dis_eff, cfg.topk)
    topk_mask = (topk_dis < thresh) & (topk_dis < BIG * 0.5) & node_mask[:, :, None]

    bidx = torch.arange(B, device=dev)[:, None, None]
    sender_is_tool = tool_mask[bidx, topk_idx]  # (B, N, topk)
    tool_ids = n_p + torch.arange(n_eef, device=dev)
    tool_valid = tool_mask[:, tool_ids][:, None, :]  # (B, 1, n_eef)
    receiver_is_obj = node_mask & ~tool_mask

    def any_(x):  # per sample, broadcastable over (N, slots)
        return x.flatten(1).any(1)[:, None, None]

    if cfg.policy == POLICY_NONE:
        tool_slot_mask = torch.zeros(B, N, n_eef, dtype=torch.bool, device=dev)
        final_topk_mask = topk_mask
    elif cfg.policy == POLICY_TOOLS_ALL:
        if cfg.gate_on_contact:
            gate = any_(tool_mask[:, :, None] & topk_mask & ~sender_is_tool)
        else:
            gate = True
        tool_slot_mask = receiver_is_obj[:, :, None] & tool_valid & gate
        final_topk_mask = topk_mask & ~tool_mask[:, :, None] & ~sender_is_tool
    else:
        check = any_(topk_mask & sender_is_tool & receiver_is_obj[:, :, None])
        if cfg.policy == POLICY_NON_FIXED:
            eligible = _non_fixed_receivers(states, receiver_is_obj, cfg)
            pair_ok = eligible[:, :, None] & tool_valid
            frac = _f32_on(knn_frac, dev).expand(B)
            tool_slot_mask = torch.where(((frac < 1.0) & (frac > 0.0))[:, None, None],
                                         _nearest_pairs(dis[:, :, tool_ids], pair_ok, frac),
                                         pair_ok) & check
        else:
            adj_to_tool = (topk_mask & sender_is_tool).any(2) & receiver_is_obj
            eligible = _surface_receivers(states, adj_to_tool, receiver_is_obj, cfg)
            tool_slot_mask = eligible[:, :, None] & tool_valid & check
        # eligible receivers drop their topk tool senders (replaced by the tool
        # slots) and tool receivers drop eligible senders
        drop = (eligible[:, :, None] & sender_is_tool) | (tool_mask[:, :, None]
                                                          & eligible[bidx, topk_idx])
        final_topk_mask = topk_mask & ~(drop & check)

    tool_slot_idx = tool_ids.expand(B, N, n_eef)
    neighbors = torch.cat([topk_idx, tool_slot_idx], dim=-1).to(torch.int32)
    mask = torch.cat([final_topk_mask, tool_slot_mask], dim=-1)
    pad = cfg.K - neighbors.shape[-1]
    if pad > 0:
        neighbors = torch.cat([neighbors, neighbors.new_zeros(B, N, pad)], dim=-1)
        mask = torch.cat([mask, mask.new_zeros(B, N, pad)], dim=-1)
    return neighbors, mask


def _f32_on(value, dev):
    """``value`` (a number, array or tensor) as a float32 tensor on ``dev``;
    a Python number is filled in on the device, since a tensor made from it
    on the host would be copied to the card after a host wait."""
    if isinstance(value, (int, float)):
        return torch.full((), value, dtype=torch.float32, device=dev)
    return torch.as_tensor(value, dtype=torch.float32, device=dev)


def build_neighbor_graph(states, node_mask, tool_mask, adj_radius, cfg: EdgeConfig,
                         knn_frac=1.0):
    """One state's graph: ``build_neighbor_graph_batch`` on a batch of one.
    states (N, 3), node_mask and tool_mask (N,); returns neighbors (N, K)
    int32 and mask (N, K) bool."""
    r, f = (torch.as_tensor(v, dtype=torch.float32, device=states.device).reshape(1)
            for v in (adj_radius, knn_frac))
    neighbors, mask = build_neighbor_graph_batch(states[None], node_mask[None], tool_mask[None],
                                                 r, cfg, f)
    return neighbors[0], mask[0]


def neighbor_gather(x, neighbors):
    """Sender features ``x (..., N, F) -> (..., N, K, F)`` for any leading
    batch dims shared by ``x`` and ``neighbors``."""
    idx = neighbors.long()
    lead = torch.broadcast_shapes(x.shape[:-2], idx.shape[:-2])
    x = x.expand(*lead, *x.shape[-2:])
    idx = idx.expand(*lead, *idx.shape[-2:])
    flat = idx.reshape(*lead, -1, 1).expand(*lead, -1, x.shape[-1])
    return torch.gather(x, -2, flat).reshape(*idx.shape, x.shape[-1])


def neighbor_aggregate(edge_vals, mask):
    """Masked sum over the K slots: ``(..., N, K, F) -> (..., N, F)``; the
    receiver of slot (i, k) is i."""
    return torch.where(mask[..., None], edge_vals, torch.zeros_like(edge_vals)).sum(-2)


def graph_to_edge_set(neighbors, mask):
    """Host-side: the (receiver, sender) edge set, for tests and plots."""
    neighbors = torch.as_tensor(neighbors).cpu()
    rec, slot = torch.nonzero(torch.as_tensor(mask).cpu(), as_tuple=True)
    return set(zip(rec.tolist(), neighbors[rec, slot].tolist()))


def _non_fixed_receivers(states, receiver_is_obj, cfg: EdgeConfig):
    """Object receivers above the bottom ``fixed_bottom_frac`` of the y-range
    of the (padded) object block."""
    obj_y = states[:, :cfg.max_nobj, 1]
    max_y, min_y = obj_y.amax(1), obj_y.amin(1)
    y_thresh = (max_y - min_y) * cfg.fixed_bottom_frac + min_y
    return receiver_is_obj & (states[..., 1] > y_thresh[:, None])


def _nearest_pairs(pair_dis, pair_ok, frac):
    """Per sample the floor(frac * n) nearest of its n (receiver, tool) pairs
    in ``pair_ok``, ranked by a stable sort of their distances."""
    B = pair_dis.shape[0]
    flat = torch.where(pair_ok, pair_dis, torch.full_like(pair_dis, float("inf"))).reshape(B, -1)
    order = torch.argsort(flat, dim=1, stable=True)
    rank = torch.empty_like(order)
    rank.scatter_(1, order, torch.arange(flat.shape[1], device=flat.device).expand(B, -1))
    keep_k = torch.floor(frac * pair_ok.flatten(1).sum(1)).to(torch.int64)
    return (rank.reshape(pair_ok.shape) < keep_k[:, None, None]) & pair_ok


def _surface_receivers(states, adj_to_tool, receiver_is_obj, cfg: EdgeConfig):
    """Object receivers on the two bounding planes (max y, min x, max x, min
    z, max z of the object block, scaled by ``surface_ratio``) with the least
    squared-distance mass of the tool-adjacent objects."""
    obj = states[:, :cfg.max_nobj]
    ratio = cfg.surface_ratio
    hi = obj.amax(1)  # (B, 3)
    lo = obj.amin(1)
    max_y, max_x, max_z = hi[:, 1] * ratio, hi[:, 0] * ratio, hi[:, 2] * ratio
    min_x = (hi[:, 0] - lo[:, 0]) * (1.0 - ratio) + lo[:, 0]
    min_z = (hi[:, 2] - lo[:, 2]) * (1.0 - ratio) + lo[:, 2]
    w = adj_to_tool.to(states.dtype)
    x, y, z = states[..., 0], states[..., 1], states[..., 2]
    planes = [(y, max_y), (x, min_x), (x, max_x), (z, min_z), (z, max_z)]
    plane_dists = torch.stack([(w * (c - v[:, None]) * (c - v[:, None])).sum(1)
                               for c, v in planes], dim=1)
    order = torch.argsort(plane_dists, dim=1, stable=True)
    on_plane = torch.stack([y >= max_y[:, None], x <= min_x[:, None], x >= max_x[:, None],
                            z <= min_z[:, None], z >= max_z[:, None]], dim=1)  # (B, 5, N)
    b = torch.arange(states.shape[0], device=states.device)
    return on_plane[b, order[:, 0]] & on_plane[b, order[:, 1]] & receiver_is_obj
