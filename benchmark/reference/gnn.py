"""Plain PyTorch reference of the particle-relation GNN that the benchmark
holds the port against: the whole-push rollout of an MPPI chunk (what the
port's rollout kernel computes), the single-step forward that training
differentiates, and the radius-and-top-k graph they build.

A frozen, independent copy of the model's mathematics. It imports nothing of
the port and takes none of its outputs: it gets the weights as the nested
parameter dict that the benchmark made or read, and the inputs that the
benchmark generated, and works out graphs, substep counts and node inputs
again itself. Padding rows are left out (they change no real row).

Precision is a ``Numerics``: ``F32`` (the reference; every product in
float32 with TF32 off) or ``FP8`` (the control: every stored activation and
weight rounded to float8 e4m3 with a per-tensor scale, the precision below
the bfloat16 that the planning configuration states). Positions, distances
and ``pred = last + clamp(motion)`` stay float32 in both, as in the port.
"""

import numpy as np
import torch

BIG = 1e10
F8_MAX = 448.0  # the largest finite float8 e4m3 value

# the leaves of a parameter dict in the order the checkpoint files hold them
# (JAX's sorted keys: each layer's bias, then its weight)
_MLP3 = [(i, k) for i in range(3) for k in ("b", "w")]
LEAF_ORDER = ([("non_rigid_predictor", i, k) for i, k in _MLP3]
              + [("particle_encoder", i, k) for i, k in _MLP3]
              + [("particle_propagator", None, k) for k in ("b", "w")]
              + [("relation_encoder", i, k) for i, k in _MLP3]
              + [("relation_propagator", None, k) for k in ("b", "w")])


def leaf_names():
    return [f"{mod}.{k}" if i is None else f"{mod}.{i}.{k}" for mod, i, k in LEAF_ORDER]


def tree_leaves(tree):
    return [tree[mod][k] if i is None else tree[mod][i][k] for mod, i, k in LEAF_ORDER]


def tree_from_leaves(leaves):
    tree = {}
    for (mod, i, k), leaf in zip(LEAF_ORDER, leaves):
        if i is None:
            tree.setdefault(mod, {})[k] = leaf
        else:
            tree.setdefault(mod, [{}, {}, {}])[i][k] = leaf
    return tree


def leaf_shapes(m):
    """Each leaf's shape for the model sizes ``m`` (a dict of the
    configuration's model sizes, see ``model_sizes``)."""
    nfp, nfr, nf = m["nf_particle"], m["nf_relation"], m["nf_effect"]

    def mlp(n_in, n_hidden, n_out):
        return [(n_hidden,), (n_in, n_hidden), (n_hidden,), (n_hidden, n_hidden),
                (n_out,), (n_hidden, n_out)]

    return (mlp(nf, nf, 3) + mlp(m["particle_input_dim"], nfp, nf) + [(nf,), (2 * nf, nf)]
            + mlp(m["relation_input_dim"], nfr, nf) + [(nf,), (3 * nf, nf)])


def model_sizes(dynamics):
    """The model sizes of a dynamics configuration (the yaml's dict)."""
    mc, dc = dynamics["model_config"], dynamics["dataset_config"]
    material = dc["materials"][0]
    phys_dim = sum(1 for p in dynamics["material_config"][material]["physics_params"] if p["use"])
    ds = dc["datasets"][0]
    n_his = dc["n_his"]
    for key in ("state_dim", "offset_dim", "density_dim", "rel_particle_dim", "rel_density_dim"):
        if mc[key] != 0:
            raise ValueError(f"the reference computes {key} = 0 only, got {mc[key]}")
    return dict(n_his=n_his, max_nobj=ds["max_nobj"], max_neef=dc["eef"]["max_neef"],
                n_nodes=ds["max_nobj"] + dc["eef"]["max_neef"], topk=ds["topk"],
                nf_particle=mc["nf_particle"], nf_relation=mc["nf_relation"],
                nf_effect=mc["nf_effect"], pstep=mc["pstep"], phys_dim=phys_dim,
                action_dim=mc["action_dim"], attr_dim=mc["attr_dim"],
                particle_input_dim=mc["attr_dim"] + mc["action_dim"] + phys_dim,
                relation_input_dim=(2 * mc["rel_attr_dim"] + mc["rel_group_dim"]
                                    + mc["rel_distance_dim"] * n_his),
                motion_clamp=100.0)


class Numerics:
    """Where the reference rounds: ``act`` on each stored activation and
    ``weight`` on each weight. None: float32 throughout."""

    def __init__(self, name, fmt=None):
        self.name, self.fmt = name, fmt

    def _q(self, x):
        if self.fmt is None:
            return x
        amax = x.detach().abs().amax().clamp(min=1e-30)
        scale = F8_MAX / amax
        return (x * scale).to(self.fmt).to(torch.float32) / scale

    def act(self, x):
        return self._q(x)

    def weight(self, x):
        return self._q(x)


F32 = Numerics("float32")
FP8 = Numerics("float8_e4m3", torch.float8_e4m3fn)


def split_weights(params, m, num):
    """The layers as the model uses them, float32 (rounded by ``num``)."""
    nf = m["nf_effect"]
    w = {}

    def q(t):
        return num.weight(t.float())

    w["pe"] = [(q(l["w"]), q(l["b"])) for l in params["particle_encoder"]]
    w["re"] = [(q(l["w"]), q(l["b"])) for l in params["relation_encoder"]]
    w["nr"] = [(q(l["w"]), q(l["b"])) for l in params["non_rigid_predictor"]]
    rp, pp = params["relation_propagator"], params["particle_propagator"]
    w["rp_w1"], w["rp_w2"], w["rp_w3"] = (q(rp["w"][:nf]), q(rp["w"][nf:2 * nf]),
                                          q(rp["w"][2 * nf:]))
    w["rp_b"] = q(rp["b"])
    w["pp_wa"], w["pp_wb"], w["pp_b"] = q(pp["w"][:nf]), q(pp["w"][nf:]), q(pp["b"])
    return w


def mlp3(x, layers, final_relu, num):
    (w0, b0), (w1, b1), (w2, b2) = layers
    x = num.act(torch.relu(x @ w0 + b0))
    x = num.act(torch.relu(x @ w1 + b1))
    x = x @ w2 + b2
    return num.act(torch.relu(x) if final_relu else x)


def sq_dists(x):
    """(B, N, 3) -> (B, N, N) squared distances, x, y, z summed in that order."""
    diff = x[:, :, None, :] - x[:, None, :, :]
    sq = diff * diff
    return (sq[..., 0] + sq[..., 1]) + sq[..., 2]


def smallest_k(dis, k):
    """Per row the k smallest values and their columns, ties to the smaller
    column (a stable sort)."""
    vals, idx = torch.sort(dis, dim=-1, stable=True)
    return vals[..., :k], idx[..., :k]


def radius_sq(adj_radius):
    """radius squared as the models form it: a double product rounded to float32."""
    return float(np.float32(adj_radius * adj_radius))


def message_passing(w, m, penc, rel_base, idx, emask, num):
    """``pstep`` rounds of relation messages summed at each receiver."""
    part_base = num.act(penc @ w["pp_wa"] + w["pp_b"])
    B = penc.shape[0]
    bidx = torch.arange(B, device=penc.device)[:, None, None]
    effect = penc
    for _ in range(m["pstep"]):
        recv = num.act(effect @ w["rp_w2"])
        send = num.act(effect @ w["rp_w3"])
        msg = torch.relu(num.act(num.act(rel_base + recv[:, :, None]) + send[bidx, idx]))
        agg = torch.where(emask[..., None], msg, torch.zeros_like(msg)).sum(dim=2)
        effect = torch.relu(num.act(num.act(part_base + num.act(num.act(agg) @ w["pp_wb"]))
                                    + effect))
    return effect


def rollout(params, m, obj0, kp, delta, repeat, phys, adj_radius, max_repeat, num=F32,
            stats=None):
    """A chunk's whole pushes, substep by substep, each sample recorded at
    its own repeat (the rope and granular rollout of MPPI).

    obj0 (B, n_p, 3) float32 object state; kp, delta (B, n_eef, 3) the
    pusher's start and its move a substep; repeat (B,) substeps a sample
    runs; phys (B, phys_dim). Each substep builds the radius-and-top-k graph
    of the newest frame (all rows valid, no tool-tool pairs), runs the GNN
    and re-sticks the pusher to the lowest object y. Returns (B, n_p, 3).
    ``stats`` receives ``sample_steps`` (the substeps the samples run) and
    ``edges`` (the real edges over those substeps).
    """
    w = split_weights(params, m, num)
    B, n_p, _ = obj0.shape
    N, n_his, K = m["n_nodes"], m["n_his"], m["topk"]
    dev = obj0.device
    f32 = torch.float32
    rows = torch.arange(N, device=dev)
    tool = rows >= n_p
    attrs = torch.stack([(~tool).to(f32), tool.to(f32)], dim=-1).expand(B, N, 2)
    g = (~tool).to(f32)[None, :, None].expand(B, N, 1)
    pair_ok = ~(tool[:, None] & tool[None, :])
    thresh = radius_sq(adj_radius)
    action = torch.cat([torch.zeros(B, n_p, 3, dtype=f32, device=dev), delta.float()], dim=1)
    phys_n = torch.cat([phys.float()[:, None, :].expand(B, n_p, m["phys_dim"]),
                        torch.zeros(B, N - n_p, m["phys_dim"], dtype=f32, device=dev)], dim=1)
    pin = num.act(torch.cat([attrs, phys_n, action], dim=-1))
    penc = mlp3(pin, w["pe"], True, num)
    state0 = torch.cat([obj0.float(), kp.float()], dim=1)
    hs = [state0] * n_his
    rec = obj0.float()
    bidx = torch.arange(B, device=dev)[:, None, None]
    nh3 = n_his * 3
    rmax = min(int(repeat.max()), max_repeat) if B else 0
    for step in range(1, rmax + 1):
        last = hs[-1]
        dis = torch.where(pair_ok, sq_dists(last), torch.full_like(last[..., 0:1], BIG))
        vals, idx = smallest_k(dis, K)
        emask = vals < thresh
        if stats is not None:
            live = repeat >= step
            stats["sample_steps"] = stats.get("sample_steps", 0) + int(live.sum())
            stats["edges"] = stats.get("edges", 0) + int((emask.sum(dim=(1, 2)) * live).sum())
        sn = num.act(torch.cat([hs[i + 1] - hs[i] for i in range(n_his - 1)] + [last], dim=-1))
        node_g = torch.cat([sn, attrs, g], dim=-1)
        T = node_g[:, :, None, :].expand(B, N, K, node_g.shape[-1])
        G = node_g[bidx, idx]
        rel_in = torch.cat([T[..., nh3:nh3 + 2], G[..., nh3:nh3 + 2],
                            torch.abs(T[..., nh3 + 2:] - G[..., nh3 + 2:]),
                            num.act(T[..., :nh3] - G[..., :nh3])], dim=-1)
        rel_base = num.act(mlp3(rel_in, w["re"], True, num) @ w["rp_w1"] + w["rp_b"])
        effect = message_passing(w, m, penc, rel_base, idx, emask, num)
        motion = mlp3(effect[:, :n_p], w["nr"], False, num)
        pred = last[:, :n_p] + torch.clamp(motion, -m["motion_clamp"], m["motion_clamp"])
        rec = torch.where((repeat == step)[:, None, None], pred, rec)
        ys = pred[..., 1].amin(dim=1)
        cand = last[:, n_p:] + action[:, n_p:]
        eef = torch.stack([cand[..., 0], ys[:, None].expand(B, N - n_p), cand[..., 2]], dim=-1)
        hs = hs[1:] + [torch.cat([pred, eef], dim=1)]
    return rec


def step_forward(params, m, state, action, physics, attrs, p_instance, neighbors, nbr_mask,
                 num=F32):
    """One differentiable GNN step on a prebuilt graph (what training runs):
    state (B, n_his, N, 3), action (B, N, 3), physics (B, phys_dim), attrs
    (B, N, 2), p_instance (B, n_p, 1), neighbors and nbr_mask (B, N, slots).
    Returns pred (B, n_p, 3)."""
    w = split_weights(params, m, num)
    B, n_his, N, _ = state.shape
    n_p, nh3 = m["max_nobj"], n_his * 3
    dev = state.device
    state_norm = torch.cat([state[:, 1:] - state[:, :-1], state[:, -1:]], dim=1)
    sn = num.act(state_norm.permute(0, 2, 1, 3).reshape(B, N, nh3))
    phys_n = torch.cat([physics[:, None, :].expand(B, n_p, m["phys_dim"]),
                        physics.new_zeros(B, N - n_p, m["phys_dim"])], dim=1)
    pin = num.act(torch.cat([attrs, phys_n, action], dim=-1))
    g = torch.cat([p_instance, p_instance.new_zeros(B, N - n_p, 1)], dim=1)
    node_g = torch.cat([sn, attrs, g], dim=-1)
    idx = neighbors.long()
    K = idx.shape[-1]
    bidx = torch.arange(B, device=dev)[:, None, None]
    T = node_g[:, :, None, :].expand(B, N, K, node_g.shape[-1])
    G = node_g[bidx, idx]
    rel_in = torch.cat([T[..., nh3:nh3 + 2], G[..., nh3:nh3 + 2],
                        torch.abs(num.act(T[..., nh3 + 2:] - G[..., nh3 + 2:])),
                        num.act(T[..., :nh3] - G[..., :nh3])], dim=-1)
    penc = mlp3(pin, w["pe"], True, num)
    rel_base = num.act(mlp3(rel_in, w["re"], True, num) @ w["rp_w1"] + w["rp_b"])
    effect = message_passing(w, m, penc, rel_base, idx, nbr_mask, num)
    motion = mlp3(effect[:, :n_p], w["nr"], False, num)
    return state[:, -1, :n_p] + torch.clamp(motion, -m["motion_clamp"], m["motion_clamp"])


def neighbor_graph(states, node_mask, tool_mask, adj_radius, m, policy, knn_frac,
                   fixed_bottom_frac=0.1):
    """The training graph of each sample's newest frame: top-k below the
    radius over valid non-tool-tool pairs (self-edges kept), then the tool
    slots of the policy: ``none`` (no tool slots used) or ``non_fixed``
    (where some object receives a top-k edge from a tool, the tools
    connect to the objects above the bottom tenth of the object y-range,
    only the ``knn_frac`` nearest such pairs when 0 < knn_frac < 1; those
    objects drop their top-k tool senders and the tools drop them as
    senders). Returns neighbors (B, N, topk + n_eef) and their mask."""
    B, N, _ = states.shape
    dev = states.device
    n_p, n_eef, K = m["max_nobj"], m["max_neef"], m["topk"]
    dis = sq_dists(states.float())
    valid_pair = node_mask[:, :, None] & node_mask[:, None, :]
    tool_pair = tool_mask[:, :, None] & tool_mask[:, None, :]
    dis_eff = torch.where(valid_pair & ~tool_pair, dis, torch.full_like(dis, BIG))
    r = torch.as_tensor(adj_radius, dtype=torch.float32, device=dev).reshape(-1, 1, 1)
    topk_dis, topk_idx = smallest_k(dis_eff, K)
    topk_mask = (topk_dis < r * r) & (topk_dis < BIG * 0.5) & node_mask[:, :, None]
    bidx = torch.arange(B, device=dev)[:, None, None]
    sender_is_tool = tool_mask[bidx, topk_idx]
    tool_ids = n_p + torch.arange(n_eef, device=dev)
    tool_valid = tool_mask[:, tool_ids][:, None, :]
    receiver_is_obj = node_mask & ~tool_mask
    if policy == "none":
        tool_slot_mask = torch.zeros(B, N, n_eef, dtype=torch.bool, device=dev)
        final_mask = topk_mask
    elif policy == "non_fixed":
        check = (topk_mask & sender_is_tool & receiver_is_obj[:, :, None]).flatten(1).any(1)
        check = check[:, None, None]
        obj_y = states[:, :n_p, 1]
        y_thresh = (obj_y.amax(1) - obj_y.amin(1)) * fixed_bottom_frac + obj_y.amin(1)
        eligible = receiver_is_obj & (states[..., 1] > y_thresh[:, None])
        pair_ok = eligible[:, :, None] & tool_valid
        frac = torch.as_tensor(knn_frac, dtype=torch.float32, device=dev).expand(B)
        pair_dis = dis[:, :, tool_ids]
        flat = torch.where(pair_ok, pair_dis, torch.full_like(pair_dis, float("inf")))
        order = torch.argsort(flat.reshape(B, -1), dim=1, stable=True)
        rank = torch.empty_like(order)
        rank.scatter_(1, order, torch.arange(order.shape[1], device=dev).expand(B, -1))
        keep = torch.floor(frac * pair_ok.flatten(1).sum(1)).to(torch.int64)
        nearest = (rank.reshape(pair_ok.shape) < keep[:, None, None]) & pair_ok
        partial = ((frac < 1.0) & (frac > 0.0))[:, None, None]
        tool_slot_mask = torch.where(partial, nearest, pair_ok) & check
        drop = (eligible[:, :, None] & sender_is_tool) | (tool_mask[:, :, None]
                                                          & eligible[bidx, topk_idx])
        final_mask = topk_mask & ~(drop & check)
    else:
        raise ValueError(f"the reference builds policies none and non_fixed, not {policy!r}")
    neighbors = torch.cat([topk_idx, tool_ids.expand(B, N, n_eef)], dim=-1)
    return neighbors, torch.cat([final_mask, tool_slot_mask], dim=-1)
