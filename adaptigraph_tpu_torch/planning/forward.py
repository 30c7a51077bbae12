"""Batched forward dynamics for MPPI and physics identification (counterpart
of ``adaptigraph_tpu/planning/forward.py``).

``dynamics_rollout`` is the differentiable model of the gradient-descent
Planner: per substep the graph build and the training forward (K2 with its
activations kept, K3 in the backward), so gradients reach the actions.

``dynamics_rollout_batched`` advances a chunk of samples push by push, on
the JAX branches with ``use_fused``: for edge policy ``none`` (rope,
granular) each look-ahead step's whole push in one launch of the rollout
kernel (K1, ``fused_rollout_chunk``) or, per substep, one launch of the
single-step forward with its graph built in the kernel (K2e); for the tool
policies (cloth) per substep the graph built by ``ops.graph`` and one launch
of the single-step forward on it (K2). ``dynamics_masked`` (physics
identification) runs K1 for policy ``none`` and, for the tool policies, the
JAX per-sample rollout with per-sample masks, per substep the graph build and
one float32 K2 launch. On CPU tensors every
kernel is replaced by its plain version, so the JAX ``use_fused=False``
branch has no switch of its own here. The JAX ``_spb_for`` (samples per
kernel block, and its ``ADAPTIGRAPH_SPB`` variable) sizes TPU blocks and has
no counterpart: a CUDA block runs one sample at a time.
"""

import dataclasses

import torch

from adaptigraph_tpu_torch.models.gnn import GNNConfig
from adaptigraph_tpu_torch.ops.fused_gnn import (fused_forward_batch, fused_rollout_chunk,
                                                 weight_list)
from adaptigraph_tpu_torch.ops.fused_gnn_train import make_fused_train_forward
from adaptigraph_tpu_torch.ops.graph import EdgeConfig, build_neighbor_graph_batch
from adaptigraph_tpu_torch.planning.actions import decode_action
from adaptigraph_tpu_torch.utils.profiling import span


@dataclasses.dataclass(frozen=True)
class DynamicsConfig:
    """Static planning-time dynamics parameters (same fields as the JAX one)."""

    gnn: GNNConfig
    edge: EdgeConfig
    n_his: int
    push_length: float = 0.1
    sim_real_ratio: float = 10.0
    max_repeat: int = 15  # static bound: ceil(action_upper_lim[3])
    pusher_offsets: tuple = ()  # lateral offsets of the pusher points (5-pt board)
    gripper_enable: bool = False
    adj_thresh: float = 0.5
    use_mean_y: bool = False  # dynamics_masked re-sticks to the masked mean y

    def __post_init__(self):
        if self.n_his != self.gnn.n_his:
            raise ValueError(f"n_his {self.n_his} != gnn.n_his {self.gnn.n_his}")

    @property
    def gripper_lift(self):
        return 0.01 * self.sim_real_ratio if self.gripper_enable else 0.0


def pusher_keypoints(cfg: DynamicsConfig, decoded, theta, y):
    """eef keypoints and per-substep delta for a batch of pushes.

    decoded (B, 4) [x0, z0, x1, z1]; theta, y (B,). Returns kp and delta,
    both (B, max_neef, 3).
    """
    B = decoded.shape[0]
    n_eef = cfg.gnn.max_neef
    delta = torch.stack([decoded[:, 2] - decoded[:, 0], 0.0 * decoded[:, 0],
                         decoded[:, 3] - decoded[:, 1]], dim=-1)
    if cfg.pusher_offsets and len(cfg.pusher_offsets) > 1:
        # board pusher: points spread laterally by the configured offsets, sent
        # to the card from pinned memory (a copy from pageable memory waits on
        # the host)
        offs = torch.tensor(cfg.pusher_offsets, dtype=torch.float32)
        if decoded.is_cuda:
            offs = offs.pin_memory().to(decoded.device, non_blocking=True)
        offs = offs * cfg.sim_real_ratio
        xs = decoded[:, :1] + offs * torch.sin(theta)[:, None]
        zs = decoded[:, 1:2] - offs * torch.cos(theta)[:, None]
        kp = torch.stack([xs, y[:, None].expand_as(xs), zs], dim=-1)
    else:
        kp = torch.stack([decoded[:, 0], y, decoded[:, 1]], dim=-1)[:, None].expand(B, n_eef, 3)
    if cfg.gripper_enable:  # (0, lift, 0), made on the device: no host-to-device copy
        kp = kp + torch.where(torch.arange(3, device=kp.device) == 1,
                              0.01 * cfg.sim_real_ratio, 0.0)
    return kp, delta[:, None].expand(B, n_eef, 3)


def dynamics_rollout(params, state, action_seqs, physics_param, cfg: DynamicsConfig,
                     compute_dtype=torch.float32, step_fn=None):
    """The JAX ``dynamics_rollout``, differentiable with respect to
    ``action_seqs``: every sample's pushes substep by substep
    (``_push_substeps``), per substep the graph of the newest frame for the
    config's edge policy (all object slots valid) and one differentiable
    step. ``step_fn(params, state, action, physics, attrs, p_instance,
    neighbors, nbr_mask) -> pred``; None takes the training forward in
    ``compute_dtype`` (``make_fused_train_forward`` on ``topk + max_neef``
    slots: on CUDA K2 with its activations kept and K3 in the backward, on
    CPU their plain versions). The gradient reaches the actions through the
    pusher keypoints, the eef's delta (the step's ``d_state`` and
    ``d_action``) and the re-stick height (``amin``, which splits it evenly
    among tied minima, as JAX's ``min``). Substeps run to each push's
    largest repeat where JAX runs ``max_repeat``: the recorded states, and
    so their gradients, are the same.

    params: the nested parameter dict (float32); state (max_nobj, 3);
    action_seqs (B, L, 4); physics_param (phys_dim,). Returns
    ``state_seqs`` (B, L, max_nobj, 3) and the decoded ``action_seqs``.
    """
    gnn, edge = cfg.gnn, cfg.edge
    step_fn = step_fn or make_fused_train_forward(gnn, edge.topk + edge.max_neef, compute_dtype)
    decoded, repeat = decode_action(action_seqs, cfg.push_length)

    def fwd(g):
        return step_fn(params, g["state"], g["action"], g["physics_param"], g["attrs"],
                       g["p_instance"], g["neighbors"], g["nbr_mask"])

    node_mask = torch.ones(action_seqs.shape[0], gnn.n_nodes, dtype=torch.bool,
                           device=action_seqs.device)
    return {"state_seqs": _substep_pushes(fwd, state, action_seqs, decoded, repeat, physics_param,
                                          cfg, node_mask),
            "action_seqs": decoded}


def _obj_y_fn(cfg: DynamicsConfig):
    """Each sample's re-stick height: its min object y (``amin``, whose
    gradient splits evenly among tied minima), or the mean with
    ``use_mean_y``."""
    def obj_y(obj):
        return obj[..., 1].mean(dim=1) if cfg.use_mean_y else obj[..., 1].amin(dim=1)

    return obj_y


def _substep_pushes(fwd, state, action_seqs, decoded, repeat, physics_param, cfg: DynamicsConfig,
                    node_mask, n_substeps=None):
    """Every look-ahead push of every sample, substep by substep
    (``_push_substeps`` with ``fwd``, ``node_mask`` and step li's count
    ``n_substeps[li]``, None: read per step), each push from the states the
    previous one recorded. Returns (B, L, max_nobj, 3)."""
    gnn = cfg.gnn
    n_p, N = gnn.max_nobj, gnn.n_nodes
    B, L = action_seqs.shape[0], action_seqs.shape[1]
    dev = action_seqs.device
    obj_y = _obj_y_fn(cfg)
    is_tool = torch.arange(N, device=dev) >= n_p
    graph = {"attrs": torch.stack([~is_tool, is_tool], dim=-1).float().expand(B, N, 2),
             "p_instance": torch.ones(B, n_p, 1, device=dev),
             "physics_param": physics_param.float().expand(B, *physics_param.shape)}
    obj = state[None].expand(B, n_p, 3)
    outs = []
    for li in range(L):
        kp, delta = pusher_keypoints(cfg, decoded[:, li], action_seqs[:, li, 2], obj_y(obj))
        obj = _push_substeps(fwd, obj, kp, delta, repeat[:, li], graph, cfg, obj_y, node_mask,
                             None if n_substeps is None else n_substeps[li])
        outs.append(obj)
    return torch.stack(outs, dim=1)


def dynamics_rollout_batched(params, state, action_seqs, physics_param, cfg: DynamicsConfig,
                             compute_dtype=torch.bfloat16, fused_substeps=True, n_substeps=None):
    """MPPI forward model for one chunk of samples (the JAX
    ``dynamics_rollout_batched`` with ``use_fused`` and ``dynamic_substeps``).

    state (max_nobj, 3) object particles (all valid); action_seqs (B, L, 4);
    physics_param (phys_dim,). ``params`` is the nested parameter dict or
    ``weight_list``'s output in ``compute_dtype``. Branches, as the JAX
    function's:

    - policy ``none`` with ``fused_substeps``: each look-ahead step's whole
      push in one K1 launch;
    - policy ``none`` without it: per substep one K2e launch, the graph built
      in the kernel;
    - a tool policy: per substep the graph built by
      ``build_neighbor_graph_batch`` and one K2 launch on its ``topk +
      max_neef`` real slots.

    Per-substep branches run to the chunk's largest repeat, at most
    ``max_repeat``, and record each sample at its own repeat. That count is
    read on the host once per look-ahead step (``substep_counts``), unless
    the caller gives every step's count in ``n_substeps`` (L ints, read for
    many chunks at once). Returns ``state_seqs`` (B, L, max_nobj, 3) and the
    decoded ``action_seqs`` (B, L, 4).
    """
    gnn, edge = cfg.gnn, cfg.edge
    B, L = action_seqs.shape[0], action_seqs.shape[1]
    decoded, repeat = decode_action(action_seqs, cfg.push_length)
    weights = (params if isinstance(params, (list, tuple))
               else weight_list(params, gnn, compute_dtype))
    kernel_edges = edge.policy == "none"

    if kernel_edges and fused_substeps:
        obj_y = _obj_y_fn(cfg)
        obj = state[None].expand(B, gnn.max_nobj, 3)
        outs = []
        for li in range(L):
            with span("k1.inputs", stream=action_seqs.device):
                kp, delta = pusher_keypoints(cfg, decoded[:, li], action_seqs[:, li, 2],
                                             obj_y(obj))
            obj = fused_rollout_chunk(
                weights, obj, kp, delta, repeat[:, li], physics_param, gnn,
                adj_radius=float(cfg.adj_thresh), edge_topk=edge.topk,
                max_repeat=cfg.max_repeat, gripper_lift=cfg.gripper_lift,
                compute_dtype=compute_dtype, mean_y=cfg.use_mean_y)
            outs.append(obj)
        return {"state_seqs": torch.stack(outs, dim=1), "action_seqs": decoded}

    if kernel_edges:
        def fwd(g):
            return fused_forward_batch(weights, g, gnn, compute_dtype, want_motion=False,
                                       build_edges=True, adj_radius=float(cfg.adj_thresh),
                                       edge_topk=edge.topk)[0]
    else:
        def fwd(g):
            return fused_forward_batch(weights, g, gnn, compute_dtype, want_motion=False,
                                       k_used=edge.topk + edge.max_neef)[0]

    node_mask = (None if kernel_edges
                 else torch.ones(B, gnn.n_nodes, dtype=torch.bool, device=action_seqs.device))
    return {"state_seqs": _substep_pushes(fwd, state, action_seqs, decoded, repeat, physics_param,
                                          cfg, node_mask, n_substeps),
            "action_seqs": decoded}


def substep_counts(repeat, max_repeat):
    """The substeps that pushes run: the largest repeat along the last axis
    (the samples), at most ``max_repeat``, read on the host in one read: an
    int for ``repeat`` (B,), nested lists of ints for more axes."""
    return torch.clamp(repeat.amax(dim=-1), max=max_repeat).tolist()


def _push_substeps(fwd, obj, kp, delta, repeat, graph, cfg: DynamicsConfig, obj_y, node_mask,
                   n_steps=None):
    """One push of every sample, substep by substep, to the batch's largest
    repeat (at most ``max_repeat``; ``n_steps`` when the caller read it,
    else ``substep_counts`` here): the history starts as the object state
    (B, max_nobj, 3) and the eef keypoints kp repeated; per substep
    ``fwd(graph)`` predicts the objects (with ``node_mask`` (B, N), the
    graph is built first by ``build_neighbor_graph_batch`` on the newest
    frame; None: ``fwd`` builds it), each sample's state is recorded at its
    own repeat, and the eef advances by delta, re-stuck to ``obj_y`` of the
    prediction plus the gripper lift. ``graph`` holds the step's other
    inputs (attrs, p_instance, physics_param). Returns the recorded states."""
    gnn = cfg.gnn
    n_p, B = gnn.max_nobj, obj.shape[0]
    hist = torch.cat([obj, kp], dim=1)[:, None].expand(B, gnn.n_his, gnn.n_nodes, 3)
    action = torch.cat([torch.zeros(B, n_p, 3, device=obj.device), delta], dim=1)
    eef_mask = (torch.arange(gnn.n_nodes, device=obj.device) >= n_p).expand(B, gnn.n_nodes)
    graph = dict(graph, action=action)
    rec = obj
    if n_steps is None:
        n_steps = substep_counts(repeat, cfg.max_repeat) if B else 0
    for ai in range(1, n_steps + 1):
        graph["state"] = hist
        if node_mask is not None:
            graph["neighbors"], graph["nbr_mask"] = build_neighbor_graph_batch(
                hist[:, -1], node_mask, eef_mask, cfg.adj_thresh, cfg.edge)
        pred = fwd(graph)
        rec = torch.where((repeat == ai)[:, None, None], pred, rec)
        # the eef advances by its delta, re-stuck to the object height
        y = obj_y(pred) + cfg.gripper_lift
        eef = hist[:, -1, n_p:] + action[:, n_p:]
        eef = torch.stack([eef[..., 0], y[:, None].expand_as(eef[..., 1]), eef[..., 2]], dim=-1)
        hist = torch.cat([hist[:, 1:], torch.cat([pred, eef], dim=1)[:, None]], dim=1)
    return rec


def dynamics_masked(params, state_init, state_mask, actions, physics_params,
                    cfg: DynamicsConfig, compute_dtype=torch.bfloat16):
    """Per-sample masked dynamics for physics identification: each element has
    its own point cloud, mask, single action and physics parameter, and the eef
    re-sticks to the masked mean object y.

    state_init (B, max_nobj, 3); state_mask (B, max_nobj) bool; actions (B, 4);
    physics_params (B, phys_dim) or (phys_dim,). Returns (B, max_nobj, 3).

    Policy ``none``: one K1 launch in ``compute_dtype`` (the JAX ``use_fused``
    branch). A tool policy: the JAX ``_single_sample_rollout`` for every
    sample at once, to the largest repeat: per substep the graph of the
    newest frame on the sample's valid objects and the tools, then the
    float32 single-step forward on it (K2, ``topk + max_neef`` slots), which
    is what the JAX XLA forward computes; ``compute_dtype`` is not used, and
    ``params`` given as ``weight_list``'s output must be float32.
    """
    B = state_init.shape[0]
    if physics_params.dim() == 1:
        physics_params = physics_params[None].expand(B, physics_params.shape[0])
    mcfg = dataclasses.replace(cfg, use_mean_y=True)
    decoded, repeat = decode_action(actions[:, None, :], cfg.push_length)
    m = state_mask.to(torch.float32)

    def obj_y(obj):  # the masked mean object y
        return (obj[..., 1] * m).sum(dim=1) / torch.clamp(m.sum(dim=1), min=1.0)

    kp, delta = pusher_keypoints(mcfg, decoded[:, 0], actions[:, 2], obj_y(state_init))
    if cfg.edge.policy != "none":
        return _masked_tool_push(params, state_init, state_mask, kp, delta, repeat[:, 0],
                                 physics_params, mcfg, obj_y)
    return fused_rollout_chunk(
        params, state_init, kp, delta, repeat[:, 0], physics_params, cfg.gnn,
        adj_radius=float(cfg.adj_thresh), edge_topk=cfg.edge.topk,
        max_repeat=cfg.max_repeat, gripper_lift=cfg.gripper_lift,
        compute_dtype=compute_dtype, obj_mask=state_mask, mean_y=True)


def _masked_tool_push(params, state_init, state_mask, kp, delta, repeat, physics_params,
                      cfg: DynamicsConfig, obj_y):
    """``dynamics_masked`` for a tool policy: per-sample object validity in
    the graph build, attrs and p_instance, the float32 forward."""
    gnn, edge = cfg.gnn, cfg.edge
    f32 = torch.float32
    if isinstance(params, (list, tuple)):
        if any(w.dtype != f32 for w in params):
            raise ValueError("dynamics_masked with a tool policy runs the float32 forward: "
                             "pass the parameter dict or float32 weights")
        weights = params
    else:
        weights = weight_list(params, gnn, f32)
    B, n_p, n_eef = state_init.shape[0], gnn.max_nobj, gnn.max_neef
    valid = state_mask.to(f32)
    tools = torch.ones(B, n_eef, device=valid.device)
    attrs = torch.stack([torch.cat([valid, torch.zeros_like(tools)], 1),  # [object, tool]
                         torch.cat([torch.zeros_like(valid), tools], 1)], dim=-1)
    graph = {"attrs": attrs, "p_instance": valid[..., None],
             "physics_param": physics_params.to(f32)}
    node_mask = torch.cat([state_mask.bool(), tools.bool()], dim=1)

    def fwd(g):
        return fused_forward_batch(weights, g, gnn, f32, want_motion=False,
                                   k_used=edge.topk + edge.max_neef)[0]

    return _push_substeps(fwd, state_init.to(f32), kp, delta, repeat, graph, cfg, obj_y, node_mask)
