"""Batched forward dynamics for MPPI and physics identification (counterpart
of ``adaptigraph_tpu/planning/forward.py``).

Both entry points run each look-ahead step's whole push through
``ops.fused_gnn.fused_rollout_chunk``: one kernel launch per step on CUDA,
its plain version on the CPU. Only edge policy ``none`` (rope, granular) is
ported; the tool policies need the single-step kernel of the cloth slice.
"""

import dataclasses

import torch

from adaptigraph_tpu_torch.models.gnn import GNNConfig
from adaptigraph_tpu_torch.ops.fused_gnn import fused_rollout_chunk, weight_list
from adaptigraph_tpu_torch.ops.graph import EdgeConfig
from adaptigraph_tpu_torch.planning.actions import decode_action


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
        # board pusher: points spread laterally by the configured offsets
        offs = torch.as_tensor(cfg.pusher_offsets, dtype=torch.float32,
                               device=decoded.device) * cfg.sim_real_ratio
        xs = decoded[:, :1] + offs * torch.sin(theta)[:, None]
        zs = decoded[:, 1:2] - offs * torch.cos(theta)[:, None]
        kp = torch.stack([xs, y[:, None].expand_as(xs), zs], dim=-1)
    else:
        kp = torch.stack([decoded[:, 0], y, decoded[:, 1]], dim=-1)[:, None].expand(B, n_eef, 3)
    if cfg.gripper_enable:
        kp = kp + torch.tensor([0.0, 0.01 * cfg.sim_real_ratio, 0.0], device=kp.device)
    return kp, delta[:, None].expand(B, n_eef, 3)


def _require_policy_none(cfg: DynamicsConfig):
    if cfg.edge.policy != "none":
        raise NotImplementedError(
            f"edge policy {cfg.edge.policy!r} needs the single-step kernel (cloth slice)")


def dynamics_rollout_batched(params, state, action_seqs, physics_param, cfg: DynamicsConfig,
                             compute_dtype=torch.bfloat16):
    """MPPI forward model for one chunk of samples.

    state (max_nobj, 3) object particles (all valid); action_seqs (B, L, 4);
    physics_param (phys_dim,). ``params`` is the nested parameter dict or
    ``weight_list``'s output in ``compute_dtype``. Returns ``state_seqs``
    (B, L, max_nobj, 3) and the decoded ``action_seqs`` (B, L, 4).
    """
    _require_policy_none(cfg)
    gnn = cfg.gnn
    B, L = action_seqs.shape[0], action_seqs.shape[1]
    decoded, repeat = decode_action(action_seqs, cfg.push_length)
    weights = (params if isinstance(params, (list, tuple))
               else weight_list(params, gnn, compute_dtype))
    obj = state[None].expand(B, gnn.max_nobj, 3)
    outs = []
    for li in range(L):
        y = obj[..., 1].mean(dim=1) if cfg.use_mean_y else obj[..., 1].amin(dim=1)
        kp, delta = pusher_keypoints(cfg, decoded[:, li], action_seqs[:, li, 2], y)
        obj = fused_rollout_chunk(
            weights, obj, kp, delta, repeat[:, li], physics_param, gnn,
            adj_radius=float(cfg.adj_thresh), edge_topk=cfg.edge.topk,
            max_repeat=cfg.max_repeat, gripper_lift=cfg.gripper_lift,
            compute_dtype=compute_dtype, mean_y=cfg.use_mean_y)
        outs.append(obj)
    return {"state_seqs": torch.stack(outs, dim=1), "action_seqs": decoded}


def dynamics_masked(params, state_init, state_mask, actions, physics_params,
                    cfg: DynamicsConfig, compute_dtype=torch.bfloat16):
    """Per-sample masked dynamics for physics identification: each element has
    its own point cloud, mask, single action and physics parameter, and the eef
    re-sticks to the masked mean object y.

    state_init (B, max_nobj, 3); state_mask (B, max_nobj) bool; actions (B, 4);
    physics_params (B, phys_dim) or (phys_dim,). Returns (B, max_nobj, 3).
    """
    _require_policy_none(cfg)
    B = state_init.shape[0]
    if physics_params.dim() == 1:
        physics_params = physics_params[None].expand(B, physics_params.shape[0])
    mcfg = dataclasses.replace(cfg, use_mean_y=True)
    decoded, repeat = decode_action(actions[:, None, :], cfg.push_length)
    m = state_mask.to(torch.float32)
    y0 = (state_init[..., 1] * m).sum(dim=1) / torch.clamp(m.sum(dim=1), min=1.0)
    kp, delta = pusher_keypoints(mcfg, decoded[:, 0], actions[:, 2], y0)
    return fused_rollout_chunk(
        params, state_init, kp, delta, repeat[:, 0], physics_params, cfg.gnn,
        adj_radius=float(cfg.adj_thresh), edge_topk=cfg.edge.topk,
        max_repeat=cfg.max_repeat, gripper_lift=cfg.gripper_lift,
        compute_dtype=compute_dtype, obj_mask=state_mask, mean_y=True)
