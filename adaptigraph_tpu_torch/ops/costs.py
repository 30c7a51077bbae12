"""Planning costs and penalties (counterpart of ``adaptigraph_tpu/ops/costs.py``).

Plain PyTorch: the JAX package computes these outside any kernel too.
``emd_hungarian`` runs on the host, as the JAX one does.
"""

import math

import torch


def chamfer(x, y, x_mask=None, y_mask=None, eps=1e-12):
    """Symmetric Chamfer distance: mean nearest-neighbour euclidean distance
    in both directions. x (..., N, D), y (..., M, D), optional bool masks
    (..., N) / (..., M). Returns (...,)."""
    diff = x[..., :, None, :] - y[..., None, :, :]
    dist = torch.sqrt(torch.sum(diff * diff, dim=-1) + eps)
    inf = float("inf")  # a Python number: a tensor made from it would be a host-to-device copy
    if x_mask is not None:
        dist = torch.where(x_mask[..., :, None], dist, inf)
    if y_mask is not None:
        dist = torch.where(y_mask[..., None, :], dist, inf)
    d_xy = dist.amin(dim=-1)
    d_yx = dist.amin(dim=-2)
    if x_mask is not None:
        d_xy = torch.where(x_mask, d_xy, torch.zeros_like(d_xy))
        n_x = torch.clamp(x_mask.sum(dim=-1), min=1)
    else:
        n_x = x.shape[-2]
    if y_mask is not None:
        d_yx = torch.where(y_mask, d_yx, torch.zeros_like(d_yx))
        n_y = torch.clamp(y_mask.sum(dim=-1), min=1)
    else:
        n_y = y.shape[-2]
    return d_xy.sum(dim=-1) / n_x + d_yx.sum(dim=-1) / n_y


def masked_chamfer(state_pred, state_real, pred_mask, real_mask):
    """Per-sample masked Chamfer: (B, N, 3) states, (B, N) bool masks -> (B,)."""
    return chamfer(state_pred, state_real, pred_mask, real_mask)


def box_loss(state, target, mask=None):
    """Mean planar distance of particles to a target box.
    state (..., N, 3); target (2, 2) [[xmin, xmax], [zmin, zmax]]."""
    xmin, xmax = target[0, 0], target[0, 1]
    zmin, zmax = target[1, 0], target[1, 1]
    x = state[..., 0]
    z = state[..., 2]
    x_diff = torch.clamp(xmin - x, min=0.0) + torch.clamp(x - xmax, min=0.0)
    z_diff = torch.clamp(zmin - z, min=0.0) + torch.clamp(z - zmax, min=0.0)
    r = torch.sqrt(x_diff ** 2 + z_diff ** 2)
    if mask is not None:
        r = torch.where(mask, r, torch.zeros_like(r))
        return r.sum(dim=-1) / torch.clamp(mask.sum(dim=-1), min=1)
    return r.mean(dim=-1)


def _prev_states_2d(state_pred, state_init, B):
    """(B, L, N, 2) x/z of the state each step starts from: the initial state,
    then the predicted states of the earlier steps. (x, z) is the stride-2
    slice of (x, y, z): an index list would be copied to the card and read
    there after a host wait."""
    init_2d = state_init[:, ::2].expand(B, 1, *state_init[:, ::2].shape)
    return torch.cat([init_2d, state_pred[:, :-1][..., ::2]], dim=1)


def rope_penalty(state_pred, action, state_init, sim_real_ratio=10.0):
    """Keep the pusher start near the rope. state_pred (B, L, N, 3), action
    (B, L, 4), state_init (N, 3) -> (B, L) penalty in [0, 1]."""
    B = action.shape[0]
    pt = action[..., :2]
    d = torch.linalg.norm(pt[:, :, None] - _prev_states_2d(state_pred, state_init, B),
                          dim=-1).amin(dim=-1)
    d = torch.clamp(d - 0.02 * sim_real_ratio, min=0.0)
    return torch.exp(-d * 100.0)


def cloth_penalty(state_pred, action, state_init, sim_real_ratio=10.0):
    """Encourage the gripper to grasp near the cloth edge."""
    pt = action[..., :2]
    state_2d = state_init[:, ::2]
    d = torch.linalg.norm(pt[:, :, None] - state_2d[None, None], dim=-1)
    d_min = torch.clamp(d.amin(dim=-1) - 0.005 * sim_real_ratio, min=0.0)
    d_max = torch.clamp(d.amax(dim=-1), max=0.4 * sim_real_ratio)
    d_max = d_max / torch.clamp(d_max.max(), min=1e-6)
    return 1.0 - torch.exp(-d_min * 100.0) - d_max * 0.2


def granular_penalty(state_pred, action, state_init, sim_real_ratio=10.0):
    """9-point board-sweep proximity penalty -> (B, L)."""
    B = action.shape[0]
    x0, z0, theta = action[..., 0], action[..., 1], action[..., 2]
    pusher_radius = 0.05 * sim_real_ratio
    dx = pusher_radius * torch.sin(theta)
    dz = -pusher_radius * torch.cos(theta)
    fracs = torch.linspace(-1.0, 1.0, 9, dtype=action.dtype, device=action.device)
    pts = torch.stack([x0[..., None] + fracs * dx[..., None],
                       z0[..., None] + fracs * dz[..., None]], dim=-1)  # (B, L, 9, 2)
    state_2d = _prev_states_2d(state_pred, state_init, B)
    d = torch.linalg.norm(pts[:, :, :, None] - state_2d[:, :, None], dim=-1)
    d = d.amin(dim=-1).amin(dim=-1)
    d = torch.clamp(d - 0.02 * sim_real_ratio, min=0.0)
    return torch.exp(-d * 100.0)


def bbox_penalty(state, bbox):
    """Workspace bounding-box exp penalty. state (B, L, N, 3), bbox (2, 2) -> (B, L)."""
    xmax = state[..., 0].amax(dim=-1)
    xmin = state[..., 0].amin(dim=-1)
    zmax = state[..., 2].amax(dim=-1)
    zmin = state[..., 2].amin(dim=-1)
    pens = torch.stack([
        torch.clamp(xmin - bbox[0, 0], min=0.0),
        torch.clamp(bbox[0, 1] - xmax, min=0.0),
        torch.clamp(zmin - bbox[1, 0], min=0.0),
        torch.clamp(bbox[1, 1] - zmax, min=0.0),
    ], dim=-1)
    return torch.exp(-pens * 100.0).amax(dim=-1)


def hausdorff(x, y, x_mask=None, y_mask=None, eps=1e-12):
    """Symmetric Hausdorff distance: the largest directed nearest-neighbour
    distance each way, summed. x (..., N, D), y (..., M, D), optional bool
    masks (..., N) / (..., M). Returns (...,)."""
    diff = x[..., :, None, :] - y[..., None, :, :]
    dist = torch.sqrt(torch.sum(diff * diff, dim=-1) + eps)
    inf = float("inf")
    if x_mask is not None:
        dist = torch.where(x_mask[..., :, None], dist, inf)
    if y_mask is not None:
        dist = torch.where(y_mask[..., None, :], dist, inf)
    d_xy = dist.amin(dim=-1)
    d_yx = dist.amin(dim=-2)
    if x_mask is not None:
        d_xy = torch.where(x_mask, d_xy, -inf)
    if y_mask is not None:
        d_yx = torch.where(y_mask, d_yx, -inf)
    return d_xy.amax(dim=-1) + d_yx.amax(dim=-1)


def emd_hungarian(x, y):
    """Earth mover's distance by exact assignment (scipy's Hungarian solver
    per batch element, on the host). x, y (B, N, D) equal-size point sets,
    tensors or arrays -> (B,) float32 numpy mean matched distance. Use
    ``emd_sinkhorn`` for a differentiable one on the device."""
    import numpy as np
    from scipy.optimize import linear_sum_assignment

    def host(a):
        return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)

    x, y = host(x), host(y)
    out = np.zeros(x.shape[0], np.float32)
    for i in range(x.shape[0]):
        cost = np.linalg.norm(x[i][:, None, :] - y[i][None, :, :], axis=-1)
        r, c = linear_sum_assignment(cost)
        out[i] = cost[r, c].mean()
    return out


def emd_sinkhorn(x, y, epsilon=0.02, n_iters=50):
    """Entropy-regularised EMD by log-domain Sinkhorn with a fixed number of
    iterations: batched and differentiable, it tends to ``emd_hungarian`` as
    epsilon -> 0. x, y (B, N, D) -> (B,) transport cost under the plan."""
    diff = x[:, :, None, :] - y[:, None, :, :]
    C = torch.sqrt(torch.sum(diff * diff, dim=-1) + 1e-12)  # (B, N, M)
    B, N, M = C.shape
    log_a = torch.full((B, N), -math.log(N), dtype=C.dtype, device=C.device)
    log_b = torch.full((B, M), -math.log(M), dtype=C.dtype, device=C.device)
    f = torch.zeros(B, N, dtype=C.dtype, device=C.device)
    g = torch.zeros(B, M, dtype=C.dtype, device=C.device)
    for _ in range(n_iters):
        f = -epsilon * torch.logsumexp((g[:, None, :] - C) / epsilon + log_b[:, None, :], dim=-1)
        g = -epsilon * torch.logsumexp((f[:, :, None] - C) / epsilon + log_a[:, :, None], dim=-2)
    P = torch.exp((f[:, :, None] + g[:, None, :] - C) / epsilon
                  + log_a[:, :, None] + log_b[:, None, :])
    return torch.sum(P * C, dim=(-2, -1))
