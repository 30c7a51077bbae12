"""Action encoding, sampling and the MPPI update (counterpart of
``adaptigraph_tpu/planning/actions.py``).

An action is ``(x, z, theta, length)``: a push starting at (x, z) in
direction theta, repeated ``int(length)`` sub-pushes of ``push_length`` each.
Randomness comes from a ``torch.Generator``; it gives other numbers than
``jax.random`` from the same seed, so parity tests feed both sides the same
samples.
"""

import math

import numpy as np
import torch


def decode_action(action, push_length=0.10):
    """(..., 4) action -> ((..., 4) [x0, z0, x1, z1], (...,) int32 repeats)."""
    x0 = action[..., 0]
    z0 = action[..., 1]
    theta = action[..., 2]
    repeat = action[..., 3].to(torch.int32)
    x1 = x0 - push_length * torch.cos(theta)
    z1 = z0 - push_length * torch.sin(theta)
    return torch.stack([x0, z0, x1, z1], dim=-1), repeat


def angle_normalize(x):
    return torch.remainder(x + math.pi, 2 * math.pi) - math.pi


def clip_actions(action, lower, upper):
    """Normalize the angle, then clamp every dimension to [lower, upper]."""
    action = torch.cat([action[..., :2], angle_normalize(action[..., 2:3]),
                        action[..., 3:]], dim=-1)
    return torch.minimum(torch.maximum(action, lower), upper)


def sample_action_seq(generator, act_seq, lower, upper, n_sample, iter_index=0,
                      noise_level=0.3, push_length=0.10):
    """Length-aware resampling around the current best sequence.

    iter 0: uniform over the action box. Later iterations perturb in endpoint
    space with per-step noise scale 0.1 * 10**i, re-encode to (theta,
    length) and keep sample 0 unperturbed. Tensors are made on
    ``act_seq.device`` from ``generator``, which must live there too.
    """
    L, A = act_seq.shape
    dev = act_seq.device
    if iter_index == 0:
        u = torch.rand((n_sample, L, A), generator=generator, device=dev)
        return u * (upper - lower) + lower

    xs, zs, thetas, lengths = act_seq.unbind(-1)
    x_ends = xs - lengths * push_length * torch.cos(thetas)
    z_ends = zs - lengths * push_length * torch.sin(thetas)
    rows = []
    for i in range(L):
        noise = torch.randn((n_sample, 4), generator=generator, device=dev) * noise_level
        res = 0.1 * (10.0 ** i) * noise
        xi = xs[i] + res[:, 0]
        zi = zs[i] + res[:, 1]
        xei = x_ends[i] + res[:, 2]
        zei = z_ends[i] + res[:, 3]
        thi = torch.atan2(zi - zei, xi - xei)
        leni = torch.sqrt((xei - xi) ** 2 + (zei - zi) ** 2) / push_length
        rows.append(clip_actions(torch.stack([xi, zi, thi, leni], dim=-1), lower, upper))
    samples = torch.stack(rows, dim=1)
    samples[0] = act_seq
    return samples


def sample_action_seq_correlated(generator, act_seq, lower, upper, n_sample, noise_level=0.1,
                                 beta_filter=0.7):
    """The Planner's default sampler: ``n_sample`` copies of ``act_seq``
    (L, A) plus low-pass filtered normal noise, clamped to [lower, upper].
    The normals, one (n_sample, A) draw per step, come from ``generator`` on
    ``act_seq.device``; ``correlated_action_seqs`` is the rest."""
    L, A = act_seq.shape
    normals = torch.randn((L, n_sample, A), generator=generator, device=act_seq.device)
    return correlated_action_seqs(normals, act_seq, lower, upper, noise_level, beta_filter)


def correlated_action_seqs(normals, act_seq, lower, upper, noise_level=0.1, beta_filter=0.7):
    """``sample_action_seq_correlated`` given its standard normals (L,
    n_sample, A): step l's residual is ``beta_filter * noise_level *
    normals[l]`` plus ``1 - beta_filter`` of step l-1's; the samples are
    ``act_seq`` plus the residuals, clamped. Returns (n_sample, L, A)."""
    residual = torch.zeros_like(normals[0])
    residuals = []
    for step in normals:
        residual = beta_filter * (step * noise_level) + residual * (1.0 - beta_filter)
        residuals.append(residual)
    out = act_seq[None] + torch.stack(residuals, dim=1)
    return torch.minimum(torch.maximum(out, lower), upper)


def optimize_action_mppi(act_seqs, reward_seqs, reward_weight=100.0, lower=None,
                         upper=None, push_length=0.10):
    """Softmax-weighted MPPI update in endpoint space."""
    w = torch.softmax(reward_seqs * reward_weight, dim=0)[:, None]
    xs, zs, thetas, lengths = act_seqs.unbind(-1)
    x_ends = xs - lengths * push_length * torch.cos(thetas)
    z_ends = zs - lengths * push_length * torch.sin(thetas)
    x = torch.sum(w * xs, dim=0)
    z = torch.sum(w * zs, dim=0)
    xe = torch.sum(w * x_ends, dim=0)
    ze = torch.sum(w * z_ends, dim=0)
    theta = torch.atan2(z - ze, x - xe)
    length = torch.sqrt((xe - x) ** 2 + (ze - z) ** 2) / push_length
    return clip_actions(torch.stack([x, z, theta, length], dim=-1), lower, upper)


def fps_action_grid(lower, upper, n_sample, grid_size=0.02):
    """Host FPS over the action grid (spacing ``grid_size`` in every
    dimension) for diverse initial samples, seeded at the point of largest
    motion (the second half of the dimensions against the first). Returns
    (n_sample, A) numpy."""
    from adaptigraph_tpu_torch.ops.fps import fps_numpy

    lower = np.asarray(lower)
    upper = np.asarray(upper)
    axes = [np.arange(lower[i], upper[i], grid_size) for i in range(len(lower))]
    grid = np.stack(np.meshgrid(*axes), axis=-1).reshape(-1, len(lower))
    c = grid.shape[1]
    motion = np.linalg.norm(grid[:, c // 2:] - grid[:, :c // 2], axis=1)
    idx = fps_numpy(grid, n_sample, start_idx=int(motion.argmax()))
    return grid[idx]
