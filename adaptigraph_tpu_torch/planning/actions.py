"""Action encoding, sampling and the MPPI update (counterpart of
``adaptigraph_tpu/planning/actions.py``).

An action is ``(x, z, theta, length)``: a push starting at (x, z) in
direction theta, repeated ``int(length)`` sub-pushes of ``push_length`` each.
Randomness comes from a ``torch.Generator``; it gives other numbers than
``jax.random`` from the same seed, so parity tests feed both sides the same
samples.
"""

import math

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
