"""Plain reference of one MPPI solve of the rope planning task: the samples
drawn from the solve's generator state, their order by summed push repeats,
each sample's whole push through ``gnn.rollout``, the reward (Chamfer to the
target, the rope and workspace penalties, normalised per chunk) and the best
sample. Imports nothing of the port.
"""

import math

import torch

from reference import gnn


def chamfer(x, y, eps=1e-12):
    """Mean nearest-neighbour distance both ways. x (B, N, 3), y (B, M, 3)."""
    diff = x[:, :, None, :] - y[:, None, :, :]
    dist = torch.sqrt(torch.sum(diff * diff, dim=-1) + eps)
    return dist.amin(dim=-1).mean(dim=-1) + dist.amin(dim=-2).mean(dim=-1)


def rope_penalty(final, action, state_init, sim_real_ratio):
    """Push starts near the rope: exp(-100 (d - 0.02 ratio)+), d the start's
    planar distance to the nearest particle of the state the push starts
    from (one look-ahead step: the initial state). final (B, N, 3), action
    (B, 4), state_init (N, 3) -> (B,)."""
    pt = action[:, :2]
    d = torch.linalg.norm(pt[:, None, :] - state_init[None, :, ::2], dim=-1).amin(dim=-1)
    return torch.exp(-torch.clamp(d - 0.02 * sim_real_ratio, min=0.0) * 100.0)


def bbox_penalty(final, bbox):
    """exp(-100 x) of how far the final state's extent stays inside the
    workspace, the largest of the four sides. final (B, N, 3), bbox (2, 2)."""
    x, z = final[..., 0], final[..., 2]
    pens = torch.stack([torch.clamp(x.amin(-1) - bbox[0, 0], min=0.0),
                        torch.clamp(bbox[0, 1] - x.amax(-1), min=0.0),
                        torch.clamp(z.amin(-1) - bbox[1, 0], min=0.0),
                        torch.clamp(bbox[1, 1] - z.amax(-1), min=0.0)], dim=-1)
    return torch.exp(-pens * 100.0).amax(dim=-1)


def reward(final, action, state_init, target, task, dtype=torch.float32):
    """-2 err / max(err) over the chunk - 5 rope penalty - 5 workspace
    penalty, err the Chamfer distance to the target; computed in ``dtype``
    (float32; the control's bfloat16), returned in float32."""
    final, action, state_init, target = (t.to(dtype) for t in (final, action, state_init, target))
    err = chamfer(final, target[None].expand(final.shape[0], *target.shape))
    r = -(2.0 / (err.max() + 1e-6)) * err
    r = r - 5.0 * rope_penalty(final, action, state_init, task["sim_real_ratio"])
    return (r - 5.0 * bbox_penalty(final, task["bbox"].to(dtype))).float()


def draw_samples(gen_state, task, device):
    """The first iteration's samples: uniform over the action box, drawn
    from a generator in ``gen_state``, then stably ordered by summed repeat."""
    gen = torch.Generator(device=device)
    gen.set_state(gen_state)
    lower, upper = task["lower"].to(device), task["upper"].to(device)
    u = torch.rand((task["n_sample"], 1, lower.shape[0]), generator=gen, device=device)
    samples = u * (upper - lower) + lower
    repeat = samples[..., 3].to(torch.int32)
    return samples[torch.argsort(repeat.sum(dim=1), stable=True)][:, 0]


def solve(params, m, task, state, target, phys, gen_state, chunk, device, num=gnn.F32,
          block=1000):
    """The reference solve. ``task``: the planning settings (``n_sample``,
    ``push_length``, ``lower``/``upper``, ``max_repeat``, ``adj_thresh``,
    ``sim_real_ratio``, ``bbox``); state (n_p, 3), target (M, 3), phys
    (phys_dim,). Rolls out ``block`` samples at a time. Returns the sorted
    samples (S, 4), their final states (S, n_p, 3), rewards (S,) and the
    work the rollout counted per chunk (``stats``)."""
    samples = draw_samples(gen_state, task, device)
    state, target = state.to(device).float(), target.to(device).float()
    phys = phys.to(device).float()
    finals, rewards, stats = [], [], []
    for c in range(0, samples.shape[0], chunk):
        acts = samples[c:c + chunk]
        st = {}
        outs = []
        for b in range(0, acts.shape[0], block):
            a = acts[b:b + block]
            B = a.shape[0]
            x0, z0, theta = a[:, 0], a[:, 1], a[:, 2]
            x1 = x0 - task["push_length"] * torch.cos(theta)
            z1 = z0 - task["push_length"] * torch.sin(theta)
            obj = state[None].expand(B, *state.shape)
            y = obj[..., 1].amin(dim=1)
            kp = torch.stack([x0, y, z0], dim=-1)[:, None].expand(B, m["max_neef"], 3)
            delta = torch.stack([x1 - x0, torch.zeros_like(x0), z1 - z0],
                                dim=-1)[:, None].expand(B, m["max_neef"], 3)
            with torch.no_grad():
                outs.append(gnn.rollout(params, m, obj, kp, delta, a[:, 3].to(torch.int32),
                                        phys[None].expand(B, -1), task["adj_thresh"],
                                        task["max_repeat"], num, st))
        fin = torch.cat(outs)
        finals.append(fin)
        rewards.append(reward(fin, acts, state, target, task))
        stats.append(st)
    return samples, torch.cat(finals), torch.cat(rewards), stats


def task_settings(planning, device):
    """The planning settings the reference reads from the configuration's
    planning task (the yaml's ``task_config``)."""
    ratio = float(planning.get("sim_real_ratio", 10.0))
    lower = torch.tensor(planning["action_lower_lim"], dtype=torch.float32)
    upper = torch.tensor(planning["action_upper_lim"], dtype=torch.float32)
    bbox = torch.tensor(planning["bbox"][:4], dtype=torch.float32).reshape(2, 2) * ratio
    if planning.get("n_look_ahead", 1) != 1 or planning.get("n_update_iter", 1) != 1:
        raise ValueError("the reference solves one look-ahead step and one update iteration")
    if planning.get("penalty_type") != "rope" or planning.get("target_type") != "pcd":
        raise ValueError("the reference scores the rope task (pcd target, rope penalty)")
    if planning.get("gripper_enable") or len(planning.get("pusher_points", [0.0])) != 1:
        raise ValueError("the reference pushes with one pusher point and no gripper")
    return {"n_sample": int(planning["n_sample"]), "n_sample_chunk": int(planning["n_sample_chunk"]),
            "push_length": float(planning.get("push_length", 0.1)), "lower": lower,
            "upper": upper, "max_repeat": int(math.ceil(planning["action_upper_lim"][3])),
            "adj_thresh": float(planning.get("adj_thresh", 0.5)), "sim_real_ratio": ratio,
            "bbox": bbox.to(device), "reward_weight": float(planning.get("reward_weight", 500.0))}
