"""Plain reference of the trainer's first optimizer steps: the compact batch
expanded to every node, the augmentation (uniform state noise, one rotation
about the vertical axis per sample, physics noise; drawn from a generator in
the state the program's generator had), the radius-and-top-k graph of the
augmented pre-rollout frame, ``n_future`` autoregressive steps of
``gnn.step_forward`` summed as per-step MSE, the gradient by autograd and
Adam with optax's defaults. Float32 with TF32 off. Imports nothing of the
port.
"""

import math

import torch

from reference import gnn


def expand(batch, m):
    """A compact batch (the dataset's numpy arrays on the device) with every
    node: the pusher rows filled into full-node arrays."""
    n_p, N = m["max_nobj"], m["n_nodes"]
    obj = batch["obj_mask"]
    B = obj.shape[0]
    dev = obj.device
    f = obj.float()

    def full(eef, lead):
        out = torch.zeros(*lead, N, 3, dtype=torch.float32, device=dev)
        out[..., n_p:, :] = eef
        return out

    attrs = torch.zeros(B, N, 2, dtype=torch.float32, device=dev)
    attrs[:, :n_p, 0] = f
    attrs[:, n_p:, 1] = 1.0
    nf1 = batch["eef_future_kp"].shape[1]
    return {"state": batch["state"], "action": full(batch["action_eef"], (B,)),
            "eef_future": full(batch["eef_future_kp"], (B, nf1)),
            "action_future": full(batch["action_future_kp"], (B, nf1)),
            "state_future": batch["state_future"], "attrs": attrs, "p_instance": f[:, :, None],
            "state_mask": torch.cat([obj, torch.ones(B, N - n_p, dtype=torch.bool, device=dev)], 1),
            "eef_mask": (torch.arange(N, device=dev) >= n_p).expand(B, N),
            "physics_param": batch["physics_param"], "adj_thresh": batch["adj_thresh"],
            "knn_frac": batch["knn_frac"]}


def augment(batch, gen, state_noise, phys_noise):
    def uniform(shape, lo, hi):
        return lo + (hi - lo) * torch.rand(shape, generator=gen, device=gen.device,
                                           dtype=torch.float32)

    noise = uniform(batch["state"].shape, -state_noise, state_noise)
    theta = uniform(batch["state"].shape[:1], -math.pi, math.pi)
    dphys = uniform(batch["physics_param"].shape, -phys_noise, phys_noise)
    c, s = torch.cos(theta), torch.sin(theta)
    z, o = torch.zeros_like(c), torch.ones_like(c)
    rot = torch.stack([torch.stack([c, -s, z], -1), torch.stack([s, c, z], -1),
                       torch.stack([z, z, o], -1)], dim=-2)

    def rmul(x):
        return torch.einsum("b...i,bij->b...j", x, rot)

    return dict(batch, state=rmul(batch["state"] + noise), action=rmul(batch["action"]),
                eef_future=rmul(batch["eef_future"]), action_future=rmul(batch["action_future"]),
                state_future=rmul(batch["state_future"]),
                physics_param=batch["physics_param"] + dphys)


def loss_and_edges(params, m, batch, policy, n_future, store_rest_state, num=gnn.F32):
    """The summed per-step MSE of ``n_future`` predictions, and the real
    edges a sample in the graph they share."""
    state = batch["state"]
    nbrs, mask = gnn.neighbor_graph(state[:, -1], batch["state_mask"], batch["eef_mask"],
                                    batch["adj_thresh"], m, policy, batch["knn_frac"])
    n_p = m["max_nobj"]
    hist, action, total = state, batch["action"], 0.0
    for fi in range(n_future):
        pred = gnn.step_forward(params, m, hist, action, batch["physics_param"], batch["attrs"],
                                batch["p_instance"], nbrs, mask, num)
        total = total + torch.mean((pred - batch["state_future"][:, fi]) ** 2)
        if fi < n_future - 1:
            nxt = torch.cat([pred, batch["eef_future"][:, fi, n_p:]], dim=1)
            hist = (torch.cat([hist[:, :1], hist[:, 2:], nxt[:, None]], dim=1) if store_rest_state
                    else torch.cat([hist[:, 1:], nxt[:, None]], dim=1))
            action = batch["action_future"][:, fi]
    return total, float(mask.sum()) / mask.shape[0]


B1, B2, EPS = 0.9, 0.999, 1e-8


@torch.no_grad()
def adam_step(leaves, grads, state, lr):
    """optax's adam(lr): b1 0.9, b2 0.999, eps 1e-8, bias-corrected moments."""
    b1, b2, eps = B1, B2, EPS
    state["count"] += 1
    c1, c2 = 1 - b1 ** state["count"], 1 - b2 ** state["count"]
    for p, g, mu, nu in zip(leaves, grads, state["mu"], state["nu"]):
        mu.mul_(b1).add_((1 - b1) * g)
        nu.mul_(b2).add_((1 - b2) * g * g)
        p.add_(-lr * ((mu / c1) / (torch.sqrt(nu / c2) + eps)))


def steps(params, m, train, batches, gen_state, device, num=gnn.F32, adam=None):
    """``len(batches)`` optimizer steps from ``params`` on compact batches
    (dicts of tensors on ``device``), from a fresh Adam state or from
    ``adam`` (``count``, ``mu``, ``nu``; copied, not changed). ``train``:
    ``policy``, ``n_future``, ``store_rest_state``, ``lr``,
    ``use_augmentation``, ``state_noise``, ``phys_noise``. Returns each
    step's loss, the first step's gradient per leaf, the leaves after the
    steps, the real edges a sample of each step's graph and Adam's first
    moment after the steps."""
    leaves = [p.detach().float().clone().requires_grad_(True) for p in gnn.tree_leaves(params)]
    if adam is None:
        state = {"count": 0, "mu": [torch.zeros_like(p) for p in leaves],
                 "nu": [torch.zeros_like(p) for p in leaves]}
    else:
        state = {"count": adam["count"], "mu": [t.detach().float().clone() for t in adam["mu"]],
                 "nu": [t.detach().float().clone() for t in adam["nu"]]}
    gen = torch.Generator(device=device)
    gen.set_state(gen_state)
    losses, edges, first_grads = [], [], None
    for compact in batches:
        batch = expand(compact, m)
        if train["use_augmentation"]:
            batch = augment(batch, gen, train["state_noise"], train["phys_noise"])
        loss, e = loss_and_edges(gnn.tree_from_leaves(leaves), m, batch, train["policy"],
                                 train["n_future"], train["store_rest_state"], num)
        grads = torch.autograd.grad(loss, leaves)
        if first_grads is None:
            first_grads = [g.detach().clone() for g in grads]
        adam_step(leaves, grads, state, train["lr"])
        losses.append(float(loss.detach()))
        edges.append(e)
    return losses, first_grads, [p.detach() for p in leaves], edges, state["mu"]
