"""Particle-relation interaction network (counterpart of
``adaptigraph_tpu/models/gnn.py``).

Parameters are a plain nested dict of tensors with the JAX layout
(``particle_encoder`` / ``relation_encoder`` / ``non_rigid_predictor``: three
``{"w": (n_in, n_out), "b": (n_out,)}`` layers; ``particle_propagator`` and
``relation_propagator``: one such layer). ``forward_batch`` is the plain
batched forward with the same branches as the JAX ``forward``; sender
features are index gathers instead of the JAX one-hot matmul.
"""

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class GNNConfig:
    """Static model hyperparameters (same fields as the JAX ``GNNConfig``)."""

    n_his: int = 4
    max_nobj: int = 100
    max_neef: int = 1

    nf_particle: int = 150
    nf_relation: int = 150
    nf_effect: int = 150

    attr_dim: int = 2
    state_dim: int = 0
    offset_dim: int = 0
    action_dim: int = 3
    density_dim: int = 0

    pstep: int = 3

    rel_particle_dim: int = 0  # -1 means "same as particle input dim"
    rel_attr_dim: int = 2
    rel_group_dim: int = 1
    rel_distance_dim: int = 3
    rel_density_dim: int = 0

    phys_dim: int = 1
    n_instance: int = 1
    motion_clamp: float = 100.0

    @property
    def n_nodes(self):
        return self.max_nobj + self.max_neef

    @property
    def particle_input_dim(self):
        return (
            self.n_his * self.state_dim
            + self.n_his * self.offset_dim
            + self.attr_dim
            + self.action_dim
            + self.density_dim
            + self.phys_dim
        )

    @property
    def rel_particle_dim_resolved(self):
        return self.particle_input_dim if self.rel_particle_dim == -1 else self.rel_particle_dim

    @property
    def relation_input_dim(self):
        return (
            self.rel_particle_dim_resolved * 2
            + self.rel_attr_dim * 2
            + self.rel_group_dim
            + self.rel_distance_dim * self.n_his
            + self.rel_density_dim
        )


def model_config_from_yaml(config, material=None):
    """Build a GNNConfig from a dynamics config dict."""
    mc = config["model_config"]
    dc = config["dataset_config"]
    matc = config["material_config"]
    material = material or dc["materials"][0]
    phys_dim = sum(1 for p in matc[material]["physics_params"] if p["use"])
    ds = dc["datasets"][0]
    return GNNConfig(
        n_his=dc["n_his"],
        max_nobj=ds["max_nobj"],
        max_neef=dc["eef"]["max_neef"],
        nf_particle=mc["nf_particle"],
        nf_relation=mc["nf_relation"],
        nf_effect=mc["nf_effect"],
        attr_dim=mc["attr_dim"],
        state_dim=mc["state_dim"],
        offset_dim=mc["offset_dim"],
        action_dim=mc["action_dim"],
        density_dim=mc["density_dim"],
        pstep=mc["pstep"],
        rel_particle_dim=mc["rel_particle_dim"],
        rel_attr_dim=mc["rel_attr_dim"],
        rel_group_dim=mc["rel_group_dim"],
        rel_distance_dim=mc["rel_distance_dim"],
        rel_density_dim=mc["rel_density_dim"],
        phys_dim=phys_dim,
        n_instance=1,
    )


def params_from_numpy(tree, device, dtype=torch.float32):
    """JAX parameter pytree (nested dicts/lists of numpy arrays, as
    ``utils.checkpoint.load_checkpoint`` returns) -> the same nesting of
    tensors on ``device``."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_from_numpy(v, device, dtype) for v in tree]
    return torch.tensor(np.asarray(tree)).to(device=device, dtype=dtype)


def params_to_numpy(tree):
    """Inverse of ``params_from_numpy``: the same nesting of float32 numpy arrays."""
    if isinstance(tree, dict):
        return {k: params_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_to_numpy(v) for v in tree]
    return tree.detach().to("cpu", torch.float32).numpy()


def _linear_init(generator, n_in, n_out):
    # U(-1/sqrt(n_in), 1/sqrt(n_in)) for both W and b (torch nn.Linear's default,
    # as in the JAX init_params)
    bound = 1.0 / float(np.sqrt(n_in))

    def uniform(*shape):
        return (torch.rand(*shape, generator=generator, device=generator.device) * 2.0 - 1.0) * bound

    return {"w": uniform(n_in, n_out), "b": uniform(n_out)}


def _mlp3_init(generator, n_in, n_hidden, n_out):
    return [_linear_init(generator, n_in, n_hidden), _linear_init(generator, n_hidden, n_hidden),
            _linear_init(generator, n_hidden, n_out)]


def init_params(generator, cfg: GNNConfig):
    """A fresh parameter dict with the JAX ``init_params`` shapes, float32 on
    the generator's device, drawn from ``generator`` (a ``torch.Generator``)."""
    nf = cfg.nf_effect
    return {
        "particle_encoder": _mlp3_init(generator, cfg.particle_input_dim, cfg.nf_particle, nf),
        "relation_encoder": _mlp3_init(generator, cfg.relation_input_dim, cfg.nf_relation, nf),
        "particle_propagator": _linear_init(generator, 2 * nf, nf),
        "relation_propagator": _linear_init(generator, 3 * nf, nf),
        "non_rigid_predictor": _mlp3_init(generator, nf, nf, 3),
    }


def count_params(params):
    """Number of scalars in a parameter nesting (tensors or numpy arrays)."""
    if isinstance(params, dict):
        return sum(count_params(v) for v in params.values())
    if isinstance(params, (list, tuple)):
        return sum(count_params(v) for v in params)
    return int(np.prod(params.shape))


def _linear(p, x):
    return x @ p["w"].to(x.dtype) + p["b"].to(x.dtype)


def _encoder(p, x):
    x = torch.relu(_linear(p[0], x))
    x = torch.relu(_linear(p[1], x))
    return torch.relu(_linear(p[2], x))


def _predictor(p, x):
    x = torch.relu(_linear(p[0], x))
    x = torch.relu(_linear(p[1], x))
    return _linear(p[2], x)


def gather_senders(x, neighbors):
    """Sender features ``x (B, N, F)`` at ``neighbors (B, N, K)`` -> (B, N, K, F)."""
    b = torch.arange(x.shape[0], device=x.device)[:, None, None]
    return x[b, neighbors.long()]


def forward_batch(params, graphs, cfg: GNNConfig, compute_dtype=torch.float32):
    """Batched forward; every graph field has a leading batch axis.

    graphs: state (B, n_his, N, 3), attrs (B, N, attr_dim), neighbors
    (B, N, K) int, nbr_mask (B, N, K) bool, action (B, N, 3), p_instance
    (B, max_nobj, n_instance), physics_param (B, phys_dim) or
    (B, max_nobj) per particle, particle_den (B,) when density_dim > 0.

    Returns pred_pos and the unclamped motion, both (B, max_nobj, 3) f32.
    """
    cd = compute_dtype
    state = graphs["state"].to(cd)
    attrs = graphs["attrs"].to(cd)
    neighbors = graphs["neighbors"]
    nbr_mask = graphs["nbr_mask"]
    action = graphs["action"].to(cd)
    p_instance = graphs["p_instance"].to(cd)

    B = state.shape[0]
    n_his = cfg.n_his
    N = cfg.n_nodes
    n_p, n_s = cfg.max_nobj, cfg.max_neef
    K = neighbors.shape[-1]

    def gather_s(x):
        return gather_senders(x, neighbors)

    def recv(x):
        return x[:, :, None, :].expand(B, N, K, x.shape[-1])

    # [res_0, ..., res_{h-2}, cur] per particle: (B, N, n_his*3)
    state_res = state[:, 1:] - state[:, :-1]
    state_norm = torch.cat([state_res, state[:, -1:]], dim=1)
    state_norm_t = state_norm.permute(0, 2, 1, 3).reshape(B, N, n_his * 3)

    parts = [attrs]
    if cfg.state_dim > 0:
        parts.append(state_norm_t)
    phys = graphs["physics_param"].to(cd)
    if phys.dim() == 2 and phys.shape[-1] == cfg.phys_dim:
        # one value per material, broadcast over the object particles
        phys_p = phys[:, None, :].expand(B, n_p, cfg.phys_dim)
    else:
        phys_p = phys.reshape(B, n_p, cfg.phys_dim)
    phys_full = torch.cat([phys_p, torch.zeros(B, n_s, cfg.phys_dim, dtype=cd,
                                               device=state.device)], dim=1)
    parts.append(phys_full)
    if cfg.action_dim > 0:
        parts.append(action)
    if cfg.density_dim > 0:
        den = graphs["particle_den"].to(cd).reshape(B, 1, 1)
        den_full = torch.cat([den.expand(B, n_p, 1),
                              torch.zeros(B, n_s, 1, dtype=cd, device=state.device)], dim=1)
        parts.append(den_full)
    p_inputs = torch.cat(parts, dim=-1)

    rel_parts = []
    if cfg.rel_particle_dim_resolved > 0:
        rel_parts += [recv(p_inputs), gather_s(p_inputs)]
    if cfg.rel_attr_dim > 0:
        rel_parts += [recv(attrs), gather_s(attrs)]
    if cfg.rel_group_dim > 0:
        g = torch.cat([p_instance, torch.zeros(B, n_s, cfg.n_instance, dtype=cd,
                                               device=state.device)], dim=1)
        rel_parts.append(torch.sum(torch.abs(g[:, :, None, :] - gather_s(g)), dim=-1,
                                   keepdim=True))
    if cfg.rel_distance_dim > 0:
        rel_parts.append(state_norm_t[:, :, None, :] - gather_s(state_norm_t))
    if cfg.rel_density_dim > 0:
        rel_parts.append(den_full[:, :, None, :] - gather_s(den_full))
    rel_inputs = torch.cat(rel_parts, dim=-1)  # (B, N, K, relation_input_dim)

    particle_encode = _encoder(params["particle_encoder"], p_inputs)
    relation_encode = _encoder(params["relation_encoder"], rel_inputs)

    # relu(W @ [rel_enc, eff_r, eff_s] + b) split into per-block products,
    # with the loop-invariant terms hoisted (as in the JAX forward)
    nf = cfg.nf_effect
    w_rp = params["relation_propagator"]["w"].to(cd)
    w1, w2, w3 = w_rp[:nf], w_rp[nf:2 * nf], w_rp[2 * nf:]
    rel_base = relation_encode @ w1 + params["relation_propagator"]["b"].to(cd)
    w_pp = params["particle_propagator"]["w"].to(cd)
    wa, wb = w_pp[:nf], w_pp[nf:]
    part_base = particle_encode @ wa + params["particle_propagator"]["b"].to(cd)

    mask_f = nbr_mask[..., None].to(cd)
    effect = particle_encode
    for _ in range(cfg.pstep):
        recv_term = effect @ w2
        send_term = gather_s(effect @ w3)
        effect_rel = torch.relu(rel_base + recv_term[:, :, None, :] + send_term)
        agg = torch.sum(effect_rel * mask_f, dim=-2)
        effect = torch.relu(part_base + agg @ wb + effect)

    motion = _predictor(params["non_rigid_predictor"], effect[:, :n_p])
    clamped = torch.clamp(motion, -cfg.motion_clamp, cfg.motion_clamp)
    pred_pos = state[:, -1, :n_p] + clamped
    return pred_pos.float(), motion.float()


def forward(params, graph, cfg: GNNConfig, compute_dtype=torch.float32):
    """Single-sample forward: ``forward_batch`` on a batch of one. The graph's
    fields are ``forward_batch``'s without the batch axis (physics_param
    (phys_dim,) or (max_nobj,); particle_den a scalar). Returns pred_pos and
    the unclamped motion, both (max_nobj, 3) f32."""
    batch = {k: torch.as_tensor(v)[None] for k, v in graph.items()}
    if "particle_den" in batch:
        batch["particle_den"] = batch["particle_den"].reshape(1)
    pred_pos, motion = forward_batch(params, batch, cfg, compute_dtype)
    return pred_pos[0], motion[0]
