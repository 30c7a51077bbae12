"""The differentiable single-step GNN forward for training (counterpart of
``adaptigraph_tpu/ops/fused_gnn_train.py``).

``make_fused_train_forward(cfg, k_used, compute_dtype)`` returns ``f(params,
state, action, physics, attrs, p_instance, neighbors, nbr_mask) -> pred``, a
``torch.autograd.Function`` whose forward is the K2 kernel (``want_motion``,
its activations kept) and whose backward is the K3 kernel
(``csrc/gnn_train_bwd.cu``: from K2's activations, where the TPU kernel
recomputes the forward, the packed node cotangents and the 24 weight
gradients, summed over samples in a fixed order) plus the JAX ``f_bwd``
glue: the clip derivative ``|motion| < motion_clamp``, the packed-column
splits, the physics sum (one value per sample) or per-particle physics, the
state-history chain rule, and ``d_state[:, -1, :n_p] += d_pred``.
``neighbors`` and ``nbr_mask`` get no gradient. On CPU tensors both kernels
are replaced by their plain versions (``gnn_forward_plain``,
``gnn_train_bwd_plain``).

Both kernels compute in ``compute_dtype``, float32 (the default, what the
JAX trainer passes when given none) or bfloat16: the packed nodes and the
weights go in in that dtype, and every layer and every cotangent is rounded
to it where the JAX kernels cast; the gradients come back in float32, the
parameters' dtype.
"""

import ctypes

import torch

from adaptigraph_tpu_torch.models.gnn import GNNConfig
from adaptigraph_tpu_torch.ops.fused_gnn import (N_WEIGHTS, _MAX_SMEM, _weight_shapes,
                                                 check_gnn_inputs, gnn_forward, gnn_forward_cuda,
                                                 pack_inputs, supports, tc_pointers, weight_list)
from adaptigraph_tpu_torch.utils.checkpoint import tree_from_leaves, tree_leaves


def gnn_train_bwd_plain(nodes, nbr, mask, dmot, weights, cfg: GNNConfig, taps=None,
                        compute_dtype=torch.float32, decisions=None):
    """Plain PyTorch version of the backward kernel, step by step as
    ``_train_bwd_kernel``: recompute the forward on the packed inputs, then
    back from ``dmot`` (B, Np, 3), the raw-motion cotangent. Returns dnodes
    (B, Np, D) and the 24 weight gradients in ``weight_list`` order and
    shapes, float32. Given float64 inputs it computes in float64 (a
    reference for the float32 rounding of the kernel and of this version).

    With ``compute_dtype`` bfloat16 it computes in float32 and rounds to
    bfloat16 wherever the JAX kernel casts to its compute dtype: the
    recomputed forward as K2 rounds it, ``dmot`` on entry, every cotangent
    product but the particle inputs' (which stays float32), the residual
    sums, the receiver and sender sums of the message cotangents, and the
    propagator-base cotangents, summed over the rounds in float32 and cast
    once. Weight gradients and the node cotangents of the relation features
    are float32 sums of those values.

    With a dict ``taps``, it also records the pre-activations of every relu
    layer ("pe0", "pe1", "pe2", "re0", "re1", "re2", "msg", "eff", "nr0",
    "nr1"): per layer a list, one entry per round, of (z, the sum of the
    absolute terms of z, the mask of the real rows). A unit whose z lies
    within rounding of 0 may fall on either side of the relu in two correct
    float32 versions, which moves its column of the layer's weight
    gradient, and through it the gradients of every layer before it.

    With a dict ``decisions`` (the same layer names, per layer a list of
    bool tensors of the pre-activations' shapes, one per round), each relu
    passes its input where the decision says so instead of where the input
    is positive: a version in another precision that takes another
    version's relu decisions (float64 with a kernel's, say) differs from it
    by arithmetic alone."""
    f32 = torch.float64 if nodes.dtype == torch.float64 else torch.float32
    bf16 = compute_dtype == torch.bfloat16

    def rnd(v):  # the JAX kernel's .astype(cd)
        return v.to(torch.bfloat16).to(f32) if bf16 else v

    (pe0w, pe0b, pe1w, pe1b, pe2w, pe2b, re0w, re0b, re1w, re1b, re2w, re2b,
     rp_w1, rp_w23, rp_b, pp_wa, pp_wb, pp_b,
     nr0w, nr0b, nr1w, nr1b, nr2w, nr2b) = [t.to(f32) for t in weights]
    B, Np, D = nodes.shape
    K = nbr.shape[1] // Np
    nh3, nf = cfg.n_his * 3, cfg.nf_effect
    Dp = D - nh3 - 3
    x = nodes.to(f32)
    idx = nbr.long().reshape(B, K, Np)
    emask = (mask.reshape(B, K, Np) > 0)[..., None]
    bidx = torch.arange(B, device=x.device)[:, None, None]
    # the sender gather and its transpose (the one-hot matmuls of the JAX kernel)
    onehot = torch.nn.functional.one_hot(idx, Np).to(f32)  # (B, K, Np, Np)

    def gather(v):  # (B, Np, F) -> (B, K, Np, F)
        return v[bidx, idx]

    def scatter(d):  # (B, K, Np, F) -> (B, Np, F)
        return torch.einsum("bkin,bkif->bnf", onehot, d)

    on = {}  # per relu layer and round, where its output passes its input

    def relu(name, v):  # the layer's output, in the compute dtype
        if decisions is None:
            out = rnd(torch.relu(v))
            on.setdefault(name, []).append(out > 0)
            return out
        keep = decisions[name][len(on.setdefault(name, []))]
        on[name].append(keep)
        return rnd(torch.where(keep, v, 0.0))

    def pos(name, t=0):
        return on[name][t].to(f32)

    def dW(a, d):  # a^T @ d summed over the batch and rows
        return a.reshape(-1, a.shape[-1]).T @ d.reshape(-1, d.shape[-1])

    def db(d):
        return d.reshape(-1, d.shape[-1]).sum(0)

    node_rows = (torch.arange(Np, device=x.device) < cfg.n_nodes)[None, :, None]

    def tap(name, z, terms, rows):  # z, recorded with ``taps``
        if taps is not None:
            taps.setdefault(name, []).append((z, terms(), rows))
        return z

    def lin(name, a, w, b, rows):
        return tap(name, a @ w + b, lambda: a.abs() @ w.abs() + b.abs(), rows)

    # ---- recompute the forward ----
    node_g = x[..., Dp:]
    T = node_g[:, None].expand(B, K, Np, node_g.shape[-1])
    G = gather(node_g)
    gdiff = rnd(T[..., nh3 + 2:] - G[..., nh3 + 2:])
    rel_in = torch.cat([T[..., nh3:nh3 + 2], G[..., nh3:nh3 + 2], gdiff.abs(),
                        rnd(T[..., :nh3] - G[..., :nh3])], dim=-1)
    p_in = x[..., :Dp]
    pe_h1 = relu("pe0", lin("pe0", p_in, pe0w, pe0b, node_rows))
    pe_h2 = relu("pe1", lin("pe1", pe_h1, pe1w, pe1b, node_rows))
    p_enc = relu("pe2", lin("pe2", pe_h2, pe2w, pe2b, node_rows))
    re_h1 = relu("re0", lin("re0", rel_in, re0w, re0b, emask))
    re_h2 = relu("re1", lin("re1", re_h1, re1w, re1b, emask))
    r_enc = relu("re2", lin("re2", re_h2, re2w, re2b, emask))
    rel_base = rnd(r_enc @ rp_w1 + rp_b)
    part_base = rnd(p_enc @ pp_wa + pp_b)
    effs, aggs = [p_enc], []
    for _ in range(cfg.pstep):
        eff = effs[-1]
        rs = rnd(eff @ rp_w23)
        z = tap("msg", rnd(rnd(rel_base + rs[..., :nf][:, None]) + gather(rs[..., nf:])),
                lambda: (r_enc.abs() @ rp_w1.abs() + rp_b.abs()
                         + (eff.abs() @ rp_w23.abs()[:, :nf])[:, None]
                         + gather(eff.abs() @ rp_w23.abs()[:, nf:])), emask)
        m = torch.where(emask, relu("msg", z), 0.0)
        agg = rnd(m.sum(1))
        z = tap("eff", rnd(rnd(part_base + rnd(agg @ pp_wb)) + eff),
                lambda: p_enc.abs() @ pp_wa.abs() + pp_b.abs() + agg @ pp_wb.abs() + eff.abs(),
                node_rows)
        effs.append(relu("eff", z))
        aggs.append(agg)
    nr_h1 = relu("nr0", lin("nr0", effs[-1], nr0w, nr0b, node_rows))
    nr_h2 = relu("nr1", lin("nr1", nr_h1, nr1w, nr1b, node_rows))

    # ---- backward ----
    dmot = rnd(dmot.to(f32))
    g = {}
    g["nr2w"], g["nr2b"] = dW(nr_h2, dmot), db(dmot)
    d_h2 = rnd(dmot @ nr2w.T) * pos("nr1")
    g["nr1w"], g["nr1b"] = dW(nr_h1, d_h2), db(d_h2)
    d_h1 = rnd(d_h2 @ nr1w.T) * pos("nr0")
    g["nr0w"], g["nr0b"] = dW(effs[-1], d_h1), db(d_h1)
    d_eff = rnd(d_h1 @ nr0w.T)

    d_pb = torch.zeros_like(p_enc)
    d_rb = torch.zeros_like(rel_base)
    g_wb = torch.zeros_like(pp_wb)
    g_w23 = torch.zeros_like(rp_w23)
    for t in reversed(range(cfg.pstep)):
        d_pre = d_eff * pos("eff", t)
        d_pb = d_pb + d_pre
        g_wb = g_wb + dW(aggs[t], d_pre)
        d_agg = rnd(d_pre @ pp_wb.T)
        d_m = d_agg[:, None] * (pos("msg", t) * emask)
        d_rb = d_rb + d_m
        d_rs = rnd(torch.cat([d_m.sum(1), scatter(d_m)], dim=-1))
        g_w23 = g_w23 + dW(effs[t], d_rs)
        d_eff = rnd(d_pre + rnd(d_rs @ rp_w23.T))
    d_pb, d_rb = rnd(d_pb), rnd(d_rb)  # summed in float32, cast once
    g["ppwb"], g["rpw23"] = g_wb, g_w23
    g["ppb"], g["ppwa"] = db(d_pb), dW(p_enc, d_pb)
    d_p_enc = rnd(d_eff + rnd(d_pb @ pp_wa.T))
    g["rpb"], g["rpw1"] = db(d_rb), dW(r_enc, d_rb)
    d_r_enc = rnd(d_rb @ rp_w1.T)

    d3 = d_r_enc * pos("re2")
    g["re2w"], g["re2b"] = dW(re_h2, d3), db(d3)
    d2 = rnd(d3 @ re2w.T) * pos("re1")
    g["re1w"], g["re1b"] = dW(re_h1, d2), db(d2)
    d1 = rnd(d2 @ re1w.T) * pos("re0")
    g["re0w"], g["re0b"] = dW(rel_in, d1), db(d1)
    d_rel_in = rnd(d1 @ re0w.T)

    dp3 = d_p_enc * pos("pe2")
    g["pe2w"], g["pe2b"] = dW(pe_h2, dp3), db(dp3)
    dp2 = rnd(dp3 @ pe2w.T) * pos("pe1")
    g["pe1w"], g["pe1b"] = dW(pe_h1, dp2), db(dp2)
    dp1 = rnd(dp2 @ pe1w.T) * pos("pe0")
    g["pe0w"], g["pe0b"] = dW(p_in, dp1), db(dp1)
    d_p_in = dp1 @ pe0w.T  # float32, as the JAX kernel leaves it

    # d|x| with abs'(0) = 1, the JAX convention (torch.abs's autograd gives 0)
    sg = torch.where(gdiff < 0, -1.0, 1.0)
    d_abs = d_rel_in[..., 4:5] * sg
    dT = torch.cat([d_rel_in[..., 5:], d_rel_in[..., 0:2], d_abs], dim=-1)
    dG = torch.cat([-d_rel_in[..., 5:], d_rel_in[..., 2:4], -d_abs], dim=-1)
    d_node_g = dT.sum(1) + scatter(dG)
    dnodes = torch.cat([d_p_in, d_node_g], dim=-1)
    order = ["pe0w", "pe0b", "pe1w", "pe1b", "pe2w", "pe2b", "re0w", "re0b", "re1w", "re1b",
             "re2w", "re2b", "rpw1", "rpw23", "rpb", "ppwa", "ppwb", "ppb",
             "nr0w", "nr0b", "nr1w", "nr1b", "nr2w", "nr2b"]
    return dnodes, [g[k] for k in order]


def launch_backward(lib, nodes, nbr, mask, dmot, weights, cfg: GNNConfig, acts, compute_dtype):
    """Check the inputs against what the kernel takes, then launch the
    backward of library ``lib`` (and the per-sample gradient sum) on the
    current stream, counting nothing (the callers count). ``nodes`` and
    ``weights`` in ``compute_dtype``, ``dmot`` float32. ``acts``: the
    activations that the forward kernel wrote in the same dtype for the same
    nodes, edges and weights (``gnn_forward_cuda``'s third output, two
    tensors in ``compute_dtype``); the kernel reads them where the TPU kernel
    recomputes the forward. The tensor-core weights are packed here, once per
    launch (``pack_tc_weights``, W itself for dX = dY W^T). Returns float32
    node cotangents and gradients."""
    f32 = torch.float32
    B, Np, K, Dp = check_gnn_inputs(nodes, nbr, mask, weights, cfg, compute_dtype,
                                    {"dmot": (dmot, (nodes.shape[0], nodes.shape[1], 3), f32)})
    dev = nodes.device
    nfp, nfr, nf, rin = cfg.nf_particle, cfg.nf_relation, cfg.nf_effect, cfg.relation_input_dim
    for which, a in enumerate(acts):
        n = B * lib.gnn_forward_act_elems(Np, K, cfg.pstep, nfp, nfr, nf, rin, which, 1)
        if a.dtype != compute_dtype or a.device != dev or a.numel() != n or not a.is_contiguous():
            raise ValueError(f"activations {which}: expected {n} contiguous {compute_dtype} on "
                             f"{dev}, got {a.numel()} {a.dtype} on {a.device}")
    bf16 = int(compute_dtype == torch.bfloat16)
    smem = lib.gnn_train_bwd_smem_bytes(Np, K, bf16)
    if smem > _MAX_SMEM:
        raise ValueError(f"{smem} bytes of shared memory per block, more than {_MAX_SMEM}")
    shapes = _weight_shapes(cfg, Dp)
    sizes = [int(torch.Size(s).numel()) for s in shapes]
    offs = [0]
    for s in sizes:
        offs.append(offs[-1] + s)
    node_s, edge_s = (
        torch.empty(B * lib.gnn_train_bwd_scratch_bytes(Np, K, cfg.pstep, nfp, nfr, nf, rin, which,
                                                         bf16),
                    dtype=torch.uint8, device=dev) for which in (0, 1))
    dnodes = torch.empty(B, Np, nodes.shape[2], dtype=f32, device=dev)
    partial = torch.empty(B, offs[-1], dtype=f32, device=dev)
    grads = torch.empty(offs[-1], dtype=f32, device=dev)
    wptrs = (ctypes.c_void_p * N_WEIGHTS)(*[t.data_ptr() for t in weights])
    tptrs, _packed = tc_pointers(weights, compute_dtype, transpose=False)
    goff = (ctypes.c_int * (N_WEIGHTS + 1))(*offs)
    rc = lib.gnn_train_bwd_launch(
        nodes.data_ptr(), nbr.data_ptr(), mask.data_ptr(), dmot.data_ptr(), wptrs, tptrs,
        acts[0].data_ptr(), acts[1].data_ptr(), node_s.data_ptr(), edge_s.data_ptr(),
        dnodes.data_ptr(), partial.data_ptr(), grads.data_ptr(), goff,
        B, Np, cfg.n_nodes, cfg.max_nobj, K, cfg.n_his, cfg.pstep, Dp, nodes.shape[2], nfp, nfr, nf,
        rin, bf16, dev.index if dev.index is not None else torch.cuda.current_device(),
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"gnn_train_bwd kernel launch failed: "
                           f"{lib.gnn_error_string(rc).decode()} ({rc})")
    return dnodes, [grads[o:o + n].view(s) for o, n, s in zip(offs, sizes, shapes)]


def gnn_train_bwd_cuda(nodes, nbr, mask, dmot, weights, cfg: GNNConfig, acts,
                       compute_dtype=torch.float32):
    """Launch K3 (``launch_backward``) on the current stream."""
    from adaptigraph_tpu_torch.ops import kernels

    out = launch_backward(kernels.library(), nodes, nbr, mask, dmot, weights, cfg, acts,
                          compute_dtype)
    gnn_train_bwd.launches += 1
    return out


def train_forward(nodes, nbr, mask, last, weights, cfg: GNNConfig, compute_dtype=torch.float32):
    """The forward with the raw motion, and what its backward needs: (pred,
    motion, acts). On CUDA tensors the kernel, whose activations ``acts``
    the backward kernel reads; on CPU tensors the plain version and ``acts``
    None (the plain backward recomputes the forward)."""
    if nodes.is_cuda:
        return gnn_forward_cuda(nodes, nbr, mask, last, weights, cfg, compute_dtype)
    pred, motion = gnn_forward(nodes, nbr, mask, last, weights, cfg, compute_dtype)
    return pred, motion, None


def gnn_train_bwd(nodes, nbr, mask, dmot, weights, cfg: GNNConfig, acts,
                  compute_dtype=torch.float32):
    """The kernel on CUDA tensors (reading ``acts``), its plain version on
    CPU tensors."""
    if nodes.is_cuda:
        return gnn_train_bwd_cuda(nodes, nbr, mask, dmot, weights, cfg, acts, compute_dtype)
    if nodes.device.type != "cpu":
        raise ValueError(f"no backward path for device {nodes.device}")
    return gnn_train_bwd_plain(nodes, nbr, mask, dmot, weights, cfg, compute_dtype=compute_dtype)


gnn_train_bwd.launches = 0


def grads_to_tree(grads, cfg: GNNConfig):
    """Kernel-layout weight gradients -> the parameter dict's nesting."""
    (g_pe0w, g_pe0b, g_pe1w, g_pe1b, g_pe2w, g_pe2b,
     g_re0w, g_re0b, g_re1w, g_re1b, g_re2w, g_re2b,
     g_rp_w1, g_rp_w23, g_rp_b, g_pp_wa, g_pp_wb, g_pp_b,
     g_nr0w, g_nr0b, g_nr1w, g_nr1b, g_nr2w, g_nr2b) = grads
    nf = cfg.nf_effect
    return {
        "particle_encoder": [{"w": g_pe0w, "b": g_pe0b}, {"w": g_pe1w, "b": g_pe1b},
                             {"w": g_pe2w, "b": g_pe2b}],
        "relation_encoder": [{"w": g_re0w, "b": g_re0b}, {"w": g_re1w, "b": g_re1b},
                             {"w": g_re2w, "b": g_re2b}],
        # the kernel splits w (3nf, nf) into W1 and the fused (nf, 2nf) [W2 | W3]
        "relation_propagator": {"w": torch.cat([g_rp_w1, g_rp_w23[:, :nf], g_rp_w23[:, nf:]], 0),
                                "b": g_rp_b},
        "particle_propagator": {"w": torch.cat([g_pp_wa, g_pp_wb], 0), "b": g_pp_b},
        "non_rigid_predictor": [{"w": g_nr0w, "b": g_nr0b}, {"w": g_nr1w, "b": g_nr1b},
                                {"w": g_nr2w, "b": g_nr2b}],
    }


class _FusedStep(torch.autograd.Function):
    """pred = f(params, state, action, physics, attrs, p_instance, edges)."""

    @staticmethod
    def forward(ctx, cfg, k_used, cd, state, action, physics, attrs, p_instance, neighbors,
                nbr_mask, *leaves):
        weights = weight_list(tree_from_leaves(leaves), cfg, cd)
        nodes, nbr, mask, last, Dp = pack_inputs(cfg, state, action, physics, attrs, p_instance,
                                                 neighbors, nbr_mask, k_used, cd)
        pred, motion, acts = train_forward(nodes, nbr, mask, last, weights, cfg, cd)
        ctx.cfg, ctx.Dp, ctx.cd = cfg, Dp, cd
        ctx.physics_shape = physics.shape
        ctx.dtypes = [t.dtype for t in (state, action, physics, attrs, p_instance)]
        ctx.save_for_backward(nodes, nbr, mask, motion, *(acts or (None, None)), *weights)
        return pred

    @staticmethod
    def backward(ctx, d_pred):
        cfg, Dp = ctx.cfg, ctx.Dp
        nodes, nbr, mask, motion, node_a, edge_a, *weights = ctx.saved_tensors
        acts = None if node_a is None else (node_a, edge_a)
        B, Np = nodes.shape[:2]
        N, n_p, n_his, nh3 = cfg.n_nodes, cfg.max_nobj, cfg.n_his, cfg.n_his * 3
        # pred = last + clip(motion): the clip derivative (strict, as JAX's) and
        # the last-state passthrough live outside the kernel
        dmot = d_pred.float() * (motion.abs() < cfg.motion_clamp).float()
        dmot_pad = torch.cat([dmot, dmot.new_zeros(B, Np - n_p, 3)], dim=1).contiguous()
        dnodes, grads = gnn_train_bwd(nodes, nbr, mask, dmot_pad, weights, cfg, acts, ctx.cd)
        dnodes = dnodes[:, :N]
        d_p_inputs, d_node_g = dnodes[..., :Dp], dnodes[..., Dp:]
        # packed columns: p_inputs = [attrs | phys | action], node_g = [state_norm | attrs | g]
        d_attrs = d_p_inputs[..., :2] + d_node_g[..., nh3:nh3 + 2]
        d_phys_rows = d_p_inputs[..., 2:2 + cfg.phys_dim]
        if len(ctx.physics_shape) == 2 and ctx.physics_shape[-1] == cfg.phys_dim:
            d_physics = d_phys_rows[:, :n_p].sum(1)  # one value per sample, broadcast
        else:
            d_physics = d_phys_rows[:, :n_p].reshape(ctx.physics_shape)
        d_action = (d_p_inputs[..., 2 + cfg.phys_dim:] if cfg.action_dim > 0
                    else torch.zeros(B, N, 3, dtype=dnodes.dtype, device=dnodes.device))
        d_p_instance = d_node_g[:, :n_p, nh3 + 2:]
        # state_norm_i = s_{i+1} - s_i (i < n_his - 1), state_norm_last = s_last
        d_sn = d_node_g[..., :nh3].reshape(B, N, n_his, 3).permute(0, 2, 1, 3)
        d_state = torch.zeros(B, n_his, N, 3, dtype=dnodes.dtype, device=dnodes.device)
        d_state[:, 1:] += d_sn[:, :n_his - 1]
        d_state[:, :n_his - 1] -= d_sn[:, :n_his - 1]
        d_state[:, -1] += d_sn[:, -1]
        d_state[:, -1, :n_p] += d_pred
        leaves = tree_leaves(grads_to_tree(grads, cfg))
        outs = [d_state, d_action, d_physics, d_attrs, d_p_instance]
        outs = [o.to(dt) for o, dt in zip(outs, ctx.dtypes)]
        return (None, None, None, *outs, None, None, *leaves)


def make_fused_train_forward(cfg: GNNConfig, k_used, compute_dtype=torch.float32):
    """The differentiable fused forward in ``compute_dtype`` (float32 or
    bfloat16): ``f(params, state, action, physics, attrs, p_instance,
    neighbors, nbr_mask) -> pred (B, max_nobj, 3)`` float32, with ``params``
    the nested parameter dict (float32; its gradients are float32).
    ``k_used`` must be ``topk + max_neef`` (the real slot count)."""
    if not supports(cfg):
        raise ValueError(f"config not supported by the training kernels: {cfg}")
    if compute_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"compute_dtype must be float32 or bfloat16, got {compute_dtype}")

    def f(params, state, action, physics, attrs, p_instance, neighbors, nbr_mask):
        return _FusedStep.apply(cfg, int(k_used), compute_dtype, state, action, physics, attrs,
                                p_instance, neighbors, nbr_mask, *tree_leaves(params))

    return f
