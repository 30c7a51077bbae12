"""The fused GNN kernels' wrappers and their plain PyTorch versions
(counterpart of ``adaptigraph_tpu/ops/fused_gnn.py``): the whole-push
rollout ``fused_rollout_chunk`` (K1, ``csrc/rollout_chunk.cu``) and the
single-step forward ``fused_forward_batch`` (``csrc/gnn_forward.cu``), with
prebuilt edges (K2, which training differentiates through
``ops/fused_gnn_train.py``) or with its radius∧topk graph built in the kernel
(K2e, ``build_edges=True``).

``fused_rollout_chunk`` runs one MPPI chunk's whole push-substep loop for a
batch of samples: per substep it shifts the ``n_his`` history, rebuilds the
radius∧topk graph from the newest frame (policy ``none``), runs the GNN
(relation encoder, ``pstep`` message passing, motion head and clamp), records
each sample at its own repeat and re-sticks the end-effector to the min (or
masked mean) object y plus the gripper lift. The particle encoding is
computed once per push (``state_dim == 0``).

``fused_forward_batch`` runs one GNN step for a batch: packed node inputs,
(k, i)-ordered edge tables with ``k_used`` real slots (K2; built outside, as
training and the tool edge policies build them) or the graph of the newest
frame built in the kernel (K2e; policy ``none``, all object slots valid, the
per-substep MPPI step), the relation and particle encoders, ``pstep`` rounds
of message passing, the motion head and ``pred = last + clamp(motion)``,
with the raw motion as a second output.

On CUDA tensors each launches its CUDA kernel; on CPU tensors it runs the
plain version (``rollout_chunk_plain``, ``gnn_forward_plain``,
``gnn_forward_edges_plain``), which computes the same function with batched
tensor ops. Numerics follow the JAX
kernels: products accumulate in float32 and every layer's output is rounded
to ``compute_dtype`` (float32 or bfloat16) where the JAX kernel rounds it;
positions, distances and ``pred = last + clamp(motion)`` stay float32.

The rollout kernel computes bfloat16 models exactly 128 wide or 129 to 152
wide at 160, and float32 ones at multiples of 4 (``k1_widths``); the wrapper
pads a narrower model's weights to them with zeros (AdaptiGraph's published
150 runs at 160 in bfloat16 and 152 in float32): in bfloat16 the
tensor-core layers in their packing's gather (``pack_tc_weights``), the
others in one small gather (``pad_weights``). That leaves the outputs as
they are. ``fused_rollout_chunk.padded_launches`` counts those launches.

Spans (``utils/profiling.py::span``, recorded only under ``torch.profiler``):
``k1.inputs``, the chunk's kernel inputs (stream time too), ``k1.launch``,
the kernel wrapper's checks, weight padding and packing, allocations and
launch (host only), and inside it ``k1.pack``, the weights' padding and
packing (stream time too).
"""

import ctypes

import numpy as np
import torch

from adaptigraph_tpu_torch.models.gnn import GNNConfig
from adaptigraph_tpu_torch.ops.graph import BIG, pairwise_sq_dists, smallest_k
from adaptigraph_tpu_torch.utils.profiling import span

N_WEIGHTS = 24
RP_W23 = 13  # weight_list's index of the relation propagator's [W2 | W3]
# the bfloat16 rollout kernel's widths (csrc/rollout_chunk.cu, see
# k1_widths): the body at 128 computes models exactly 128 wide, w160's at
# 160 models up to K1_BF16_WIDE_MODEL wide, since its rel_base rows and the
# aggregation hold that many channels (w160::kRbLd)
K1_BF16_WIDTHS = (128, 160)
K1_BF16_WIDE_MODEL = 152
_MAX_SMEM = 232448  # dynamic shared memory one block may use on Hopper
_MAX_BF16_NODE_INPUTS = 32  # Dp the bf16 rollout kernel takes (csrc/rollout_chunk.cu: pe0)


def round_up(x, m):
    return ((x + m - 1) // m) * m


def supports(cfg: GNNConfig):
    """Configs the kernel computes (the JAX ``_supports`` plus the
    ``state_dim == 0`` that hoists the particle encoder out of the loop)."""
    return (
        cfg.rel_particle_dim == 0
        and cfg.rel_density_dim == 0
        and cfg.density_dim == 0
        and cfg.offset_dim == 0
        and cfg.rel_attr_dim == 2
        and cfg.rel_group_dim == 1
        and cfg.rel_distance_dim == 3
        and cfg.attr_dim == 2
        and cfg.n_instance == 1
        and cfg.state_dim == 0
    )


def weight_list(params, cfg: GNNConfig, compute_dtype):
    """The 24 kernel weights in the JAX ``_weight_list`` order, contiguous,
    in ``compute_dtype``: particle encoder (w, b) x3, relation encoder
    (w, b) x3, relation propagator [W1, W2|W3, b], particle propagator
    [Wa, Wb, b], motion head (w, b) x3."""
    nf = cfg.nf_effect

    def w(x):  # a fresh, aligned allocation, never a view of the parameters
        return x.to(compute_dtype, copy=True).contiguous()

    pe, re, nr = params["particle_encoder"], params["relation_encoder"], params["non_rigid_predictor"]
    rp_w = params["relation_propagator"]["w"]
    pp_w = params["particle_propagator"]["w"]
    out = []
    for layers in (pe, re):
        for layer in layers:
            out += [w(layer["w"]), w(layer["b"])]
    out += [w(rp_w[:nf]), w(torch.cat([rp_w[nf:2 * nf], rp_w[2 * nf:]], dim=1)),
            w(params["relation_propagator"]["b"])]
    out += [w(pp_w[:nf]), w(pp_w[nf:]), w(params["particle_propagator"]["b"])]
    for layer in nr:
        out += [w(layer["w"]), w(layer["b"])]
    return out


# weight_list indices of the layers whose products K2 and K3 run on the
# tensor cores, in the order of their packed weights (csrc/gnn_common.cuh,
# enum Tc): pe1, pe2, re1, re2, rp_w1, rp_w23, pp_wa, pp_wb, nr0, nr1, re0.
# The others (pe0 on the particle inputs, the motion head's 3-wide last
# layer) stay on the CUDA cores.
TC_LAYERS = (2, 4, 8, 10, 12, 13, 15, 16, 18, 20, 6)


def tf32_round(x):
    """float32 x rounded to TF32 (10 mantissa bits), to nearest with ties away
    from zero, as ``cvt.rna.tf32.f32``; the low 13 bits of the result are 0."""
    if x.dtype != torch.float32:
        raise ValueError(f"tf32_round takes float32, got {x.dtype}")
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32_split(x):
    """float32 x -> (hi, lo), both TF32 values: hi = tf32(x), lo = tf32(x - hi)
    (x - hi is exact in float32), so hi + lo is x to ~2^-22 relative."""
    hi = tf32_round(x)
    return hi, tf32_round(x - hi)


_GATHER_INDEX = {}  # (shapes, padded shapes, layout, [W2 | W3]'s place, device) -> index, offsets


def _gather_index(shapes, padded, pack, transpose, halves, device):
    """Where each element of a gathered weight buffer comes from: its
    position in the weights of ``shapes`` flattened one after another, or
    one past their end (a zero). Weight i is zero-padded to ``padded[i]``
    (the one at ``halves``, [W2 | W3], each column half on its own) and,
    with ``pack``, laid out as ``pack_tc_weights`` gives it; each starts at a
    multiple of 8 elements (16 bytes), its offset. Made once per shapes,
    layout and device."""
    key = (tuple(shapes), tuple(padded), pack, transpose, halves, str(device))
    if key not in _GATHER_INDEX:
        parts, offs, at, o = [], [], 0, 0
        for i, (shape, pshape) in enumerate(zip(shapes, padded)):
            src = np.arange(at, at + int(np.prod(shape))).reshape(shape)
            at += src.size
            block = np.full(pshape, -1, np.int64)
            if i == halves:
                h, ph = shape[1] // 2, pshape[1] // 2
                block[:shape[0], :h], block[:shape[0], ph:ph + h] = src[:, :h], src[:, h:]
            else:
                block[tuple(slice(0, k) for k in shape)] = src
            if pack:
                m = block.T if transpose else block
                block = np.full((round_up(m.shape[0], 8), round_up(m.shape[1], 16)), -1, np.int64)
                block[:m.shape[0], :m.shape[1]] = m
            size = round_up(block.size, 8)
            parts += [block.reshape(-1), np.full(size - block.size, -1, np.int64)]
            offs.append(o)
            o += size
        idx = np.concatenate(parts)
        idx[idx < 0] = at
        _GATHER_INDEX[key] = (torch.from_numpy(idx).to(device), offs)
    return _GATHER_INDEX[key]


def _padded_shapes(weights, widths):
    """The shapes of ``weight_list``'s weights at the layer widths ``widths``
    (nf_particle, nf_relation, nf_effect)."""
    return _shapes(*widths, weights[6].shape[0], weights[0].shape[0])


def pack_tc_weights(weights, compute_dtype, transpose, widths=None):
    """The tensor-core layers' weights (``TC_LAYERS`` of ``weight_list``'s
    output, in ``compute_dtype``) in the layout the kernels stage, in one flat
    buffer: per layer, the rows of its product's B^T zero-padded to a depth of
    a multiple of 16 (and to a multiple of 8 rows) — with ``transpose`` (K2's
    Y = X W) W^T, (nout, round16(kin)); without (K3's dX = dY W^T) W itself,
    (round8(kin), round16(nout)). With ``widths`` (the rollout kernel's layer
    widths) each layer is first zero-padded to them, as ``pad_weights`` pads.
    One gather from the concatenated weights (``_gather_index``), so a
    launch's packing is a few device operations. Returns (hi, lo, offsets):
    in bfloat16 hi holds the weights and lo is None; in float32 hi and lo are
    the TF32 parts of ``tf32_split``. ``offsets`` are each layer's first
    element (multiples of 16)."""
    mats = [weights[i] for i in TC_LAYERS]
    shapes = [tuple(m.shape) for m in mats]
    padded = shapes
    if widths is not None:
        at_widths = _padded_shapes(weights, widths)
        padded = [at_widths[i] for i in TC_LAYERS]
    idx, offs = _gather_index(shapes, padded, True, transpose, TC_LAYERS.index(RP_W23),
                              mats[0].device)
    flat = torch.cat([m.reshape(-1) for m in mats] + [mats[0].new_zeros(1)])
    flat = flat.to(compute_dtype).index_select(0, idx)
    if compute_dtype == torch.bfloat16:
        return flat, None, offs
    hi, lo = tf32_split(flat)
    return hi, lo, offs


def tc_pointers(weights, compute_dtype, transpose, widths=None):
    """Pack (``pack_tc_weights``) and return the kernels' pointer array: the
    hi pointer of every tensor-core layer, then the lo ones (null in bf16),
    and the packed tensors, which must outlive the launch."""
    hi, lo, offs = pack_tc_weights(weights, compute_dtype, transpose, widths)
    size = hi.element_size()
    ptrs = [hi.data_ptr() + o * size for o in offs]
    ptrs += [lo.data_ptr() + o * size for o in offs] if lo is not None else [None] * len(offs)
    return (ctypes.c_void_p * len(ptrs))(*ptrs), (hi, lo)


def radius_threshold(adj_radius):
    """radius² as the JAX kernel forms it: a double product rounded to float32."""
    return float(np.float32(adj_radius * adj_radius))


def chunk_inputs(obj0, kp, delta, repeat, physics_param, cfg: GNNConfig,
                 compute_dtype, obj_mask=None):
    """Assemble the kernel inputs (the JAX wrapper's l.660-691).

    Returns ``pin`` (B, Np, Dp) in compute_dtype, the packed constant node
    inputs ``[attrs | phys | action]``; ``sa`` (B, Np, 6) f32, ``[state0 |
    action]`` with the eef rows from ``kp``/``delta`` and zero padding rows;
    ``repeat`` (B,) int32; ``valid`` (B, Np) f32, per-sample row validity.
    """
    N, n_p, n_s = cfg.n_nodes, cfg.max_nobj, cfg.max_neef
    Np = round_up(N, 8)
    B = kp.shape[0]
    dev = kp.device
    f32 = torch.float32
    if obj0.dim() == 2:
        obj0 = obj0[None].expand(B, n_p, 3)
    pad3 = torch.zeros(B, Np - N, 3, dtype=f32, device=dev)
    state0 = torch.cat([obj0.to(f32), kp.to(f32), pad3], dim=1)
    action = torch.cat([torch.zeros(B, n_p, 3, dtype=f32, device=dev), delta.to(f32), pad3], dim=1)
    sa = torch.cat([state0, action], dim=-1).contiguous()
    vobj = (obj_mask.to(f32) if obj_mask is not None
            else torch.ones(B, n_p, dtype=f32, device=dev))
    valid = torch.cat([vobj, torch.ones(B, n_s, dtype=f32, device=dev),
                       torch.zeros(B, Np - N, dtype=f32, device=dev)], dim=1).contiguous()
    attrs = torch.zeros(B, Np, 2, dtype=f32, device=dev)
    attrs[:, :n_p, 0] = vobj
    attrs[:, n_p:N, 1] = 1.0
    phys = physics_param.to(f32)
    if phys.dim() == 1:
        phys = phys[None].expand(B, phys.shape[0])
    phys_n = torch.cat([phys[:, None, :].expand(B, n_p, cfg.phys_dim),
                        torch.zeros(B, Np - n_p, cfg.phys_dim, dtype=f32, device=dev)], dim=1)
    parts = [attrs, phys_n] + ([action] if cfg.action_dim > 0 else [])
    pin = torch.cat(parts, dim=-1).to(compute_dtype).contiguous()
    return pin, sa, repeat.to(torch.int32).contiguous(), valid


def rollout_chunk_plain(pin, sa, repeat, valid, weights, cfg: GNNConfig, K, adj_radius,
                        max_repeat, gripper_lift=0.0, mean_y=False,
                        compute_dtype=torch.bfloat16, stats=None):
    """Plain PyTorch version of the kernel, on the inputs of ``chunk_inputs``.
    Returns (B, max_nobj, 3) f32: each sample's object state at its own repeat.

    ``stats`` (a dict) receives the work this batch needs: ``sample_steps``,
    the substeps each sample runs up to its own repeat, and ``edges``, the
    real edges summed over those substeps.
    """
    cd = compute_dtype
    f32 = torch.float32

    def rnd(x):  # round to the compute dtype, keep computing in f32
        return x.to(cd).to(f32)

    w = [t.to(f32) for t in weights]
    pe, re, (rp_w1, rp_w23, rp_b), (pp_wa, pp_wb, pp_b), nr = (
        w[0:6], w[6:12], w[12:15], w[15:18], w[18:24])

    def mlp3(x, p, final_relu):
        x = rnd(torch.relu(x @ p[0] + p[1]))
        x = rnd(torch.relu(x @ p[2] + p[3]))
        x = x @ p[4] + p[5]
        return rnd(torch.relu(x) if final_relu else x)

    B, Np = pin.shape[0], pin.shape[1]
    N, n_p, nf, n_his = cfg.n_nodes, cfg.max_nobj, cfg.nf_effect, cfg.n_his
    dev = pin.device
    rows = torch.arange(Np, device=dev)
    tool = (rows >= n_p) & (rows < N)
    vbool = valid > 0
    vobj = valid * (rows < n_p).to(f32)
    attrs = torch.stack([vobj, tool.to(f32).expand(B, Np)], dim=-1)
    g = vobj[..., None]
    pair_ok = vbool[:, None, :] & ~(tool[:, None] & tool[None, :])[None]
    thresh = radius_threshold(adj_radius)

    penc = mlp3(pin.to(f32), pe, True)
    part_base = rnd(penc @ pp_wa + pp_b)
    state0, action = sa[..., :3], sa[..., 3:]
    hs = [state0] * n_his
    rec = state0[:, :n_p]
    bidx = torch.arange(B, device=dev)[:, None, None]
    nh3 = n_his * 3
    rmax = min(int(repeat.max()), max_repeat) if B else 0
    for ai in range(1, rmax + 1):
        last = hs[-1]
        dis = torch.where(pair_ok, pairwise_sq_dists(last), torch.full_like(last[..., 0:1], BIG))
        vals, idx = smallest_k(dis, K)
        emask = (vals < thresh) & vbool[:, :, None]
        if stats is not None:
            live = repeat >= ai
            stats["sample_steps"] = stats.get("sample_steps", 0) + int(live.sum())
            stats["edges"] = stats.get("edges", 0) + int((emask.sum(dim=(1, 2)) * live).sum())

        sn = rnd(torch.cat([hs[i + 1] - hs[i] for i in range(n_his - 1)] + [last], dim=-1))
        node_g = torch.cat([sn, attrs, g], dim=-1)
        T = node_g[:, :, None, :].expand(B, Np, K, node_g.shape[-1])
        G = node_g[bidx, idx]
        rel_in = torch.cat([T[..., nh3:nh3 + 2], G[..., nh3:nh3 + 2],
                            torch.abs(T[..., nh3 + 2:] - G[..., nh3 + 2:]),
                            rnd(T[..., :nh3] - G[..., :nh3])], dim=-1)
        rel_base = rnd(mlp3(rel_in, re, True) @ rp_w1 + rp_b)

        effect = penc
        for _ in range(cfg.pstep):
            rs = rnd(effect @ rp_w23)
            recv, send = rs[..., :nf], rs[..., nf:]
            msg = torch.relu(rnd(rnd(rel_base + recv[:, :, None]) + send[bidx, idx]))
            agg = torch.where(emask[..., None], msg, torch.zeros_like(msg)).sum(dim=2)
            effect = torch.relu(rnd(rnd(part_base + rnd(rnd(agg) @ pp_wb)) + effect))

        motion = mlp3(effect[:, :n_p], nr, False)
        pred = last[:, :n_p] + torch.clamp(motion, -cfg.motion_clamp, cfg.motion_clamp)
        rec = torch.where((repeat == ai)[:, None, None], pred, rec)

        vo = vobj[:, :n_p]
        if mean_y:
            ys = (pred[..., 1] * vo).sum(dim=1) / torch.clamp(vo.sum(dim=1), min=1.0)
        else:
            ys = torch.where(vo > 0, pred[..., 1], torch.full_like(vo, BIG)).amin(dim=1)
        ys = ys + gripper_lift
        cand = last[:, n_p:N] + action[:, n_p:N]
        eef = torch.stack([cand[..., 0], ys[:, None].expand(B, N - n_p), cand[..., 2]], dim=-1)
        nxt = torch.cat([pred, eef, torch.zeros(B, Np - N, 3, dtype=f32, device=dev)], dim=1)
        hs = hs[1:] + [nxt]
    return rec.contiguous()


def _check(expect, dev):
    """Raise unless each named tensor is contiguous, of its shape and dtype, on dev."""
    for name, (t, shape, dtype) in expect.items():
        if t.device != dev or tuple(t.shape) != shape or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"{name}: need a contiguous {dtype} tensor of shape {shape} on "
                             f"{dev}, got {t.dtype} {tuple(t.shape)} on {t.device}")


def rollout_chunk_cuda(pin, sa, repeat, valid, weights, cfg: GNNConfig, K, adj_radius,
                       max_repeat, gripper_lift, mean_y, compute_dtype):
    """Check every input against what the kernel takes, then launch it on the
    current stream. Scratch and output come from ``torch.empty``."""
    from adaptigraph_tpu_torch.ops import kernels

    if compute_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"compute_dtype must be float32 or bfloat16, got {compute_dtype}")
    dev = pin.device
    B, Np, Dp = pin.shape
    N, n_p, nf = cfg.n_nodes, cfg.max_nobj, cfg.nf_effect
    expect = {
        "pin": (pin, (B, Np, Dp), compute_dtype),
        "sa": (sa, (B, Np, 6), torch.float32),
        "repeat": (repeat, (B,), torch.int32),
        "valid": (valid, (B, Np), torch.float32),
    }
    shapes = _weight_shapes(cfg, Dp)
    for i, (t, shape) in enumerate(zip(weights, shapes)):
        expect[f"weight {i}"] = (t, shape, compute_dtype)
    if len(weights) != N_WEIGHTS:
        raise ValueError(f"expected {N_WEIGHTS} weights, got {len(weights)}")
    _check(expect, dev)
    bf16 = compute_dtype == torch.bfloat16
    widths = k1_widths(cfg, compute_dtype)
    padded = widths != (cfg.nf_particle, cfg.nf_relation, nf)
    if bf16 and cfg.relation_input_dim > 32:  # re0's depth is two k16 steps
        raise ValueError(f"the bfloat16 kernel takes at most 32 relation inputs, got "
                         f"{cfg.relation_input_dim}")
    if bf16 and Dp > _MAX_BF16_NODE_INPUTS:
        # the particle encoder's first layer reads its inputs and weight as
        # float from one 32 KB node matrix: (Np + 128) x Dp floats
        raise ValueError(f"the bfloat16 kernel takes at most {_MAX_BF16_NODE_INPUTS} node "
                         f"inputs, got {Dp}")
    for t in [pin] + list(weights):
        if t.data_ptr() % 16:
            raise ValueError("kernel inputs must be 16-byte aligned")
    if Np < N or Np > 128 or K > Np:
        raise ValueError(f"unsupported node padding Np={Np} for N={N}, K={K}")
    lib = kernels.library()
    dims = (Np, N, n_p, K, cfg.n_his, cfg.pstep, Dp, *widths, cfg.relation_input_dim)
    smem = lib.rollout_chunk_smem_bytes(*dims, int(bf16))
    if smem > _MAX_SMEM:
        raise ValueError(f"this config (layer widths {widths} in the kernel) needs {smem} bytes "
                         f"of shared memory per block, more than the {_MAX_SMEM} a Hopper block "
                         f"may use")
    knf = widths[2]
    rb_ld = K1_BF16_WIDE_MODEL if bf16 and knf == K1_BF16_WIDTHS[1] else knf  # rel_base's rows
    relbase = torch.empty(B, Np * K, rb_ld, dtype=compute_dtype, device=dev)
    penc = torch.empty(B, Np, knf, dtype=compute_dtype, device=dev)
    pbase = torch.empty(B, Np, knf, dtype=compute_dtype, device=dev)
    out = torch.empty(B, n_p, 3, dtype=torch.float32, device=dev)
    with span("k1.pack", stream=dev):
        # the weights the kernel reads as they are (bf16: not the tensor-core
        # layers) padded to its widths; the tensor-core layers (bf16) as W^T,
        # padded in the same gather
        kept = (pad_weights(weights, widths, skip=TC_LAYERS if bf16 else ()) if padded
                else weights)
        wptrs = (ctypes.c_void_p * N_WEIGHTS)(*[None if t is None else t.data_ptr()
                                                for t in kept])
        tcptrs, _packed = (tc_pointers(weights, compute_dtype, True, widths if padded else None)
                           if bf16 else (None, None))
    # bf16: round 1's recv|send, once per push
    rs1 = torch.empty(B, Np, 2 * knf, dtype=compute_dtype, device=dev) if bf16 else None
    rc = lib.rollout_chunk_launch(
        pin.data_ptr(), sa.data_ptr(), repeat.data_ptr(), valid.data_ptr(), wptrs, tcptrs,
        relbase.data_ptr(), penc.data_ptr(), pbase.data_ptr(),
        rs1.data_ptr() if rs1 is not None else None, out.data_ptr(),
        B, *dims, radius_threshold(adj_radius), float(gripper_lift), float(cfg.motion_clamp),
        int(max_repeat), int(bool(mean_y)), int(bf16),
        dev.index if dev.index is not None else torch.cuda.current_device(),
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"rollout_chunk kernel launch failed: "
                           f"{lib.rollout_chunk_error_string(rc).decode()} ({rc})")
    fused_rollout_chunk.launches += 1
    fused_rollout_chunk.padded_launches += int(padded)
    return out


def k1_widths(cfg: GNNConfig, compute_dtype):
    """The layer widths (nf_particle, nf_relation, nf_effect) at which the
    rollout kernel computes ``cfg``'s model: in bfloat16 all three at 128
    (the body at 128 takes exactly that) or, where the widest lies in 129 ..
    ``K1_BF16_WIDE_MODEL``, all three at 160 (the body at 160); in float32
    each rounded up to a multiple of 4 (a float4 load). Raises for widths the
    bfloat16 kernel does not compute."""
    widths = (cfg.nf_particle, cfg.nf_relation, cfg.nf_effect)
    if compute_dtype != torch.bfloat16:
        return tuple(round_up(w, 4) for w in widths)
    narrow, wide = K1_BF16_WIDTHS
    if widths == (narrow,) * 3:
        return widths
    if narrow < max(widths) <= K1_BF16_WIDE_MODEL:
        return (wide,) * 3
    raise ValueError(f"the bfloat16 rollout kernel computes layer widths of {narrow} (all three) "
                     f"or {narrow + 1} to {K1_BF16_WIDE_MODEL} (padded to {wide}), got {widths}")


def pad_weights(weights, widths, skip=()):
    """``weight_list``'s 24 weights zero-padded to the layer widths
    ``widths`` (nf_particle, nf_relation, nf_effect, each at least the
    model's): the rows and columns past a width zero, the two halves of the
    recv|send weight [W2 | W3] each padded on its own; those at ``skip``
    left out (None in their place). One gather from the concatenated
    weights (``_gather_index``), the padded weights views of one buffer. A
    padded channel computes relu(0 + 0) = 0 in every layer and adds nothing
    to the next, so the model's outputs stay as they are."""
    keep = [i for i in range(len(weights)) if i not in skip]
    padded = _padded_shapes(weights, widths)
    idx, offs = _gather_index([tuple(weights[i].shape) for i in keep], [padded[i] for i in keep],
                              False, False, keep.index(RP_W23) if RP_W23 in keep else None,
                              weights[0].device)
    flat = torch.cat([weights[i].reshape(-1) for i in keep] + [weights[0].new_zeros(1)])
    flat = flat.index_select(0, idx)
    out = [None] * len(weights)
    for i, o in zip(keep, offs):
        out[i] = flat[o:o + int(np.prod(padded[i]))].view(padded[i])
    return out


def _weight_shapes(cfg: GNNConfig, Dp):
    return _shapes(cfg.nf_particle, cfg.nf_relation, cfg.nf_effect, cfg.relation_input_dim, Dp)


def _shapes(nfp, nfr, nf, rin, Dp):
    return [(Dp, nfp), (nfp,), (nfp, nfp), (nfp,), (nfp, nf), (nf,),
            (rin, nfr), (nfr,), (nfr, nfr), (nfr,), (nfr, nf), (nf,),
            (nf, nf), (nf, 2 * nf), (nf,),
            (nf, nf), (nf, nf), (nf,),
            (nf, nf), (nf,), (nf, nf), (nf,), (nf, 3), (3,)]


def rollout_chunk(pin, sa, repeat, valid, weights, cfg: GNNConfig, K, adj_radius, max_repeat,
                  gripper_lift=0.0, mean_y=False, compute_dtype=torch.bfloat16):
    """The kernel on CUDA tensors, its plain version on CPU tensors."""
    if pin.is_cuda:
        with span("k1.launch"):
            return rollout_chunk_cuda(pin, sa, repeat, valid, weights, cfg, K, adj_radius,
                                      max_repeat, gripper_lift, mean_y, compute_dtype)
    if pin.device.type != "cpu":
        raise ValueError(f"no rollout path for device {pin.device}")
    return rollout_chunk_plain(pin, sa, repeat, valid, weights, cfg, K, adj_radius, max_repeat,
                               gripper_lift, mean_y, compute_dtype)


def fused_rollout_chunk(params, obj0, kp, delta, repeat, physics_param, cfg: GNNConfig,
                        adj_radius, edge_topk, max_repeat=15, gripper_lift=0.0,
                        compute_dtype=torch.bfloat16, obj_mask=None, mean_y=False):
    """Run one MPPI chunk's whole substep loop (one kernel launch on CUDA).

    obj0: (max_nobj, 3) or (B, max_nobj, 3) f32 object state; kp, delta:
    (B, max_neef, 3) eef start keypoints and per-substep displacement;
    repeat: (B,) integer substep counts; physics_param: (phys_dim,) or
    (B, phys_dim); obj_mask: optional (B, max_nobj) bool per-sample object
    validity; mean_y: re-stick the eef to the masked mean object y instead of
    the min. ``params`` is the nested parameter dict or ``weight_list``'s
    output. Returns (B, max_nobj, 3) f32.
    """
    if not supports(cfg):
        raise ValueError(f"config not supported by the rollout kernel: {cfg}")
    weights = (params if isinstance(params, (list, tuple))
               else weight_list(params, cfg, compute_dtype))
    with span("k1.inputs", stream=kp.device):
        pin, sa, rep, valid = chunk_inputs(obj0, kp, delta, repeat, physics_param, cfg,
                                           compute_dtype, obj_mask)
    return rollout_chunk(pin, sa, rep, valid, weights, cfg, int(edge_topk), adj_radius,
                         int(max_repeat), gripper_lift, mean_y, compute_dtype)


fused_rollout_chunk.launches = 0
fused_rollout_chunk.padded_launches = 0  # launches whose weights the wrapper padded


# ---------------------------------------------------------------------------
# single-step forward with prebuilt edges (K2)
# ---------------------------------------------------------------------------

def pack_node_inputs(cfg: GNNConfig, state, action, physics, attrs, p_instance, compute_dtype):
    """ONE packed node tensor ``[p_inputs | state_norm | attrs | g]`` padded to
    Np rows -> ((B, Np, D) in compute_dtype, Dp), as the JAX
    ``pack_node_inputs``. The training backward recomputes from the same
    packing."""
    N, n_p, n_s = cfg.n_nodes, cfg.max_nobj, cfg.max_neef
    Np = round_up(N, 8)
    B, n_his = state.shape[0], cfg.n_his
    dev = state.device
    state_norm = torch.cat([state[:, 1:] - state[:, :-1], state[:, -1:]], dim=1)
    state_norm_f = state_norm.permute(0, 2, 1, 3).reshape(B, N, n_his * 3)
    if physics.dim() == 2 and physics.shape[-1] == cfg.phys_dim:
        phys_p = physics[:, None, :].expand(B, n_p, cfg.phys_dim)
    else:
        phys_p = physics.reshape(B, n_p, cfg.phys_dim)
    phys_full = torch.cat([phys_p, phys_p.new_zeros(B, n_s, cfg.phys_dim)], dim=1)
    parts = [attrs] + ([state_norm_f] if cfg.state_dim > 0 else []) + [phys_full]
    if cfg.action_dim > 0:
        parts.append(action)
    p_inputs = torch.cat(parts, dim=-1)
    g = torch.cat([p_instance, p_instance.new_zeros(B, n_s, cfg.n_instance)], dim=1)
    nodes = torch.cat([p_inputs, state_norm_f, attrs, g], dim=-1)
    nodes = torch.cat([nodes, nodes.new_zeros(B, Np - N, nodes.shape[-1])], dim=1)
    return nodes.to(device=dev, dtype=compute_dtype).contiguous(), p_inputs.shape[-1]


def pack_edge_tables(neighbors, nbr_mask, K, N, Np):
    """neighbors/mask (B, N, >=K) -> flat (B, K*Np) tables in the kernels'
    (k, i) row order, int32 senders and float32 mask; padded rows point at
    node 0 with mask 0."""
    B = neighbors.shape[0]
    nbr = torch.zeros(B, K, Np, dtype=torch.int32, device=neighbors.device)
    mask = torch.zeros(B, K, Np, dtype=torch.float32, device=neighbors.device)
    nbr[:, :, :N] = neighbors[..., :K].transpose(1, 2).to(torch.int32)
    mask[:, :, :N] = nbr_mask[..., :K].transpose(1, 2).to(torch.float32)
    return nbr.reshape(B, K * Np), mask.reshape(B, K * Np)


def pack_inputs(cfg: GNNConfig, state, action, physics, attrs, p_instance, neighbors, nbr_mask,
                k_used, compute_dtype):
    """All K2/K3 inputs of one step: (nodes, nbr, mask, last, Dp), ``last``
    the newest state frame padded to (B, Np, 3) float32."""
    N, Np = cfg.n_nodes, round_up(cfg.n_nodes, 8)
    nodes, Dp = pack_node_inputs(cfg, state, action, physics, attrs, p_instance, compute_dtype)
    nbr, mask = pack_edge_tables(neighbors, nbr_mask, k_used, N, Np)
    return nodes, nbr, mask, pad_last(cfg, state), Dp


def pad_last(cfg: GNNConfig, state):
    """The newest frame of ``state`` (B, n_his, N, 3), padded to (B, Np, 3)
    float32."""
    Np = round_up(cfg.n_nodes, 8)
    last = state[:, -1].float()
    return torch.cat([last, last.new_zeros(last.shape[0], Np - cfg.n_nodes, 3)], dim=1).contiguous()


def gnn_forward_plain(nodes, nbr, mask, last, weights, cfg: GNNConfig, compute_dtype,
                      want_motion=True):
    """Plain PyTorch version of the kernel, on the packed inputs: nodes
    (B, Np, D), nbr/mask (B, K*Np) in (k, i) order, last (B, Np, 3) f32.
    Returns pred and the raw motion (or None), (B, max_nobj, 3) f32. Rounds
    to ``compute_dtype`` where the JAX kernel casts; a masked slot adds
    nothing, as the JAX kernel's -3e38 relation bias makes its message 0."""
    cd, f32 = compute_dtype, torch.float32

    def rnd(x):
        return x.to(cd).to(f32)

    w = [t.to(f32) for t in weights]
    pe, re, (rp_w1, rp_w23, rp_b), (pp_wa, pp_wb, pp_b), nr = (
        w[0:6], w[6:12], w[12:15], w[15:18], w[18:24])

    def mlp3(x, p, final_relu):
        x = rnd(torch.relu(x @ p[0] + p[1]))
        x = rnd(torch.relu(x @ p[2] + p[3]))
        x = x @ p[4] + p[5]
        return rnd(torch.relu(x) if final_relu else x)

    B, Np, D = nodes.shape
    K = nbr.shape[1] // Np
    nh3, nf, n_p = cfg.n_his * 3, cfg.nf_effect, cfg.max_nobj
    Dp = D - nh3 - 3
    x = nodes.to(f32)
    idx = nbr.long().reshape(B, K, Np)
    emask = (mask.reshape(B, K, Np) > 0)[..., None]
    bidx = torch.arange(B, device=x.device)[:, None, None]
    node_g = x[..., Dp:]
    T = node_g[:, None].expand(B, K, Np, node_g.shape[-1])
    G = node_g[bidx, idx]
    rel_in = torch.cat([T[..., nh3:nh3 + 2], G[..., nh3:nh3 + 2],
                        torch.abs(rnd(T[..., nh3 + 2:] - G[..., nh3 + 2:])),
                        rnd(T[..., :nh3] - G[..., :nh3])], dim=-1)
    penc = mlp3(x[..., :Dp], pe, True)
    rel_base = rnd(mlp3(rel_in, re, True) @ rp_w1 + rp_b)
    part_base = rnd(penc @ pp_wa + pp_b)
    effect = penc
    for _ in range(cfg.pstep):
        rs = rnd(effect @ rp_w23)
        recv, send = rs[..., :nf], rs[..., nf:]
        msg = torch.relu(rnd(rnd(rel_base + recv[:, None]) + send[bidx, idx]))
        agg = torch.where(emask, msg, torch.zeros_like(msg)).sum(dim=1)
        effect = torch.relu(rnd(rnd(part_base + rnd(rnd(agg) @ pp_wb)) + effect))
    motion = mlp3(effect[:, :n_p], nr, False)
    pred = last[:, :n_p].to(f32) + torch.clamp(motion, -cfg.motion_clamp, cfg.motion_clamp)
    return pred, (motion if want_motion else None)


def check_gnn_inputs(nodes, nbr, mask, weights, cfg: GNNConfig, compute_dtype, extra=(), K=None):
    """What the K2, K2e and K3 kernels take: contiguous tensors of these
    shapes and dtypes on one device, 24 weights, Np < 32768 and pstep >= 1,
    layer widths (nf_particle, nf_relation, nf_effect) that are multiples of
    8 up to 128 (the tensor-core tiles' 16-byte rows, a 128-row weight
    slice); with ``nbr`` None (K2e: the graph built in the kernel, ``K``
    slots), no tables and Np <= 128 (a warp's four columns per lane).
    Returns (B, Np, K, Dp)."""
    if compute_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"compute_dtype must be float32 or bfloat16, got {compute_dtype}")
    if len(weights) != N_WEIGHTS:
        raise ValueError(f"expected {N_WEIGHTS} weights, got {len(weights)}")
    widths = (cfg.nf_particle, cfg.nf_relation, cfg.nf_effect)
    if any(w % 8 or not 8 <= w <= 128 for w in widths):
        raise ValueError(f"the kernels need layer widths that are multiples of 8 up to 128, "
                         f"got {widths}")
    B, Np, D = nodes.shape
    if nbr is not None:
        K = nbr.shape[1] // Np if nbr.dim() == 2 else 0
    Dp = D - cfg.n_his * 3 - 3
    if (Np != round_up(cfg.n_nodes, 8) or Np >= 32768 or K < 1 or cfg.pstep < 1 or Dp < 1
            or nbr is None and (Np > 128 or K > Np)):
        raise ValueError(f"unsupported shapes: nodes {tuple(nodes.shape)}, nbr "
                         f"{None if nbr is None else tuple(nbr.shape)}, K {K}, pstep {cfg.pstep}")
    expect = {"nodes": (nodes, (B, Np, D), compute_dtype)}
    if nbr is not None:
        expect.update(nbr=(nbr, (B, K * Np), torch.int32), mask=(mask, (B, K * Np), torch.float32))
    for i, (t, shape) in enumerate(zip(weights, _weight_shapes(cfg, Dp))):
        expect[f"weight {i}"] = (t, shape, compute_dtype)
    expect.update(extra)
    _check(expect, nodes.device)
    return B, Np, K, Dp


def launch_forward(lib, nodes, nbr, mask, last, weights, cfg: GNNConfig, compute_dtype,
                   want_motion, keep_acts, K=None, adj_radius=None):
    """Check the inputs against what the kernel takes, then launch the
    single-step forward of library ``lib`` on the current stream, counting
    nothing (the callers count). With ``nbr`` None the kernel builds the
    radius∧topk graph (``K`` slots, ``adj_radius``) itself. With
    ``keep_acts`` every activation of every sample is kept for the training
    backward, one block per sample; without, each resident block reuses one
    scratch (a forward alone). Activations (in ``compute_dtype``) and outputs
    come from ``torch.empty``; the tensor-core weights are packed here, once
    per launch (``pack_tc_weights``). Returns (pred, motion or None, acts)."""
    B, Np, K, Dp = check_gnn_inputs(
        nodes, nbr, mask, weights, cfg, compute_dtype,
        {"last": (last, (nodes.shape[0], nodes.shape[1], 3), torch.float32)}, K=K)
    dev = nodes.device
    radius = nbr is None
    nfp, nfr, nf, rin = cfg.nf_particle, cfg.nf_relation, cfg.nf_effect, cfg.relation_input_dim
    bf16 = int(compute_dtype == torch.bfloat16)
    smem = lib.gnn_forward_smem_bytes(Np, K, int(radius), bf16)
    if smem > _MAX_SMEM:
        raise ValueError(f"{smem} bytes of shared memory per block, more than {_MAX_SMEM}")
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    grid = ctypes.c_int(0)
    rc = lib.gnn_forward_grid(B, Np, K, int(radius), int(keep_acts), bf16, index, ctypes.byref(grid))
    if rc != 0:
        raise RuntimeError(f"gnn_forward grid query failed: {lib.gnn_error_string(rc).decode()}")
    node_a, edge_a = (
        torch.empty(grid.value * lib.gnn_forward_act_elems(Np, K, cfg.pstep, nfp, nfr, nf, rin,
                                                            which, int(keep_acts)),
                    dtype=compute_dtype, device=dev) for which in (0, 1))
    n_p = cfg.max_nobj
    pred = torch.empty(B, n_p, 3, dtype=torch.float32, device=dev)
    motion = torch.empty(B, n_p, 3, dtype=torch.float32, device=dev) if want_motion else None
    wptrs = (ctypes.c_void_p * N_WEIGHTS)(*[t.data_ptr() for t in weights])
    tptrs, _packed = tc_pointers(weights, compute_dtype, transpose=True)
    rc = lib.gnn_forward_launch(
        nodes.data_ptr(), None if radius else nbr.data_ptr(), None if radius else mask.data_ptr(),
        last.data_ptr(), wptrs, tptrs, node_a.data_ptr(), edge_a.data_ptr(), pred.data_ptr(),
        motion.data_ptr() if motion is not None else None,
        B, Np, cfg.n_nodes, n_p, K, cfg.n_his, cfg.pstep, Dp, nodes.shape[2], nfp, nfr, nf, rin,
        float(cfg.motion_clamp), radius_threshold(adj_radius) if radius else 0.0,
        int(keep_acts), grid.value, bf16, index, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"gnn_forward kernel launch failed: {lib.gnn_error_string(rc).decode()} "
                           f"({rc})")
    return pred, motion, (node_a, edge_a)


def act_layout(lib, cfg: GNNConfig, K):
    """Where training's kept activations lie in a sample's part of each of
    the two tensors K2 writes (the library's ``gnn_forward_act_offsets``):
    for which 0 (node buffers) and 1 (edge buffers), a list of (name, offset
    in elements, slots, rows, width), a buffer holding ``slots`` tensors of
    (rows, width) one after another."""
    Np, P = round_up(cfg.n_nodes, 8), cfg.pstep
    names = ([("pe_h1", 1), ("pe_h2", 1), ("effs", P + 1), ("pb", 1), ("rs", 1), ("aggs", P),
              ("nr_h1", 1), ("nr_h2", 1)],
             [("rel_in", 1), ("re_h1", 1), ("re_h2", 1), ("r_enc", 1), ("rel_base", 1), ("ms", P)])
    out = []
    for which, rows in ((0, Np), (1, Np * K)):
        offs = (ctypes.c_longlong * 9)()
        n = lib.gnn_forward_act_offsets(Np, K, P, cfg.nf_particle, cfg.nf_relation, cfg.nf_effect,
                                        cfg.relation_input_dim, which, offs)
        out.append([(name, offs[i], slots, rows, (offs[i + 1] - offs[i]) // (slots * rows))
                    for i, (name, slots) in enumerate(names[which][:n - 1])])
    return out


def gnn_forward_cuda(nodes, nbr, mask, last, weights, cfg: GNNConfig, compute_dtype,
                     want_motion=True, keep_acts=True):
    """Launch K2 (prebuilt edges) on the current stream. Returns (pred,
    motion or None, acts): with ``keep_acts``, ``acts`` the two tensors
    (in ``compute_dtype``) holding every activation, which the training
    backward (K3) reads; without, a scratch that holds nothing afterwards."""
    from adaptigraph_tpu_torch.ops import kernels

    out = launch_forward(kernels.library(), nodes, nbr, mask, last, weights, cfg, compute_dtype,
                         want_motion, keep_acts)
    gnn_forward.launches += 1
    return out


def gnn_forward(nodes, nbr, mask, last, weights, cfg: GNNConfig, compute_dtype, want_motion=True):
    """K2 on CUDA tensors (a forward alone: no activations kept), its plain
    version on CPU tensors."""
    if nodes.is_cuda:
        return gnn_forward_cuda(nodes, nbr, mask, last, weights, cfg, compute_dtype,
                                want_motion, keep_acts=False)[:2]
    if nodes.device.type != "cpu":
        raise ValueError(f"no forward path for device {nodes.device}")
    return gnn_forward_plain(nodes, nbr, mask, last, weights, cfg, compute_dtype, want_motion)


gnn_forward.launches = 0


# ---------------------------------------------------------------------------
# single-step forward with the graph built in the kernel (K2e)
# ---------------------------------------------------------------------------

def radius_edge_tables(last, cfg: GNNConfig, K, adj_radius, ablate=None):
    """The graph that K2e builds, as K2's (B, K*Np) tables in (k, i) order:
    per receiver the K valid senders nearest to it in ``last`` (B, Np, 3)
    f32, all N rows valid, tool-tool pairs excluded, the self-edge kept, an
    edge where the squared distance is below float32(adj_radius²), ties to
    the smaller sender (the JAX ``_edges_stacked``). ``ablate``, the parts
    that the profiling builds switch off: ``"no_edge"`` gives every row the
    senders (i + k) mod Np, every slot real; ``"no_gather"`` makes every
    sender its receiver, on the graph built; ``"mlp_only"`` both."""
    B, Np = last.shape[:2]
    N, n_p, dev = cfg.n_nodes, cfg.max_nobj, last.device
    rows = torch.arange(Np, device=dev)
    if ablate in ("no_edge", "mlp_only"):
        nbr = ((rows[None] + torch.arange(K, device=dev)[:, None]) % Np).expand(B, K, Np)
        mask = torch.ones(B, K, Np, dtype=torch.bool, device=dev)
    else:
        valid = rows < N
        tool = (rows >= n_p) & valid
        pair_ok = valid[None, :] & ~(tool[:, None] & tool[None, :])
        dis = torch.where(pair_ok, pairwise_sq_dists(last.float()), BIG)
        vals, idx = smallest_k(dis, K)
        mask = ((vals < radius_threshold(adj_radius)) & valid[None, :, None]).transpose(1, 2)
        nbr = idx.transpose(1, 2)
    if ablate in ("no_gather", "mlp_only"):
        nbr = rows.expand(B, K, Np)
    return (nbr.reshape(B, K * Np).to(torch.int32).contiguous(),
            mask.reshape(B, K * Np).to(torch.float32).contiguous())


def gnn_forward_edges_plain(nodes, last, weights, cfg: GNNConfig, compute_dtype, K, adj_radius,
                            want_motion=True, ablate=None):
    """Plain PyTorch version of K2e (and of its profiling builds with
    ``ablate``): K2's plain version on the graph ``radius_edge_tables``
    builds in-line."""
    nbr, mask = radius_edge_tables(last, cfg, K, adj_radius, ablate)
    return gnn_forward_plain(nodes, nbr, mask, last, weights, cfg, compute_dtype, want_motion)


def gnn_forward_edges_cuda(nodes, last, weights, cfg: GNNConfig, compute_dtype, K, adj_radius,
                           want_motion=True):
    """Launch K2e (a forward alone) on the current stream. Returns (pred,
    motion or None)."""
    from adaptigraph_tpu_torch.ops import kernels

    out = launch_forward(kernels.library(), nodes, None, None, last, weights, cfg, compute_dtype,
                         want_motion, False, K, adj_radius)
    gnn_forward_edges.launches += 1
    return out[:2]


def gnn_forward_edges(nodes, last, weights, cfg: GNNConfig, compute_dtype, K, adj_radius,
                      want_motion=True):
    """K2e on CUDA tensors, its plain version on CPU tensors."""
    if nodes.is_cuda:
        return gnn_forward_edges_cuda(nodes, last, weights, cfg, compute_dtype, K, adj_radius,
                                      want_motion)
    if nodes.device.type != "cpu":
        raise ValueError(f"no forward path for device {nodes.device}")
    return gnn_forward_edges_plain(nodes, last, weights, cfg, compute_dtype, K, adj_radius,
                                   want_motion)


gnn_forward_edges.launches = 0


def fused_forward_batch(params, graphs, cfg: GNNConfig, compute_dtype=torch.bfloat16, k_used=None,
                        want_motion=True, build_edges=False, adj_radius=None, edge_topk=None):
    """One GNN step for a batch (the JAX ``fused_forward_batch``; one kernel
    launch on CUDA). ``graphs``: state (B, n_his, N, 3), attrs, action,
    p_instance, physics_param, as ``forward_batch`` takes them, and with
    prebuilt edges (K2) neighbors / nbr_mask (B, N, >=k_used); ``k_used``:
    the real slots (``topk + max_neef``), the rest must be masked. With
    ``build_edges`` (K2e) the radius∧topk graph of the newest frame is built
    in the kernel: ``edge_topk`` slots, radius ``adj_radius``, policy
    ``none`` with all object slots valid (see ``radius_edge_tables``).
    ``params`` is the nested parameter dict or ``weight_list``'s output. The
    JAX ``samples_per_block`` and ``interpret`` are TPU notions with no
    counterpart here: a block runs one sample at a time. Returns (pred,
    motion or None), (B, max_nobj, 3) f32."""
    if not supports(cfg):
        raise ValueError(f"config not supported by the forward kernel: {cfg}")
    weights = (params if isinstance(params, (list, tuple))
               else weight_list(params, cfg, compute_dtype))
    if build_edges:
        if adj_radius is None or edge_topk is None:
            raise ValueError("build_edges needs adj_radius and edge_topk")
        nodes, _ = pack_node_inputs(cfg, graphs["state"], graphs["action"],
                                    graphs["physics_param"], graphs["attrs"],
                                    graphs["p_instance"], compute_dtype)
        last = pad_last(cfg, graphs["state"])
        return gnn_forward_edges(nodes, last, weights, cfg, compute_dtype, int(edge_topk),
                                 adj_radius, want_motion)
    K = min(k_used or graphs["neighbors"].shape[-1], graphs["neighbors"].shape[-1])
    nodes, nbr, mask, last, _ = pack_inputs(
        cfg, graphs["state"], graphs["action"], graphs["physics_param"], graphs["attrs"],
        graphs["p_instance"], graphs["neighbors"], graphs["nbr_mask"], K, compute_dtype)
    return gnn_forward(nodes, nbr, mask, last, weights, cfg, compute_dtype, want_motion)
