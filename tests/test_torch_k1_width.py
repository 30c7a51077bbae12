"""The rollout kernel (K1) at AdaptiGraph's published width, 150, on the CPU:
the kernel computes a bfloat16 model 129 to 152 wide at 160 and a float32
one at the next multiple of 4 (``k1_widths``), and refuses other bfloat16
widths; the wrapper pads the weights to those widths with zeros (the
tensor-core layers in their packing's gather, ``pack_tc_weights``, the
others in ``pad_weights``), which leaves the rollout's outputs as they are;
the packing at a model's own widths is the packing without padding;
``rollout_chunk_cuda`` takes 150 in both dtypes up to the library call (the
kernels themselves run only on the card), with rel_base's rows as the
kernel keeps them, and counts the padded launch; K2, K2e and K3 still
refuse 150."""

import dataclasses

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from adaptigraph_tpu_torch.ops import fused_gnn, kernels
from adaptigraph_tpu_torch.ops.fused_gnn import (K1_BF16_WIDE_MODEL, RP_W23, TC_LAYERS,
                                                 _weight_shapes, chunk_inputs, k1_widths,
                                                 pack_tc_weights, pad_weights, rollout_chunk_cuda,
                                                 rollout_chunk_plain, round_up)
from adaptigraph_tpu_torch.utils.profiling import SPANS

BF16, F32 = torch.bfloat16, torch.float32
_ROPE = []


def _rope(width=150):
    """The port's rope model (``configs/``, as the planner loads it) with all
    three layer widths at ``width``: a GNNConfig."""
    if not _ROPE:
        from adaptigraph_tpu_torch.cli import _task_objects
        from adaptigraph_tpu_torch.utils.config import load_planning_config

        _ROPE.append(_task_objects(load_planning_config("rope"))[0].dcfg.gnn)
    return dataclasses.replace(_ROPE[0], nf_particle=width, nf_relation=width, nf_effect=width)


def _weights(cfg, dtype=F32, seed=0):
    g = torch.Generator().manual_seed(seed)
    return [((torch.rand(s, generator=g) * 2 - 1) / np.sqrt(s[0])).to(dtype)
            for s in _weight_shapes(cfg, cfg.particle_input_dim)]


def _inputs(cfg, dtype, B=4, seed=1, steps=None):
    g = torch.Generator().manual_seed(seed)
    n_p = cfg.max_nobj
    obj = torch.rand(B, n_p, 3, generator=g) * torch.tensor([2.0, 0.1, 0.5])
    kp = torch.rand(B, cfg.max_neef, 3, generator=g)
    delta = torch.rand(B, cfg.max_neef, 3, generator=g) * 0.1
    repeat = (torch.full((B,), steps, dtype=torch.int32) if steps
              else torch.randint(1, 5, (B,), generator=g, dtype=torch.int32))
    phys = torch.rand(B, cfg.phys_dim, generator=g)
    return (obj, kp, delta, repeat, phys), chunk_inputs(obj, kp, delta, repeat, phys, cfg, dtype)


@pytest.mark.parametrize("dtype,widths", [(BF16, (160,) * 3), (F32, (152,) * 3)])
def test_the_kernel_computes_150_at_its_padded_widths(dtype, widths):
    assert k1_widths(_rope(150), dtype) == widths
    assert k1_widths(_rope(128), dtype) == (128,) * 3  # the 128 body, unpadded
    assert k1_widths(_rope(100), F32) == (100,) * 3
    for width in (129, K1_BF16_WIDE_MODEL):  # the 160 body's narrowest and widest models
        assert k1_widths(_rope(width), BF16) == (160,) * 3
    mixed = dataclasses.replace(_rope(128), nf_effect=150)
    assert k1_widths(mixed, BF16) == (160,) * 3


@pytest.mark.parametrize("width", [100, 153, 160, 168])
def test_bf16_refuses_widths_the_kernel_does_not_compute(width):
    """The 128 body takes exactly 128, and the 160 body keeps 152 channels in
    rel_base and the aggregation, so 153 .. 160 would come out wrong."""
    msg = rf"128 \(all three\) or 129 to 152 \(padded to 160\), got \({width}, {width}, {width}\)"
    with pytest.raises(ValueError, match=msg):
        k1_widths(_rope(width), BF16)
    _, (pin, sa, rep, valid) = _inputs(_rope(width), BF16, B=1)
    with pytest.raises(ValueError, match=msg):  # before anything is asked of the library
        rollout_chunk_cuda(pin, sa, rep, valid, _weights(_rope(width), BF16), _rope(width), 10,
                           0.5, 10, 0.0, False, BF16)


@pytest.mark.parametrize("transpose", [True, False])
@pytest.mark.parametrize("dtype", [BF16, F32])
def test_packing_150_wide_layers_keeps_every_weight_and_zero_padding(dtype, transpose):
    """Each tensor-core layer of a 150-wide model, packed as K2 (W^T) or K3
    (W) take it, comes back bit for bit (float32: its TF32 part), and every
    padded row and depth column holds an exact zero; packed at the kernel's
    160 in the same gather, it equals the packing of ``pad_weights``' padded
    weights, the model's weights and zeros."""
    cfg = _rope(150)
    w = _weights(cfg, dtype)
    hi, _, offs = pack_tc_weights(w, dtype, transpose)
    want = [w[i] if dtype == BF16 else fused_gnn.tf32_round(w[i]) for i in TC_LAYERS]
    for o, m in zip(offs, want):
        rows, cols = (m.shape[1], m.shape[0]) if transpose else tuple(m.shape)
        block = hi[o:o + round_up(rows, 8) * round_up(cols, 16)].view(round_up(rows, 8),
                                                                      round_up(cols, 16))
        assert torch.equal(block[:rows, :cols], m.t() if transpose else m)
        assert block[rows:].count_nonzero() == 0 and block[:, cols:].count_nonzero() == 0
    widths = (160,) * 3
    hi, lo, offs = pack_tc_weights(w, dtype, transpose, widths)
    two_step = pack_tc_weights(pad_weights(w, widths), dtype, transpose)
    assert offs == two_step[2] and torch.equal(hi, two_step[0])
    assert lo is None if dtype == BF16 else torch.equal(lo, two_step[1])
    for o, i in zip(offs, TC_LAYERS):
        kin, nout = pad_weights(w, widths)[i].shape
        rows, cols = (nout, kin) if transpose else (kin, nout)
        block = hi[o:o + round_up(rows, 8) * round_up(cols, 16)]
        assert block.count_nonzero() == want[TC_LAYERS.index(i)].count_nonzero()


@pytest.mark.parametrize("transpose", [True, False])
@pytest.mark.parametrize("dtype", [BF16, F32])
def test_packing_at_the_models_own_widths_is_the_unpadded_packing(dtype, transpose):
    """At 128 the rollout kernel's packing (with its widths) is the packing
    K2 and K3 use (without), element for element, so the 128 body stages
    what it staged before."""
    cfg = _rope(128)
    w = _weights(cfg, dtype)
    plain = pack_tc_weights(w, dtype, transpose)
    at_widths = pack_tc_weights(w, dtype, transpose, k1_widths(cfg, BF16))
    assert plain[2] == at_widths[2] and torch.equal(plain[0], at_widths[0])
    assert plain[1] is None if dtype == BF16 else torch.equal(plain[1], at_widths[1])


@pytest.mark.parametrize("dtype", [BF16, F32])
def test_padded_weights_leave_the_rollout_as_it_is(dtype):
    """The plain rollout on the weights padded to the kernel's widths (the
    recv|send weight's halves each on their own) gives the unpadded model's
    result; the padding is zeros around every weight, bit for bit."""
    cfg = _rope(150)
    w = _weights(cfg, dtype)
    widths = k1_widths(cfg, dtype)
    pw = pad_weights(w, widths)
    nf, W = cfg.nf_effect, widths[2]
    for i, (t, p) in enumerate(zip(w, pw)):
        assert p.data_ptr() % 16 == 0
        if i == RP_W23:
            assert torch.equal(p[:nf, :nf], t[:, :nf]) and torch.equal(p[:nf, W:W + nf], t[:, nf:])
        else:
            assert torch.equal(p[tuple(slice(0, k) for k in t.shape)], t)
        assert p.count_nonzero() == t.count_nonzero()
    pcfg = dataclasses.replace(cfg, nf_particle=widths[0], nf_relation=widths[1],
                               nf_effect=widths[2])
    _, (pin, sa, rep, valid) = _inputs(cfg, dtype, B=3, steps=2)
    args = (pin, sa, rep, valid)
    ours = rollout_chunk_plain(*args, w, cfg, 10, 0.5, 10, compute_dtype=dtype)
    padded = rollout_chunk_plain(*args, pw, pcfg, 10, 0.5, 10, compute_dtype=dtype)
    torch.testing.assert_close(padded, ours, rtol=0, atol=1e-5 if dtype == F32 else 1e-2)


class _Library:
    """The kernel library's two K1 entries, recording what they are given."""

    def __init__(self):
        self.calls = []

    def rollout_chunk_smem_bytes(self, *dims):
        self.calls.append(("smem", dims))
        return 200_000

    def rollout_chunk_launch(self, *args):
        self.calls.append(("launch", args))
        return 0


@pytest.mark.parametrize("width,dtype,kernel_width,rel_base",
                         [(150, BF16, 160, 152), (152, BF16, 160, 152), (150, F32, 152, 152),
                          (128, BF16, 128, 128)])
def test_the_wrapper_takes_150_up_to_the_library(width, dtype, kernel_width, rel_base,
                                                 monkeypatch):
    """On CPU tensors every check of ``rollout_chunk_cuda`` passes at 150 in
    both dtypes (at 128 nothing is padded); the library is asked for the
    padded widths' shared memory and launch, rel_base is allocated with rows
    as the kernel keeps them (the 160 body: 152), and the launch is counted
    as padded; the weights' padding and packing lie in the span ``k1.pack``;
    the 160 body is given no unpacked tensor-core weight (it reads them
    packed), the float32 body every weight padded."""
    lib = _Library()
    monkeypatch.setattr(kernels, "library", lambda variant=None: lib)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: type("S", (), {"cuda_stream": 0})())
    empty, made = torch.empty, []

    def recording_empty(*shape, **kw):
        made.append(tuple(shape))
        return empty(*shape, **kw)

    monkeypatch.setattr(fused_gnn.torch, "empty", recording_empty)
    cfg = _rope(width)
    _, (pin, sa, rep, valid) = _inputs(cfg, dtype, B=2)
    launches = fused_gnn.fused_rollout_chunk.launches
    padded = fused_gnn.fused_rollout_chunk.padded_launches
    weights = _weights(cfg, dtype)
    SPANS.reset()
    made.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        with fused_gnn.span("k1.launch"):
            out = rollout_chunk_cuda(pin, sa, rep, valid, weights, cfg, 10, 0.5, 10, 0.0, False,
                                     dtype)
    assert out.shape == (2, cfg.max_nobj, 3)
    (_, smem_dims), (_, launch) = lib.calls
    assert smem_dims[7:10] == (kernel_width,) * 3 and smem_dims[-1] == int(dtype == BF16)
    assert launch[19:22] == (kernel_width,) * 3  # eleven pointers, B, seven dims, then the widths
    Np, K = pin.shape[1], 10
    assert made[0] == (2, Np * K, rel_base)  # rel_base, then penc and pbase
    assert made[1:3] == [(2, Np, kernel_width)] * 2
    wptrs = list(launch[4])
    read_unpacked = [i for i in range(24) if dtype == F32 or width == 128 or i not in TC_LAYERS]
    assert [i for i, ptr in enumerate(wptrs) if ptr is not None] == read_unpacked
    assert fused_gnn.fused_rollout_chunk.launches == launches + 1
    assert fused_gnn.fused_rollout_chunk.padded_launches == padded + (width != kernel_width)
    assert SPANS.stats()["k1.launch/k1.pack"]["count"] == 1
    SPANS.reset()


def test_k2_k2e_and_k3_still_refuse_150():
    cfg = _rope(150)
    _, (pin, _, _, _) = _inputs(cfg, BF16)
    with pytest.raises(ValueError, match="multiples of 8 up to 128"):
        fused_gnn.check_gnn_inputs(pin, None, None, _weights(cfg, BF16), cfg, BF16, K=10)
