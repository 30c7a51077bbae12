"""The tensor-core weights of K2 and K3, packed once per launch in PyTorch
(``ops/fused_gnn.py::pack_tc_weights``), at rope, granular and cloth width
and at a narrow width whose depths are not multiples of 16 (so that the
padding is exercised):

- unpacking gives every weight back bit for bit, as W^T (K2's layout) and
  as W (K3's); in float32 the hi part is the weight rounded to TF32, bit for
  bit;
- the padding to a depth of a multiple of 16 (and to a multiple of 8 rows)
  is zero, and every layer starts at a multiple of 16 elements (16-byte
  aligned rows for cp.async);
- hi + lo reconstructs each float32 weight within 2^-22 of its magnitude;
- hi and lo are TF32 values (their low 13 mantissa bits are zero);
- the split-TF32 product hi·hi + hi·lo + lo·hi of a layer, emulated with
  float32 matmuls on numpy-seeded inputs, lies within 1e-6 of the float64
  product relative to its norm, where TF32 alone (hi·hi) does not.
"""

import numpy as np
import pytest
import torch

from adaptigraph_tpu_torch.models.gnn import GNNConfig, model_config_from_yaml
from adaptigraph_tpu_torch.ops.fused_gnn import (N_WEIGHTS, TC_LAYERS, _weight_shapes,
                                                 pack_tc_weights, round_up, tf32_round, tf32_split)
from adaptigraph_tpu_torch.utils.config import load_dynamics_config

WIDTHS = ["rope", "granular", "cloth", "narrow"]


def _cfg(name):
    if name == "narrow":
        return GNNConfig(n_his=4, max_nobj=20, max_neef=1, nf_particle=40, nf_relation=24,
                         nf_effect=56, pstep=2)
    return model_config_from_yaml(load_dynamics_config(name))


def _weights(name, seed=0):
    """The 24 kernel weights (weight_list's shapes), float32, from numpy."""
    cfg = _cfg(name)
    rng = np.random.RandomState(seed)
    shapes = _weight_shapes(cfg, cfg.particle_input_dim)
    assert len(shapes) == N_WEIGHTS
    return cfg, [torch.tensor((rng.standard_normal(s) / np.sqrt(s[0])).astype(np.float32))
                 for s in shapes]


def unpack_tc_weights(flat, offsets, shapes, transpose):
    """The weights (``shapes``, each (kin, nout)) back from a flat buffer of
    ``pack_tc_weights``: the inverse of its layout."""
    out = []
    for o, (k, n) in zip(offsets, shapes):
        rows, cols = (n, k) if transpose else (k, n)
        prows, pcols = round_up(rows, 8), round_up(cols, 16)
        m = flat[o:o + prows * pcols].view(prows, pcols)[:rows, :cols]
        out.append(m.t() if transpose else m)
    return out


def _tc_shapes(weights):
    return [tuple(weights[i].shape) for i in TC_LAYERS]


@pytest.mark.parametrize("name", WIDTHS)
def test_unpack_gives_back_every_weight(name):
    _, w = _weights(name)
    for transpose in (True, False):
        packed, lo, offs = pack_tc_weights([t.to(torch.bfloat16) for t in w], torch.bfloat16,
                                           transpose)
        assert lo is None and packed.dtype == torch.bfloat16
        for i, got in zip(TC_LAYERS, unpack_tc_weights(packed, offs, _tc_shapes(w), transpose)):
            assert torch.equal(got, w[i].to(torch.bfloat16))
        hi, lo, offs = pack_tc_weights(w, torch.float32, transpose)
        for i, got in zip(TC_LAYERS, unpack_tc_weights(hi, offs, _tc_shapes(w), transpose)):
            assert torch.equal(got.contiguous().view(torch.int32),
                               tf32_round(w[i]).view(torch.int32))


@pytest.mark.parametrize("name", WIDTHS)
def test_padding_is_zero(name):
    _, w = _weights(name)
    padded = 0
    for transpose in (True, False):
        for dtype in (torch.bfloat16, torch.float32):
            hi, lo, offs = pack_tc_weights([t.to(dtype) for t in w], dtype, transpose)
            ends = offs[1:] + [hi.numel()]
            for part in [hi] + ([lo] if lo is not None else []):
                for o, end, (k, n) in zip(offs, ends, _tc_shapes(w)):
                    rows, cols = (n, k) if transpose else (k, n)
                    prows, pcols = round_up(rows, 8), round_up(cols, 16)
                    assert o % 16 == 0 and end - o == prows * pcols
                    block = part[o:end].view(prows, pcols)
                    assert torch.count_nonzero(block[:, cols:]) == 0
                    assert torch.count_nonzero(block[rows:]) == 0
                    padded += block.numel() - rows * cols
    assert padded > 0  # re0's 17 relation inputs are padded at every width


@pytest.mark.parametrize("name", WIDTHS)
def test_hi_plus_lo_reconstructs_float32(name):
    _, w = _weights(name)
    for transpose in (True, False):
        hi, lo, offs = pack_tc_weights(w, torch.float32, transpose)
        shapes = _tc_shapes(w)
        for i, h, l in zip(TC_LAYERS, unpack_tc_weights(hi, offs, shapes, transpose),
                           unpack_tc_weights(lo, offs, shapes, transpose)):
            err = (h.double() + l.double() - w[i].double()).abs()
            assert bool((err <= 2.0 ** -22 * w[i].double().abs()).all())


@pytest.mark.parametrize("name", WIDTHS)
def test_parts_are_tf32(name):
    _, w = _weights(name)
    for transpose in (True, False):
        hi, lo, _ = pack_tc_weights(w, torch.float32, transpose)
        for part in (hi, lo):
            assert torch.count_nonzero(part.view(torch.int32) & 0x1FFF) == 0
        # the remainder is well below the rounded part: lo carries the low bits
        assert float(lo.abs().max()) <= 2.0 ** -11 * float(hi.abs().max())


@pytest.mark.parametrize("name", WIDTHS)
def test_split_tf32_product(name):
    """Y = X W of the relation propagator's first layer (rp_w1, nf x nf)
    through its packed K2 weight, as the float32 kernels compute it: X split
    in place (tf32_split), W from the packing, three TF32 products summed in
    float32."""
    _, w = _weights(name)
    hi, lo, offs = pack_tc_weights(w, torch.float32, True)
    layer = TC_LAYERS.index(12)  # rp_w1
    shape = _tc_shapes(w)[layer]
    wh, wl = (unpack_tc_weights(p, offs[layer:layer + 1], [shape], True)[0] for p in (hi, lo))
    x = torch.tensor(np.random.RandomState(1).standard_normal((960, shape[0])).astype(np.float32))
    xh, xl = tf32_split(x)
    split = xh @ wh + xh @ wl + xl @ wh
    want = x.double() @ w[12].double()

    def rel(a):
        return float((a.double() - want).norm() / want.norm())

    assert rel(split) <= 1e-6
    assert rel(xh @ wh) > 1e-5  # TF32 alone keeps ~3 digits
