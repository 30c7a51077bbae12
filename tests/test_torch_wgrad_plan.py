"""K3's batch-wide weight gradients are planned in PyTorch
(``ops/fused_gnn_train.py::wgrad_plan``) and summed on the card by
``csrc/gnn_train_bwd.cu``'s ``wgrad_sum_samples_kernel`` and
``sum_samples_kernel``. Here, with no card:

- the plan covers every (job, 128-column slice, sample, row chunk) exactly
  once, in one fixed order (jobs, slices, samples and chunks ascending), no
  item deeper than ``WGRAD_DEPTH`` rows, each job's slices groups of
  consecutive items, and it is the same on a second call;
- the tables, read as the kernels read them (emulated in float64 on random
  cotangents: each block an equal share of the chunks that hold rows, edge
  chunks past a sample's real edges skipped, a sample with no real edges
  among them; block k's run in group g summed into slot k + g, and the sum
  finding a group's blocks from its first chunk), give every weight and bias
  gradient of X^T dY summed over the samples' real rows.
"""

import dataclasses

import numpy as np
import pytest

from adaptigraph_tpu_torch.cli import _dyn_objects
from adaptigraph_tpu_torch.ops.fused_gnn import _weight_shapes, round_up
from adaptigraph_tpu_torch.ops.fused_gnn_train import (WGRAD_DEPTH, WGRAD_JOBS, WGRAD_SLICE,
                                                       wgrad_plan)
from adaptigraph_tpu_torch.utils.config import load_dynamics_config


def _shapes(name, width):
    gnn, edge = _dyn_objects(load_dynamics_config(name))
    gnn = dataclasses.replace(gnn, nf_particle=width, nf_relation=width, nf_effect=width)
    return ([tuple(s) for s in _weight_shapes(gnn, gnn.particle_input_dim)],
            round_up(gnn.n_nodes, 8), edge.topk + edge.max_neef, gnn.pstep)


# (config, width, B, chunk rows): the benchmark's cells (B 128, both dtypes'
# chunks), the data-parallel shards (B 64), the GD Planner (B 512), a narrow
# width (one slice for rp_w23), one sample, and none
CASES = [("rope", 128, 128, 32), ("rope", 128, 128, 64), ("softbody", 128, 128, 32),
         ("softbody", 128, 64, 64), ("rope", 128, 512, 32), ("rope", 64, 3, 32),
         ("rope", 128, 1, 64), ("rope", 128, 0, 32)]
IDS = [f"{c}-nf{w}-B{b}-rows{r}" for c, w, b, r in CASES]


def _rows(kind, Np, K, pstep):
    return {"node": Np, "round": pstep * Np, "edge": K * Np}[kind]


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_plan_covers_every_chunk_once_in_order(case):
    name, width, B, chunk = case
    shapes, Np, K, pstep = _shapes(name, width)
    plan = wgrad_plan(shapes, B, Np, K, pstep, chunk)
    want, got = [], []
    for j, (w, _, kind) in enumerate(WGRAD_JOBS):
        n_c = -(-_rows(kind, Np, K, pstep) // chunk)
        for n0 in range(0, shapes[w][1], WGRAD_SLICE):
            want += [(j, n0, b, c) for b in range(B) for c in range(n_c)]
    for g, (j, n0, i0, i1) in enumerate(plan.groups.tolist()):
        assert plan.item_group[i0:i1].tolist() == [g] * (i1 - i0)
        for b0, b1, c0, c1 in plan.items[i0:i1].tolist():
            assert (b1 - b0) * (c1 - c0) * chunk <= max(WGRAD_DEPTH, chunk)
            got += [(j, n0, b, c) for b in range(b0, b1) for c in range(c0, c1)]
    assert got == want  # each once, in the fixed order
    assert [g[2] for g in plan.groups[1:].tolist()] == [g[3] for g in plan.groups[:-1].tolist()]
    assert len(plan.item_group) == len(plan.items)
    again = wgrad_plan(shapes, B, Np, K, pstep, chunk)
    assert all(np.array_equal(a, b) for a, b in zip(plan, again))


def _emulate(plan, shapes, ops, real_rows, chunk, blocks):
    """What wgrad_sum_samples_kernel and sum_samples_kernel compute from the
    plan, in float64: the chunks that hold rows, in item order, cut into
    `blocks` equal shares (partition); each block's run in a group into slot
    block + group (X^T dY of the slice and dY's column sums, each chunk's
    rows cut at its sample's); then each gradient element as the sum of its
    group's blocks' slots, found from the group's first chunk, read through
    wtab and job_group. Returns the gradients and the chunks a block."""
    chunks = []  # (group, sample, first row, end row) of every chunk that holds rows
    gstart = []
    for g, (j, _, i0, i1) in enumerate(plan.groups.tolist()):
        gstart.append(len(chunks))
        for b0, b1, c0, c1 in plan.items[i0:i1].tolist():
            for b in range(b0, b1):
                rows = real_rows(j, b)
                chunks += [(g, b, c * chunk, min((c + 1) * chunk, rows))
                           for c in range(c0, min(c1, -(-rows // chunk)))]
    total = len(chunks)
    gstart.append(total)
    slot = plan.slot
    partial = np.full((blocks + len(plan.groups), slot), np.nan)  # as the allocator leaves it
    start = [k * total // blocks for k in range(blocks + 1)]
    for k in range(blocks):
        for g, b, lo, hi in chunks[start[k]:start[k + 1]]:
            j, n0 = plan.groups[g][:2]
            at = k + g
            if np.isnan(partial[at, 0]):
                partial[at] = 0.0
            X, Y = ops[j]
            x, y = X[b, lo:hi], Y[b, lo:hi, n0:n0 + WGRAD_SLICE]
            kin, ns = x.shape[1], y.shape[1]
            partial[at, :kin * WGRAD_SLICE].reshape(kin, WGRAD_SLICE)[:, :ns] += x.T @ y
            partial[at, slot - WGRAD_SLICE:slot - WGRAD_SLICE + ns] += y.sum(0)
    wtab = plan.wtab.tolist()
    nw = len(shapes)
    goff, job, cols = wtab[:nw + 1], wtab[nw + 1:2 * nw + 1], wtab[2 * nw + 1:]
    grads = np.zeros(goff[-1])
    for i in range(goff[-1]):
        w = max(k for k in range(nw) if goff[k] <= i)
        e = i - goff[w]
        n = e % cols[w] if cols[w] else e
        at = (e // cols[w]) * WGRAD_SLICE + n % WGRAD_SLICE if cols[w] else slot - WGRAD_SLICE + n
        g = plan.job_group[job[w]] + n // WGRAD_SLICE
        a, b = gstart[g], gstart[g + 1]
        grads[i] = sum(partial[k + g, at] for k in range(blocks)
                       if start[k] < start[k + 1] and start[k] < b and start[k + 1] > a)
    return [grads[goff[w]:goff[w + 1]].reshape(shapes[w]) for w in range(nw)], np.diff(start)


@pytest.mark.parametrize("case", [("rope", 64, 3, 32, 4, 1.0), ("softbody", 64, 2, 64, 3, 1.0),
                                  ("rope", 64, 5, 64, 40, 1.0), ("rope", 64, 6, 32, 40, 0.1)],
                         ids=["rope-f32-rows", "softbody-bf16-rows", "rope-more-blocks",
                              "rope-few-edges"])
def test_plan_tables_sum_every_real_row(case):
    name, width, B, chunk, blocks, fill = case
    shapes, Np, K, pstep = _shapes(name, width)
    plan = wgrad_plan(shapes, B, Np, K, pstep, chunk)
    rng = np.random.RandomState(3)
    ecount = rng.randint(1, int(K * Np * fill) + 1, B)
    ecount[1] = 0  # a sample with no real edges
    ops = []
    for w, _, kind in WGRAD_JOBS:
        R = _rows(kind, Np, K, pstep)
        ops.append((rng.randn(B, R, shapes[w][0]), rng.randn(B, R, shapes[w][1])))

    def real_rows(j, b):
        kind = WGRAD_JOBS[j][2]
        return int(ecount[b]) if kind == "edge" else _rows(kind, Np, K, pstep)

    got, per_block = _emulate(plan, shapes, ops, real_rows, chunk, blocks)
    assert per_block.max() - per_block.min() <= 1  # equal shares of the chunks that hold rows
    for j, (w, bias, _) in enumerate(WGRAD_JOBS):
        X, Y = ops[j]
        want = sum(X[b, :real_rows(j, b)].T @ Y[b, :real_rows(j, b)] for b in range(B))
        np.testing.assert_allclose(got[w], want, rtol=1e-12, atol=1e-9)
        if bias is not None:
            want_b = sum(Y[b, :real_rows(j, b)].sum(0) for b in range(B))
            np.testing.assert_allclose(got[bias], want_b, rtol=1e-12, atol=1e-9)
