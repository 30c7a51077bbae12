"""The cell ``rope.solve`` (configuration ``rope``: AdaptiGraph's published
150-wide rope model) on the CPU, at a tiny size but the published width: a
sound solve agrees with the reference; each fault a solve cell can have
makes ``correct`` come out false under the cell's limits; the port's plain
rollout on the configuration agrees with the reference; the reader of
``k1_pack_ms``, the span around K1's weight padding and packing."""

import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from bench_tiny import limits_of, tiny_cell
from harness import runner
from harness import spec as specs
from reference import gnn as ref
from adaptigraph_tpu_torch.utils import profiling

CELL = "rope.solve"


def _run(width, faults=(), limits=None):
    cell, config, traffic = tiny_cell(CELL, width=width)
    run = runner.Run(cell, config, traffic, 3, 0.0, False, specs.ROOT, torch.device("cpu"),
                     limits, time.perf_counter())
    run.faults = list(faults)
    runner.execute(run)
    return run


def test_the_cell_runs_the_published_width():
    spec = specs.load_spec()
    _, config, _, e2e, per_layer = specs.resolve_cell(spec, CELL)
    mc = config["dynamics"]["model_config"]
    assert (mc["nf_particle"], mc["nf_relation"], mc["nf_effect"]) == (150, 150, 150)
    assert {m["name"] for m in e2e} == {"solve_ms", "solve_p95_ms", "setup_s"}
    assert "k1_pack_ms" in {m["name"] for m in per_layer}


def test_a_sound_published_width_solve_agrees_with_the_reference():
    run = _run(150, limits=limits_of(CELL))
    values = {k: v["value"] for k, v in run.checks.items()}
    assert values["best_mismatch"] == 0.0 and values["state_err"] < 0.05
    assert values["state_err_chunk"] < 0.1 and values["reward_err"] < 1e-5
    assert run.correct is True and run.failed == 0
    assert run.attempted >= 1 and run.layer["k1_ops_per_launch"] > 0


@pytest.mark.parametrize("fault", ["half_batch", "answer", "reward"])
def test_a_broken_timed_path_is_not_correct(fault):
    run = _run(16, faults=[fault], limits=limits_of(CELL))
    assert run.correct is False and run.failed >= 1


def test_the_plain_rollout_at_150_agrees_with_the_benchmarks_reference():
    from adaptigraph_tpu_torch.cli import _dyn_objects
    from adaptigraph_tpu_torch.ops.fused_gnn import chunk_inputs, rollout_chunk_plain, weight_list

    dyn = specs.load_json(f"{specs.BENCH_DIR}/configs/rope.json")["dynamics"]
    m, cfg = ref.model_sizes(dyn), _dyn_objects(dyn)[0]
    assert (cfg.nf_particle, cfg.nf_relation, cfg.nf_effect) == (150, 150, 150)
    g = torch.Generator().manual_seed(3)
    params = ref.tree_from_leaves([(torch.rand(s, generator=g) * 2 - 1) / np.sqrt(s[0])
                                   for s in ref.leaf_shapes(m)])
    B, n_p = 4, m["max_nobj"]
    obj = torch.rand(B, n_p, 3, generator=g) * torch.tensor([2.0, 0.1, 0.5])
    kp = torch.rand(B, 1, 3, generator=g)
    delta = torch.rand(B, 1, 3, generator=g) * 0.1
    repeat = torch.randint(1, 5, (B,), generator=g, dtype=torch.int32)
    phys = torch.rand(B, 1, generator=g)
    pin, sa, rep, valid = chunk_inputs(obj, kp, delta, repeat, phys, cfg, torch.float32)
    ours = rollout_chunk_plain(pin, sa, rep, valid, weight_list(params, cfg, torch.float32), cfg,
                               m["topk"], 0.5, 10, compute_dtype=torch.float32)
    theirs = ref.rollout(params, m, obj, kp, delta, repeat, phys, 0.5, 10)
    torch.testing.assert_close(ours, theirs, rtol=1e-5, atol=1e-5)


@pytest.fixture
def fresh_spans():
    profiling.SPANS.reset()
    yield
    profiling.SPANS.reset()


def test_the_pack_reader_sums_its_spans_per_solve(fresh_spans, monkeypatch):
    read = specs.load_reader("k1_pack_ms")
    run = SimpleNamespace(layer={"trace_units": 4})
    assert read(run) is None  # nothing recorded, as in a program without the span
    spans = profiling.SPANS
    name = "mppi.solve/mppi.chunk/k1.launch/k1.pack"
    spans.totals[name] += 0.004
    spans.counts[name] += 40
    spans.stream_totals[name] += 0.002
    spans.stream_counts[name] += 40
    assert read(run) == pytest.approx(2.0 / 4)
    monkeypatch.delattr(profiling, "SPANS")  # a port that records no spans
    assert read(run) is None
