"""``chip_smoke.py --k1``, the paired measurement of what the rollout kernel
(K1) moves, and the host side of K1's cycle counters: which phases the mode
runs and in what order, that its build line does not fail on the build
gate (an older checkout runs it too), how many sub-phase counters a
profiling build has, how the counters become the ``kernel_phases`` line,
and that the counters' names follow the kernel's own lists. Nothing here
needs a card or nvcc."""

import os
import re
from unittest import mock

import pytest
import torch

import chip_smoke
from chip_smoke import (K1_SUB_PHASES, PHASES, UNGATED_MODES, k1_cycle_split, k1_sub_phase_count,
                        phase_k1)

SOURCE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                      "adaptigraph_tpu_torch", "csrc", "rollout_chunk.cu")


@pytest.mark.parametrize("argv,gated", [([], True), (["--k1"], False), (["--k23"], False),
                                        (["--softbody"], True), (["--learned"], True)])
def test_measurement_modes_report_the_build_gate(argv, gated):
    assert (argv not in UNGATED_MODES) is gated


def test_phase_k1_runs_what_k1_moves_in_order():
    calls = []

    def record(name, result=None):
        def f(*args, **kw):
            calls.append(name)
            return result
        return f

    def plan_inputs(run):
        run()  # the plan
        calls.append("plan_k1_inputs")
        return "inputs"

    names = ["phase_solve", "phase_granular_solve", "phase_demo_ppo", "phase_planner_mppi",
             "phase_plan"]
    with mock.patch.multiple(chip_smoke, material=record("material", "rope"),
                             time_kernel=record("time_kernel", {"ms": 1.0}),
                             time_edges_kernel=record("time_edges_kernel", {"ms": 2.0}),
                             plan_k1_inputs=plan_inputs,
                             time_k1_inputs=record("time_k1_inputs", {"ms": 3.0}),
                             emit=record("emit"), **{n: record(n) for n in names}):
        phase_k1("cpu")
    # K2e's time beside K1's (the two kernels share the graph build), and K1's
    # on the plan's own input after the plan
    assert calls == (["material", "time_kernel", "emit", "time_edges_kernel", "emit"] + names
                     + ["plan_k1_inputs", "time_k1_inputs", "emit"])


def test_plan_k1_inputs_copies_the_first_full_chunk(monkeypatch):
    """``plan_k1_inputs`` passes every K1 launch of the plan on and returns
    copies of the first one at B 2000; the plan's later writes to its
    tensors do not reach them."""
    from adaptigraph_tpu_torch.ops import fused_gnn

    launched = []
    monkeypatch.setattr(fused_gnn, "rollout_chunk_cuda",
                        lambda *args: launched.append(args[0].shape[0]) or "out")
    estimate, first, second = (torch.zeros(512, 2), torch.ones(chip_smoke.B_CHUNK, 2),
                               torch.full((chip_smoke.B_CHUNK, 2), 2.0))

    def plan():
        assert fused_gnn.rollout_chunk_cuda(estimate, "w") == "out"
        fused_gnn.rollout_chunk_cuda(first, "w")
        fused_gnn.rollout_chunk_cuda(second, "w")
        first.fill_(7.0)

    args = chip_smoke.plan_k1_inputs(plan)
    assert launched == [512, chip_smoke.B_CHUNK, chip_smoke.B_CHUNK]
    assert args[1] == "w" and torch.equal(args[0], torch.ones(chip_smoke.B_CHUNK, 2))
    with pytest.raises(SystemExit):
        chip_smoke.plan_k1_inputs(lambda: fused_gnn.rollout_chunk_cuda(estimate, "w"))


def test_cycle_split_with_sub_phases():
    cycles = [10, 20, 30, 0, 25, 5, 5, 5]
    sub = [3, 12, 9, 20, 4]
    out = k1_cycle_split(cycles, sub, sample_steps=2)
    assert out["cycles_per_sample_step"] == 50.0
    assert out["share"] == {"encoder": 0.1, "graph": 0.2, "relation": 0.3, "projection": 0.0,
                            "aggregate": 0.25, "update": 0.05, "head": 0.05, "restick": 0.05}
    assert out["sub_cycles_per_sample_step"] == dict(zip(K1_SUB_PHASES,
                                                         [1.5, 6.0, 4.5, 10.0, 2.0]))
    assert out["sub_share"] == dict(zip(K1_SUB_PHASES, [0.03, 0.12, 0.09, 0.2, 0.04]))


def test_cycle_split_with_every_sub_phase():
    """Every sub-phase of a build that counts them all (the graph build's and
    the node-sized products' parts after the relation MLP's and the
    aggregation's): cycles per sample-substep and shares of all the cycles,
    in the order of ``K1_SUB_PHASES``."""
    cycles = [400, 300, 200, 0, 100, 0, 0, 0]
    sub = [10, 20, 30, 40, 50, 60, 70, 80, 90, 100, 110]
    assert len(sub) == len(K1_SUB_PHASES)
    out = k1_cycle_split(cycles, sub, sample_steps=5)
    assert out["cycles_per_sample_step"] == 200.0
    assert list(out["sub_cycles_per_sample_step"]) == list(K1_SUB_PHASES)
    assert out["sub_cycles_per_sample_step"]["graph_rows"] == 12.0
    assert out["sub_cycles_per_sample_step"]["node_barriers"] == 22.0
    assert out["sub_share"]["graph_selection"] == 0.07
    assert out["sub_share"]["node_products"] == 0.09
    assert sum(out["sub_share"].values()) == pytest.approx(0.66)


@pytest.mark.parametrize("lib,count", [
    ({"rollout_chunk_sub_phases": lambda: 11, "rollout_chunk_set_sub_clocks": print}, 11),
    ({"rollout_chunk_set_sub_clocks": print}, 5),  # an older build: the first five
    ({}, 0),  # no sub-phase counters
], ids=["reports", "older", "none"])
def test_sub_phase_count_of_a_profiling_build(lib, count):
    prof = type("Lib", (), {k: staticmethod(v) for k, v in lib.items()})()
    assert k1_sub_phase_count(prof) == count
    if count:
        assert len(k1_cycle_split([1] * len(PHASES), [1] * count, 1)["sub_share"]) == count


def test_cycle_split_of_a_build_without_sub_phases():
    out = k1_cycle_split([1] * len(PHASES), None, sample_steps=4)
    assert out["cycles_per_sample_step"] == len(PHASES) / 4
    assert out["sub_cycles_per_sample_step"] is None and out["sub_share"] is None


def _enum(name):
    with open(SOURCE) as f:
        body = re.search(r"enum %s \{([^}]*)\}" % name, f.read()).group(1)
    return [v.strip() for v in body.split(",") if v.strip()]


def test_counter_names_follow_the_kernel():
    """PHASES and K1_SUB_PHASES name the profiling build's counters in the
    order of the kernel's Phase and SubPhase enums (the last entry of each
    is the count)."""
    phases, subs = _enum("Phase"), _enum("SubPhase")
    assert phases[-1] == "kPhases" and len(phases) - 1 == len(PHASES)
    assert subs[-1] == "kSubPhases" and len(subs) - 1 == len(K1_SUB_PHASES)
    assert [p[1:].lower() for p in phases[:-1]] == list(PHASES)
    assert subs[:-1] == ["kRelInputs", "kRelProducts", "kRelEpilogues", "kAggRows", "kAggSums",
                         "kGraphRows", "kGraphSelection", "kGraphCompaction", "kNodeProducts",
                         "kNodeEpilogues", "kNodeBarriers"]
    prefix = {"Rel": "relation_", "Agg": "aggregate_", "Graph": "graph_", "Node": "node_"}
    for k, name in zip(subs[:-1], K1_SUB_PHASES):  # kRelInputs -> relation_inputs, ...
        part = re.sub(r"^k(Rel|Agg|Graph|Node)", lambda m: prefix[m.group(1)], k).lower()
        assert part == name
