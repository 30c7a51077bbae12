"""``chip_smoke.py --k1``, the paired measurement of what the rollout kernel
(K1) moves, and the host side of K1's cycle counters: which phases the mode
runs and in what order, that its build line does not fail on the build
gate (an older checkout runs it too), how the profiling build's counters
become the ``kernel_phases`` line, and that the counters' names follow the
kernel's own lists. Nothing here needs a card or nvcc."""

import os
import re
from unittest import mock

import pytest

import chip_smoke
from chip_smoke import K1_SUB_PHASES, PHASES, UNGATED_MODES, k1_cycle_split, phase_k1

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

    names = ["phase_solve", "phase_granular_solve", "phase_demo_ppo", "phase_planner_mppi",
             "phase_plan"]
    with mock.patch.multiple(chip_smoke, material=record("material", "rope"),
                             time_kernel=record("time_kernel", {"ms": 1.0}),
                             emit=record("emit"), **{n: record(n) for n in names}):
        phase_k1("cpu")
    assert calls == ["material", "time_kernel", "emit"] + names


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
    assert subs[:-1] == ["kRelInputs", "kRelProducts", "kRelEpilogues", "kAggRows", "kAggSums"]
    for k, name in zip(subs[:-1], K1_SUB_PHASES):  # kRelInputs -> relation_inputs, ...
        part = re.sub(r"^k(Rel|Agg)", lambda m: {"Rel": "relation_", "Agg": "aggregate_"}[
            m.group(1)], k).lower()
        assert part == name
