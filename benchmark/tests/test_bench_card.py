"""On the card, at each cell's own size: the control (the reference in the
program's place, a precision below the configuration's: float8 for the
bfloat16 rollout and bfloat16 for the float32 reward of the solve, TF32 for
the float32 training) is not correct under the committed limits. Run on the
card with ``python3 -m pytest benchmark/tests -m card``; skips without one."""

import time

import pytest

from harness import runner
from harness import spec as specs
from bench_tiny import limits_of

CONTROL = {"solve": "fp8", "train": "tf32"}


@pytest.mark.card
@pytest.mark.parametrize("workload", ["rope_nf128.solve", "rope_nf128.train",
                                      "softbody_nf128.train"])
def test_the_control_is_not_correct(card, workload):
    spec = specs.load_spec()
    cell, config, traffic, _, _ = specs.resolve_cell(spec, workload)
    run = runner.Run(cell, config, traffic, 7, 2.0, False, specs.ROOT, card,
                     limits_of(workload), time.perf_counter(),
                     control=CONTROL[traffic["kind"]])
    runner.execute(run)
    assert run.correct is False
