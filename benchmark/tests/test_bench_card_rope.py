"""On the card, at the cell's own size: the controls of ``rope.solve`` (the
reference in the program's place, a precision below the configuration's:
float8 for the bfloat16 rollout, bfloat16 for the float32 reward) are not
correct under the cell's limits. Run on the card with ``python3 -m pytest
benchmark/tests -m card``; skips without one."""

import time

import pytest

from bench_tiny import limits_of
from harness import runner
from harness import spec as specs

CELL = "rope.solve"


@pytest.mark.card
@pytest.mark.parametrize("seed", [7, 2654435761, 4052739537881])
def test_the_control_is_not_correct(card, seed):
    spec = specs.load_spec()
    cell, config, traffic, _, _ = specs.resolve_cell(spec, CELL)
    run = runner.Run(cell, config, traffic, seed, 2.0, False, specs.ROOT, card, limits_of(CELL),
                     time.perf_counter(), control="fp8")
    runner.execute(run)
    print({k: v["value"] for k, v in run.checks.items()})
    assert run.correct is False
