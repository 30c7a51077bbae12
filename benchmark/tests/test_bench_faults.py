"""Runs of the harness with the timed path broken underneath (on the CPU, at
a tiny size, the harness's look for a card skipped): each fault that a cell
can have makes ``correct`` come out false under the committed limits."""

import pytest

from bench_tiny import limits_of, run_tiny

CASES = [("rope_nf128.solve", "half_batch"), ("rope_nf128.solve", "answer"),
         ("rope_nf128.solve", "reward"),
         ("rope_nf128.train", "unchanged"), ("rope_nf128.train", "half_batch"),
         ("rope_nf128.train", "answer"),
         ("softbody_nf128.train", "unchanged"), ("softbody_nf128.train", "half_batch"),
         ("softbody_nf128.train", "answer")]


@pytest.mark.parametrize("workload,fault", CASES)
def test_a_broken_timed_path_is_not_correct(workload, fault):
    run = run_tiny(workload, faults=[fault], limits=limits_of(workload))
    assert run.correct is False and run.failed >= 1


def test_patches_are_undone_after_a_run():
    from adaptigraph_tpu_torch.dynamics import train
    from adaptigraph_tpu_torch.ops import fused_gnn

    before = (train.adam_step, train.multi_step_loss, fused_gnn.rollout_chunk)
    run_tiny("rope_nf128.train", faults=["unchanged", "half_batch"],
             limits=limits_of("rope_nf128.train"))
    assert (train.adam_step, train.multi_step_loss, fused_gnn.rollout_chunk) == before
