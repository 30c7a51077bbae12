"""The port's ``utils/profiling.py`` against the JAX package's: the stage
timer's nesting and counts, the GNN forward's FLOP counts (equal), the
synchronised call timer's (mean, std) and the ``torch.profiler`` trace."""

import json
import os
import time

import pytest
import torch

from adaptigraph_tpu.models.gnn import GNNConfig as JaxGNNConfig
from adaptigraph_tpu.utils import profiling as jax_profiling
from adaptigraph_tpu_torch.models.gnn import GNNConfig
from adaptigraph_tpu_torch.utils import profiling


def _timed(timer):
    with timer("solve"):
        with timer("rollout"):
            time.sleep(0.002)
        with timer("rollout"):
            pass
    with timer("solve"):
        pass


def test_stage_timer_matches_jax():
    got, want = profiling.StageTimer(), jax_profiling.StageTimer()
    _timed(got)
    _timed(want)
    g, w = got.stats(), want.stats()
    assert list(g) == list(w) == ["solve", "solve/rollout"]
    assert [v["count"] for v in g.values()] == [v["count"] for v in w.values()] == [2, 2]
    assert g["solve/rollout"]["total_s"] >= 0.002 and g["solve"]["total_s"] >= 0.002
    lines = []
    got.report(lines.append)
    assert len(lines) == 2 and lines[1].startswith("solve/rollout")
    got.reset()
    assert got.stats() == {}


@pytest.mark.parametrize("kw", [dict(n_his=4, max_nobj=100, max_neef=1, nf_particle=128,
                                     nf_relation=128, nf_effect=128, pstep=3),
                                dict(n_his=3, max_nobj=20, max_neef=5, nf_particle=32,
                                     nf_relation=32, nf_effect=32, pstep=2)])
def test_gnn_forward_flops_match_jax(kw):
    for k_used in (11, 25):
        assert profiling.gnn_forward_flops(GNNConfig(**kw), k_used) == \
            jax_profiling.gnn_forward_flops(JaxGNNConfig(**kw), k_used)


def test_time_synced_and_device_trace(tmp_path):
    x = torch.randn(64, 64)
    mean, std = profiling.time_synced(lambda: x @ x, iters=5, device="cpu")
    assert mean > 0 and std >= 0
    with profiling.device_trace(str(tmp_path)) as prof:
        x @ x
    assert any("mm" in e.key for e in prof.key_averages())
    with open(os.path.join(tmp_path, "trace.json")) as f:
        assert "traceEvents" in json.load(f)
