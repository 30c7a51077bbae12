"""The port's spans (``utils/profiling.py::span``) and its always-on counters:
nothing recorded and no CUDA event made with no profiler session; under one,
nested names in ``SPANS`` and the profiler's events; stream time from an
event pair; the spans a CPU solve, ``DevicePrefetcher`` and ``GraphedStep``
record; the kernel build's and load's set-up counters."""

import contextlib
import dataclasses
import os
import threading
import time
from unittest import mock

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import adaptigraph_tpu_torch.planning.mppi_solve as mppi
from adaptigraph_tpu_torch import cli
from adaptigraph_tpu_torch.dynamics import train
from adaptigraph_tpu_torch.models.gnn import init_params
from adaptigraph_tpu_torch.ops import kernels
from adaptigraph_tpu_torch.planning import closed_loop
from adaptigraph_tpu_torch.utils.config import load_planning_config
from adaptigraph_tpu_torch.utils.profiling import SPANS, span

LOWER = np.asarray([-2.0, -2.0, -np.pi, 2.0], np.float32)
UPPER = np.asarray([2.0, 2.0, np.pi, 4.0], np.float32)


@pytest.fixture(autouse=True)
def fresh_spans():
    SPANS.reset()
    yield
    SPANS.reset()


def _traced():
    return profile(activities=[ProfilerActivity.CPU])


def _counts(stats):
    return {k: v["count"] for k, v in stats.items()}


def test_without_a_profiler_a_span_is_one_shared_null_context(monkeypatch):
    def no_event(*args, **kwargs):
        raise AssertionError("a span made a CUDA event with no profiler session")

    monkeypatch.setattr(torch.cuda, "Event", no_event)
    assert not torch._C._autograd._profiler_enabled()
    first = span("mppi.solve")
    assert first is span("mppi.reward", stream=torch.device("cuda", 0))
    assert isinstance(first, contextlib.nullcontext)
    with first:
        with span("mppi.chunk", stream="cuda"):
            pass
    assert SPANS.stats() == {} and SPANS.stream_stats() == {}


def test_under_a_profiler_spans_nest_and_lie_in_the_trace():
    with _traced() as prof:
        with span("mppi.solve"):
            for _ in range(3):
                with span("mppi.chunk"):
                    with span("mppi.reward", stream="cpu"):  # no event on a CPU device
                        torch.ones(4) + 1
    names = [e.name for e in prof.events()]
    for name in ("mppi.solve", "mppi.chunk", "mppi.reward"):
        assert name in names
    assert _counts(SPANS.stats()) == {"mppi.solve": 1, "mppi.solve/mppi.chunk": 3,
                                      "mppi.solve/mppi.chunk/mppi.reward": 3}
    stats = SPANS.stats()
    assert stats["mppi.solve"]["total_s"] >= stats["mppi.solve/mppi.chunk"]["total_s"] > 0
    assert SPANS.stream_stats() == {}
    SPANS.reset()
    assert SPANS.stats() == {}


def test_a_spans_thread_without_a_session_records_nothing():
    """The profiler's state is per thread: a thread started inside a session
    (``DevicePrefetcher``'s worker) records no span."""
    with _traced():
        worker = threading.Thread(target=lambda: span("train.stage").__enter__())
        worker.start()
        worker.join(timeout=10)
        assert not worker.is_alive()
    assert SPANS.stats() == {}


class _FakeEvent:
    """A CUDA event stand-in: ``record`` notes the stream's clock (ms)."""

    def __init__(self, enable_timing=False):
        assert enable_timing
        self.at = None
        self.synchronized = False

    def record(self, stream=None):
        self.at = stream.clock
        stream.clock += 2.5

    def synchronize(self):
        self.synchronized = True

    def elapsed_time(self, end):
        return end.at - self.at


def test_stream_time_is_an_event_pair_on_the_devices_current_stream(monkeypatch):
    stream = mock.Mock(clock=10.0)
    capturing = [False]
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: stream)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: capturing[0])
    dev = torch.device("cuda", 0)
    with _traced():
        with span("mppi.solve"):
            with span("mppi.sample", stream=dev):
                stream.clock += 4.0  # the work queued inside the span
            with span("mppi.sample", stream=dev):
                pass
            capturing[0] = True
            with span("mppi.sort", stream=dev):  # no event while capturing a graph
                pass
    pending = [end for _, _, end in SPANS._pending]
    got = SPANS.stream_stats()
    assert all(e.synchronized for e in pending) and SPANS._pending == []
    # (2.5 + 4.0) and 2.5 ms: each pair spans the work and the start's own record
    assert got == {"mppi.solve/mppi.sample": {"total_s": pytest.approx(9.0e-3), "count": 2}}
    assert _counts(SPANS.stats())["mppi.solve/mppi.sort"] == 1
    assert SPANS.stream_stats() == got  # read once, kept


def _tiny_task(n_sample, chunk, iters):
    tcfg, _ = cli._task_objects(load_planning_config("rope"))
    d = tcfg.dcfg
    gnn = dataclasses.replace(d.gnn, nf_particle=16, nf_relation=16, nf_effect=16, pstep=2,
                              max_nobj=20)
    edge = dataclasses.replace(d.edge, max_nobj=20, topk=5)
    tcfg.dcfg = dataclasses.replace(d, gnn=gnn, edge=edge, max_repeat=4)
    tcfg.mcfg = mppi.MPPIConfig(n_sample=n_sample, n_sample_chunk=chunk, n_look_ahead=1,
                                n_update_iter=iters, reward_weight=50.0, noise_level=0.5)
    return tcfg


def test_a_cpu_solve_records_each_layers_spans_and_the_same_answer():
    n_sample, chunk, iters, solves = 24, 8, 2, 2
    tcfg = _tiny_task(n_sample, chunk, iters)
    rng = np.random.RandomState(3)
    state = rng.uniform(-0.5, 0.5, (20, 3)).astype(np.float32)
    target = state + np.asarray([0.3, 0.0, 0.2], np.float32)
    act0 = np.asarray([[0.0, 0.0, 0.0, 3.0]], np.float32)
    phys = np.asarray([0.5], np.float32)
    params = init_params(torch.Generator().manual_seed(0), tcfg.dcfg.gnn)
    solve = mppi.make_mppi_solver(tcfg.dcfg, tcfg.mcfg,
                                  closed_loop.make_reward_fn(tcfg, target, "cpu"), LOWER, UPPER,
                                  device="cpu", compute_dtype=torch.float32)

    def run():
        return [solve(params, state, act0, torch.Generator().manual_seed(s), phys)
                for s in range(solves)]

    untraced = run()
    assert SPANS.stats() == {}
    with _traced():
        traced = run()
    for a, b in zip(untraced, traced):
        for key in a:
            assert torch.equal(a[key], b[key]), key
    chunks = n_sample // chunk
    per = {"mppi.solve": 1, "mppi.solve/mppi.weights": 1, "mppi.solve/mppi.inputs": 1,
           "mppi.solve/mppi.sample": iters, "mppi.solve/mppi.sort": iters,
           "mppi.solve/mppi.chunk": iters * chunks,
           # pusher_keypoints, then chunk_inputs, before each (plain) rollout
           "mppi.solve/mppi.chunk/k1.inputs": 2 * iters * chunks,
           "mppi.solve/mppi.chunk/mppi.reward": iters * chunks,
           "mppi.solve/mppi.update": iters, "mppi.solve/mppi.best": iters + iters - 1}
    assert _counts(SPANS.stats()) == {k: v * solves for k, v in per.items()}
    assert SPANS.stream_stats() == {}  # CPU tensors: host time only


def test_the_prefetchers_wait_is_a_span_per_batch_and_a_starved_count():
    release = threading.Event()

    def loader():
        release.wait(timeout=10)
        for i in range(3):
            yield {"x": np.full((2,), i, np.float32)}

    starved = train.DevicePrefetcher.starved
    prefetch = train.DevicePrefetcher(loader(), "cpu", depth=2)
    try:
        with _traced():
            threading.Timer(0.05, release.set).start()
            first = next(prefetch)  # the queue is empty until the loader is released
            deadline = time.monotonic() + 10
            while prefetch._q.qsize() < 2 and time.monotonic() < deadline:
                time.sleep(0.01)
            rest = [next(prefetch), next(prefetch)]
    finally:
        prefetch.close()
    assert [float(b["x"][0]) for b in [first] + rest] == [0.0, 1.0, 2.0]
    assert train.DevicePrefetcher.starved == starved + 1
    stats = SPANS.stats()
    assert _counts(stats) == {"train.batch_wait": 3}
    assert stats["train.batch_wait"]["total_s"] >= 0.04


class _FakeGraph:
    replays = 0

    def register_generator_state(self, generator):
        pass

    def replay(self):
        _FakeGraph.replays += 1


def test_graphed_steps_capture_count_and_replay_spans(monkeypatch):
    """``GraphedStep`` with the CUDA graph and stream calls stood in for on
    the CPU: one capture (counted with its seconds, over every instance)
    for two calls of the same shapes, and per replayed slice one
    ``train.copy_in`` and one ``train.replay``."""
    @contextlib.contextmanager
    def fake_capture(graph, stream=None, capture_error_mode=None):
        yield

    stream = mock.Mock()
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _FakeGraph)
    monkeypatch.setattr(torch.cuda, "graph", fake_capture)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: stream)
    monkeypatch.setattr(torch.cuda, "Stream", lambda device=None: stream)
    monkeypatch.setattr(torch.cuda, "stream", lambda s: contextlib.nullcontext())

    def step(leaf, batch, generator):
        return (leaf * batch["x"]).sum()

    graphed = train.GraphedStep(step)
    leaf = torch.ones(2)
    superbatch = {"x": torch.arange(6, dtype=torch.float32).reshape(3, 2)}
    captures, capture_s = train.GraphedStep.captures, train.GraphedStep.capture_s
    with _traced():
        graphed((leaf,), superbatch, None)
        graphed((leaf,), superbatch, None)
    assert train.GraphedStep.captures == captures + 1
    assert train.GraphedStep.capture_s > capture_s
    assert graphed.replays == 5 and _FakeGraph.replays >= 5
    assert _counts(SPANS.stats()) == {"train.capture": 1, "train.copy_in": 5,
                                      "train.replay": 5}


def _fake_nvcc(tmp_path):
    """A stand-in for nvcc that writes each ``-o`` file it is given."""
    path = tmp_path / "nvcc"
    path.write_text("#!/bin/sh\nwhile [ $# -gt 1 ]; do\n"
                    "  if [ \"$1\" = -o ]; then : > \"$2\"; fi\n  shift\ndone\n")
    path.chmod(0o755)
    return str(path)


def test_kernel_build_and_load_counters(monkeypatch, tmp_path):
    """``build.builds`` and ``build.build_s`` count the builds that ran nvcc
    (a warm call counts none); ``library.load_s`` adds each load's seconds."""
    monkeypatch.setattr(kernels, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(kernels, "_nvcc", lambda: _fake_nvcc(tmp_path))
    builds, build_s = kernels.build.builds, kernels.build.build_s
    path = kernels.build("no_edge")
    assert os.path.exists(path)
    assert kernels.build.builds == builds + 1 and kernels.build.build_s > build_s
    assert kernels.build("no_edge") == path and kernels.build.builds == builds + 1
    load_s = kernels.library.load_s
    loaded = []
    monkeypatch.setattr(kernels.ctypes, "CDLL", lambda p: loaded.append(p) or mock.MagicMock())
    kernels.library.__wrapped__("no_edge")  # the load itself, past the cache
    assert loaded == [path] and kernels.library.load_s > load_s
    assert kernels.build.builds == builds + 1

