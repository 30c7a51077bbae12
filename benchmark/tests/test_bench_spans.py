"""The readers of the port's spans and set-up counters
(``metrics/_spans.py`` and the metrics that use it, ``capture_s``,
``kernel_load_s``): None where the port recorded nothing or keeps no such
record, and the per-unit value of records set by hand."""

from types import SimpleNamespace

import pytest

from harness import spec as specs
from adaptigraph_tpu_torch.dynamics import train
from adaptigraph_tpu_torch.ops import kernels
from adaptigraph_tpu_torch.utils import profiling

SPAN_READERS = ("reward_stream_ms", "mppi_stream_ms", "solve_host_ms", "batch_wait_ms",
                "copy_in_stream_ms")
COUNTER_READERS = ("capture_s", "kernel_load_s")


@pytest.fixture(autouse=True)
def fresh_spans():
    profiling.SPANS.reset()
    yield
    profiling.SPANS.reset()


def _run(units):
    return SimpleNamespace(layer={"trace_units": units})


def _record(name, host_s=0.0, stream_s=None, count=1):
    spans = profiling.SPANS
    spans.totals[name] += host_s
    spans.counts[name] += count
    if stream_s is not None:
        spans.stream_totals[name] += stream_s
        spans.stream_counts[name] += count


def test_every_new_reader_is_a_metric_of_the_benchmark():
    names = {m["name"] for m in specs.load_spec()["per_layer"]}
    assert set(SPAN_READERS + COUNTER_READERS) <= names


@pytest.mark.parametrize("name", SPAN_READERS)
def test_a_span_reader_finds_nothing_without_records(name, monkeypatch):
    read = specs.load_reader(name)
    assert read(_run(4)) is None
    _record("bench.other", host_s=1.0, stream_s=1.0)  # spans of other names only
    assert read(_run(4)) is None
    monkeypatch.delattr(profiling, "SPANS")  # a port that records no spans
    assert read(_run(4)) is None


def test_the_solve_readers_sum_their_spans_per_solve():
    solve = "mppi.solve"
    chunk = solve + "/mppi.chunk"
    _record(solve, host_s=0.100, count=4)
    _record(solve + "/mppi.weights", host_s=0.5, stream_s=0.004, count=4)
    _record(solve + "/mppi.inputs", stream_s=0.001, count=4)
    _record(solve + "/mppi.sample", stream_s=0.002, count=4)
    _record(solve + "/mppi.sort", stream_s=0.003, count=4)
    _record(chunk, host_s=0.090, count=40)
    _record(chunk + "/k1.inputs", stream_s=0.008, count=80)
    _record(chunk + "/k1.launch", host_s=0.020, count=40)
    _record(chunk + "/mppi.reward", host_s=0.010, stream_s=0.024, count=40)
    _record(solve + "/mppi.update", stream_s=0.005, count=4)
    _record(solve + "/mppi.best", stream_s=0.001, count=4)
    run = _run(4)
    assert specs.load_reader("reward_stream_ms")(run) == pytest.approx(24.0 / 4)
    assert specs.load_reader("mppi_stream_ms")(run) == pytest.approx(24.0 / 4)
    assert specs.load_reader("solve_host_ms")(run) == pytest.approx(100.0 / 4)


def test_the_train_readers_sum_their_spans_per_step():
    _record("train.batch_wait", host_s=0.003, count=3)
    _record("train.copy_in", host_s=0.001, stream_s=0.0006, count=30)
    _record("train.replay", host_s=0.002, count=30)
    run = _run(30)
    assert specs.load_reader("batch_wait_ms")(run) == pytest.approx(3.0 / 30)
    assert specs.load_reader("copy_in_stream_ms")(run) == pytest.approx(0.6 / 30)


def test_the_counter_readers(monkeypatch):
    capture, load = specs.load_reader("capture_s"), specs.load_reader("kernel_load_s")
    monkeypatch.setattr(train.GraphedStep, "captures", 0)
    monkeypatch.setattr(kernels.library, "load_s", 0.0)
    assert capture(_run(1)) is None and load(_run(1)) is None  # nothing captured or loaded
    monkeypatch.setattr(train.GraphedStep, "captures", 2)
    monkeypatch.setattr(train.GraphedStep, "capture_s", 1.25)
    monkeypatch.setattr(kernels.build, "build_s", 0.0)  # a warm run: nothing built
    monkeypatch.setattr(kernels.library, "load_s", 0.125)
    assert capture(_run(1)) == 1.25 and load(_run(1)) == 0.125
    monkeypatch.setattr(kernels.build, "build_s", 100.0)  # a cold run
    assert load(_run(1)) == 100.125
    monkeypatch.delattr(train.GraphedStep, "captures")  # a port without the counters
    monkeypatch.delattr(kernels.library, "load_s")
    assert capture(_run(1)) is None and load(_run(1)) is None
