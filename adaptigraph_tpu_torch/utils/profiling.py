"""Profiling and tracing utilities (counterpart of
``adaptigraph_tpu/utils/profiling.py``): hierarchical stage timers, the
port's spans (``span``, recorded only while a ``torch.profiler`` session is
active), a ``torch.profiler`` device trace for Perfetto, timed calls that
synchronise the device, and the GNN forward's analytic FLOP count.
"""

import contextlib
import time
from collections import defaultdict

import numpy as np
import torch


class StageTimer:
    """Accumulating named-stage wall timers.

    >>> timer = StageTimer()
    >>> with timer("solve"):
    ...     ...
    >>> timer.report()
    """

    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)
        self._stack = []

    @contextlib.contextmanager
    def __call__(self, name):
        self._stack.append(name)
        full = "/".join(self._stack)
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[full] += dt
            self.counts[full] += 1
            self._stack.pop()

    def stats(self):
        return {
            k: {"total_s": self.totals[k], "count": self.counts[k],
                "mean_ms": 1e3 * self.totals[k] / max(self.counts[k], 1)}
            for k in sorted(self.totals)
        }

    def report(self, print_fn=print):
        for k, s in self.stats().items():
            print_fn(f"{k:40s} {s['total_s']:8.3f}s  x{s['count']:<5d} "
                     f"{s['mean_ms']:8.2f} ms/call")

    def reset(self):
        self.totals.clear()
        self.counts.clear()


class Spans(StageTimer):
    """The records of ``span``: each span's host seconds and count by nested
    name (the ``StageTimer``), and for a span taken with a CUDA ``stream``
    device its stream time, the elapsed time of a CUDA event pair recorded
    on that device's current stream at the span's entry and exit: the card's
    time on the work queued inside the span, with the card's wait for the
    host while it was queued. The events are read only by ``stream_stats``,
    which waits for them."""

    def __init__(self):
        super().__init__()
        self.stream_totals = defaultdict(float)
        self.stream_counts = defaultdict(int)
        self._pending = []  # (nested name, start event, end event), not read yet

    @contextlib.contextmanager
    def record(self, name, stream=False):
        """One span: a ``torch.profiler.record_function`` (so it lies in the
        trace with the kernels, on their clock), its host time and, with a
        CUDA ``stream`` device, its event pair."""
        with torch.profiler.record_function(name), self(name):
            full = "/".join(self._stack)
            events = _stream_events(stream)
            try:
                yield
            finally:
                if events is not None:
                    start, end, on = events
                    end.record(on)
                    self._pending.append((full, start, end))

    def stream_stats(self):
        """Each stream-timed span's total stream seconds and count by nested
        name. Waits for the events not read yet."""
        for name, start, end in self._pending:
            end.synchronize()
            self.stream_totals[name] += start.elapsed_time(end) / 1e3
            self.stream_counts[name] += 1
        self._pending.clear()
        return {k: {"total_s": self.stream_totals[k], "count": self.stream_counts[k]}
                for k in sorted(self.stream_totals)}

    def reset(self):
        super().reset()
        self.stream_totals.clear()
        self.stream_counts.clear()
        self._pending.clear()


def _stream_events(device):
    """(start event, end event, stream) for a span's stream time on
    ``device``'s current stream, the start recorded; None for no device, a
    CPU device, or a stream that is capturing a CUDA graph."""
    if not device:
        return None
    device = torch.device(device)
    if device.type != "cuda" or torch.cuda.is_current_stream_capturing():
        return None
    stream = torch.cuda.current_stream(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record(stream)
    return start, end, stream


SPANS = Spans()
_OFF = contextlib.nullcontext()


def span(name, stream=False):
    """A span of the port's code named ``name``, recorded in ``SPANS`` (under
    the names of the spans it lies in, joined by ``/``) and in the
    ``torch.profiler`` trace only while a profiler session is active on
    this thread. ``stream``: False (host time only) or the device on whose
    current stream the span's stream time is taken too (none on a CPU
    device). With no session it returns one shared null context and records
    nothing."""
    if not torch._C._autograd._profiler_enabled():
        return _OFF
    return SPANS.record(name, stream)


@contextlib.contextmanager
def device_trace(log_dir):
    """Record the host's operators and, where a card is present, its kernels
    with ``torch.profiler`` while the block runs, then write a Chrome/Perfetto
    trace to ``log_dir/trace.json``. Yields the profiler (``key_averages()``
    sums by kernel)."""
    import os

    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
        # keep CUPTI attached after the session (torch.profiler's own setting
        # where CUDA graphs run): one torn down and attached again need not
        # trace the kernels of a graph captured meanwhile, such as the train
        # steps' (``dynamics.train.GraphedStep``)
        os.environ.setdefault("TEARDOWN_CUPTI", "0")
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def time_synced(fn, *args, iters=10, warmup=1, device="cuda", **kwargs):
    """Wall-time ``fn(*args, **kwargs)`` with the device synchronised before
    and after each call (the JAX ``time_jitted``'s ``block_until_ready``):
    PyTorch returns before the card finishes, so an unsynchronised clock
    measures the enqueue. ``device``: the device whose work is waited for
    (a CPU device waits for nothing). Returns (mean_s, std_s)."""
    for _ in range(warmup):
        fn(*args, **kwargs)
    _sync(device)
    times = []
    for _ in range(iters):
        _sync(device)
        t0 = time.perf_counter()
        fn(*args, **kwargs)
        _sync(device)
        times.append(time.perf_counter() - t0)
    return float(np.mean(times)), float(np.std(times))


def gnn_forward_flops(cfg, k_used):
    """Analytic FLOP count for ONE GNN forward (one sample, one substep),
    split into "useful" model FLOPs (encoders, propagators, head) and the
    one-hot sender-gather matmuls of the JAX TPU kernel's lowering (the CUDA
    kernels gather by index instead; the count is kept so the two packages
    report the same numbers). Returns dict(useful=..., gather=...) in FLOPs
    (multiply-adds x 2)."""
    N = cfg.n_nodes
    K = int(k_used)
    nf = cfg.nf_effect
    n_p = cfg.max_nobj
    nh3 = cfg.n_his * 3

    d_in_p = cfg.attr_dim + cfg.phys_dim + (3 if cfg.action_dim else 0) \
        + (nh3 if cfg.state_dim else 0) + (1 if cfg.density_dim else 0)
    d_in_r = 2 * cfg.rel_attr_dim + (1 if cfg.rel_group_dim else 0) \
        + (nh3 if cfg.rel_distance_dim else 0)

    useful = 0
    useful += 2 * N * (d_in_p * nf + 2 * nf * nf)          # particle encoder
    useful += 2 * N * K * (d_in_r * nf + 2 * nf * nf)      # relation encoder
    useful += 2 * N * K * nf * nf                          # rel_base (enc @ w1)
    useful += 2 * N * nf * nf                              # part_base
    useful += cfg.pstep * (3 * 2 * N * nf * nf)            # recv/send/agg mats
    useful += 2 * n_p * (2 * nf * nf + nf * 3)             # motion head

    # one-hot gathers: attrs, group, state-residual block, pstep x effect
    gather_cols = cfg.attr_dim + cfg.n_instance + nh3 + cfg.pstep * nf
    gather = 2 * N * N * K * gather_cols
    return {"useful": float(useful), "gather": float(gather)}
