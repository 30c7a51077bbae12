"""The traced window and its reduction: ``torch.profiler`` over a few units
of the cell's work, reduced to the device time of each kernel by name, the
number of its records, the device's busy time (the union of kernel, copy and
set intervals on each card), the top device operations and the longest idle
gaps named by what the host was doing meanwhile.

``TEARDOWN_CUPTI=0`` keeps CUPTI attached after the session, as the port's
``utils/profiling.py::device_trace`` sets it: a session torn down and
attached again need not trace the kernels of a CUDA graph captured
meanwhile, and the train cells replay graphs.
"""

import contextlib
import os
import time

import torch



def _kind(e):
    try:
        return str(e.activity_type()).lower()
    except (AttributeError, RuntimeError):
        return ""


def _is_device_op(e):
    from torch.autograd import DeviceType

    if e.device_type() != DeviceType.CUDA:
        return False
    kind = _kind(e)
    if "annotation" in kind or getattr(e, "is_user_annotation", lambda: False)():
        return False
    return True


@contextlib.contextmanager
def traced():
    """Profile the block (CPU and CUDA activity). Yields a dict that holds,
    once the block is done, ``window_s`` (host clock from the first
    synchronised start to the synchronised end) and ``events``."""
    from torch.profiler import ProfilerActivity, profile

    os.environ.setdefault("TEARDOWN_CUPTI", "0")
    out = {}
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        yield out
        for d in range(torch.cuda.device_count()):
            torch.cuda.synchronize(d)
        out["window_s"] = time.perf_counter() - t0
    out["events"] = list(prof.profiler.kineto_results.events())


def _union(intervals):
    total, end = 0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def reduce(events, n_cards, top=10):
    """The trace's figures: ``kernel_ns`` and ``kernel_count`` by device
    operation name; ``busy_s`` the union of device intervals per card,
    averaged over ``n_cards``; ``device_ops`` the ``top`` operations by
    device seconds; ``idle_gaps`` the ``top`` longest gaps between device
    intervals on the busiest card, each named by the innermost host span or
    operator that covered the gap's middle."""
    dev_ops, host = [], []
    for e in events:
        start, dur = e.start_ns(), e.duration_ns()
        if _is_device_op(e):
            dev_ops.append((e.device_index(), start, start + dur, e.name()))
        elif dur > 0:
            host.append((start, start + dur, e.name()))
    kernel_ns, kernel_count = {}, {}
    per_card = {}
    for d, s, t, name in dev_ops:
        kernel_ns[name] = kernel_ns.get(name, 0) + (t - s)
        kernel_count[name] = kernel_count.get(name, 0) + 1
        per_card.setdefault(d, []).append((s, t))
    busy = {d: _union(iv) for d, iv in per_card.items()}
    busiest = max(busy, key=busy.get) if busy else None
    gaps = []
    if busiest is not None:
        end = None
        for s, t in sorted(per_card[busiest]):
            if end is not None and s > end:
                gaps.append((s - end, end, s))
            end = t if end is None else max(end, t)
    gaps.sort(reverse=True)
    named = []
    for length, s, t in gaps[:top]:
        mid = (s + t) // 2
        cover = [h for h in host if h[0] <= mid <= h[1]]
        # the innermost covering span: the latest to start
        name = max(cover)[2] if cover else "no host operation"
        named.append([name, length / 1e9])
    ops = sorted(kernel_ns.items(), key=lambda kv: -kv[1])[:top]
    return {"kernel_ns": kernel_ns, "kernel_count": kernel_count,
            "busy_s": sum(busy.values()) / 1e9 / max(n_cards, 1),
            "busiest_busy_s": busy.get(busiest, 0) / 1e9 if busiest is not None else 0.0,
            "device_ops": [[name, ns / 1e9] for name, ns in ops], "idle_gaps": named}


def kernel_time(summary, patterns):
    """(device seconds, records) of the operations whose names hold one of
    ``patterns``."""
    ns = sum(v for k, v in summary["kernel_ns"].items() if any(p in k for p in patterns))
    n = sum(v for k, v in summary["kernel_count"].items() if any(p in k for p in patterns))
    return ns / 1e9, n


def kernel_time_busiest(events, patterns):
    """The device seconds of the matching operations on the card where they
    took longest (a sharded solve's busiest card)."""
    per = {}
    for e in events:
        if _is_device_op(e) and any(p in e.name() for p in patterns):
            per[e.device_index()] = per.get(e.device_index(), 0) + e.duration_ns()
    return max(per.values()) / 1e9 if per else 0.0
