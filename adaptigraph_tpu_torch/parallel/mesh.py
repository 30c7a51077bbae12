"""Device lists and sharding helpers (counterpart of
``adaptigraph_tpu/parallel/mesh.py``).

The JAX package shards the batch or sample axis over a 1-D
``jax.sharding.Mesh``, one process driving every chip, and ``shard_map``
runs the shards at once. The port stays one process driving a device list:
a mesh is a plain list of ``torch.device``s, and the sharded solve and train
step (``planning/mppi_solve.py``, ``dynamics/train.py``) run each shard's
work on its entry, gathering onto ``mesh[0]``. No ``torch.distributed``. A
list may name one device more than once: the whole sharded code then runs,
with that many shards, on one card or on the CPU.

Each entry on a card gets a CUDA stream of its own (``shard_streams``; two
for a card named twice), and a shard's work runs on it with its card
current (``shard_scope``), so the host issues every shard's work without
waiting for a card and the shards run at once. The hand-offs go through
events. Each shard starts once the work queued so far is done on
``mesh[0]``'s current stream (the caller's, where the shard inputs were
made) and on its own card's current stream, where a batch that
``dynamics.train.DevicePrefetcher`` copied to that card was ordered
(``fork``); ``mesh[0]``'s current stream goes on once every shard is done
(``join``). A
tensor used on a stream other than the one it was made on is marked as used
there (``used_on``, ``record_stream``), so the caching allocator does not
hand its memory on before that stream is done with it. On the CPU every one
of these is a no-op.
"""

import contextlib

import numpy as np
import torch


def make_mesh(n_devices=None, device_type="cuda", devices=None):
    """The first ``n_devices`` devices of ``device_type`` (all of them when
    None), or the given ``devices`` (which may repeat a device). Raises when
    fewer devices exist than were asked for: it never returns a shorter list,
    and never falls back to the CPU."""
    if devices is not None:
        avail = [torch.device(d) for d in devices]
    elif device_type == "cuda":
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        avail = [torch.device("cuda", i) for i in range(count)]
    elif device_type == "cpu":
        avail = [torch.device("cpu")]
    else:
        raise ValueError(f"unknown device type {device_type!r}")
    n = len(avail) if n_devices is None else int(n_devices)
    if n < 1 or n > len(avail):
        what = f"{len(avail)} {device_type} device(s)" if devices is None else f"{len(avail)} devices"
        raise RuntimeError(f"a mesh of {n} needs {max(n, 1)} devices; {what} available")
    return avail[:n]


def device_scope(device):
    """The context in which a shard's work runs: its card current (the
    kernels' launchers and ``device="cuda"`` allocations follow it), or
    nothing for the CPU."""
    device = torch.device(device)
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def shard_streams(mesh):
    """A new CUDA stream for each mesh entry on a card, None for a CPU entry.
    A sharded function makes its streams once and runs each shard on its
    own."""
    return [torch.cuda.Stream(d) if d.type == "cuda" else None
            for d in (torch.device(d) for d in mesh)]


@contextlib.contextmanager
def shard_scope(device, stream):
    """``device_scope(device)`` with ``stream`` current as well (None: the
    card's current stream stays): the kernels' launchers, the caching
    allocator and PyTorch's own kernels then all use the shard's stream."""
    with device_scope(device), (torch.cuda.stream(stream) if stream is not None
                                else contextlib.nullcontext()):
        yield


def _home_stream(home):
    return torch.cuda.current_stream(home) if torch.device(home).type == "cuda" else None


def fork(streams, home):
    """Every shard's stream waits for the work queued so far on ``home``'s
    current stream (the caller's) and on its own card's current stream (a
    card other than ``home`` orders there what it was handed, such as the
    batch prefetcher's copy). No host wait."""
    if _home_stream(home) is None:
        return
    events = {}
    for s in streams:
        if s is None:
            continue
        for d in (torch.device(home), s.device):
            if d not in events:
                events[d] = torch.cuda.current_stream(d).record_event()
            s.wait_event(events[d])


def join(streams, home):
    """``home``'s current stream waits for the work queued so far on every
    shard's stream. No host wait."""
    cur = _home_stream(home)
    for s in streams:
        if s is not None and cur is not None:
            cur.wait_stream(s)


def used_on(tree, stream):
    """Marks every tensor in ``tree`` (dicts, lists and tuples of tensors and
    other values) that lies on ``stream``'s card as used on ``stream``
    (``record_stream``); nothing when ``stream`` is None. A tensor on
    another card reaches the stream only through a copy, which PyTorch
    orders on both cards' current streams."""
    if stream is not None:
        tree_map(lambda x: x.record_stream(stream)
                 if isinstance(x, torch.Tensor) and x.device == stream.device else None, tree)


def run_shards(mesh, streams, work, counters, tallies):
    """``fn(*args)`` for every item ``(s, fn, args)`` of ``work`` (the body
    of JAX's ``shard_map``), issued in the order given, each on shard s's
    stream ``streams[s]`` with its card ``mesh[s]`` current, all from this
    thread without a host wait, between a ``fork`` from and a ``join`` to
    ``mesh[0]``'s current stream. An item's arguments are marked as used on
    its shard's stream, and the launches of the wrappers in ``counters``
    that it made are added to ``tallies[s]``. Returns each item's output
    (a tensor, a tree of tensors, or None) on ``mesh[0]``, in ``work``'s
    order, marked as used on its current stream. State that outlives the
    call (the parameters, the optimizer state) is the caller's, made on the
    caller's stream, which waits for the shards."""
    home = torch.device(mesh[0])
    fork(streams, home)
    outs = []
    for s, fn, a in work:
        used_on(a, streams[s])
        with shard_scope(mesh[s], streams[s]), count_launches(counters, tallies[s]):
            outs.append(fn(*a))
    outs = gather(outs, [s for s, _, _ in work], mesh, streams)
    join(streams, home)
    used_on(outs, _home_stream(home))
    return outs


def gather(outs, shards, mesh, streams):
    """Each output (a tensor, a tree of tensors or None) on ``mesh[0]``,
    copied from shard ``shards[i]``'s card on its stream. Issue it only once
    every shard's work is queued: a copy from another card makes
    ``mesh[0]``'s current stream wait for that shard, and a later copy of
    another shard's inputs, which runs on that stream, would wait too."""
    home = torch.device(mesh[0])
    gathered = []
    for s, out in zip(shards, outs):
        with shard_scope(mesh[s], streams[s]):
            gathered.append(tree_map(lambda x: None if x is None else x.to(home), out))
    return gathered


def launch_tallies(counters, n):
    """``n`` zeroed tallies (one per shard) of the launches of each kernel
    wrapper in ``counters``, keyed by the wrapper's name."""
    return [{c.__name__: 0 for c in counters} for _ in range(n)]


@contextlib.contextmanager
def count_launches(counters, tally):
    """Adds to ``tally`` (one of ``launch_tallies``') the launches that each
    wrapper in ``counters`` (its ``launches`` count) made inside the block:
    one shard's share of a sharded call."""
    before = [c.launches for c in counters]
    try:
        yield
    finally:
        for c, b in zip(counters, before):
            tally[c.__name__] += c.launches - b


def tree_map(fn, tree):
    """``fn`` applied to every leaf of ``tree`` (dicts, lists and tuples of
    leaves), in the same nesting."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def split_batch(batch, n, batch_axis=0):
    """``batch`` (a tensor or array, or a dict, list or tuple of them) cut
    along ``batch_axis`` into ``n`` equal parts: a list of ``n`` trees of
    contiguous tensors on the batch's device. Raises on a remainder, as JAX's
    ``NamedSharding`` does."""

    def part(x, i):
        x = torch.as_tensor(x)
        size = x.shape[batch_axis]
        if size % n:
            raise ValueError(f"batch axis {batch_axis} of size {size} does not split "
                             f"evenly over {n} shards")
        return x.narrow(batch_axis, i * (size // n), size // n).contiguous()

    return [tree_map(lambda x, i=i: part(x, i), batch) for i in range(n)]


def shard_batch(batch, mesh, batch_axis=0):
    """A host batch split along ``batch_axis`` (``batch_axis=1`` for
    ``(K, B, ...)`` superbatches: the step axis stays whole), one equal part
    per mesh entry, each on its device. Returns the list of parts."""
    return [tree_map(lambda x, d=d: x.to(d), part)
            for d, part in zip(mesh, split_batch(batch, len(mesh), batch_axis))]


def replicate(tree, mesh):
    """One copy of ``tree`` (tensors, arrays or numbers in dicts, lists and
    tuples) per mesh entry, on its device; entries that name the same device
    get copies of their own. A tensor that requires grad gives leaves that
    require grad."""

    def copy(x, d):
        if isinstance(x, torch.Tensor):
            return x.detach().to(d, copy=True).requires_grad_(x.requires_grad)
        if isinstance(x, np.ndarray):
            return torch.tensor(x, device=d)
        return x

    return [tree_map(lambda x, d=d: copy(x, d), tree) for d in mesh]
