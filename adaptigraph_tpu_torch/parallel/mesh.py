"""Device lists and sharding helpers (counterpart of
``adaptigraph_tpu/parallel/mesh.py``).

The JAX package shards the batch or sample axis over a 1-D
``jax.sharding.Mesh``, one process driving every chip. The port stays one
process driving a device list: a mesh is a plain list of ``torch.device``s,
and the sharded solve and train step (``planning/mppi_solve.py``,
``dynamics/train.py``) run each shard's work on its entry, gathering onto
``mesh[0]``. No ``torch.distributed``. A list may name one device more than
once: the whole sharded code then runs, with that many shards, on one card or
on the CPU.
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


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
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

    return [_tree_map(lambda x, i=i: part(x, i), batch) for i in range(n)]


def shard_batch(batch, mesh, batch_axis=0):
    """A host batch split along ``batch_axis`` (``batch_axis=1`` for
    ``(K, B, ...)`` superbatches: the step axis stays whole), one equal part
    per mesh entry, each on its device. Returns the list of parts."""
    return [_tree_map(lambda x, d=d: x.to(d), part)
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

    return [_tree_map(lambda x, d=d: copy(x, d), tree) for d in mesh]
