"""Fixed-dt timestamp accumulation for recorded observation/action streams
(a copy of ``adaptigraph_tpu/realworld/accumulate.py``).

Equivalent of the reference's ``common/timestamp_accumulator.py``
(reference: ``src/planning/real_world/common/timestamp_accumulator.py:6-222``):
sensor frames and robot commands arrive at irregular wall-clock times; the
recorders re-sample them onto a global clock ``start_time + k*dt`` by picking,
for every global slot, the first sample whose window covers it (repeating the
previous sample over dropped frames). The reference walks samples in a Python
loop; here the slot assignment is a vectorized cummax + searchsorted, which is
what lets the sim-backed env re-sample thousands of frames per push cheaply.
"""

import numpy as np

__all__ = [
    "accumulate_timestamp_idxs",
    "align_to_global_idxs",
    "TimestampObsAccumulator",
    "TimestampActionAccumulator",
]


def accumulate_timestamp_idxs(timestamps, start_time, dt, eps=1e-5,
                              next_global_idx=0, allow_negative=False):
    """Assign sorted ``timestamps`` to global slots of width ``dt``.

    Returns ``(local_idxs, global_idxs, next_global_idx)``: for each global
    slot in ``[next_global_idx, max_slot]`` the index of the first timestamp
    whose slot is >= it (so one sample may fill several slots after drops).
    ``next_global_idx=None`` restarts at the first sample's slot (the
    overwrite mode the action accumulator uses).
    Reference: ``timestamp_accumulator.py:6-41``.
    """
    ts = np.asarray(timestamps, np.float64)
    gidx = np.floor((ts - start_time) / dt + eps).astype(np.int64)
    keep = np.ones(len(gidx), bool) if allow_negative else gidx >= 0
    local_of_kept = np.nonzero(keep)[0]
    gidx = gidx[keep]
    if len(gidx) == 0:
        return [], [], (0 if next_global_idx is None else next_global_idx)
    if next_global_idx is None:
        next_global_idx = int(gidx[0])
    cummax = np.maximum.accumulate(gidx)
    last = int(cummax[-1])
    if last < next_global_idx:
        return [], [], next_global_idx
    global_idxs = np.arange(next_global_idx, last + 1)
    # first sample whose running-max slot reaches each global slot
    local = np.searchsorted(cummax, global_idxs, side="left")
    local_idxs = local_of_kept[local]
    return list(local_idxs), list(global_idxs), last + 1


def align_to_global_idxs(timestamps, target_global_idxs, start_time, dt,
                         eps=1e-5):
    """For each target global slot, the local sample index to use
    (repeating the last sample when the stream ends early).
    Reference: ``timestamp_accumulator.py:44-76``."""
    target = list(np.asarray(target_global_idxs).tolist())
    assert len(target) > 0
    local_idxs, global_idxs, _ = accumulate_timestamp_idxs(
        timestamps, start_time, dt, eps=eps,
        next_global_idx=target[0], allow_negative=True)
    local_idxs = local_idxs[:len(target)]
    global_idxs = global_idxs[:len(target)]
    while len(global_idxs) < len(target):
        local_idxs.append(len(timestamps) - 1)
        global_idxs.append((global_idxs[-1] + 1) if global_idxs else target[0])
    assert list(global_idxs) == target
    return local_idxs


class _GrowBuffer:
    """Amortized-doubling (n, *shape) buffer."""

    def __init__(self):
        self.arr = None

    def ensure(self, n, template):
        if self.arr is None:
            shape = (max(n, len(np.atleast_1d(template))),) + template.shape[1:]
            self.arr = np.zeros(shape, template.dtype)
        elif n > len(self.arr):
            new = np.zeros((max(n, 2 * len(self.arr)),) + self.arr.shape[1:],
                           self.arr.dtype)
            new[:len(self.arr)] = self.arr
            self.arr = new
        return self.arr


class TimestampObsAccumulator:
    """Accumulates dicts of (T, ...) observation arrays onto the global clock,
    append-only (reference: ``timestamp_accumulator.py:79-150``)."""

    def __init__(self, start_time, dt, eps=1e-5):
        self.start_time = start_time
        self.dt = dt
        self.eps = eps
        self._bufs = {}
        self._ts = _GrowBuffer()
        self.next_global_idx = 0

    def __len__(self):
        return self.next_global_idx

    @property
    def data(self):
        return {k: b.arr[:len(self)] for k, b in self._bufs.items()}

    @property
    def actual_timestamps(self):
        if self._ts.arr is None:
            return np.array([])
        return self._ts.arr[:len(self)]

    @property
    def timestamps(self):
        return self.start_time + np.arange(len(self)) * self.dt

    def put(self, data, timestamps):
        timestamps = np.asarray(timestamps, np.float64)
        local, glob, self.next_global_idx = accumulate_timestamp_idxs(
            timestamps, self.start_time, self.dt, eps=self.eps,
            next_global_idx=self.next_global_idx)
        if not glob:
            return
        n = glob[-1] + 1
        for key, value in data.items():
            value = np.asarray(value)
            buf = self._bufs.setdefault(key, _GrowBuffer()).ensure(n, value)
            buf[glob] = value[local]
        self._ts.ensure(n, timestamps)[glob] = timestamps[local]


class TimestampActionAccumulator:
    """Like the obs accumulator but re-playable: later puts overwrite earlier
    global slots (receding-horizon action streams; reference:
    ``timestamp_accumulator.py:153-222``)."""

    def __init__(self, start_time, dt, eps=1e-5):
        self.start_time = start_time
        self.dt = dt
        self.eps = eps
        self._buf = _GrowBuffer()
        self._ts = _GrowBuffer()
        self.size = 0

    def __len__(self):
        return self.size

    @property
    def actions(self):
        if self._buf.arr is None:
            return np.array([])
        return self._buf.arr[:len(self)]

    @property
    def actual_timestamps(self):
        if self._ts.arr is None:
            return np.array([])
        return self._ts.arr[:len(self)]

    @property
    def timestamps(self):
        return self.start_time + np.arange(len(self)) * self.dt

    def put(self, actions, timestamps):
        actions = np.asarray(actions)
        timestamps = np.asarray(timestamps, np.float64)
        local, glob, _ = accumulate_timestamp_idxs(
            timestamps, self.start_time, self.dt, eps=self.eps,
            next_global_idx=None)  # overwrite mode
        if not glob:
            return
        n = glob[-1] + 1
        self._buf.ensure(n, actions)[glob] = actions[local]
        self._ts.ensure(n, timestamps)[glob] = timestamps[local]
        self.size = max(self.size, n)
