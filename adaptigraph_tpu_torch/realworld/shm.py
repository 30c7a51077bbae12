"""ctypes binding for the C++ shared-memory ring buffer and queue
(counterpart of ``adaptigraph_tpu/realworld/shm.py``).

Fixed-shape numpy frames streamed from a producer process (a camera) to
consumers, newest first, timestamped; and a bounded FIFO of fixed-layout
records, the command plane between the parent and its camera or robot
children. The data plane is ``cpp/shm_ring.cpp``, a byte copy of the JAX
package's source (per-slot seqlocks, so a torn read is detected and retried),
so a ring or queue written here is read by the JAX package's classes and the
reverse: the segment layout and the record packing are the same.

The library is built at first use with the C++ compiler directly (no cmake),
linked with ``-lrt``, into ``build/torch_shm/`` beside the package, named by
a hash of the source and flags. Nothing here runs at import, and no library
built for the JAX package is ever loaded.
"""

import ctypes
import functools
import hashlib
import os
import queue
import shutil
import subprocess
import tempfile

import numpy as np

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(PKG_DIR, "realworld", "cpp", "shm_ring.cpp")
BUILD_DIR = os.path.join(os.path.dirname(PKG_DIR), "build", "torch_shm")
CXX_FLAGS = ["-std=c++17", "-O3", "-fPIC", "-shared"]


def _compiler():
    for name in (os.environ.get("CXX"), "g++", "c++"):
        path = name and shutil.which(name)
        if path:
            return path
    raise RuntimeError("no C++ compiler found to build the shared-memory ring "
                       "(set CXX or install g++)")


def library_path():
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"libshm_ring_{h.hexdigest()[:16]}.so")


def build_library():
    """Compile ``shm_ring.cpp`` if the library for this source is not there
    yet. Returns its path; raises with the compiler's output on a failure."""
    out = library_path()
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        lib_tmp = os.path.join(tmp, "libshm_ring.so")
        res = subprocess.run([_compiler(), *CXX_FLAGS, SOURCE, "-o", lib_tmp, "-lrt"],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"building the shared-memory ring failed ({res.returncode}):\n"
                               f"{res.stderr}{res.stdout}")
        os.replace(lib_tmp, out)  # atomic: a concurrent build sees all or nothing
    return out


@functools.lru_cache(maxsize=None)
def _load():
    lib = ctypes.CDLL(build_library())
    lib.shm_queue_create.restype = ctypes.c_void_p
    lib.shm_queue_create.argtypes = [ctypes.c_char_p, ctypes.c_uint64, ctypes.c_uint64]
    lib.shm_queue_open.restype = ctypes.c_void_p
    lib.shm_queue_open.argtypes = [ctypes.c_char_p]
    lib.shm_queue_elem_bytes.restype = ctypes.c_uint64
    lib.shm_queue_elem_bytes.argtypes = [ctypes.c_void_p]
    lib.shm_queue_capacity.restype = ctypes.c_uint64
    lib.shm_queue_capacity.argtypes = [ctypes.c_void_p]
    lib.shm_queue_size.restype = ctypes.c_uint64
    lib.shm_queue_size.argtypes = [ctypes.c_void_p]
    lib.shm_queue_put.restype = ctypes.c_int
    lib.shm_queue_put.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint64]
    lib.shm_queue_get_k.restype = ctypes.c_int
    lib.shm_queue_get_k.argtypes = [ctypes.c_void_p, ctypes.c_uint64, ctypes.c_void_p]
    lib.shm_queue_clear.restype = None
    lib.shm_queue_clear.argtypes = [ctypes.c_void_p]
    lib.shm_queue_close.restype = None
    lib.shm_queue_close.argtypes = [ctypes.c_void_p]
    lib.shm_queue_unlink.restype = None
    lib.shm_queue_unlink.argtypes = [ctypes.c_char_p]
    lib.shm_ring_create.restype = ctypes.c_void_p
    lib.shm_ring_create.argtypes = [ctypes.c_char_p, ctypes.c_uint64, ctypes.c_uint64]
    lib.shm_ring_open.restype = ctypes.c_void_p
    lib.shm_ring_open.argtypes = [ctypes.c_char_p]
    lib.shm_ring_elem_bytes.restype = ctypes.c_uint64
    lib.shm_ring_elem_bytes.argtypes = [ctypes.c_void_p]
    lib.shm_ring_capacity.restype = ctypes.c_uint64
    lib.shm_ring_capacity.argtypes = [ctypes.c_void_p]
    lib.shm_ring_count.restype = ctypes.c_uint64
    lib.shm_ring_count.argtypes = [ctypes.c_void_p]
    lib.shm_ring_put.restype = ctypes.c_uint64
    lib.shm_ring_put.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                 ctypes.c_uint64, ctypes.c_double]
    lib.shm_ring_get.restype = ctypes.c_int
    lib.shm_ring_get.argtypes = [ctypes.c_void_p, ctypes.c_uint64,
                                 ctypes.c_void_p, ctypes.POINTER(ctypes.c_double)]
    lib.shm_ring_get_last_k.restype = ctypes.c_int
    lib.shm_ring_get_last_k.argtypes = [ctypes.c_void_p, ctypes.c_uint64,
                                        ctypes.c_void_p, ctypes.POINTER(ctypes.c_double)]
    lib.shm_ring_close.restype = None
    lib.shm_ring_close.argtypes = [ctypes.c_void_p]
    lib.shm_ring_unlink.restype = None
    lib.shm_ring_unlink.argtypes = [ctypes.c_char_p]
    return lib


class ShmRingBuffer:
    """Fixed-shape numpy frame ring over POSIX shared memory.

    One process creates (``create=True``, becomes the owner/writer by
    convention), others open by name. The owner unlinks the segment on close.
    """

    def __init__(self, name, shape, dtype, capacity=64, create=False):
        self.lib = _load()
        self.shape = tuple(shape)
        self.dtype = np.dtype(dtype)
        self.elem_bytes = int(np.prod(self.shape)) * self.dtype.itemsize
        bname = name.encode()
        if create:
            self.h = self.lib.shm_ring_create(bname, self.elem_bytes, capacity)
        else:
            self.h = self.lib.shm_ring_open(bname)
            if self.h and self.lib.shm_ring_elem_bytes(self.h) != self.elem_bytes:
                raise ValueError("shape/dtype mismatch with existing ring")
        if not self.h:
            raise OSError(f"shm ring {'create' if create else 'open'} failed: {name}")
        self.name = name

    @property
    def count(self):
        return int(self.lib.shm_ring_count(self.h))

    def put(self, frame, timestamp):
        frame = np.ascontiguousarray(frame, dtype=self.dtype)
        if frame.shape != self.shape:
            raise ValueError(f"frame of shape {frame.shape}, the ring holds {self.shape}")
        self.lib.shm_ring_put(self.h, frame.ctypes.data_as(ctypes.c_void_p),
                              self.elem_bytes, float(timestamp))

    def get(self, k=0):
        """k-th most recent frame (0 = latest) -> (frame, timestamp) or None."""
        out = np.empty(self.shape, self.dtype)
        ts = ctypes.c_double()
        rc = self.lib.shm_ring_get(self.h, k, out.ctypes.data_as(ctypes.c_void_p),
                                   ctypes.byref(ts))
        if rc != 0:
            return None
        return out, ts.value

    def get_last_k(self, k):
        """Last k frames, oldest first -> (frames (m, *shape), timestamps (m,))."""
        out = np.empty((k,) + self.shape, self.dtype)
        ts = np.empty(k, np.float64)
        got = self.lib.shm_ring_get_last_k(
            self.h, k, out.ctypes.data_as(ctypes.c_void_p),
            ts.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
        return out[:got], ts[:got]

    def close(self):
        if self.h:
            self.lib.shm_ring_close(self.h)
            self.h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class ShmQueue:
    """Bounded FIFO of dicts of fixed-shape numpy arrays over POSIX shared
    memory, backed by the C++ SPSC queue in ``cpp/shm_ring.cpp``.

    Python-facing equivalent of the reference's ``SharedMemoryQueue``
    (reference: ``src/planning/real_world/shared_memory/shared_memory_queue.py:10-187``):
    the command plane between the parent and camera/robot child processes.
    Fields are packed into one contiguous record so a put/get is a single
    native memcpy; ``put`` raises ``queue.Full`` and ``get``/``get_k``/
    ``get_all`` raise ``queue.Empty`` like the reference.
    """

    def __init__(self, name, specs, capacity=64, create=False):
        """specs: list of (field_name, shape, dtype) defining the record."""
        self.lib = _load()
        self.specs = []
        offset = 0
        for fname, shape, dtype in specs:
            shape = tuple(int(s) for s in shape)
            dtype = np.dtype(dtype)
            nbytes = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
            offset = -(-offset // dtype.itemsize) * dtype.itemsize  # align
            self.specs.append((fname, shape, dtype, offset, nbytes))
            offset += nbytes
        self.elem_bytes = max(offset, 1)
        bname = name.encode()
        if create:
            self.h = self.lib.shm_queue_create(bname, self.elem_bytes, capacity)
        else:
            self.h = self.lib.shm_queue_open(bname)
            if self.h and self.lib.shm_queue_elem_bytes(self.h) != self.elem_bytes:
                raise ValueError("record layout mismatch with existing queue")
        if not self.h:
            raise OSError(f"shm queue {'create' if create else 'open'} failed: {name}")
        self.name = name

    @classmethod
    def from_examples(cls, name, examples, capacity=64, create=True):
        """Infer the record layout from an example dict (reference:
        ``create_from_examples``, shared_memory_queue.py:44-75)."""
        specs = []
        for key, value in examples.items():
            value = np.asarray(value)
            if value.dtype == object:
                raise TypeError(f"unsupported object field {key!r}")
            specs.append((key, value.shape, value.dtype))
        return cls(name, specs, capacity=capacity, create=create)

    def qsize(self):
        return int(self.lib.shm_queue_size(self.h))

    def empty(self):
        return self.qsize() == 0

    def clear(self):
        self.lib.shm_queue_clear(self.h)

    def _pack(self, data):
        rec = np.zeros(self.elem_bytes, np.uint8)
        for fname, shape, dtype, off, nbytes in self.specs:
            value = np.ascontiguousarray(data[fname], dtype=dtype)
            if value.shape != shape:
                value = value.reshape(shape)
            rec[off:off + nbytes] = value.reshape(-1).view(np.uint8)
        return rec

    def _unpack(self, recs, k=None):
        """recs: (n, elem_bytes) uint8 -> dict of (n, *shape) or (*shape,)."""
        out = {}
        for fname, shape, dtype, off, nbytes in self.specs:
            raw = recs[:, off:off + nbytes].copy().view(dtype)
            arr = raw.reshape((len(recs),) + shape)
            out[fname] = arr if k is not None else arr[0]
        return out

    def put(self, data):
        rec = self._pack(data)
        if self.lib.shm_queue_put(self.h, rec.ctypes.data_as(ctypes.c_void_p),
                                  self.elem_bytes) != 0:
            raise queue.Full()

    def _get_k_impl(self, k):
        recs = np.empty((k, self.elem_bytes), np.uint8)
        got = self.lib.shm_queue_get_k(self.h, k,
                                       recs.ctypes.data_as(ctypes.c_void_p))
        if got <= 0:
            raise queue.Empty()
        return recs[:got]

    def get(self):
        """Pop one record -> dict of arrays (raises queue.Empty)."""
        return self._unpack(self._get_k_impl(1))

    def get_k(self, k):
        """Pop exactly up-to-k records -> dict of (m, *shape) arrays."""
        recs = self._get_k_impl(k)
        return self._unpack(recs, k=len(recs))

    def get_all(self):
        """Drain the queue -> dict of (m, *shape) arrays."""
        n = max(self.qsize(), 1)
        recs = self._get_k_impl(n)
        return self._unpack(recs, k=len(recs))

    def close(self):
        if self.h:
            self.lib.shm_queue_close(self.h)
            self.h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def align_timestamps(ts_lists, target_time):
    """Per-stream index of the frame closest to ``target_time`` (the
    reference's TimestampObsAccumulator alignment,
    ``src/planning/real_world/common/timestamp_accumulator.py:44-152``)."""
    return [int(np.argmin(np.abs(np.asarray(ts) - target_time))) if len(ts) else -1
            for ts in ts_lists]
