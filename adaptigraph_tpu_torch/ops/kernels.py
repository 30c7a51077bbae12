"""Build and bind the port's CUDA kernels.

At first use every ``csrc/*.cu`` (with the ``csrc/*.cuh`` it includes) is
compiled for ``sm_90a`` with ``nvcc`` (one process per source, all started
together), linked into one shared library with a plain C interface, and
loaded with ``ctypes``. The library goes to ``build/torch_kernels/`` beside
the package, named by a hash of the sources and flags, so a changed source
builds anew and an unchanged one is reused. Nothing here runs at import.

``phase_clocks=True`` selects a second, profiling build of the same sources
(``-DROLLOUT_PHASE_CLOCKS``) whose rollout kernel adds its blocks' SM cycles
per phase into a buffer set with ``rollout_chunk_set_phase_clocks``; the
port's own calls use the normal build.
"""

import ctypes
import functools
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(PKG_DIR), "build", "torch_kernels")
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
PHASE_CLOCK_FLAGS = ["-DROLLOUT_PHASE_CLOCKS"]


def sources():
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))


def headers():
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cuh")))


def _nvcc():
    path = shutil.which("nvcc")
    if path is None:
        home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
        path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a machine with the "
                           "CUDA toolkit (set CUDA_HOME or put nvcc on PATH)")
    return path


def _flags(phase_clocks):
    return NVCC_FLAGS + (PHASE_CLOCK_FLAGS if phase_clocks else [])


def _digest(srcs, flags):
    h = hashlib.sha256(" ".join(flags).encode())
    for s in srcs:
        h.update(os.path.basename(s).encode())
        with open(s, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def library_path(phase_clocks=False):
    digest = _digest(sources() + headers(), _flags(phase_clocks))
    return os.path.join(BUILD_DIR, f"libadaptigraph_kernels_{digest}.so")


def build(phase_clocks=False):
    """Compile and link the kernels if the library for these sources is not
    there yet. Returns its path; raises with nvcc's stderr on a failure.
    ptxas' register and spill report goes to ``<library>.ptxas.txt``."""
    out = library_path(phase_clocks)
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        for src in sources():
            obj = os.path.join(tmp, os.path.basename(src) + ".o")
            procs.append((src, obj, subprocess.Popen(
                [nvcc, *_flags(phase_clocks), "-c", src, "-o", obj],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
        reports = []
        for src, _, proc in procs:
            stdout, stderr = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src} ({proc.returncode}):\n{stderr}{stdout}")
            reports.append(f"== {os.path.basename(src)}\n{stderr}{stdout}")
        lib_tmp = os.path.join(tmp, "lib.so")
        link = subprocess.run([nvcc, *ARCH_FLAGS, "-shared", "-o", lib_tmp,
                               *[obj for _, obj, _ in procs]],
                              capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n{link.stderr}{link.stdout}")
        with open(out + ".ptxas.txt", "w") as f:
            f.write("\n".join(reports))
        os.replace(lib_tmp, out)  # atomic: a concurrent build sees all or nothing
    return out


@functools.lru_cache(maxsize=None)
def library(phase_clocks=False):
    """The loaded kernel library (built at first use), with every entry's
    argument and return types declared."""
    lib = ctypes.CDLL(build(phase_clocks))
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    if phase_clocks:
        lib.rollout_chunk_set_phase_clocks.argtypes = [P]
        lib.rollout_chunk_set_phase_clocks.restype = None
    lib.rollout_chunk_smem_bytes.argtypes = [I] * 12  # dims, bf16
    lib.rollout_chunk_smem_bytes.restype = I
    lib.rollout_chunk_error_string.argtypes = [I]
    lib.rollout_chunk_error_string.restype = ctypes.c_char_p
    lib.rollout_chunk_launch.argtypes = (
        [P, P, P, P, ctypes.POINTER(P), P, P, P, P]   # inputs, weights, scratch, output
        + [I] * 12                                    # B and the dims
        + [F, F, F]                                   # thresh, gripper_lift, motion_clamp
        + [I, I, I]                                   # max_repeat, mean_y, bf16
        + [I, P])                                     # device, stream
    lib.rollout_chunk_launch.restype = I
    L = ctypes.c_longlong
    lib.gnn_error_string.argtypes = [I]
    lib.gnn_error_string.restype = ctypes.c_char_p
    lib.gnn_forward_act_floats.argtypes = [I] * 8  # Np, K, pstep, nf_p, nf_r, nf, rel_in, which
    lib.gnn_forward_act_floats.restype = L
    lib.gnn_forward_smem_bytes.argtypes = [I, I]
    lib.gnn_forward_smem_bytes.restype = I
    lib.gnn_forward_launch.argtypes = (
        [P, P, P, P, ctypes.POINTER(P), P, P, P, P]   # inputs, weights, activations, outputs
        + [I] * 13                                    # B and the dims
        + [F, I, I, P])                               # motion_clamp, bf16, device, stream
    lib.gnn_forward_launch.restype = I
    lib.gnn_train_bwd_scratch_floats.argtypes = [I] * 7  # Np, K, nf_p, nf_r, nf, rel_in, which
    lib.gnn_train_bwd_scratch_floats.restype = L
    lib.gnn_train_bwd_smem_bytes.argtypes = [I, I]
    lib.gnn_train_bwd_smem_bytes.restype = I
    lib.gnn_train_bwd_launch.argtypes = (
        [P, P, P, P, ctypes.POINTER(P)]               # nodes, nbr, mask, dmot, weights
        + [P] * 7 + [ctypes.POINTER(I)]               # activations, scratch, outputs, offsets
        + [I] * 13                                    # B and the dims
        + [I, P])                                     # device, stream
    lib.gnn_train_bwd_launch.restype = I
    return lib
