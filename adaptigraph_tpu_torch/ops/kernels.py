"""Build and bind the port's CUDA kernels.

At first use every ``csrc/*.cu`` (with the ``csrc/*.cuh`` it includes) is
compiled for ``sm_90a`` with ``nvcc`` (one process per source, all started
together), linked into one shared library with a plain C interface, and
loaded with ``ctypes``. The library goes to ``build/torch_kernels/`` beside
the package, named by a hash of the sources and flags, so a changed source
builds anew and an unchanged one is reused. Nothing here runs at import.

A ``variant`` other than the normal build (``None``) is a profiling build of
the same sources, which the port's own calls never use:

- ``"phase_clocks"`` (``-DROLLOUT_PHASE_CLOCKS -DGNN_PHASE_CLOCKS``): the
  rollout kernel adds its blocks' SM cycles per phase into a buffer set with
  ``rollout_chunk_set_phase_clocks`` and, in bfloat16, thread 0's cycles in
  the parts of the relation MLP, the aggregation, the graph build and the
  node-sized products into one set with ``rollout_chunk_set_sub_clocks``
  (``rollout_chunk_sub_phases`` of them); the single-step forward and its
  backward into 16 counters each, set with ``gnn_forward_set_phase_clocks``
  and ``gnn_train_bwd_set_phase_clocks``, and the backward's batch-wide
  weight gradients into 7, set with ``gnn_train_bwd_set_wgrad_clocks``;
- ``"no_edge"``, ``"no_gather"`` and ``"mlp_only"`` (both): the single-step
  forward with its in-kernel graph ablated (``csrc/gnn_forward.cu``, built
  alone), the parts switched off in ``profiling/kernel_parts.py``.

Set-up counters, always kept: ``build.builds`` and ``build.build_s``, the
builds that ran nvcc and their seconds (0 where every library was built
already), and ``library.load_s``, the seconds of every variant's load and
declarations.
"""

import ctypes
import functools
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import time

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(PKG_DIR), "build", "torch_kernels")
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
# variant -> (extra flags, the one source it builds or None for all)
VARIANTS = {
    None: ([], None),
    "phase_clocks": (["-DROLLOUT_PHASE_CLOCKS", "-DGNN_PHASE_CLOCKS"], None),
    "no_edge": (["-DGNN_ABLATE_NO_EDGE"], "gnn_forward.cu"),
    "no_gather": (["-DGNN_ABLATE_NO_GATHER"], "gnn_forward.cu"),
    "mlp_only": (["-DGNN_ABLATE_NO_EDGE", "-DGNN_ABLATE_NO_GATHER"], "gnn_forward.cu"),
}


def sources(variant=None):
    only = VARIANTS[variant][1]
    return sorted(p for p in glob.glob(os.path.join(CSRC_DIR, "*.cu"))
                  if only is None or os.path.basename(p) == only)


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


def _flags(variant):
    return NVCC_FLAGS + VARIANTS[variant][0]


def _digest(srcs, flags):
    h = hashlib.sha256(" ".join(flags).encode())
    for s in srcs:
        h.update(os.path.basename(s).encode())
        with open(s, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def library_path(variant=None):
    digest = _digest(sources(variant) + headers(), _flags(variant))
    return os.path.join(BUILD_DIR, f"libadaptigraph_kernels_{digest}.so")


def build(variant=None):
    """Compile and link the kernels if the library for these sources is not
    there yet. Returns its path; raises with nvcc's stderr on a failure.
    ptxas' register and spill report goes to ``<library>.ptxas.txt``."""
    out = library_path(variant)
    if os.path.exists(out):
        return out
    t0 = time.perf_counter()
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        for src in sources(variant):
            obj = os.path.join(tmp, os.path.basename(src) + ".o")
            procs.append((src, obj, subprocess.Popen(
                [nvcc, *_flags(variant), "-c", src, "-o", obj],
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
    build.builds += 1
    build.build_s += time.perf_counter() - t0
    return out


build.builds = 0
build.build_s = 0.0


@functools.lru_cache(maxsize=None)
def library(variant=None):
    """The loaded kernel library of a build variant (built at first use),
    with every entry's argument and return types declared."""
    path = build(variant)
    t0 = time.perf_counter()
    lib = _declared(ctypes.CDLL(path), variant)
    library.load_s += time.perf_counter() - t0
    return lib


library.load_s = 0.0


def _declared(lib, variant):
    """``lib`` with the argument and return types of every entry of the
    variant's build declared."""
    P, I, F, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
    lib.gnn_error_string.argtypes = [I]
    lib.gnn_error_string.restype = ctypes.c_char_p
    lib.gnn_forward_act_elems.argtypes = [I] * 9  # Np, K, pstep, nf_p, nf_r, nf, rel_in, which, keep
    lib.gnn_forward_act_elems.restype = L
    lib.gnn_forward_act_offsets.argtypes = [I] * 8 + [ctypes.POINTER(L)]  # dims, which, out
    lib.gnn_forward_act_offsets.restype = I
    lib.gnn_forward_smem_bytes.argtypes = [I] * 4  # Np, K, radius, bf16
    lib.gnn_forward_smem_bytes.restype = I
    lib.gnn_forward_grid.argtypes = [I] * 7 + [ctypes.POINTER(I)]  # B, Np, K, radius, keep, bf16, device
    lib.gnn_forward_grid.restype = I
    lib.gnn_forward_launch.argtypes = (
        [P, P, P, P, ctypes.POINTER(P), ctypes.POINTER(P)]  # inputs, weights, packed weights
        + [P, P, P, P]                                # activations, outputs
        + [I] * 13                                    # B and the dims
        + [F, F, I, I, I, I, P])                      # clamp, thresh, keep, grid, bf16, device, stream
    lib.gnn_forward_launch.restype = I
    if VARIANTS[variant][1] is not None:  # a build of the forward alone
        return lib
    if variant == "phase_clocks":
        for fn in (lib.rollout_chunk_set_phase_clocks, lib.rollout_chunk_set_sub_clocks):
            fn.argtypes = [P]
            fn.restype = None
        lib.rollout_chunk_sub_phases.argtypes = []
        lib.rollout_chunk_sub_phases.restype = I
        for fn in (lib.gnn_forward_set_phase_clocks, lib.gnn_train_bwd_set_phase_clocks,
                   lib.gnn_train_bwd_set_wgrad_clocks):
            fn.argtypes = [P]
            fn.restype = I
    lib.rollout_chunk_smem_bytes.argtypes = [I] * 12  # dims, bf16
    lib.rollout_chunk_smem_bytes.restype = I
    lib.rollout_chunk_error_string.argtypes = [I]
    lib.rollout_chunk_error_string.restype = ctypes.c_char_p
    lib.rollout_chunk_launch.argtypes = (
        [P, P, P, P, ctypes.POINTER(P), ctypes.POINTER(P)]  # inputs, weights, packed weights
        + [P, P, P, P, P]                             # scratch, output
        + [I] * 12                                    # B and the dims
        + [F, F, F]                                   # thresh, gripper_lift, motion_clamp
        + [I, I, I]                                   # max_repeat, mean_y, bf16
        + [I, P])                                     # device, stream
    lib.rollout_chunk_launch.restype = I
    # Np, K, pstep, Dp, nf_p, nf_r, nf, rel_in, which, bf16
    lib.gnn_train_bwd_scratch_bytes.argtypes = [I] * 10
    lib.gnn_train_bwd_scratch_bytes.restype = L
    lib.gnn_train_bwd_smem_bytes.argtypes = [I, I, I]
    lib.gnn_train_bwd_smem_bytes.restype = I
    lib.gnn_train_bwd_launch.argtypes = (
        [P, P, P, P, ctypes.POINTER(P), ctypes.POINTER(P)]  # nodes, nbr, mask, dmot, weights, packed
        + [P] * 9                                     # activations, scratch, edge counts, outputs
        + [P] + [I] * 5                               # the weight gradients' plan and its sizes
        + [I] * 13                                    # B and the dims
        + [I, I, P])                                  # bf16, device, stream
    lib.gnn_train_bwd_launch.restype = I
    return lib
