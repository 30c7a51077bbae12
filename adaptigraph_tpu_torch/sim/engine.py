"""ctypes binding for the C++ XPBD simulator (counterpart of
``adaptigraph_tpu/sim/engine.py``).

``sim/cpp/xpbd.cpp`` is a byte-for-byte copy of the JAX package's source.
It is built at first use with the C++ compiler directly (no cmake), with
the flags of the JAX package's ``CMakeLists.txt`` (``-fopenmp`` only where
the compiler has OpenMP, as CMake's ``find_package(OpenMP)`` decides; the
source's OpenMP loops are per particle, so the results are the same
without it), into ``build/torch_sim/`` beside the package, the library
named by a hash of the sources and flags.
The hash also covers the host CPU's model and flags, since ``-march=native``
builds for the machine that compiles. Nothing here runs at import, and no
library built for the JAX package is ever loaded.
"""

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile

import numpy as np

SCENE_TYPES = {"rope": 0, "granular": 1, "cloth": 2, "softbody": 3,
               "multiobj": 4, "bunnybath": 5}

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPP_DIR = os.path.join(PKG_DIR, "sim", "cpp")
SOURCES = [os.path.join(CPP_DIR, "xpbd.cpp"), os.path.join(CPP_DIR, "xpbd.h")]
BUILD_DIR = os.path.join(os.path.dirname(PKG_DIR), "build", "torch_sim")
CXX_FLAGS = ["-std=c++17", "-O3", "-march=native", "-ffast-math", "-fPIC", "-shared"]


@functools.lru_cache(maxsize=None)
def _compiler():
    for name in (os.environ.get("CXX"), "g++", "c++"):
        path = name and shutil.which(name)
        if path:
            return path
    raise RuntimeError("no C++ compiler found to build the simulator (set CXX or install g++)")


@functools.lru_cache(maxsize=None)
def _flags():
    """CXX_FLAGS, with -fopenmp where the compiler builds an OpenMP program."""
    src = "#include <omp.h>\nint main() { return omp_get_max_threads() < 1; }\n"
    probe = subprocess.run([_compiler(), "-fopenmp", "-x", "c++", "-", "-o", os.devnull],
                           input=src, capture_output=True, text=True)
    return CXX_FLAGS + (["-fopenmp"] if probe.returncode == 0 else [])


def _cpu_id():
    """The first CPU's model name and flags (empty where /proc/cpuinfo is absent)."""
    try:
        with open("/proc/cpuinfo") as f:
            lines = f.read().split("\n\n")[0].splitlines()
    except OSError:
        return ""
    return "\n".join(l for l in lines if l.startswith(("model name", "flags")))


def library_path():
    h = hashlib.sha256((" ".join(_flags()) + _cpu_id()).encode())
    for s in SOURCES:
        with open(s, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"libxpbd_{h.hexdigest()[:16]}.so")


def build_library():
    """Compile ``xpbd.cpp`` if the library for these sources is not there
    yet. Returns its path; raises with the compiler's output on a failure."""
    out = library_path()
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        lib_tmp = os.path.join(tmp, "libxpbd.so")
        res = subprocess.run([_compiler(), *_flags(), SOURCES[0], "-o", lib_tmp],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"building the simulator failed ({res.returncode}):\n"
                               f"{res.stderr}{res.stdout}")
        os.replace(lib_tmp, out)  # atomic: a concurrent build sees all or nothing
    return out


@functools.lru_cache(maxsize=None)
def _load():
    lib = ctypes.CDLL(build_library())
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    FP, IP = ctypes.POINTER(F), ctypes.POINTER(I)
    lib.xpbd_create.restype = P
    lib.xpbd_create.argtypes = [I, FP, I, ctypes.c_uint64]
    lib.xpbd_n_particles.restype = I
    lib.xpbd_n_particles.argtypes = [P]
    lib.xpbd_get_positions.argtypes = [P, FP]
    lib.xpbd_get_positions.restype = None
    lib.xpbd_get_inv_mass.argtypes = [P, FP]
    lib.xpbd_get_inv_mass.restype = None
    lib.xpbd_set_tool.argtypes = [P, FP, I, F]
    lib.xpbd_set_tool.restype = None
    lib.xpbd_get_tool.argtypes = [P, FP]
    lib.xpbd_get_tool.restype = None
    lib.xpbd_step.argtypes = [P, FP, I]
    lib.xpbd_step.restype = None
    lib.xpbd_create_softbody_points.restype = P
    lib.xpbd_create_softbody_points.argtypes = [FP, I, F, F, I, F]
    lib.xpbd_get_instance.argtypes = [P, IP]
    lib.xpbd_get_instance.restype = None
    lib.xpbd_fluid_range.argtypes = [P, IP]
    lib.xpbd_fluid_range.restype = None
    lib.xpbd_grasp.restype = I
    lib.xpbd_grasp.argtypes = [P, I, F]
    lib.xpbd_release.argtypes = [P]
    lib.xpbd_release.restype = None
    lib.xpbd_destroy.argtypes = [P]
    lib.xpbd_destroy.restype = None
    return lib


def _fptr(arr):
    arr = np.ascontiguousarray(arr, dtype=np.float32)
    return arr, arr.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


class XPBDScene:
    """One live simulation: a scene built from its sampled parameters, a
    kinematic tool, and the step."""

    def __init__(self, scene: str, params, seed=0):
        self._lib = _load()
        arr, ptr = _fptr(np.asarray(params, np.float32))
        self._h = self._lib.xpbd_create(SCENE_TYPES[scene], ptr, len(arr), seed)
        if not self._h:
            raise ValueError(f"unknown scene {scene}")
        self._n_tool = 0

    @classmethod
    def from_points(cls, points, spacing, stiffness=0.5, cluster_span=3, fixed_frac=0.0):
        """Soft body from an arbitrary particle fill (e.g. ``meshutil.voxelize``'s
        output): the FleX CreateSoftBody-from-mesh role (by_softbody.h:260)."""
        self = cls.__new__(cls)
        self._lib = _load()
        arr, ptr = _fptr(np.asarray(points, np.float32))
        self._h = self._lib.xpbd_create_softbody_points(ptr, len(arr), spacing, stiffness,
                                                        cluster_span, fixed_frac)
        if not self._h:
            raise ValueError("softbody_points creation failed")
        self._n_tool = 0
        return self

    @property
    def n_particles(self):
        return self._lib.xpbd_n_particles(self._h)

    def get_positions(self):
        out = np.empty((self.n_particles, 3), np.float32)
        self._lib.xpbd_get_positions(self._h, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
        return out

    def get_inv_mass(self):
        out = np.empty(self.n_particles, np.float32)
        self._lib.xpbd_get_inv_mass(self._h, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
        return out

    def set_tool(self, tool_positions, radius=0.06):
        arr, ptr = _fptr(tool_positions)
        self._n_tool = arr.shape[0]
        self._lib.xpbd_set_tool(self._h, ptr, self._n_tool, radius)

    def get_tool(self):
        out = np.empty((self._n_tool, 3), np.float32)
        self._lib.xpbd_get_tool(self._h, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
        return out

    def get_instance(self):
        """Particle -> object-instance id."""
        out = np.empty(self.n_particles, np.int32)
        self._lib.xpbd_get_instance(self._h, out.ctypes.data_as(ctypes.POINTER(ctypes.c_int)))
        return out

    def fluid_mask(self):
        """Boolean mask of fluid particles (an empty range: no fluid)."""
        out = (ctypes.c_int * 2)()
        self._lib.xpbd_fluid_range(self._h, out)
        mask = np.zeros(self.n_particles, bool)
        mask[out[0]:out[1]] = True
        return mask

    def grasp(self, k=5, max_dist=0.1):
        """Pin the k nearest movable particles to tool point 0. Returns the
        number of particles grasped (0: nothing in reach)."""
        return self._lib.xpbd_grasp(self._h, int(k), float(max_dist))

    def release(self):
        """Restore the inverse mass of the grasped particles."""
        self._lib.xpbd_release(self._h)

    def step(self, tool_target=None):
        if tool_target is None:
            tool_target = self.get_tool()
        arr, ptr = _fptr(tool_target)
        self._lib.xpbd_step(self._h, ptr, arr.shape[0])

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.xpbd_destroy(self._h)
            self._h = None
