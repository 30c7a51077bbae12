"""The JAX simulator that the port's simulator parity tests compare with.

The JAX package loads a committed ``build/sim/libxpbd.so`` when it finds
one, and that binary was compiled with ``-march=native -ffast-math`` on
whatever CPU built it. The port compiles the same ``xpbd.cpp`` with the same
flags on the host it runs on. On a host whose instruction set differs from
the one that built it, the two binaries round differently, and a bit-exact
comparison would test the two CPUs rather than the port.

``jax_sim_built_here`` therefore builds the JAX library from the JAX
package's own sources with its own ``build_library``, once per process, into
a temporary directory outside the repo, and points the JAX engine's loader
at it for the module. A test file that compares with JAX's simulator imports
the fixture; being autouse, it then applies to every test of that file.
"""

import atexit
import contextlib
import shutil
import tempfile

import numpy as np
import pytest

from adaptigraph_tpu.sim import engine as jax_engine
from adaptigraph_tpu_torch.sim.engine import XPBDScene
from adaptigraph_tpu_torch.sim.env import PushEnv

_built = []


def jax_library_built_here():
    """Path of a JAX simulator library compiled on this host (built once per
    process, removed at exit)."""
    if not _built:
        build_dir = tempfile.mkdtemp(prefix="jax_xpbd_")
        atexit.register(shutil.rmtree, build_dir, ignore_errors=True)
        _built.append(jax_engine.build_library(build_dir=build_dir))
    return _built[0]


@contextlib.contextmanager
def jax_sim_from_source():
    """Within the block, new JAX scenes load the library built on this host."""
    saved = jax_engine._SEARCH, jax_engine._lib
    jax_engine._SEARCH, jax_engine._lib = [jax_library_built_here()], None
    try:
        yield
    finally:
        jax_engine._SEARCH, jax_engine._lib = saved


def _grid():
    ax = np.arange(4, dtype=np.float32) * 0.1
    return np.stack(np.meshgrid(ax, ax + 0.2, ax, indexing="ij"), -1).reshape(-1, 3)


@pytest.fixture(scope="module", autouse=True)
def jax_sim_built_here():
    with jax_sim_from_source():
        yield


def test_jax_scenes_load_the_library_built_here():
    lib_path = jax_library_built_here()
    scene = jax_engine.XPBDScene.from_points(_grid(), spacing=0.1)
    assert scene._lib._name == lib_path == jax_engine._SEARCH[0]
    assert not lib_path.startswith(jax_engine._REPO_ROOT)


def test_block_restores_the_engine_state():
    outer = jax_engine._SEARCH, jax_engine._lib
    with jax_sim_from_source():
        assert jax_engine._lib is None
        jax_engine.XPBDScene.from_points(_grid(), spacing=0.1)
        assert jax_engine._lib is not None
    assert (jax_engine._SEARCH, jax_engine._lib) == outer


@pytest.mark.parametrize("material", ["softbody", "rope", "granular"])
def test_reset_is_bit_equal_to_jax(material):
    """Softbody's reset is the scene whose rounding exposed two binaries
    built on different CPUs; with both built here they agree bit for bit."""
    from adaptigraph_tpu.sim.env import PushEnv as JaxPushEnv

    np.testing.assert_array_equal(PushEnv(material, seed=3).reset(),
                                  JaxPushEnv(material, seed=3).reset())


def test_points_scene_steps_bit_equal_to_jax():
    scenes = [cls.from_points(_grid(), spacing=0.1, fixed_frac=0.2)
              for cls in (jax_engine.XPBDScene, XPBDScene)]
    for _ in range(5):
        for sc in scenes:
            sc.step(np.zeros((0, 3), np.float32))
    np.testing.assert_array_equal(scenes[1].get_positions(), scenes[0].get_positions())
