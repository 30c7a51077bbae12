"""The port's data pipeline against the JAX package: the synthetic rope
generator, h5 I/O and preprocessing (files equal), the in-memory
preprocessing path, FPS, per-sample and packed batch assembly (equal batches
for one seed) and the compact-batch expansion."""

import json
import os

import numpy as np
import pytest
import torch

from adaptigraph_tpu.dynamics import dataset as jax_dataset
from adaptigraph_tpu.dynamics import train as jax_train
from adaptigraph_tpu.dynamics.preprocess import preprocess as jax_preprocess
from adaptigraph_tpu.models.gnn import GNNConfig as JaxGNNConfig
from adaptigraph_tpu.ops import fps as jax_fps
from adaptigraph_tpu.sim.synthetic import gen_rope_dataset as jax_gen
from adaptigraph_tpu_torch.dynamics import dataset
from adaptigraph_tpu_torch.dynamics.graphs import GraphSpec
from adaptigraph_tpu_torch.dynamics.preprocess import preprocess, preprocess_episodes
from adaptigraph_tpu_torch.dynamics.train import expand_compact_batch
from adaptigraph_tpu_torch.models.gnn import GNNConfig
from adaptigraph_tpu_torch.ops import fps
from adaptigraph_tpu_torch.sim.synthetic import SYNTH_EEF_OFFSETS, gen_rope_dataset, simulate_rope_dataset
from test_torch_jaxsim import jax_sim_built_here  # noqa: F401  (autouse)

PHYS_SPECS = [{"name": "stiffness", "use": True, "min": 0.0, "max": 1.0},
              {"name": "length", "use": False, "min": 2.5, "max": 5.0}]
PREP = dict(n_his=4, n_future=3, dist_thresh=0.1, phys_param_specs=PHYS_SPECS)
GEN = dict(n_episodes=4, n_pushes=2, seed=3, n_particles=30)
SPEC_KW = dict(n_his=4, n_future=3, max_nobj=24, max_neef=1, fps_radius_range=(0.18, 0.22),
               adj_radius_range=(0.48, 0.52), topk=6)
RATIO = {"train": [0, 0.75], "valid": [0.75, 1]}


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    """The JAX generator + JAX preprocess, the port's generator + the port's
    preprocess of its h5 files, and the port's in-memory preprocess."""
    root = tmp_path_factory.mktemp("torchdata")
    out = {k: str(root / k) for k in ("jax_sim", "sim", "jax_prep", "prep", "mem_prep")}
    jax_gen(out["jax_sim"], **GEN)
    gen_rope_dataset(out["sim"], **GEN)
    jax_preprocess(out["jax_sim"], out["jax_prep"], SYNTH_EEF_OFFSETS, **PREP)
    preprocess(out["sim"], out["prep"], SYNTH_EEF_OFFSETS, **PREP)
    preprocess_episodes(simulate_rope_dataset(**GEN), out["mem_prep"], SYNTH_EEF_OFFSETS, **PREP)
    return out


def _npz(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


@pytest.mark.parametrize("which", ["prep", "mem_prep"])
def test_preprocess_files_equal_jax(dirs, which):
    want_dir, got_dir = dirs["jax_prep"], dirs[which]
    names = sorted(os.listdir(os.path.join(want_dir, "episodes")))
    assert names == sorted(os.listdir(os.path.join(got_dir, "episodes")))
    assert len(names) == GEN["n_episodes"]
    for rel in [os.path.join("episodes", n) for n in names] + ["physics.npz"]:
        want, got = _npz(os.path.join(want_dir, rel)), _npz(os.path.join(got_dir, rel))
        assert set(want) == set(got), rel
        for k in want:
            assert want[k].dtype == got[k].dtype, (rel, k)
            np.testing.assert_array_equal(got[k], want[k], err_msg=f"{rel}:{k}")
    with open(os.path.join(want_dir, "meta.json")) as f, open(os.path.join(got_dir, "meta.json")) as g:
        assert json.load(f) == json.load(g)


def test_preprocess_drops_filtered_pushes(dirs, tmp_path):
    filt = {"000001": [2]}
    jax_preprocess(dirs["sim"], str(tmp_path / "j"), SYNTH_EEF_OFFSETS, filter_actions=filt, **PREP)
    preprocess(dirs["sim"], str(tmp_path / "t"), SYNTH_EEF_OFFSETS, filter_actions=filt, **PREP)
    want = _npz(str(tmp_path / "j" / "episodes" / "000001.npz"))
    got = _npz(str(tmp_path / "t" / "episodes" / "000001.npz"))
    np.testing.assert_array_equal(got["pairs"], want["pairs"])
    full = _npz(os.path.join(dirs["prep"], "episodes", "000001.npz"))
    assert len(got["pairs"]) < len(full["pairs"])


@pytest.mark.parametrize("num,radius", [(8, 0.05), (60, 0.3)])
def test_fps_matches_jax(num, radius):
    pcd = np.random.RandomState(0).rand(50, 3).astype(np.float32)
    for start in (0, 17):
        np.testing.assert_array_equal(fps.fps_numpy(pcd, num, start_idx=start),
                                      jax_fps.fps_numpy(pcd, num, start_idx=start))
        np.testing.assert_array_equal(fps.fps_downsample(pcd, num, radius, start_idx=start),
                                      jax_fps.fps_downsample(pcd, num, radius, start_idx=start))
    np.testing.assert_array_equal(fps.fps_rad_numpy(pcd, 0.3, rng=np.random.RandomState(1)),
                                  jax_fps.fps_rad_numpy(pcd, 0.3, rng=np.random.RandomState(1)))


def _specs():
    return GraphSpec(**SPEC_KW), jax_dataset.GraphSpec(**SPEC_KW)


@pytest.mark.parametrize("compact", [False, True])
def test_packed_batches_equal_jax(dirs, compact):
    spec, jspec = _specs()
    got_ds = dataset.PackedDataset(dirs["prep"], spec, "train", RATIO, seed=2, compact=compact)
    want_ds = jax_dataset.PackedDataset(dirs["prep"], jspec, "train", RATIO, seed=2, compact=compact)
    assert len(got_ds) == len(want_ds)
    got = dataset._assemble_batch(got_ds, 6, 2, np.random.RandomState(9))
    want = jax_dataset._assemble_batch(want_ds, 6, 2, np.random.RandomState(9))
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape[:2] == (2, 6)
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_per_sample_batches_equal_jax(dirs):
    spec, jspec = _specs()
    got_ds = dataset.DynDataset(dirs["prep"], spec, "valid", RATIO)
    want_ds = jax_dataset.DynDataset(dirs["prep"], jspec, "valid", RATIO)
    got = dataset._assemble_batch(got_ds, 5, 1, np.random.RandomState(4))
    want = jax_dataset._assemble_batch(want_ds, 5, 1, np.random.RandomState(4))
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_batch_loader_thread_and_superbatches(dirs):
    spec, _ = _specs()
    ds = dataset.PackedDataset(dirs["prep"], spec, "train", RATIO, compact=True)
    loader = dataset.BatchLoader(ds, 4, seed=1, stack_steps=3)
    try:
        batch = next(loader)
    finally:
        loader.close()
    assert batch["state"].shape == (3, 4, spec.n_his, spec.n_nodes, 3)
    assert batch["obj_mask"].dtype == bool


def test_expand_compact_batch_matches_jax(dirs):
    spec, jspec = _specs()
    ds = dataset.PackedDataset(dirs["prep"], spec, "train", RATIO, compact=True)
    batch = ds.make_batch(np.array([0, 3, len(ds) - 1]), np.random.RandomState(0))
    kw = dict(n_his=4, max_nobj=spec.max_nobj, max_neef=1)
    want = jax_train.expand_compact_batch(batch, JaxGNNConfig(**kw))
    got = expand_compact_batch({k: torch.tensor(v) for k, v in batch.items()}, GNNConfig(**kw))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    full = {k: torch.tensor(v) for k, v in
            dataset.PackedDataset(dirs["prep"], spec, "train", RATIO).make_batch(
                np.array([0, 3, len(ds) - 1]), np.random.RandomState(0)).items()}
    assert expand_compact_batch(full, GNNConfig(**kw)) is full
    for k in full:
        np.testing.assert_array_equal(got[k].numpy(), full[k].numpy(), err_msg=k)
