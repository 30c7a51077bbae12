"""The port's data generation and filtering against the JAX package's: the
same seeds give the same sampled actions and trajectories (bit for bit,
since the simulator is the same), the same h5 episodes (with capture and
through the robot), the same filter flags, box episodes and mesh geometry,
and the CLI's datagen -> filter -> preprocess writes the same files."""

import glob
import json
import os

import h5py
import numpy as np
import pytest
import torch

from adaptigraph_tpu import cli as jax_cli
from adaptigraph_tpu.sim import box2d as jax_box2d
from adaptigraph_tpu.sim import datagen as jax_datagen
from adaptigraph_tpu.sim import filter as jax_filter
from adaptigraph_tpu.sim import meshutil as jax_meshutil
from adaptigraph_tpu.sim.engine import XPBDScene as JaxXPBDScene
from adaptigraph_tpu.sim.env import PushEnv as JaxPushEnv
from adaptigraph_tpu_torch import cli
from adaptigraph_tpu_torch.sim import box2d, datagen, filter as sim_filter, meshutil
from adaptigraph_tpu_torch.sim import io as sim_io
from adaptigraph_tpu_torch.sim.engine import XPBDScene
from adaptigraph_tpu_torch.sim.env import ACTION_KINDS, PushEnv
from test_torch_jaxsim import jax_sim_built_here  # noqa: F401  (autouse)


def _h5_tree(path):
    out = {}

    def walk(g, pre):
        for k in g:
            if isinstance(g[k], h5py.Group):
                walk(g[k], pre + k + "/")
            else:
                out[pre + k] = g[k][()]

    with h5py.File(path, "r") as f:
        walk(f, "")
    return out


def assert_same_files(want_dir, got_dir):
    """Every file under want_dir is under got_dir with the same contents (h5
    datasets and npz arrays compared as arrays, other files byte for byte)."""
    want = sorted(os.path.relpath(p, want_dir) for p in glob.glob(f"{want_dir}/**/*", recursive=True)
                  if os.path.isfile(p))
    got = sorted(os.path.relpath(p, got_dir) for p in glob.glob(f"{got_dir}/**/*", recursive=True)
                 if os.path.isfile(p))
    assert want == got and want
    for rel in want:
        a, b = os.path.join(want_dir, rel), os.path.join(got_dir, rel)
        if rel.endswith(".h5"):
            ta, tb = _h5_tree(a), _h5_tree(b)
            assert sorted(ta) == sorted(tb), rel
            for k in ta:
                np.testing.assert_array_equal(tb[k], ta[k], err_msg=f"{rel}:{k}")
        elif rel.endswith(".npz"):
            with np.load(a) as za, np.load(b) as zb:
                assert sorted(za.files) == sorted(zb.files), rel
                for k in za.files:
                    np.testing.assert_array_equal(zb[k], za[k], err_msg=f"{rel}:{k}")
        else:
            with open(a, "rb") as fa, open(b, "rb") as fb:
                assert fa.read() == fb.read(), rel


@pytest.fixture
def one_sim_thread():
    """One OpenMP thread for the simulator (the runtime torch loaded, which
    the simulator's library shares in this process): bunnybath's fluid step
    is reproducible only on one thread, in either package."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("material", ["rope", "granular", "cloth", "softbody", "multiobj",
                                      "bunnybath", "rigid"])
def test_sample_and_execute_action_match_jax(material, request):
    """Each material's action family: the same kinds and actions drawn from
    the same seed, the same trajectories and eef states, the same validity
    gate."""
    if material == "bunnybath":
        request.getfixturevalue("one_sim_thread")
    want, got = JaxPushEnv(material, seed=3), PushEnv(material, seed=3)
    np.testing.assert_array_equal(got.reset(), want.reset())
    kinds = set()
    for _ in range(3 if ACTION_KINDS[material] == "mixed" else 1):
        (wk, wa), (gk, ga) = want.sample_action(), got.sample_action()
        assert gk == wk
        kinds.add(gk)
        np.testing.assert_array_equal(ga, wa)
        before = got.get_positions()
        (wp, we), (gp, ge) = want.execute_action(wk, wa), got.execute_action(gk, ga)
        np.testing.assert_array_equal(gp, wp)
        np.testing.assert_array_equal(ge, we)
        assert got.push_moved_object(before, gp) == want.push_moved_object(before, wp)
    if material == "softbody":  # the mixed family drew both a push and a poke
        assert kinds == {"push", "poke"}


@pytest.mark.parametrize("kw", [{"capture_depth": True}, {"robot": True}],
                         ids=["capture", "robot"])
def test_gen_episode_files_match_jax(tmp_path, kw):
    """One rope episode with 4-camera RGB-D capture, and one driven through
    the arm's IK chain: the port's files equal the JAX generator's."""
    want = jax_datagen.gen_episode(str(tmp_path / "jax"), "rope", 0, n_pushes=1, seed=0, **kw)
    got = datagen.gen_episode(str(tmp_path / "port"), "rope", 0, n_pushes=1, seed=0, **kw)
    assert got == want == (0, 1, False)
    assert_same_files(str(tmp_path / "jax"), str(tmp_path / "port"))
    if kw.get("capture_depth"):
        data = sim_io.load_episode_step(str(tmp_path / "port" / "000000" / "01.h5"))
        assert data["observations"]["depth"]["cam_0"].shape[0] == data["positions"].shape[0]


def test_generate_with_workers_equals_one_process(tmp_path):
    """Softbody over two spawned workers writes the files of one process, and
    those of the JAX generator."""
    datagen.generate(str(tmp_path / "one"), "softbody", 3, n_pushes=1, n_workers=1, seed=4)
    datagen.generate(str(tmp_path / "two"), "softbody", 3, n_pushes=1, n_workers=2, seed=4)
    jax_datagen.generate(str(tmp_path / "jax"), "softbody", 3, n_pushes=1, seed=4)
    assert_same_files(str(tmp_path / "one"), str(tmp_path / "two"))
    assert_same_files(str(tmp_path / "jax"), str(tmp_path / "one"))


def test_start_episode_extension_equals_one_run(tmp_path, monkeypatch):
    """Episodes [0, 2) then [2, 3) equal one [0, 3) run; ``bad_episodes.txt``
    is appended to by the extension, as the JAX generator appends to it
    (episodes 1 and 2 reported bad)."""
    for mod in (datagen, jax_datagen):
        real = mod.gen_episode

        def marked(*a, _real=real, **k):
            e, n, _ = _real(*a, **k)
            return e, n, e in (1, 2)

        monkeypatch.setattr(mod, "gen_episode", marked)
    for name, mod in (("port", datagen), ("jax", jax_datagen)):
        assert mod.generate(str(tmp_path / name / "ext"), "rope", 2, n_pushes=1, seed=7) == [1]
        assert mod.generate(str(tmp_path / name / "ext"), "rope", 1, n_pushes=1, seed=7,
                            start_episode=2) == [2]
        mod.generate(str(tmp_path / name / "once"), "rope", 3, n_pushes=1, seed=7)
    with open(tmp_path / "port" / "ext" / "bad_episodes.txt") as f:
        assert f.read() == "1\n2\n"
    assert_same_files(str(tmp_path / "jax" / "ext"), str(tmp_path / "port" / "ext"))
    os.remove(tmp_path / "port" / "ext" / "bad_episodes.txt")
    os.remove(tmp_path / "port" / "once" / "bad_episodes.txt")
    assert_same_files(str(tmp_path / "port" / "once"), str(tmp_path / "port" / "ext"))


def test_filter_matches_jax_on_drift_and_nan(tmp_path):
    """A clean push, one whose penultimate frame drifted from rest, one with a
    NaN: both filters flag pushes 2 and 3 and write the same json."""
    epi = tmp_path / "000000"
    epi.mkdir()
    rng = np.random.RandomState(0)
    rest = rng.randn(30, 3).astype(np.float32) * 0.1
    base = rest[None] + np.linspace(0, 0.05, 4)[:, None, None].astype(np.float32)
    eef = np.zeros((4, 1, 14), np.float32)
    sim_io.store_episode_step(str(epi / "00.h5"), base, eef, np.zeros(4))
    drifted = base.copy()
    drifted[-2] += 5.0
    sim_io.store_episode_step(str(epi / "01.h5"), drifted, eef, np.zeros(4))
    bad = base.copy()
    bad[1, 0, 0] = np.nan
    sim_io.store_episode_step(str(epi / "02.h5"), bad, eef, np.zeros(4))
    sim_io.store_properties(str(epi), {"stiffness": 0.5})

    want = jax_filter.filter_dataset(str(tmp_path), out_file=str(tmp_path / "jax.json"))
    got = sim_filter.filter_dataset(str(tmp_path))
    assert got == want == {"000000": [2, 3]}
    assert sim_filter.scan_episode(str(epi)) == jax_filter.scan_episode(str(epi))
    with open(tmp_path / "jax.json") as a, open(tmp_path / "filter_artifacts.json") as b:
        assert a.read() == b.read()
    assert sim_filter.load_filter_file(str(tmp_path / "filter_artifacts.json")) == {"000000": [2, 3]}


def test_box2d_matches_jax(tmp_path):
    """The quasi-static box sim (an off-center push that rotates the box) and
    a box episode file equal the JAX package's."""
    sims = [mod.BoxSim(100.0, 60.0, center_of_mass=(20.0, 0.0)) for mod in (jax_box2d, box2d)]
    for sim in sims:
        sim.set_pusher(np.array([25.0, 80.0]))
        for t in range(30):
            sim.update(np.array([25.0, 80.0 - 3.0 * t]))
    np.testing.assert_array_equal(sims[1].get_corners(), sims[0].get_corners())
    assert abs(sims[1].theta) > 1e-3 and sims[1].theta == sims[0].theta
    want = jax_box2d.gen_box_episode(str(tmp_path / "jax"), 0, n_steps=40)
    got = box2d.gen_box_episode(str(tmp_path / "port"), 0, n_steps=40)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert box2d.gen_box_data(str(tmp_path / "port"), 2, seed=3) == 2
    jax_box2d.gen_box_data(str(tmp_path / "jax"), 2, seed=3)
    assert_same_files(str(tmp_path / "jax"), str(tmp_path / "port"))


def _brute_dist(mod, points, verts, faces):
    verts = np.asarray(verts, np.float64)
    out = np.full(len(points), np.inf)
    for f in faces:
        out = np.minimum(out, mod._point_tri_dist2(np.asarray(points, np.float64),
                                                   verts[f[0]], verts[f[1]], verts[f[2]]))
    return np.sqrt(out)


def test_point_tri_dist_regions_match_jax():
    v0, v1, v2 = np.zeros(3), np.array([2.0, 0.0, 0.0]), np.array([0.0, 2.0, 0.0])
    pts = np.array([[0.5, 0.5, 1.0], [-1.0, -1.0, 0.0], [1.0, -2.0, 0.0], [3.0, 0.0, 0.0]])
    got = np.sqrt(meshutil._point_tri_dist2(pts, v0, v1, v2))
    np.testing.assert_array_equal(got, np.sqrt(jax_meshutil._point_tri_dist2(pts, v0, v1, v2)))
    np.testing.assert_allclose(got, [1.0, np.sqrt(2.0), 2.0, 1.0], atol=1e-12)


def test_aabbtree_matches_jax_and_bruteforce():
    rng = np.random.RandomState(0)
    verts = rng.randn(60, 3)
    faces = rng.randint(0, 60, size=(80, 3))
    faces = faces[(faces[:, 0] != faces[:, 1]) & (faces[:, 1] != faces[:, 2])
                  & (faces[:, 0] != faces[:, 2])]
    pts = rng.randn(50, 3) * 2.0
    got = meshutil.AABBTree(verts, faces).closest_dist(pts)
    np.testing.assert_array_equal(got, jax_meshutil.AABBTree(verts, faces).closest_dist(pts))
    np.testing.assert_allclose(got, _brute_dist(meshutil, pts, verts, faces), atol=1e-9)


def test_box_sdf_matches_jax_and_analytic():
    verts, faces = meshutil.box_mesh(size=(1.0, 1.0, 1.0))
    jv, jf = jax_meshutil.box_mesh(size=(1.0, 1.0, 1.0))
    np.testing.assert_array_equal(verts, jv)
    np.testing.assert_array_equal(faces, jf)
    sdf, origin, spacing = meshutil.make_sdf(verts, faces, dims=13, margin=0.25)
    jsdf, jorigin, jspacing = jax_meshutil.make_sdf(verts, faces, dims=13, margin=0.25)
    np.testing.assert_array_equal(sdf, jsdf)
    np.testing.assert_array_equal(origin, jorigin)
    assert spacing == jspacing
    ax = [origin[d] + spacing * np.arange(n) for d, n in enumerate(sdf.shape)]
    grid = np.stack(np.meshgrid(*ax, indexing="ij"), axis=-1)
    q = np.abs(grid) - 0.5
    want = np.linalg.norm(np.maximum(q, 0.0), axis=-1) + np.minimum(np.max(q, axis=-1), 0.0)
    np.testing.assert_allclose(sdf, want.astype(np.float32), atol=1e-5)


def test_voxelized_body_and_obj_round_trip_match_jax(tmp_path):
    verts, faces = meshutil.box_mesh(size=(0.8, 0.6, 0.9))
    pts = meshutil.voxelize(verts, faces, spacing=0.2)
    np.testing.assert_array_equal(pts, jax_meshutil.voxelize(verts, faces, spacing=0.2))
    assert len(pts) > 0
    assert (meshutil.AABBTree(verts, faces).closest_dist(pts) > 0.05).all()
    obj = tmp_path / "box.obj"
    with open(obj, "w") as f:
        for v in verts:
            f.write(f"v {v[0]} {v[1]} {v[2]}\n")
        for a, b, c in faces + 1:
            f.write(f"f {a} {b} {c}\n")
    v2, f2 = meshutil.load_obj(str(obj))
    jv2, jf2 = jax_meshutil.load_obj(str(obj))
    np.testing.assert_array_equal(v2, jv2)
    np.testing.assert_array_equal(f2, jf2)
    np.testing.assert_allclose(v2, verts, atol=1e-6)


def test_mesh_softbody_matches_jax():
    """A voxelized box mesh as a shape-matching soft body with a fixed bottom
    layer: the port's scene steps as the JAX package's, bit for bit."""
    verts, faces = meshutil.box_mesh(size=(0.6, 0.4, 0.5), center=(0, 0.35, 0))
    pts = meshutil.voxelize(verts, faces, spacing=0.08)
    expected = (0.6 * 0.4 * 0.5) / 0.08 ** 3
    assert 0.7 * expected < len(pts) < 1.3 * expected
    scenes = [cls.from_points(pts, spacing=0.08, stiffness=0.7, fixed_frac=0.1)
              for cls in (JaxXPBDScene, XPBDScene)]
    np.testing.assert_array_equal(scenes[1].get_inv_mass(), scenes[0].get_inv_mass())
    assert (scenes[1].get_inv_mass() == 0).sum() > 0
    p0 = scenes[1].get_positions().copy()
    for _ in range(20):
        for sc in scenes:
            sc.step(np.zeros((0, 3), np.float32))
    np.testing.assert_array_equal(scenes[1].get_positions(), scenes[0].get_positions())
    assert np.abs(scenes[1].get_positions() - p0).mean() < 0.05


def _prep_files_equal(want_dir, got_dir):
    assert sorted(os.listdir(os.path.join(want_dir, "episodes"))) == \
        sorted(os.listdir(os.path.join(got_dir, "episodes")))
    assert_same_files(want_dir, got_dir)


@pytest.mark.parametrize("argv", [
    ["--material", "rope", "--n_episodes", "2", "--n_pushes", "2", "--seed", "0"],
    ["--config", "softbody", "--n_episodes", "2"]],
    ids=["rope", "softbody"])
def test_cli_datagen_filter_preprocess_match_jax(tmp_path, argv):
    """``datagen`` (by material, and by the softbody data_gen config: 5
    pushes an episode, seed 0), then ``filter``, then ``preprocess
    --filter_file`` with the material's dynamics config, through the port's
    CLI (two spawned workers) and the JAX CLI (one process: its pool forks,
    which hangs in a process whose OpenMP threads torch has started): the
    same h5 episodes, filter json and prep dir."""
    config = argv[argv.index("--material") + 1] if "--material" in argv else "softbody"
    for name, main, workers in (("jax", jax_cli.main, "1"), ("port", cli.main, "2")):
        d = tmp_path / name
        main(["datagen", *argv, "--n_workers", workers, "--data_dir", str(d / "sim")])
        main(["filter", "--data_dir", str(d / "sim"), "--out", str(d / "filter.json")])
        main(["preprocess", "--config", config, "--data_dir", str(d / "sim"),
              "--prep_dir", str(d / "prep"), "--filter_file", str(d / "filter.json")])
    assert_same_files(str(tmp_path / "jax" / "sim"), str(tmp_path / "port" / "sim"))
    with open(tmp_path / "jax" / "filter.json") as a, open(tmp_path / "port" / "filter.json") as b:
        assert json.load(a) == json.load(b)
    _prep_files_equal(str(tmp_path / "jax" / "prep"), str(tmp_path / "port" / "prep"))
    n_pushes = 5 if config == "softbody" else 2
    assert len(glob.glob(str(tmp_path / "port" / "sim" / "*" / "*.h5"))) == 2 * n_pushes


def test_cli_datagen_box_config_matches_jax(tmp_path):
    for name, main in (("jax", jax_cli.main), ("port", cli.main)):
        main(["datagen", "--config", "box", "--data_dir", str(tmp_path / name),
              "--n_episodes", "2"])
    assert os.path.exists(tmp_path / "port" / "000001.npz")
    assert_same_files(str(tmp_path / "jax"), str(tmp_path / "port"))


def test_in_memory_pipeline_equals_the_files(tmp_path):
    """What a host without h5py runs: ``simulate`` (two spawned workers)
    gives the pushes that ``generate`` writes, ``flag_episodes`` the flags
    of ``filter_dataset`` and ``preprocess_episodes(filter_actions=...)`` the
    prep files of ``preprocess`` (push 2 of episode 1 dropped in both)."""
    from adaptigraph_tpu_torch.dynamics.preprocess import preprocess, preprocess_episodes

    datagen.generate(str(tmp_path / "sim"), "softbody", 2, n_pushes=2, seed=5)
    episodes = datagen.simulate("softbody", 2, n_pushes=2, n_workers=2, seed=5)
    assert [e for e, *_ in episodes] == [0, 1]
    for e, props, pushes, bad in episodes:
        epi = tmp_path / "sim" / f"{e:06d}"
        assert not bad and props == sim_io.load_properties(str(epi))
        assert len(pushes) == len(sim_io.list_pushes(str(epi))) == 2
        for i, push in enumerate(pushes, start=1):
            want = sim_io.load_episode_step(str(epi / f"{i:02d}.h5"))
            for k in ("positions", "eef_states", "action", "particle_2_instance"):
                np.testing.assert_array_equal(push[k], want[k], err_msg=k)
            np.testing.assert_array_equal(push["particle_inv_weight_is_0"],
                                          want["particle_inv_weight_is_0"])
    flags = sim_filter.flag_episodes((f"{e:06d}", [p["positions"] for p in pushes])
                                     for e, _, pushes, _ in episodes)
    assert flags == sim_filter.filter_dataset(str(tmp_path / "sim"))
    drop = {"000001": [2]}
    args = (np.zeros((5, 3), np.float32), 5, 3, 0.1,
            [{"name": "stiffness", "use": True, "min": 0.0, "max": 1.0}])
    preprocess(str(tmp_path / "sim"), str(tmp_path / "prep"), *args, store_rest_state=True,
               filter_actions=drop)
    preprocess_episodes([(props, pushes) for _, props, pushes, _ in episodes],
                        str(tmp_path / "prep_mem"), *args, store_rest_state=True,
                        filter_actions=drop)
    assert_same_files(str(tmp_path / "prep"), str(tmp_path / "prep_mem"))
