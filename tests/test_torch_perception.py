"""The port's perception (point-cloud passes, FPS state building, colour
masks) against the JAX package's on the same scenes and random draws."""

import os

import numpy as np
import pytest

from adaptigraph_tpu.realworld import detect as jax_detect
from adaptigraph_tpu.realworld import perception as jax_perception
from adaptigraph_tpu.realworld.env import SimRealEnv as JaxSimRealEnv
from adaptigraph_tpu_torch.realworld import detect, perception
from adaptigraph_tpu_torch.realworld.env import SimRealEnv, sim_to_board
from test_torch_jaxsim import jax_sim_built_here  # noqa: F401  (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _pm(port_side, mask):
    """A PerceptionModule of one package, with that package's colour mask or none."""
    per, det = (perception, detect) if port_side else (jax_perception, jax_detect)
    return per.PerceptionModule(stride=2, mask_fn=det.color_spread_mask_fn() if mask else None)


@pytest.mark.parametrize("material,use_raw", [("rope", True), ("rope", False),
                                              ("granular", True), ("granular", False)],
                         ids=["rope-raw", "rope-color_mask", "granular-raw",
                              "granular-color_mask"])
def test_get_state_cur_matches_jax(material, use_raw):
    """The same scene and RandomState give the same perceived state, in use_raw
    mode and through the colour mask with the voxel and outlier passes, twice
    in a row (the FPS start is drawn from the RandomState each time)."""
    want_env, got_env = (JaxSimRealEnv(material, seed=4, img_size=200),
                         SimRealEnv(material, seed=4, img_size=200))
    want_rng, got_rng = np.random.RandomState(7), np.random.RandomState(7)
    for _ in range(2):
        want, want_all = jax_perception.get_state_cur(
            want_env, _pm(False, not use_raw), fps_radius=0.2, max_nobj=100,
            use_raw=use_raw, rng=want_rng)
        got, got_all = perception.get_state_cur(
            got_env, _pm(True, not use_raw), fps_radius=0.2, max_nobj=100,
            use_raw=use_raw, rng=got_rng)
        np.testing.assert_array_equal(got_all, want_all)
        np.testing.assert_array_equal(got, want)
        assert len(got) > 3
    assert got_rng.randint(1 << 30) == want_rng.randint(1 << 30)


def test_construct_graph_matches_jax():
    pts = np.random.RandomState(0).uniform(-1, 1, (300, 3)).astype(np.float32)
    eef = np.ones((2, 3), np.float32)
    want = jax_perception.construct_graph(pts, 0.3, max_nobj=50, max_neef=4, eef_kps=eef,
                                          rng=np.random.RandomState(3))
    got = perception.construct_graph(pts, 0.3, max_nobj=50, max_neef=4, eef_kps=eef,
                                     rng=np.random.RandomState(3))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_rope_view_fixture_through_both_packages():
    """The recorded rope view: the colour mask, the IoU deduplication and the
    fixture's masks agree between the packages."""
    with np.load(os.path.join(ROOT, "fixtures", "perception", "rope_view0.npz")) as fx:
        rgb, color_mask, box_mask = fx["rgb"], fx["color_mask"], fx["box_mask"]
    got = detect.color_spread_mask_fn()(rgb)
    np.testing.assert_array_equal(got, jax_detect.color_spread_mask_fn()(rgb))
    np.testing.assert_array_equal(got, color_mask)
    masks = [box_mask, color_mask, box_mask.copy(), ~color_mask]
    scores = [0.6, 0.9, 0.5, 0.2]
    for thresh in (0.0, 0.5, 0.9):
        for max_n in (None, 1, 2):
            assert (detect.dedup_masks(masks, scores, thresh, max_n)
                    == jax_detect.dedup_masks(masks, scores, thresh, max_n))
    for a in masks:
        for b in masks:
            assert detect.mask_iou(a, b) == jax_detect.mask_iou(a, b)


def test_empty_crop_raises_empty_perception_error():
    """A scene whose object lies outside the crop box gives no points: the
    error names the cause."""
    env = SimRealEnv("rope", seed=0, img_size=120)
    env.get_bbox = lambda: np.array([[5.0, 6.0], [5.0, 6.0], [-0.5, -0.0012]], np.float32)
    with pytest.raises(perception.EmptyPerceptionError, match="0 object points"):
        perception.get_state_cur(env, perception.PerceptionModule(stride=2), use_raw=True,
                                 rng=np.random.RandomState(0))
    with pytest.raises(perception.EmptyPerceptionError):
        perception.construct_graph(np.zeros((0, 3), np.float32), 0.2)


def test_construct_goal_matches_jax():
    want = jax_perception.construct_goal_from_perception(JaxSimRealEnv("rope", seed=6,
                                                                       img_size=160))
    got = perception.construct_goal_from_perception(SimRealEnv("rope", seed=6, img_size=160))
    np.testing.assert_array_equal(got, want)
    assert got.shape[1] == 3 and len(got) > 10


def test_board_and_sim_coordinates_round_trip():
    pts = np.random.RandomState(2).randn(40, 3).astype(np.float32)
    back = perception.obs_to_sim_coords(sim_to_board(pts, 10.0), 10.0)
    np.testing.assert_allclose(back, pts, rtol=1e-6, atol=1e-6)
    board = sim_to_board(pts, 10.0)
    np.testing.assert_array_equal(perception.obs_to_sim_coords(board, 10.0),
                                  jax_perception.obs_to_sim_coords(board, 10.0))
    np.testing.assert_allclose(sim_to_board(perception.obs_to_sim_coords(board, 10.0), 10.0),
                               board, rtol=1e-6, atol=1e-6)


def test_perception_cli(tmp_path, capsys):
    """``perception --construct_goal`` saves the JAX command's goal, and
    ``--calibrate`` prints the perceived state's Chamfer distance to the
    simulator's particles."""
    import adaptigraph_tpu.cli as jax_cli
    from adaptigraph_tpu_torch import cli

    got = cli.main(["perception", "--construct_goal", "--seed", "1",
                    "--out", str(tmp_path / "port.npz"), "--device", "cpu"])
    jax_cli.main(["perception", "--construct_goal", "--seed", "1",
                  "--out", str(tmp_path / "jax.npz")])
    with np.load(tmp_path / "port.npz") as g, np.load(tmp_path / "jax.npz") as w:
        np.testing.assert_array_equal(g["goal"], w["goal"])
        np.testing.assert_array_equal(g["goal"], got)
    err = cli.main(["perception", "--calibrate", "--device", "cpu"])
    assert "calibration check" in capsys.readouterr().out
    assert 0.0 <= err < 0.2
