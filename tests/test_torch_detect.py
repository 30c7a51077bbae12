"""The learned-perception tier (``realworld/detect.py``'s ``GroundedSAMMask``,
``boxes_to_masks``, ``make_mask_fn``) and ``plan --learned_perception``
against the JAX package. No model weights are loaded: the detector is
injected (the recorded fixture's boxes, or the bounding box of the render's
colour-spread mask) and ``boxes_to_masks`` segments. Both sides are numpy,
so the masks are compared exactly; the closed loop is held to the
identical-samples harness of ``test_torch_closed_loop.py``."""

import os
import sys

import numpy as np
import pytest

from adaptigraph_tpu.realworld import detect as jax_detect
from adaptigraph_tpu.realworld import perception as jax_perception
from adaptigraph_tpu.realworld.env import SimRealEnv as JaxSimRealEnv
from adaptigraph_tpu_torch import cli
from adaptigraph_tpu_torch.realworld import detect, perception
from adaptigraph_tpu_torch.realworld.env import SimRealEnv
from test_torch_closed_loop import (_tiny_cli_task, assert_plans_agree, colour_box_detector,
                                    run_plans_with_identical_samples, weights)  # noqa: F401
from test_torch_jaxsim import jax_sim_built_here  # noqa: F401  (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_MESSAGE = "--learned_perception needs torch+transformers and task obj_list prompts"


@pytest.fixture(scope="module")
def fixture_view():
    with np.load(os.path.join(ROOT, "fixtures", "perception", "rope_view0.npz")) as fx:
        return {k: fx[k] for k in fx.files}


def _both(**kw):
    """The JAX mask and the port's, built with the same arguments."""
    return (jax_detect.GroundedSAMMask(**kw),
            detect.GroundedSAMMask(**kw, device="cpu"))


def _replay(boxes, scores, labels=None):
    def detector(rgb):
        return boxes, scores, list(labels or ["rope"] * len(boxes))

    return detector


def test_grounded_sam_mask_matches_jax_on_fixture(fixture_view):
    """The recorded rope view: the same detections and masks, a keep-mask
    equal to the fixture's ``box_mask``, the 0.95 threshold dropping the 0.9
    detection, and the keep-all mask when nothing is left."""
    rgb, boxes, scores = fixture_view["rgb"], fixture_view["boxes"], fixture_view["scores"]
    want, got = _both(prompts=("rope",), detector=_replay(boxes, scores),
                      segmenter=detect.boxes_to_masks, box_threshold=0.5)
    (wb, ws, wl), (gb, gs, gl) = want.detect(rgb), got.detect(rgb)
    np.testing.assert_array_equal(gb, wb)
    np.testing.assert_array_equal(gs, ws)
    assert gl == wl == ["rope"]
    (wm, wms), (gm, gms) = want.segment(rgb), got.segment(rgb)
    assert gm.shape == (1,) + rgb.shape[:2]
    np.testing.assert_array_equal(gm, wm)
    np.testing.assert_array_equal(gms, wms)
    np.testing.assert_array_equal(got(rgb), fixture_view["box_mask"])
    np.testing.assert_array_equal(got(rgb), want(rgb))
    want_hi, got_hi = _both(prompts=("rope",), detector=_replay(boxes, scores),
                            segmenter=detect.boxes_to_masks, box_threshold=0.95)
    assert len(got_hi.detect(rgb)[0]) == len(want_hi.detect(rgb)[0]) == 0
    assert got_hi(rgb).all() and want_hi(rgb).all()


@pytest.mark.parametrize("box_t,text_t,iou,max_n", [(0.5, 0.5, 0.9, 1), (0.3, 0.6, 0.9, 2),
                                                    (0.3, 0.3, 0.5, 3), (0.3, 0.3, 0.99, None)])
def test_thresholds_dedup_and_budget_match_jax(fixture_view, box_t, text_t, iou, max_n):
    """Several detections, overlapping and not, through both thresholds, the
    IoU dedup and the instance budget."""
    rgb = fixture_view["rgb"]
    boxes = np.array([[137, 136, 179, 188], [138, 137, 180, 188], [10, 10, 60, 40],
                      [200, 250, 330, 340], [0, 0, 5, 5]], np.float32)
    scores = np.array([0.9, 0.8, 0.55, 0.7, 0.35], np.float32)
    labels = ["rope", "rope", "rope", "cloth", "rope"]
    want, got = _both(prompts=("rope", "cloth"), detector=_replay(boxes, scores, labels),
                      segmenter=detect.boxes_to_masks, box_threshold=box_t,
                      text_threshold=text_t, iou_thresh=iou, max_n=max_n)
    (wb, ws, wl), (gb, gs, gl) = want.detect(rgb), got.detect(rgb)
    np.testing.assert_array_equal(gb, wb)
    np.testing.assert_array_equal(gs, ws)
    assert gl == wl
    (wm, wms), (gm, gms) = want.segment(rgb), got.segment(rgb)
    np.testing.assert_array_equal(gm, wm)
    np.testing.assert_array_equal(gms, wms)
    np.testing.assert_array_equal(got(rgb), want(rgb))
    if max_n is not None:
        assert len(gm) <= max_n


def test_boxes_to_masks_matches_jax():
    """Random boxes, some overhanging the image on each side, and none."""
    rng = np.random.RandomState(0)
    rgb = np.zeros((48, 64, 3), np.uint8)
    lo = rng.uniform(-20, 60, (24, 2))
    boxes = np.concatenate([lo, lo + rng.uniform(0, 40, (24, 2))], 1).astype(np.float32)
    got = detect.boxes_to_masks(rgb, boxes)
    np.testing.assert_array_equal(got, jax_detect.boxes_to_masks(rgb, boxes))
    assert got.shape == (24, 48, 64)
    x0, y0, x1, y1 = -5.0, 40.0, 70.0, 90.0  # overhangs left, right and bottom
    m = detect.boxes_to_masks(rgb, [[x0, y0, x1, y1]])[0]
    assert m[40:].all() and not m[:40].any()
    assert detect.boxes_to_masks(rgb, np.zeros((0, 4))).shape == (0, 48, 64)


def test_segmenter_falls_back_to_filled_boxes(fixture_view, monkeypatch):
    """When the SAM load raises, both packages segment with filled boxes."""
    rgb, boxes, scores = fixture_view["rgb"], fixture_view["boxes"], fixture_view["scores"]

    def no_weights(self):
        raise OSError("no SAM weights")

    monkeypatch.setattr(jax_detect.GroundedSAMMask, "_load_segmenter", no_weights)
    monkeypatch.setattr(detect.GroundedSAMMask, "_load_segmenter", no_weights)
    want, got = _both(prompts=("rope",), detector=_replay(boxes, scores))
    np.testing.assert_array_equal(got(rgb), want(rgb))
    np.testing.assert_array_equal(got(rgb), fixture_view["box_mask"])
    assert got._segmenter is detect.boxes_to_masks


def test_make_mask_fn_matches_jax(monkeypatch):
    """None without prompts or without transformers; else a GroundedSAMMask
    on the caller's device (the card by default), nothing loaded yet."""
    assert detect.make_mask_fn(()) is None and jax_detect.make_mask_fn(()) is None
    gm = detect.make_mask_fn(("rope",), max_n=2, box_threshold=0.4, device="cpu")
    want = jax_detect.make_mask_fn(("rope",), max_n=2, box_threshold=0.4)
    assert isinstance(gm, detect.GroundedSAMMask)
    for k in ("prompts", "max_n", "box_threshold", "text_threshold", "iou_thresh"):
        assert getattr(gm, k) == getattr(want, k), k
    assert gm.device == "cpu" and gm._detector is None and gm._segmenter is None
    assert detect.make_mask_fn(("rope",)).device == "cuda"
    monkeypatch.setitem(sys.modules, "transformers", None)
    assert detect.make_mask_fn(("rope",)) is None
    assert jax_detect.make_mask_fn(("rope",)) is None


def test_plan_cli_exits_with_jax_message_without_transformers(monkeypatch):
    """Without transformers both CLIs exit with the same message."""
    from adaptigraph_tpu import cli as jax_cli

    _tiny_cli_task(monkeypatch)
    monkeypatch.setitem(sys.modules, "transformers", None)
    messages = []
    for main, extra in ((jax_cli.main, []), (cli.main, ["--device", "cpu"])):
        with pytest.raises(SystemExit) as exc:
            main(["plan", "--config", "rope", "--n_actions", "1", "--learned_perception",
                  *extra])
        messages.append(str(exc.value))
    assert messages[1] == messages[0] == JAX_MESSAGE


def _learned_pm(jax_side):
    det, per = (jax_detect, jax_perception) if jax_side else (detect, perception)
    kw = {} if jax_side else {"device": "cpu"}
    gm = det.GroundedSAMMask(("rope",), detector=colour_box_detector(),
                             segmenter=det.boxes_to_masks, **kw)
    return per.PerceptionModule(stride=2, mask_fn=gm, obj_prompts=("rope",))


def test_learned_keep_masks_give_jax_points():
    """The non-use_raw perception fed the GroundedSAMMask keep-masks: the same
    points and state as JAX's, twice in a row."""
    want_env, got_env = (JaxSimRealEnv("rope", seed=4, img_size=200),
                         SimRealEnv("rope", seed=4, img_size=200))
    want_rng, got_rng = np.random.RandomState(7), np.random.RandomState(7)
    for _ in range(2):
        want, want_all = jax_perception.get_state_cur(
            want_env, _learned_pm(True), fps_radius=0.2, max_nobj=100, use_raw=False,
            rng=want_rng)
        got, got_all = perception.get_state_cur(
            got_env, _learned_pm(False), fps_radius=0.2, max_nobj=100, use_raw=False,
            rng=got_rng)
        np.testing.assert_array_equal(got_all, want_all)
        np.testing.assert_array_equal(got, want)
        assert len(got) > 3


def test_run_plan_with_learned_masks_matches_jax(monkeypatch, tmp_path, weights):
    """The closed loop perceiving through the learned keep-masks, with the
    same samples per solve on both sides: the same pushes, errors, estimates
    and files."""
    want, got = run_plans_with_identical_samples(monkeypatch, tmp_path, weights, True,
                                                 pm_factory=_learned_pm, use_raw=False)
    assert_plans_agree(want, got, tmp_path, True)


def test_box_keep_masks_perceive_as_the_colour_mask():
    """On the rope rig the render-driven detector's filled boxes perceive the
    state the colour mask does: the box's table pixels fall to the rope
    config's z filter (k_filter 0.5)."""
    env = SimRealEnv("rope", seed=0, img_size=240)
    rgb = env.get_obs()["color_0"]
    box, colour = _learned_pm(False).mask_fn(rgb), detect.color_spread_mask_fn()(rgb)
    assert (colour & ~box).sum() == 0 and (box & ~colour).sum() > 0  # the box holds table
    states = []
    for mask_fn in (_learned_pm(False).mask_fn, detect.color_spread_mask_fn()):
        pm = perception.PerceptionModule(stride=2, k_filter=0.5, mask_fn=mask_fn)
        states.append(perception.get_state_cur(env, pm, fps_radius=0.1, max_nobj=100,
                                               use_raw=False, rng=np.random.RandomState(0)))
    np.testing.assert_array_equal(states[0][1], states[1][1])
    np.testing.assert_array_equal(states[0][0], states[1][0])
    assert len(states[0][0]) > 3
