"""The port's rollout evaluator on CPU tensors (the graph build and K2's plain
version, float32) against the JAX evaluator's XLA path, on one prep dir
written by the JAX ``preprocess``, at a small width (40 objects, topk 10,
nf 16, pstep 2): the host-side chain and start state exactly; per-step
errors and predictions over at most 8 steps at rtol 1e-4 / atol 1e-5 (one
push, a batch with padded steps and per-particle physics, the dataset
statistics); the CLI's ``summary.json``; and the video frames."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from adaptigraph_tpu import cli as jax_cli
from adaptigraph_tpu.dynamics import rollout as jax_rollout
from adaptigraph_tpu.dynamics.dataset import DynDataset as JaxDynDataset
from adaptigraph_tpu.dynamics.graphs import GraphSpec as JaxGraphSpec
from adaptigraph_tpu.dynamics.preprocess import preprocess
from adaptigraph_tpu.models.gnn import GNNConfig as JaxGNNConfig
from adaptigraph_tpu.models.gnn import init_params
from adaptigraph_tpu.ops.graph import EdgeConfig as JaxEdgeConfig
from adaptigraph_tpu.sim.synthetic import SYNTH_EEF_OFFSETS, gen_rope_dataset
from adaptigraph_tpu.utils import viz as jax_viz
from adaptigraph_tpu_torch import cli
from adaptigraph_tpu_torch.dynamics import rollout
from adaptigraph_tpu_torch.dynamics.graphs import GraphSpec
from adaptigraph_tpu_torch.models.gnn import GNNConfig, params_from_numpy, params_to_numpy
from adaptigraph_tpu_torch.ops import fused_gnn
from adaptigraph_tpu_torch.ops.graph import EdgeConfig
from adaptigraph_tpu_torch.utils import checkpoint as ckpt
from adaptigraph_tpu_torch.utils import viz
from test_torch_jaxsim import jax_sim_built_here  # noqa: F401  (autouse)

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SPEC_KW = dict(n_his=4, n_future=3, max_nobj=40, max_neef=1, fps_radius_range=(0.18, 0.22),
               adj_radius_range=(0.48, 0.52), topk=10)
JSPEC, SPEC = JaxGraphSpec(**SPEC_KW), GraphSpec(**SPEC_KW)
GKW = dict(n_his=4, max_nobj=40, max_neef=1, nf_particle=16, nf_relation=16, nf_effect=16, pstep=2)
JCFG, CFG = JaxGNNConfig(**GKW), GNNConfig(**GKW)
JECFG, ECFG = JaxEdgeConfig(max_nobj=40, max_neef=1, topk=10), EdgeConfig(max_nobj=40, max_neef=1,
                                                                            topk=10)
TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module")
def prep_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_rollout")
    gen_rope_dataset(str(root / "sim"), n_episodes=2, n_pushes=2, seed=3, n_particles=30)
    preprocess(str(root / "sim"), str(root / "prep"), SYNTH_EEF_OFFSETS, n_his=4, n_future=3,
               dist_thresh=0.1,
               phys_param_specs=[{"name": "stiffness", "use": True, "min": 0.0, "max": 1.0}])
    return str(root / "prep")


def _params(seed=0):
    p = jax.tree_util.tree_map(np.asarray, init_params(jax.random.PRNGKey(seed), JCFG))
    return p, params_from_numpy(p, "cpu")


def _episode(prep_dir, ei=0):
    ds = JaxDynDataset(prep_dir, JSPEC, phase="valid", ratio={"train": [0, 0], "valid": [0, 1]})
    return ds._episode(ei), ds.physics_norm[ei]


def test_frame_chain_and_start_state_match_jax(prep_dir):
    rng = np.random.RandomState(0)
    eef = np.cumsum(rng.rand(40, 1, 3) * 0.06, axis=0)
    for start, steps in ((0, 100), (3, 5)):
        np.testing.assert_array_equal(rollout.frame_chain(eef, start, 0.1, steps),
                                      jax_rollout.frame_chain(eef, start, 0.1, steps))
    epi, _ = _episode(prep_dir)
    chain = jax_rollout.frame_chain(epi["eef_pos"], 0, 0.1, 8)
    for fps_idx in (None, np.arange(0, 20, 2)):
        got = rollout.build_start_state(SPEC, epi["obj_pos"], epi["eef_pos"], chain, fps_idx=fps_idx)
        want = jax_rollout.build_start_state(JSPEC, epi["obj_pos"], epi["eef_pos"], chain,
                                             fps_idx=fps_idx)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


def test_rollout_episode_matches_jax(prep_dir):
    """One push through ``rollout_scan`` (B 1, the real steps only; JAX pads
    to a power-of-two bucket and cuts it off), and again with a previous
    push's FPS indices kept."""
    epi, phys = _episode(prep_dir)
    jp, tp = _params(0)
    launches = fused_gnn.gnn_forward.launches
    for fps_idx in (None, np.arange(0, 24, 2)):
        want = jax_rollout.rollout_episode(jp, JSPEC, JCFG, JECFG, epi["obj_pos"], epi["eef_pos"],
                                           phys, max_steps=7, fps_idx=fps_idx)
        got = rollout.rollout_episode(tp, SPEC, CFG, ECFG, epi["obj_pos"], epi["eef_pos"], phys,
                                      max_steps=7, fps_idx=fps_idx)
        assert len(got[0]) == 7
        np.testing.assert_allclose(got[0], want[0], **TOL)
        np.testing.assert_allclose(got[1], want[1], **TOL)
        np.testing.assert_array_equal(got[2], want[2])
        np.testing.assert_array_equal(got[3], want[3])
    assert fused_gnn.gnn_forward.launches == launches  # CPU tensors: the plain version


def test_rollout_scan_batched_matches_jax(prep_dir):
    """Two pushes of different lengths (the shorter one's padded steps
    frozen) with per-particle physics, against the JAX batched XLA scan."""
    epi, phys = _episode(prep_dir, 1)
    jp, tp = _params(1)
    pb = epi["push_bounds"]
    pushes = [jax_rollout._prepare_push(JSPEC, epi["obj_pos"][pb[p]:pb[p + 1]],
                                        epi["eef_pos"][pb[p]:pb[p + 1]], phys, 0.1, 8)
              for p in range(2)]
    T = 8
    lens = [min(p["T"], T) for p in pushes]
    lens[0] -= 2
    rng = np.random.RandomState(2)

    def pad(x, n):
        out = np.zeros((T,) + x.shape[1:], np.float32)
        out[:n], out[n:] = x[:n], x[n - 1]
        return out

    batch = dict(
        state_history=np.stack([p["hist"] for p in pushes]),
        eef_seq=np.stack([pad(p["eef_seq"], n) for p, n in zip(pushes, lens)]),
        gt_seq=np.stack([pad(p["gt_seq"], n) for p, n in zip(pushes, lens)]),
        state_mask=np.stack([p["state_mask"] for p in pushes]),
        eef_mask=np.stack([p["eef_mask"] for p in pushes]),
        attrs=np.stack([p["attrs"] for p in pushes]),
        p_instance=np.stack([p["p_instance"] for p in pushes]),
        physics_param=rng.rand(2, SPEC.max_nobj).astype(np.float32),
        obj_count=np.asarray([p["n_obj"] for p in pushes], np.int32),
        step_valid=np.stack([np.arange(T) < n for n in lens]))
    want = jax_rollout.rollout_scan_batched(jp, **{k: jnp.asarray(v) for k, v in batch.items()},
                                            adj_thresh=jnp.asarray(0.5), gnn_cfg=JCFG,
                                            edge_cfg=JECFG)
    got = rollout.rollout_scan_batched(tp, **{k: torch.tensor(v) for k, v in batch.items()},
                                       adj_thresh=0.5, gnn_cfg=CFG, edge_cfg=ECFG)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    # the history is frozen past the shorter push's end: its padded steps all predict the same
    np.testing.assert_array_equal(got[1][0, lens[0]:].numpy(),
                                  got[1][0, lens[0]:lens[0] + 1].expand(T - lens[0], -1, -1).numpy())


@pytest.mark.parametrize("keep_prev_fps", [False, True])
def test_rollout_dataset_matches_jax(prep_dir, tmp_path, keep_prev_fps):
    jp, tp = _params(2)
    kw = dict(phase_ratio=(0.0, 1.0), dist_thresh=0.1, max_steps=8, keep_prev_fps=keep_prev_fps)
    want = jax_rollout.rollout_dataset(jp, JSPEC, JCFG, JECFG, prep_dir, **kw)
    got = rollout.rollout_dataset(tp, SPEC, CFG, ECFG, prep_dir, out_dir=str(tmp_path), **kw)
    for k in ("median", "q25", "q75"):
        np.testing.assert_allclose(got[k], want[k], **TOL)
    assert len(got["per_push"]) == len(want["per_push"]) >= 4
    for a, b in zip(got["per_push"], want["per_push"]):
        np.testing.assert_allclose(a, b, **TOL)
    with np.load(tmp_path / "rollout_errors.npz") as z:
        np.testing.assert_allclose(z["median"], got["median"])
        assert z["per_push_padded"].shape == (len(got["per_push"]), len(got["median"]))
    assert any(f.startswith("rollout_ep0.") for f in os.listdir(tmp_path))


def _small_config(tmp_path):
    with open(os.path.join(ROOT, "adaptigraph_tpu_torch", "configs", "dynamics", "rope.yaml")) as f:
        config = yaml.safe_load(f)
    config["dataset_config"]["datasets"][0]["max_nobj"] = 40
    config["model_config"].update(nf_particle=16, nf_relation=16, nf_effect=16, pstep=2)
    path = tmp_path / "rope_small.yaml"
    path.write_text(yaml.safe_dump(config))
    return str(path)


def test_cli_rollout_summary_matches_jax(prep_dir, tmp_path):
    """``rollout --all_episodes`` of a checkpoint that both packages read: the
    port's summary.json against the JAX command's, on the CPU."""
    config = _small_config(tmp_path)
    jp, tp = _params(3)
    summaries = {}
    for name in ("jax", "torch"):
        out = tmp_path / name
        ckpt.save_checkpoint(str(out), 0, params_to_numpy(tp))
        argv = ["rollout", "--config", config, "--prep_dir", prep_dir, "--out_dir", str(out),
                "--all_episodes"]
        if name == "jax":
            jax_cli.main(argv)
        else:
            cli.main(argv + ["--device", "cpu"])
        with open(out / "rollout" / "summary.json") as f:
            summaries[name] = json.load(f)
        assert os.path.exists(out / "rollout" / "error_median_iqr.png")
    assert summaries["torch"]["n_pushes"] == summaries["jax"]["n_pushes"] >= 4
    for k in ("median_last_step", "median_mean", "push_final_median"):
        np.testing.assert_allclose(summaries["torch"][k], summaries["jax"][k], **TOL)
    assert cli.build_parser().parse_args(["rollout", "--config", "rope"]).device == "cuda"


def test_video_frames_match_jax():
    rng = np.random.RandomState(0)
    pred, gt = rng.randn(2, 3, 12, 3) * 0.5
    intr, extr = viz.topdown_camera(center=(0.1, -0.2))
    jintr, jextr = jax_viz.topdown_camera(center=(0.1, -0.2))
    np.testing.assert_array_equal(intr, jintr)
    np.testing.assert_array_equal(extr, jextr)
    got = viz.render_rollout_frames(pred, gt, intr, extr, n_valid=10)
    want = jax_viz.render_rollout_frames(pred, gt, jintr, jextr, n_valid=10)
    assert len(got) == 3
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
