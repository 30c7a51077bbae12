"""Autoregressive rollout evaluation (counterpart of
``adaptigraph_tpu/dynamics/rollout.py``).

- host side (numpy): the deterministic start graph (FPS with the midpoint
  radius, fixed start index) and the frame chain, successive episode frames
  spaced by eef displacement >= dist_thresh;
- device side: a loop over the chain, all pushes of a batch advancing
  together; each step rebuilds the graph from the current predicted state
  (``ops.graph.build_neighbor_graph_batch``), runs one float32 GNN step on it
  (``fused_forward_batch`` with prebuilt edges: the K2 kernel on CUDA
  tensors, its plain version on CPU tensors; the JAX ``use_fused`` branch),
  records the mean particle L2 error against the FPS'd ground truth, and
  splices the prediction and the next eef into the history.

The device is the parameters': a checkpoint loaded on the card rolls out on
the card. The JAX ``use_fused`` and ``interpret`` switches have no
counterpart here.
"""

import os

import numpy as np
import torch

from adaptigraph_tpu_torch.models.gnn import GNNConfig
from adaptigraph_tpu_torch.ops.fps import fps_downsample
from adaptigraph_tpu_torch.ops.fused_gnn import fused_forward_batch, weight_list
from adaptigraph_tpu_torch.ops.graph import EdgeConfig, build_neighbor_graph_batch
from adaptigraph_tpu_torch.utils.checkpoint import tree_leaves


def frame_chain(eef_kp, start, dist_thresh, max_steps):
    """Frames spaced by >= dist_thresh eef displacement, starting at
    ``start``, at most ``max_steps + 1`` of them."""
    eef = eef_kp[:, 0]
    chain = [start]
    cur = eef[start]
    for f in range(start + 1, len(eef)):
        if np.linalg.norm(eef[f] - cur) >= dist_thresh:
            chain.append(f)
            cur = eef[f]
        if len(chain) >= max_steps + 1:
            break
    return np.asarray(chain, np.int64)


def build_start_state(spec, obj_pos, eef_pos, chain, rng=None, fps_idx=None):
    """Deterministic start graph inputs: (state_history (n_his, N, 3), fps_idx,
    state_mask, eef_mask, n_obj). The history is the start frame repeated.
    ``fps_idx``: reuse a previous push's FPS indices instead of sampling."""
    n_his, N = spec.n_his, spec.n_nodes
    fps_radius = float(np.mean(spec.fps_radius_range))
    start = chain[0]
    if fps_idx is None:
        fps_idx = fps_downsample(obj_pos[start], spec.max_nobj, fps_radius, start_idx=0,
                                 rng=rng or np.random.RandomState(0))
    n_obj = len(fps_idx)
    eef_rows = slice(spec.max_nobj, spec.max_nobj + eef_pos.shape[1])
    state_history = np.zeros((n_his, N, 3), np.float32)
    state_history[:, :n_obj] = obj_pos[start][fps_idx]
    state_history[:, eef_rows] = eef_pos[start]
    state_mask = np.zeros(N, bool)
    state_mask[:n_obj] = True
    state_mask[eef_rows] = True
    eef_mask = np.zeros(N, bool)
    eef_mask[eef_rows] = True
    return state_history, fps_idx, state_mask, eef_mask, n_obj


def _device(params):
    return params[0].device if isinstance(params, (list, tuple)) else tree_leaves(params)[0].device


def rollout_scan_batched(params, state_history, eef_seq, gt_seq, state_mask, eef_mask, attrs,
                         p_instance, physics_param, obj_count, step_valid, adj_thresh,
                         gnn_cfg: GNNConfig, edge_cfg: EdgeConfig):
    """Batched rollout: every push advances together, one graph build and one
    GNN step per step for the whole batch. Tensors on one device:
    state_history (B, n_his, N, 3), eef_seq (B, T, max_neef, 3), gt_seq
    (B, T, max_nobj, 3), state_mask / eef_mask (B, N) bool, attrs (B, N, 2),
    p_instance (B, max_nobj, 1), physics_param (B, phys_dim) or per particle
    (B, max_nobj), obj_count (B,), step_valid (B, T) bool (False for
    chain-padding steps, which freeze the history), adj_thresh a float.
    ``params``: the nested parameter dict or ``weight_list``'s float32
    output. Returns errors (B, T), the mean particle L2 error per step, and
    preds (B, T, max_nobj, 3)."""
    n_p, n_eef = gnn_cfg.max_nobj, gnn_cfg.max_neef
    eef_rows = slice(n_p, n_p + n_eef)
    f32 = torch.float32
    weights = (params if isinstance(params, (list, tuple))
               else weight_list(params, gnn_cfg, f32))
    k_used = edge_cfg.topk + edge_cfg.max_neef
    obj_valid = torch.arange(n_p, device=obj_count.device)[None] < obj_count[:, None]
    count = torch.clamp(obj_count.to(f32), min=1.0)
    graph = {"attrs": attrs, "p_instance": p_instance, "physics_param": physics_param}
    hist = state_history
    errors, preds = [], []
    for t in range(eef_seq.shape[1]):
        eef_next = eef_seq[:, t]
        action = torch.zeros_like(hist[:, 0])
        action[:, eef_rows] = eef_next - hist[:, -1, eef_rows]
        graph["neighbors"], graph["nbr_mask"] = build_neighbor_graph_batch(
            hist[:, -1], state_mask, eef_mask, adj_thresh, edge_cfg)
        graph["state"], graph["action"] = hist, action
        pred = fused_forward_batch(weights, graph, gnn_cfg, compute_dtype=f32, k_used=k_used,
                                   want_motion=False)[0]
        err = torch.linalg.norm(pred - gt_seq[:, t], dim=-1)
        errors.append(torch.where(obj_valid, err, 0.0).sum(1) / count)
        preds.append(pred)
        nxt = hist[:, -1].clone()
        nxt[:, :n_p] = pred
        nxt[:, eef_rows] = eef_next
        new_hist = torch.cat([hist[:, 1:], nxt[:, None]], dim=1)
        hist = torch.where(step_valid[:, t, None, None, None], new_hist, hist)
    return torch.stack(errors, 1), torch.stack(preds, 1)


def rollout_scan(params, state_history, eef_seq, gt_seq, state_mask, eef_mask, attrs, p_instance,
                 physics_param, obj_count, adj_thresh, gnn_cfg: GNNConfig, edge_cfg: EdgeConfig):
    """One push's rollout: ``rollout_scan_batched`` at B 1, every step valid.
    state_history (n_his, N, 3), eef_seq (T, max_neef, 3), gt_seq (T,
    max_nobj, 3), masks (N,), attrs (N, 2), p_instance (max_nobj, 1),
    physics_param (phys_dim,) or (max_nobj,), obj_count an int. Returns
    errors (T,) and preds (T, max_nobj, 3)."""
    dev = state_history.device
    T = eef_seq.shape[0]
    errors, preds = rollout_scan_batched(
        params, state_history[None], eef_seq[None], gt_seq[None], state_mask[None],
        eef_mask[None], attrs[None], p_instance[None], physics_param[None],
        torch.as_tensor([obj_count], device=dev), torch.ones(1, T, dtype=torch.bool, device=dev),
        adj_thresh, gnn_cfg, edge_cfg)
    return errors[0], preds[0]


def _inputs(spec, n_obj, n_eef):
    """attrs (N, 2) and p_instance (max_nobj, 1) of a push with n_obj valid
    objects."""
    attrs = np.zeros((spec.n_nodes, 2), np.float32)
    attrs[:n_obj, 0] = 1.0
    attrs[spec.max_nobj:spec.max_nobj + n_eef, 1] = 1.0
    p_instance = np.zeros((spec.max_nobj, 1), np.float32)
    p_instance[:n_obj, 0] = 1.0
    return attrs, p_instance


def rollout_episode(params, spec, gnn_cfg, edge_cfg, obj_pos, eef_pos, physics_param, start=0,
                    dist_thresh=0.1, max_steps=100, fps_idx=None):
    """Evaluate one episode push from ``start``: returns (errors (T,), preds
    (T, max_nobj, 3), chain, fps_idx) as numpy. ``fps_idx``: keep a previous
    push's FPS sample. The JAX function pads the chain to a power-of-two
    length to bound its recompilation; eager PyTorch compiles nothing, so
    only the T real steps run."""
    p = _prepare_push(spec, obj_pos, eef_pos, physics_param, dist_thresh, max_steps,
                      fps_idx=fps_idx, start=start)
    if p is None:
        return (np.zeros(0), np.zeros((0, spec.max_nobj, 3)),
                frame_chain(eef_pos, start, dist_thresh, max_steps), fps_idx)
    dev = _device(params)

    def t(a):
        return torch.as_tensor(np.asarray(a), device=dev)

    errors, preds = rollout_scan(
        params, t(p["hist"]), t(p["eef_seq"]), t(p["gt_seq"]), t(p["state_mask"]),
        t(p["eef_mask"]), t(p["attrs"]), t(p["p_instance"]), t(p["physics"]), p["n_obj"],
        float(np.mean(spec.adj_radius_range)), gnn_cfg, edge_cfg)
    return errors.cpu().numpy(), preds.cpu().numpy(), p["chain"], p["fps_idx"]


def _prepare_push(spec, obj_pos, eef_pos, physics_param, dist_thresh, max_steps, fps_idx=None,
                  start=0):
    """Host-side push preparation: frame chain from ``start``, start state
    and the gt/eef sequences. None when the chain is too short, else a dict
    of arrays."""
    chain = frame_chain(eef_pos, start, dist_thresh, max_steps)
    if len(chain) < 2:
        return None
    hist, fps_idx, state_mask, eef_mask, n_obj = build_start_state(
        spec, obj_pos, eef_pos, chain, fps_idx=fps_idx)
    T = len(chain) - 1
    gt_seq = np.zeros((T, spec.max_nobj, 3), np.float32)
    for t, f in enumerate(chain[1:]):
        gt_seq[t, :n_obj] = obj_pos[f][fps_idx]
    attrs, p_instance = _inputs(spec, n_obj, eef_pos.shape[1])
    return dict(hist=hist, eef_seq=eef_pos[chain[1:]].astype(np.float32), gt_seq=gt_seq,
                state_mask=state_mask, eef_mask=eef_mask, attrs=attrs, p_instance=p_instance,
                n_obj=n_obj, T=T, chain=chain, fps_idx=fps_idx,
                physics=np.asarray(physics_param, np.float32))


def rollout_pushes_batched(params, spec, gnn_cfg, edge_cfg, pushes):
    """Evaluate prepared pushes (``_prepare_push``'s) as one batch, the
    shorter chains padded with frozen steps to the longest. Returns each
    push's errors (numpy), cut to its own chain length."""
    if not pushes:
        return []
    Tmax = max(p["T"] for p in pushes)

    def pad_t(x, T):
        out = np.zeros((Tmax,) + x.shape[1:], x.dtype)
        out[:T] = x
        out[T:] = x[T - 1]
        return out

    dev = _device(params)

    def stack(xs, dtype=None):
        return torch.as_tensor(np.stack(xs) if dtype is None else np.asarray(xs, dtype), device=dev)

    errors, _ = rollout_scan_batched(
        params, stack([p["hist"] for p in pushes]),
        stack([pad_t(p["eef_seq"], p["T"]) for p in pushes]),
        stack([pad_t(p["gt_seq"], p["T"]) for p in pushes]),
        stack([p["state_mask"] for p in pushes]), stack([p["eef_mask"] for p in pushes]),
        stack([p["attrs"] for p in pushes]), stack([p["p_instance"] for p in pushes]),
        stack([p["physics"] for p in pushes]), stack([p["n_obj"] for p in pushes], np.int32),
        stack([np.arange(Tmax) < p["T"] for p in pushes]),
        float(np.mean(spec.adj_radius_range)), gnn_cfg, edge_cfg)
    errors = errors.cpu().numpy()
    return [errors[i, :p["T"]] for i, p in enumerate(pushes)]


def rollout_dataset(params, spec, gnn_cfg, edge_cfg, prep_dir, phase_ratio=(0.98, 1.0),
                    dist_thresh=0.1, max_steps=100, out_dir=None, save_video=True,
                    keep_prev_fps=False):
    """Evaluate the episodes of the ``phase_ratio`` slice of ``prep_dir``:
    per push where the episode records push boundaries (all pushes in one
    batch), else the whole episode; with ``out_dir``, a pred | gt | both
    video of the first episode (skipped, with a line saying so, where cv2 is
    missing) and ``rollout_errors.npz``. ``keep_prev_fps``: within an
    episode, reuse the first push's FPS indices for every later push.
    Returns the per-step median and IQR over pushes and the per-push
    errors."""
    from adaptigraph_tpu_torch.dynamics.dataset import DynDataset

    ds = DynDataset(prep_dir, spec, phase="valid",
                    ratio={"train": [0, phase_ratio[0]], "valid": list(phase_ratio)})
    all_errors, pushes = [], []
    for ei in range(len(ds.epi_files)):
        epi = ds._episode(ei)
        per_push = "push_bounds" in epi and len(epi["push_bounds"]) > 2
        if per_push:
            pb = epi["push_bounds"]
            epi_fps = None  # the first push's FPS indices, reused with keep_prev_fps
            for p in range(len(pb) - 1):
                b0, b1 = int(pb[p]), int(pb[p + 1])
                if b1 - b0 < 4:
                    continue
                prep = _prepare_push(spec, epi["obj_pos"][b0:b1], epi["eef_pos"][b0:b1],
                                     ds.physics_norm[ei], dist_thresh, max_steps, fps_idx=epi_fps)
                if prep is None:
                    continue
                if keep_prev_fps and epi_fps is None:
                    epi_fps = prep["fps_idx"]
                pushes.append(prep)
        if per_push and not (ei == 0 and out_dir and save_video):
            continue  # the per-push errors are recorded; the video needs episode 0 only
        errors, preds, chain, _ = rollout_episode(
            params, spec, gnn_cfg, edge_cfg, epi["obj_pos"], epi["eef_pos"], ds.physics_norm[ei],
            start=0, dist_thresh=dist_thresh, max_steps=max_steps)
        if ei == 0 and out_dir and save_video and len(errors):
            _save_rollout_video(spec, epi, chain, preds, out_dir)
        if len(errors) and not per_push:
            all_errors.append(errors)
    all_errors.extend(rollout_pushes_batched(params, spec, gnn_cfg, edge_cfg, pushes))
    if not all_errors:
        return {"median": np.zeros(0), "q25": np.zeros(0), "q75": np.zeros(0)}
    L = max(len(e) for e in all_errors)
    padded = np.full((len(all_errors), L), np.nan)
    for i, e in enumerate(all_errors):
        padded[i, :len(e)] = e
    stats = {"median": np.nanmedian(padded, axis=0), "q25": np.nanpercentile(padded, 25, axis=0),
             "q75": np.nanpercentile(padded, 75, axis=0), "per_push": all_errors}
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        # the full (n_pushes, L) error matrix, NaN past each push's end
        np.savez(os.path.join(out_dir, "rollout_errors.npz"), median=stats["median"],
                 q25=stats["q25"], q75=stats["q75"], per_push_padded=padded)
    return stats


def _save_rollout_video(spec, epi, chain, preds, out_dir):
    """The first episode's pred | gt | both video, where cv2 (and, without an
    mp4 codec, imageio) imports; else one line saying it was not written."""
    from adaptigraph_tpu_torch.utils import viz

    n_show = min(spec.max_nobj, epi["obj_pos"].shape[1])
    gt = np.stack([epi["obj_pos"][f][:n_show] for f in chain[1:]])
    intr, extr = viz.topdown_camera(center=tuple(gt[0].mean(axis=0)[[0, 2]]))
    try:
        frames = viz.render_rollout_frames(preds, gt, intr, extr, n_valid=n_show)
        viz.save_video(frames, os.path.join(out_dir, "rollout_ep0.mp4"))
    except ImportError as e:
        print(f"rollout video not written: {e}")
