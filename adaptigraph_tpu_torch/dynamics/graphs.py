"""Host-side assembly of fixed-shape training samples (numpy copy of
``adaptigraph_tpu/dynamics/graphs.py``): FPS downsampling, padding to
``max_nobj``, history/future/action assembly, masks, attrs and physics
parameters. No edges are built here: augmentation and edge construction run
on the device in the train step (``dynamics.train``).
"""

import dataclasses

import numpy as np

from adaptigraph_tpu_torch.ops.fps import fps_downsample


@dataclasses.dataclass(frozen=True)
class GraphSpec:
    """Static dataset geometry (same fields as the JAX ``GraphSpec``)."""

    n_his: int
    n_future: int
    max_nobj: int
    max_neef: int
    fps_radius_range: tuple
    adj_radius_range: tuple
    topk: int
    knn_range: tuple = (1.0, 1.0)
    store_rest_state: bool = False
    phys_dim: int = 1

    @property
    def n_nodes(self):
        return self.max_nobj + self.max_neef


def assemble_sample(spec: GraphSpec, obj_pos, eef_pos, pair, physics_param, rng):
    """Build one fixed-shape (edge-free) training sample.

    obj_pos (T, N_obj_all, 3) and eef_pos (T, N_eef, 3) are the episode's
    frames; pair the (n_his + n_future,) frame indices (one fewer with
    ``store_rest_state``, whose rest frame 0 is implicit); physics_param the
    (phys_dim,) normalized parameters; rng a ``np.random.RandomState``.
    """
    n_his, n_future = spec.n_his, spec.n_future
    N = spec.n_nodes

    frames = list(pair)
    if spec.store_rest_state and len(frames) == n_his - 1 + n_future:
        frames = [0] + frames
    if len(frames) != n_his + n_future:
        raise ValueError(f"pair has {len(frames)} frames, expected {n_his + n_future}")

    obj_kps = obj_pos[frames]
    eef_kps = eef_pos[frames]

    fps_radius = rng.uniform(*spec.fps_radius_range)
    fps_idx = fps_downsample(obj_kps[n_his - 1], spec.max_nobj, fps_radius, rng=rng)
    obj_kp_num = len(fps_idx)

    fps_obj = obj_kps[:, fps_idx]
    fps_obj_pad = np.zeros((len(frames), spec.max_nobj, 3), np.float32)
    fps_obj_pad[:, :obj_kp_num] = fps_obj

    eef_kp_num = eef_kps.shape[1]

    states_delta = np.zeros((N, 3), np.float32)
    states_delta[spec.max_nobj : spec.max_nobj + eef_kp_num] = eef_kps[n_his] - eef_kps[n_his - 1]

    state_history = np.zeros((n_his, N, 3), np.float32)
    state_history[:, : spec.max_nobj] = fps_obj_pad[:n_his]
    state_history[:, spec.max_nobj : spec.max_nobj + eef_kp_num] = eef_kps[:n_his]

    state_future = fps_obj_pad[n_his:]
    eef_future = np.zeros((max(n_future - 1, 1), N, 3), np.float32)
    action_future = np.zeros((max(n_future - 1, 1), N, 3), np.float32)
    for fi in range(n_future - 1):
        lo = spec.max_nobj
        hi = spec.max_nobj + eef_kp_num
        eef_future[fi, lo:hi] = eef_kps[n_his + fi]
        action_future[fi, lo:hi] = eef_kps[n_his + fi + 1] - eef_kps[n_his + fi]

    state_mask = np.zeros(N, bool)
    state_mask[:obj_kp_num] = True
    state_mask[spec.max_nobj : spec.max_nobj + eef_kp_num] = True
    eef_mask = np.zeros(N, bool)
    eef_mask[spec.max_nobj : spec.max_nobj + eef_kp_num] = True
    obj_mask = np.zeros(spec.max_nobj, bool)
    obj_mask[:obj_kp_num] = True

    attrs = np.zeros((N, 2), np.float32)
    attrs[:obj_kp_num, 0] = 1.0
    attrs[spec.max_nobj : spec.max_nobj + eef_kp_num, 1] = 1.0

    p_instance = np.zeros((spec.max_nobj, 1), np.float32)
    p_instance[:obj_kp_num, 0] = 1.0

    adj_thresh = rng.uniform(*spec.adj_radius_range)
    knn_frac = rng.uniform(*spec.knn_range)

    return {
        "state": state_history,  # (n_his, N, 3)
        "action": states_delta,  # (N, 3)
        "eef_future": eef_future,  # (n_future-1, N, 3)
        "action_future": action_future,  # (n_future-1, N, 3)
        "state_future": state_future.astype(np.float32),  # (n_future, max_nobj, 3)
        "attrs": attrs,
        "p_instance": p_instance,
        "state_mask": state_mask,
        "eef_mask": eef_mask,
        "obj_mask": obj_mask,
        "physics_param": np.asarray(physics_param, np.float32).reshape(spec.phys_dim),
        "adj_thresh": np.float32(adj_thresh),
        "knn_frac": np.float32(knn_frac),
    }


def collate(samples):
    """Stack a list of sample dicts into one batch dict."""
    return {k: np.stack([s[k] for s in samples], axis=0) for k in samples[0]}
