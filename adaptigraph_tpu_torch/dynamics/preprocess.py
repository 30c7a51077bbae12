"""Preprocessing: simulated episodes -> training artifacts (numpy copy of
``adaptigraph_tpu/dynamics/preprocess.py``).

- eef 14-dof states -> 3D keypoints by quaternion-rotating the configured
  offsets;
- frame pairs: for each frame, ``n_his`` frames back and ``n_future``
  forward, spaced by an eef displacement of at least ``dist_thresh``;
- physics parameters, min/max-normalized to [0, 1].

``preprocess`` walks a directory of h5 episodes; ``preprocess_episodes``
takes episodes held in memory (``sim.synthetic.simulate_rope_episode``'s
output) and writes the same ``prep_dir`` files (``episodes/*.npz``,
``physics.npz``, ``meta.json``), without h5.
"""

import os

import numpy as np

from adaptigraph_tpu_torch.dynamics.dataset import save_episode, save_meta, save_physics
from adaptigraph_tpu_torch.sim import io as sim_io
from adaptigraph_tpu_torch.utils.transforms import quat_to_rotmat


def process_eef(eef_states, eef_offsets):
    """(T, N_eef_raw, 14) eef states -> (T, len(eef_offsets), 3) keypoints:
    each offset rotated by the eef quaternion and added to the eef position;
    with fewer raw states than offsets the last raw state is reused."""
    eef_states = np.asarray(eef_states)
    if eef_states.ndim == 2:
        eef_states = eef_states[:, None, :]
    T, n_raw, _ = eef_states.shape
    n_kp = len(eef_offsets)
    out = np.zeros((T, n_kp, 3), np.float32)
    for j in range(n_kp):
        raw_j = min(j, n_raw - 1)
        pos = eef_states[:, raw_j, 0:3]
        quat = eef_states[:, raw_j, 6:10]
        rot = quat_to_rotmat(quat)
        out[:, j] = pos + np.einsum("tij,j->ti", rot, np.asarray(eef_offsets[j], np.float64))
    return out


def extract_frame_pairs(eef_kp, dist_thresh, n_his, n_future, frame_offset=0, store_rest_state=False):
    """For every frame ``fj`` of a push, up to ``n_his`` history frames walking
    back and ``n_future`` future frames walking forward, each spaced by at
    least ``dist_thresh`` of eef displacement, padded by repeating the last
    frame found; indices shifted by ``frame_offset``. With
    ``store_rest_state`` the history is one frame shorter and frame 0 is
    prepended. Returns (n_frames, n_his + n_future) int64."""
    eef = np.asarray(eef_kp)[:, 0]
    T = eef.shape[0]
    rows = []
    for fj in range(T):
        traj = [fj]
        cur = eef[fj]
        fi = fj
        target_hist = n_his - 1 if store_rest_state else n_his
        while fi >= 0 and len(traj) < target_hist:
            if np.linalg.norm(cur - eef[fi]) >= dist_thresh:
                traj.append(fi)
                cur = eef[fi]
            fi -= 1
        traj = traj + [traj[-1]] * (target_hist - len(traj))
        traj = traj[::-1]

        cur = eef[fj]
        fi = fj
        while fi < T and len(traj) < target_hist + n_future:
            if np.linalg.norm(cur - eef[fi]) >= dist_thresh:
                traj.append(fi)
                cur = eef[fi]
            fi += 1
        traj = traj + [traj[-1]] * (target_hist + n_future - len(traj))

        row = np.asarray(traj) + frame_offset
        if store_rest_state:
            row = np.concatenate([[0], row])
        rows.append(row)
    return np.asarray(rows, np.int64)


def physics_params(props, phys_param_specs):
    """(raw, normalized) float32 vectors of the used physics parameters."""
    used = [s for s in phys_param_specs if s["use"]]
    raw = np.array([props[s["name"]] for s in used], np.float32)
    norm = np.array([(props[s["name"]] - s["min"]) / (s["max"] - s["min"] + 1e-6) for s in used],
                    np.float32)
    return raw, norm


def process_episode(path, pushes, eef_offsets, n_his, n_future, dist_thresh,
                    store_rest_state=False, dropped_pushes=()):
    """Write one episode's ``episodes/*.npz`` from its pushes (dicts with
    ``positions``, ``eef_states`` and optionally ``particle_inv_weight_is_0``,
    in push order). Pushes numbered (from 1) in ``dropped_pushes`` keep
    their frames but give no frame pairs."""
    obj_chunks, eef_chunks, pair_chunks = [], [], []
    push_bounds = [0]
    n_frames = 0
    fixed_mask = None
    for push_idx, data in enumerate(pushes, start=1):
        if fixed_mask is None and "particle_inv_weight_is_0" in data:
            fm = np.asarray(data["particle_inv_weight_is_0"])
            fixed_mask = fm.reshape(fm.shape[0], fm.shape[1], -1)[0, :, 0].astype(bool)
        eef_kp = process_eef(data["eef_states"], eef_offsets)
        pairs = extract_frame_pairs(eef_kp, dist_thresh, n_his, n_future, n_frames, store_rest_state)
        obj_chunks.append(data["positions"])
        eef_chunks.append(eef_kp)
        n_frames += len(pairs)
        push_bounds.append(n_frames)
        if push_idx in dropped_pushes:
            continue
        pair_chunks.append(pairs)
    save_episode(
        path,
        np.concatenate(obj_chunks, axis=0),
        np.concatenate(eef_chunks, axis=0),
        np.concatenate(pair_chunks, axis=0) if pair_chunks else np.zeros((0, n_his + n_future), np.int64),
        fixed_mask=fixed_mask,
        push_bounds=push_bounds,
    )


def _write(episodes, prep_dir, eef_offsets, n_his, n_future, dist_thresh, phys_param_specs,
           store_rest_state):
    """episodes: iterable of (name, properties, pushes, dropped push numbers)."""
    os.makedirs(os.path.join(prep_dir, "episodes"), exist_ok=True)
    raw_phys, norm_phys = [], []
    for slot, (_, props, pushes, dropped) in enumerate(episodes):
        raw, norm = physics_params(props, phys_param_specs)
        raw_phys.append(raw)
        norm_phys.append(norm)
        process_episode(os.path.join(prep_dir, "episodes", f"{slot:06d}.npz"), pushes, eef_offsets,
                        n_his, n_future, dist_thresh, store_rest_state, dropped)
    save_physics(prep_dir, np.stack(raw_phys), np.stack(norm_phys))
    save_meta(prep_dir, {"n_his": n_his, "n_future": n_future, "dist_thresh": dist_thresh,
                         "store_rest_state": store_rest_state, "n_episodes": len(raw_phys)})
    return len(raw_phys)


def preprocess(data_dir, prep_dir, eef_offsets, n_his, n_future, dist_thresh,
               phys_param_specs, store_rest_state=False, filter_actions=None):
    """Process every h5 episode under ``data_dir`` into ``prep_dir``.

    phys_param_specs: dicts with keys name/use/min/max (the material
    config's ``physics_params``); filter_actions: optional {episode_name:
    [push_idx, ...]} of pushes to drop."""
    def episodes():
        for epi in sim_io.list_episodes(data_dir):
            epi_dir = os.path.join(data_dir, epi)
            pushes = (sim_io.load_episode_step(os.path.join(epi_dir, f))
                      for f in sim_io.list_pushes(epi_dir))
            dropped = (filter_actions or {}).get(epi, [])
            yield epi, sim_io.load_properties(epi_dir), pushes, dropped

    return _write(episodes(), prep_dir, eef_offsets, n_his, n_future, dist_thresh,
                  phys_param_specs, store_rest_state)


def preprocess_episodes(episodes, prep_dir, eef_offsets, n_his, n_future, dist_thresh,
                        phys_param_specs, store_rest_state=False):
    """``preprocess`` for episodes held in memory: a list of (properties,
    pushes) pairs, as ``sim.synthetic.simulate_rope_dataset`` returns."""
    return _write(((None, props, pushes, ()) for props, pushes in episodes), prep_dir, eef_offsets,
                  n_his, n_future, dist_thresh, phys_param_specs, store_rest_state)
