"""Sim-data quality filter: flag pushes with simulator artifacts
(counterpart of ``adaptigraph_tpu/sim/filter.py``; ``scan_pushes`` and
``flag_episodes`` take episodes held in memory, as ``sim.datagen.simulate``
gives them).

Plays the role of the reference's ``filter_sim_data.py`` (reference:
``src/dynamics/preprocess/filter_sim_data.py:46-98``), which flags a push
when the max per-particle displacement of its penultimate frame from the
episode rest state exceeds a threshold (particles stuck to the tool, solver
blow-ups). Two more gates: non-finite positions and a velocity spike (the
largest single-frame displacement). The json it writes is what
``preprocess(filter_actions=...)`` reads, through ``load_filter_file``.
"""

import json
import os

import numpy as np

from adaptigraph_tpu_torch.sim import io as sim_io


def scan_pushes(positions, drift_thresh=1.0, spike_thresh=0.5):
    """Flag suspicious pushes of one episode from each push's (T, N, 3)
    positions, in push order. Returns {push_idx: reason} (1-based push
    indices, matching the preprocess filter convention)."""
    flags = {}
    if not positions:
        return flags
    rest = positions[0][0]
    for idx, pos in enumerate(positions, start=1):
        if not np.isfinite(pos).all():
            flags[idx] = "non-finite positions"
            continue
        # max drift of the penultimate frame from rest (filter_sim_data.py:79)
        if len(pos) >= 2:
            drift = float(np.max(np.abs(pos[-2] - rest)))
            if drift > drift_thresh:
                flags[idx] = f"drift {drift:.3f} > {drift_thresh}"
                continue
        # single-frame velocity spike
        if len(pos) >= 2:
            spike = float(np.max(np.linalg.norm(np.diff(pos, axis=0), axis=-1)))
            if spike > spike_thresh:
                flags[idx] = f"frame-to-frame spike {spike:.3f} > {spike_thresh}"
    return flags


def _positions(epi_dir):
    return [sim_io.load_episode_step(os.path.join(epi_dir, f))["positions"]
            for f in sim_io.list_pushes(epi_dir)]


def scan_episode(epi_dir, drift_thresh=1.0, spike_thresh=0.5):
    """``scan_pushes`` on the h5 pushes of one episode directory."""
    return scan_pushes(_positions(epi_dir), drift_thresh, spike_thresh)


def flag_episodes(episodes, drift_thresh=1.0, spike_thresh=0.5):
    """{episode name: sorted flagged push indices} for the episodes that
    have any, from (name, [positions of each push]) pairs."""
    result = {}
    for name, positions in episodes:
        flags = scan_pushes(positions, drift_thresh, spike_thresh)
        if flags:
            result[name] = sorted(flags)
    return result


def filter_dataset(data_dir, out_file=None, drift_thresh=1.0, spike_thresh=0.5):
    """Scan all episodes; write a json filter file consumable by
    ``preprocess(filter_actions=...)``. Returns {episode_name: [push_idx]}."""
    result = flag_episodes(((epi, _positions(os.path.join(data_dir, epi)))
                            for epi in sim_io.list_episodes(data_dir)), drift_thresh, spike_thresh)
    out_file = out_file or os.path.join(data_dir, "filter_artifacts.json")
    with open(out_file, "w") as f:
        json.dump({k: list(v) for k, v in result.items()}, f, indent=1)
    return result


def load_filter_file(path):
    """Filter file -> {episode: [push_idx]} for preprocess."""
    with open(path) as f:
        return {k: list(v) for k, v in json.load(f).items()}
