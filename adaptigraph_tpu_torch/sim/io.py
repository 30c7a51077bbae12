"""Episode h5 I/O (copy of ``adaptigraph_tpu/sim/io.py``).

Schema per push file ``<epi:06d>/<push:02d>.h5``::

    info/{n_cams, timestamp, n_particles}
    action                       (action_dim,)
    positions                    (T, N, 3) float32
    eef_states                   (T, N_eef, 14) float32  [pos(3) prev_pos(3) quat(4) prev_quat(4)]
    observations/color/cam_k     (T, H, W, 3) uint8   [optional]
    observations/depth/cam_k     (T, H, W) uint16     [optional]
    particle_inv_weight_is_0     (T, N, 1) bool       [optional]
    particle_2_instance          (N,) int32           [optional]

Physics properties are stored per episode as ``property_params.json``.
``h5py`` is imported inside the functions that read or write h5, so the
port imports without it; data held in memory never needs it.
"""

import json
import os

import numpy as np


def store_episode_step(filename, positions, eef_states, action, observations=None, inv_weight_is_0=None,
                       particle_2_instance=None):
    import h5py

    with h5py.File(filename, "w") as f:
        f.create_dataset("info/n_cams", data=0 if observations is None else len(observations.get("color", {})))
        f.create_dataset("info/timestamp", data=positions.shape[0])
        f.create_dataset("info/n_particles", data=positions.shape[1])
        f.create_dataset("action", data=np.asarray(action, np.float32))
        f.create_dataset("positions", data=np.asarray(positions, np.float32))
        f.create_dataset("eef_states", data=np.asarray(eef_states, np.float32))
        if observations is not None:
            for kind, cams in observations.items():
                for cam, arr in cams.items():
                    f.create_dataset(f"observations/{kind}/{cam}", data=arr)
        if inv_weight_is_0 is not None:
            f.create_dataset("particle_inv_weight_is_0", data=np.asarray(inv_weight_is_0, bool))
        if particle_2_instance is not None:
            f.create_dataset("particle_2_instance", data=np.asarray(particle_2_instance, np.int32))


def load_episode_step(filename):
    import h5py

    data = {}
    with h5py.File(filename, "r") as f:
        for key in f.keys():
            if key == "observations":
                data[key] = {
                    kind: {cam: f[key][kind][cam][()] for cam in f[key][kind]} for kind in f[key]
                }
            elif key == "info":
                data[key] = {k: f[key][k][()] for k in f[key]}
            else:
                data[key] = f[key][()]
    return data


def store_properties(epi_dir, properties: dict):
    with open(os.path.join(epi_dir, "property_params.json"), "w") as f:
        json.dump({k: (v.tolist() if isinstance(v, np.ndarray) else v) for k, v in properties.items()}, f)


def load_properties(epi_dir):
    with open(os.path.join(epi_dir, "property_params.json")) as f:
        return json.load(f)


def list_episodes(data_dir):
    return sorted(
        f for f in os.listdir(data_dir) if os.path.isdir(os.path.join(data_dir, f)) and f.isdigit()
    )


def list_pushes(epi_dir):
    return sorted(f for f in os.listdir(epi_dir) if f.endswith(".h5"))
