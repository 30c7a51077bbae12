"""Synthetic rope-pushing data (numpy copy of the rope generator of
``adaptigraph_tpu/sim/synthetic.py``).

A particle chain pushed by a point end-effector: particles inside the pusher
radius are displaced, position-based relaxation re-imposes the segment rest
lengths, and ``stiffness`` in [0, 1] sets how far a deformation propagates.

``simulate_rope_episode`` returns an episode as arrays (no files), so a
dataset can be built and preprocessed in memory; ``gen_rope_episode`` stores
the same episode as h5 push files plus ``property_params.json``, the schema
of ``sim.io``. Both draw from ``rng`` in the JAX package's order, so a seed
gives the JAX generator's episodes.

``cloth_sheet`` is a flat cloth state for planning at the cloth config's
width, where the repository has no cloth data.
"""

import os

import numpy as np

from adaptigraph_tpu_torch.sim import io as sim_io

SYNTH_EEF_OFFSETS = [[0.0, 0.0, 0.0]]
PUSH_LENGTH = 0.1
PUSHER_RADIUS = 0.12


def _relax_rope(pts, rest_len, stiffness, iters=20):
    """Position-based chain relaxation with stiffness-weighted bending."""
    for _ in range(iters):
        d = pts[1:] - pts[:-1]
        dist = np.linalg.norm(d, axis=1, keepdims=True) + 1e-9
        corr = 0.5 * (1.0 - rest_len / dist) * d
        pts[:-1] += corr
        pts[1:] -= corr
        mid = 0.5 * (pts[:-2] + pts[2:])
        pts[1:-1] += (0.12 + 0.5 * stiffness) * 0.5 * (mid - pts[1:-1])
    return pts


def rope_step(pts, eef, delta, stiffness, rest_len):
    """Advance the rope one pusher sub-step."""
    pts = pts.copy()
    new_eef = eef + delta
    rel = pts - new_eef
    rel[:, 1] = 0.0
    dist = np.linalg.norm(rel, axis=1)
    inside = dist < PUSHER_RADIUS
    if inside.any():
        push_dir = rel[inside] / (dist[inside][:, None] + 1e-9)
        pts[inside] += push_dir * (PUSHER_RADIUS - dist[inside])[:, None]
        pts[inside] += delta[None] * 0.3
    pts = _relax_rope(pts, rest_len, stiffness)
    return pts, new_eef


def sample_rope(rng, n_particles=60):
    length = rng.uniform(2.5, 4.0)
    theta = rng.uniform(-np.pi, np.pi)
    center = rng.uniform(-0.5, 0.5, size=2)
    t = np.linspace(-length / 2, length / 2, n_particles)
    pts = np.zeros((n_particles, 3))
    pts[:, 0] = center[0] + t * np.cos(theta)
    pts[:, 2] = center[1] + t * np.sin(theta)
    pts[:, 1] = 0.05
    pts[:, 0] += 0.05 * np.sin(t * 3 + rng.uniform(0, 6))
    pts[:, 2] += 0.05 * np.cos(t * 2 + rng.uniform(0, 6))
    rest_len = length / (n_particles - 1)
    return pts, rest_len


def sample_push(rng, pts):
    """A push start near the rope and a direction through it."""
    i = rng.randint(pts.shape[0])
    target = pts[i, [0, 2]]
    ang = rng.uniform(-np.pi, np.pi)
    start = target + np.array([np.cos(ang), np.sin(ang)]) * rng.uniform(0.3, 0.6)
    direction = target - start
    direction = direction / (np.linalg.norm(direction) + 1e-9)
    n_steps = rng.randint(10, 25)
    return start, direction, n_steps


def simulate_rope_episode(n_pushes, stiffness, rng, n_particles=60, substeps=3):
    """One episode as arrays: ``(properties, pushes)``, where each push is a
    dict of ``positions`` (T, n_particles, 3), ``eef_states`` (T, 1, 14) and
    ``action`` (4,), float32 (the fields of one h5 push file)."""
    pts, rest_len = sample_rope(rng, n_particles)
    pushes = []
    for _ in range(n_pushes):
        start, direction, n_steps = sample_push(rng, pts)
        eef = np.array([start[0], 0.05, start[1]])
        frames_pos, frames_eef = [], []
        step_delta = np.array([direction[0], 0.0, direction[1]]) * (PUSH_LENGTH / substeps)
        for _ in range(n_steps):
            for _ in range(substeps):
                pts, eef = rope_step(pts, eef, step_delta, stiffness, rest_len)
            frames_pos.append(pts.copy())
            eef_state = np.zeros(14, np.float32)
            eef_state[0:3] = eef
            eef_state[6:10] = [0, 0, 0, 1]
            frames_eef.append(eef_state[None])
        action = np.array([start[0], start[1], np.arctan2(direction[1], direction[0]), n_steps],
                          np.float32)
        pushes.append({"positions": np.asarray(frames_pos, np.float32),
                       "eef_states": np.asarray(frames_eef, np.float32),
                       "action": action})
    props = {"stiffness": float(stiffness), "length": float(rest_len * (n_particles - 1)),
             "num_particles": n_particles, "particle_radius": 0.05,
             "thickness": 3.0, "dynamic_friction": 0.3}
    return props, pushes


def gen_rope_episode(epi_dir, n_pushes, stiffness, rng, n_particles=60, substeps=3):
    """Generate one episode: ``n_pushes`` h5 files + property_params.json."""
    os.makedirs(epi_dir, exist_ok=True)
    props, pushes = simulate_rope_episode(n_pushes, stiffness, rng, n_particles, substeps)
    for push, data in enumerate(pushes, start=1):
        sim_io.store_episode_step(os.path.join(epi_dir, f"{push:02d}.h5"), data["positions"],
                                  data["eef_states"], data["action"])
    sim_io.store_properties(epi_dir, props)


def simulate_rope_dataset(n_episodes=8, n_pushes=4, seed=0, n_particles=60):
    """``n_episodes`` episodes of ``simulate_rope_episode``, in memory."""
    rng = np.random.RandomState(seed)
    episodes = []
    for _ in range(n_episodes):
        stiffness = rng.uniform(0.0, 1.0)
        episodes.append(simulate_rope_episode(n_pushes, stiffness, rng, n_particles))
    return episodes


def gen_rope_dataset(out_dir, n_episodes=8, n_pushes=4, seed=0, n_particles=60):
    rng = np.random.RandomState(seed)
    os.makedirs(out_dir, exist_ok=True)
    for e in range(n_episodes):
        stiffness = rng.uniform(0.0, 1.0)
        gen_rope_episode(os.path.join(out_dir, f"{e:06d}"), n_pushes, stiffness, rng, n_particles)
    return out_dir


def cloth_sheet(seed, nx=10, nz=10, spacing=0.3, jitter=0.02):
    """A flat nx x nz sheet of particles (x, 0, z) at ``spacing`` sim units,
    centred on the origin, each moved by ``jitter`` x a normal draw from
    ``numpy.random.RandomState(seed)`` -> (nx * nz, 3) float32."""
    rng = np.random.RandomState(seed)
    x, z = np.meshgrid((np.arange(nx) - (nx - 1) / 2) * spacing,
                       (np.arange(nz) - (nz - 1) / 2) * spacing, indexing="ij")
    sheet = np.stack([x.ravel(), np.zeros(nx * nz), z.ravel()], -1)
    return (sheet + rng.randn(nx * nz, 3) * jitter).astype(np.float32)
