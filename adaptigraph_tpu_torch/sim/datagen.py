"""Data generation: episodes of randomized pushes -> h5 (counterpart
of ``adaptigraph_tpu/sim/datagen.py``; host numpy and the C++ simulator).

Re-implements the reference's data generator (reference:
``src/sim/data_gen/data_gen.py:16-239``): a per-episode worker resets the
env, samples and executes pushes with a validity gate and bounded retries,
and stores one h5 per push plus the episode's physics properties; episodes
fan out over worker processes. The workers are spawned, not forked: the
calling process may hold a CUDA context and loader threads, which a fork
must not copy. Each episode's draws depend only on the base seed and its
index, so the files do not depend on the number of workers. ``simulate``
returns the same episodes in memory, for a host without h5py.
"""

import multiprocessing as mp
import os

import numpy as np

from adaptigraph_tpu_torch.sim import engine
from adaptigraph_tpu_torch.sim import io as sim_io
from adaptigraph_tpu_torch.sim.env import PushEnv

MAX_RETRIES = 10  # reference: data_gen.py:77 retry budget


def simulate_episode(material, n_pushes, seed, capture_depth=False, robot=False):
    """One episode in memory: (properties, pushes, bad, camera parameters or
    None), each push a dict of the fields of its h5 file (``positions``,
    ``eef_states``, ``action``, ``observations``, ``particle_inv_weight_is_0``,
    ``particle_2_instance``). An episode is bad when the simulator produced
    non-finite positions or ``MAX_RETRIES`` sampled actions in a row moved
    nothing; its pushes up to then are kept."""
    env = PushEnv(material, seed=seed, capture_depth=capture_depth, robot=robot)
    env.reset()
    fixed_mask = env.get_fixed_mask()

    pushes = []
    bad = False
    while len(pushes) < n_pushes:
        for _ in range(MAX_RETRIES):
            kind, action = env.sample_action()
            before = env.get_positions()
            positions, eef_states = env.execute_action(kind, action)
            if not np.isfinite(positions).all():
                # a simulator blow-up aborts the episode
                # (reference: flex_env.py:458-460 NaN check)
                bad = True
                break
            if env.push_moved_object(before, positions):
                break
        else:
            bad = True
        if bad:
            break
        pushes.append({
            "positions": positions,
            "eef_states": eef_states,
            "action": action,
            "observations": env.last_observations(),
            "particle_inv_weight_is_0": np.tile(fixed_mask[None, :, None],
                                                (positions.shape[0], 1, 1)),
            "particle_2_instance": env.scene.get_instance(),
        })
    return env.properties, pushes, bad, env.camera_params()


def gen_episode(data_dir, material, epi_idx, n_pushes, seed,
                capture_depth=False, robot=False):
    """One episode into ``data_dir/<epi_idx:06d>`` (``simulate_episode``):
    one h5 file per push, ``property_params.json`` and, with
    ``capture_depth``, ``cameras.npz``. Returns (epi_idx, pushes stored, bad)."""
    epi_dir = os.path.join(data_dir, f"{epi_idx:06d}")
    os.makedirs(epi_dir, exist_ok=True)
    properties, pushes, bad, cams = simulate_episode(material, n_pushes, seed, capture_depth,
                                                     robot)
    for push_idx, push in enumerate(pushes, start=1):
        sim_io.store_episode_step(
            os.path.join(epi_dir, f"{push_idx:02d}.h5"), push["positions"], push["eef_states"],
            push["action"], observations=push["observations"],
            inv_weight_is_0=push["particle_inv_weight_is_0"],
            particle_2_instance=push["particle_2_instance"])
    sim_io.store_properties(epi_dir, properties)
    if cams is not None:
        # per-episode camera parameters (reference: data_gen saves camera npy)
        np.savez(os.path.join(epi_dir, "cameras.npz"), **cams)
    return epi_idx, len(pushes), bad


def _worker(args):
    return gen_episode(*args)


def _simulate_worker(args):
    material, epi_idx, n_pushes, seed = args
    return (epi_idx,) + simulate_episode(material, n_pushes, seed)[:3]


def _pool(n_workers):
    """``n_workers`` spawned processes, each with its share of the host's
    cores as OpenMP threads. Workers that each start a thread per core
    oversubscribe the host, and the simulator's threads spin while they wait
    (two workers on 8 cores ran ~60x slower than one). The share goes in
    ``OMP_NUM_THREADS`` while the workers start: a worker reads it when it
    first loads an OpenMP runtime, which may be while it imports the caller's
    main module, before any initializer would run. Episodes do not depend on
    the thread count, but for bunnybath's: its fluid step gives other
    particles on more than one thread, from run to run, in the JAX package's
    simulator too."""
    old = os.environ.get("OMP_NUM_THREADS")
    os.environ["OMP_NUM_THREADS"] = str(max(1, (os.cpu_count() or 1) // n_workers))
    try:
        return mp.get_context("spawn").Pool(n_workers)
    finally:
        if old is None:
            del os.environ["OMP_NUM_THREADS"]
        else:
            os.environ["OMP_NUM_THREADS"] = old


def _run(fn, jobs, n_workers):
    if n_workers <= 1:
        return [fn(j) for j in jobs]
    engine.build_library()  # once here, not once per worker
    with _pool(n_workers) as pool:
        return pool.map(fn, jobs)


def generate(data_dir, material, n_episodes, n_pushes=5, n_workers=1, seed=0,
             capture_depth=False, robot=False, start_episode=0):
    """Episodes ``start_episode .. start_episode + n_episodes - 1`` into
    ``data_dir`` over ``n_workers`` spawned processes (reference:
    data_gen.py:215-239). Episode ``e`` draws seed ``seed + e*997``, so
    generating [0, 100) then [100, 300) with the same base seed equals one
    [0, 300) run. ``robot=True`` drives every push through the xArm6 IK
    chain with the tool's contact-face collision geometry (reference:
    flex_env.py:308-481). Returns the bad episode indices, which are also
    appended to ``bad_episodes.txt`` (an extending run keeps the base run's
    list)."""
    os.makedirs(data_dir, exist_ok=True)
    results = _run(_worker, [(data_dir, material, e, n_pushes, seed + e * 997, capture_depth, robot)
                             for e in range(start_episode, start_episode + n_episodes)], n_workers)
    bad = [e for e, _, b in results if b]
    if bad:
        with open(os.path.join(data_dir, "bad_episodes.txt"), "a") as f:
            f.write("\n".join(str(b) for b in bad) + "\n")
    return bad


def simulate(material, n_episodes, n_pushes=5, n_workers=1, seed=0):
    """``generate``'s episodes held in memory, with the same seeds and over
    the same worker pool, for a host without h5py: a list of (episode
    index, properties, pushes, bad), pushes as ``simulate_episode`` gives
    them (no camera capture, no robot)."""
    return _run(_simulate_worker, [(material, e, n_pushes, seed + e * 997)
                                   for e in range(n_episodes)], n_workers)
