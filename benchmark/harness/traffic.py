"""The one generator of the benchmark's inputs. It reads a traffic mix's
parameters and the cell's configuration and makes, from the run's seed,
the scenes of a solve cell or the compact training batches of a train
cell, on the host, as numpy arrays. It never calls the port (its
simulator included), so a change to the program cannot move the inputs.
"""

import glob
import os

import numpy as np


def host_rng(seed, stream):
    """A numpy generator for one use (``stream``) of the run's seed; any
    whole number, negative or past 64 bits included, gives a valid one."""
    return np.random.default_rng([int(seed) % (1 << 64), stream])


def recorded_states(traffic, root):
    """Every recorded object state the mix names: the arrays ``keys`` of the
    files matching ``files`` (a glob from the root of the checkout)."""
    out = []
    for path in sorted(glob.glob(os.path.join(root, traffic["files"]))):
        with np.load(path) as z:
            out += [z[k].astype(np.float32) for k in traffic["keys"]]
    if not out:
        raise FileNotFoundError(f"no recorded states match {traffic['files']!r} under {root}")
    return out


def solve_scenes(traffic, m, root, rng):
    """``traffic["pool"]`` scenes: a recorded state resampled into the
    object slots (every recorded point once, then repeats, in a shuffled
    order), the target (the whole recorded state moved by a planar offset
    uniform in +-``target_offset``) and a physics parameter uniform in
    ``phys_range``. Returns a list of (state (n_p, 3), target (M, 3),
    phys (phys_dim,))."""
    states = recorded_states(traffic, root)
    n_p = m["max_nobj"]
    scenes = []
    for _ in range(traffic["pool"]):
        s = states[rng.integers(len(states))]
        idx = rng.permutation(len(s))
        if len(s) < n_p:
            idx = np.concatenate([idx, rng.integers(0, len(s), n_p - len(s))])
        state = s[idx[:n_p]]
        off = rng.uniform(-1.0, 1.0, 3) * traffic["target_offset"]
        off[1] = 0.0
        target = (s + off).astype(np.float32)
        phys = rng.uniform(*traffic["phys_range"], m["phys_dim"]).astype(np.float32)
        scenes.append((np.ascontiguousarray(state), target, phys))
    return scenes


def _common(batch, B, m, dynamics, rng):
    ds = dynamics["dataset_config"]["datasets"][0]
    batch["physics_param"] = rng.random((B, m["phys_dim"]), dtype=np.float32)
    batch["adj_thresh"] = rng.uniform(*ds["adj_radius_range"], size=B).astype(np.float32)
    batch["knn_frac"] = rng.uniform(*ds.get("knn_range", [1.0, 1.0]), size=B).astype(np.float32)
    return batch


def _compact(obj, tool, n_obj, m, n_future):
    """The compact batch of ``obj`` (B, F, n_p, 3) and ``tool`` (B, F, n_eef, 3)
    frames, the first n_his the history."""
    B, F = obj.shape[:2]
    n_his, n_p = F - n_future, m["max_nobj"]
    nf1 = max(n_future - 1, 1)
    state = np.concatenate([obj[:, :n_his], tool[:, :n_his]], axis=2)
    eef_kp = np.zeros((B, nf1, tool.shape[2], 3), np.float32)
    act_kp = np.zeros_like(eef_kp)
    if n_future > 1:
        eef_kp[:, :n_future - 1] = tool[:, n_his:n_his + n_future - 1]
        act_kp[:, :n_future - 1] = tool[:, n_his + 1:] - tool[:, n_his:F - 1]
    return {"state": np.ascontiguousarray(state, np.float32),
            "action_eef": np.ascontiguousarray(tool[:, n_his] - tool[:, n_his - 1], np.float32),
            "eef_future_kp": eef_kp, "action_future_kp": act_kp,
            "state_future": np.ascontiguousarray(obj[:, n_his:], np.float32),
            "obj_mask": np.arange(n_p)[None] < n_obj[:, None]}


def fixture_rows(traffic, m, dynamics, root, rng, B):
    """Rows at a recorded interaction's density: the recorded points (one
    interaction a row, drawn) as an n_his-frame history with per-frame noise,
    n_future frames moving ``future_step`` of the way a frame toward the
    state recorded after the push, and the pusher rows beside them moving
    ``tool_step`` a frame."""
    pairs = []
    for path in sorted(glob.glob(os.path.join(root, traffic["files"]))):
        with np.load(path) as z:
            pairs.append((z[traffic["keys"][0]].astype(np.float32),
                          z[traffic["keys"][1]].astype(np.float32)))
    n_his, n_future = m["n_his"], dynamics["dataset_config"]["n_future"]
    n_p, n_t, F = m["max_nobj"], m["max_neef"], m["n_his"] + n_future
    frac = np.r_[np.zeros(n_his), np.arange(1, n_future + 1) * traffic["future_step"]]
    obj = np.zeros((B, F, n_p, 3), np.float32)
    tool = np.zeros((B, F, n_t, 3), np.float32)
    pick = rng.integers(len(pairs), size=B)
    n_obj = np.array([len(pairs[p][0]) for p in pick])
    step = np.array(traffic["tool_step"], np.float32)
    for p, (s0, s1) in enumerate(pairs):
        rows = np.nonzero(pick == p)[0]
        n = len(s0)
        obj[rows, :, :n] = (s0 + frac[:, None, None] * (s1 - s0)
                            + rng.standard_normal((len(rows), F, n, 3)) * traffic["noise"])
        base = s0.mean(0) + np.stack([np.linspace(-0.2, 0.2, n_t), np.zeros(n_t),
                                      np.full(n_t, traffic["tool_depth"])], -1)
        tool[rows] = base + np.arange(F)[:, None, None] * step
    return _common(_compact(obj, tool, n_obj, m, n_future), B, m, dynamics, rng)


def block_rows(traffic, m, dynamics, root, rng, B):
    """Soft blocks pushed by a flat pusher: per row a lattice of nx x ny x nz
    particles (ranges ``lattice``) at a spacing in ``spacing``, at most n_p
    of them kept (a random subset: the dataset's farthest-point sampling at
    a radius below the spacing keeps every point up to the budget), turned
    about the vertical axis; frame 0 is the block at rest, then the pusher's
    row of ``eef_offsets`` starts ``gap`` from the block's face and moves
    ``push`` a frame into it, the particles near the face following with a
    depth decay of ``decay``, plus per-frame noise."""
    n_his, n_future = m["n_his"], dynamics["dataset_config"]["n_future"]
    n_p, F = m["max_nobj"], n_his + n_future
    offsets = np.array([p[0] for p in dynamics["dataset_config"]["eef"]["pos"]], np.float32)
    n_t = len(offsets)
    obj = np.zeros((B, F, n_p, 3), np.float32)
    tool = np.zeros((B, F, n_t, 3), np.float32)
    n_obj = np.zeros(B, np.int64)
    lo, hi = traffic["lattice"]
    t = np.arange(F, dtype=np.float32)
    for b in range(B):
        nx, ny, nz = (int(rng.integers(l, h + 1)) for l, h in zip(lo, hi))
        sp = rng.uniform(*traffic["spacing"])
        grid = np.stack(np.meshgrid(np.arange(nx), np.arange(ny), np.arange(nz), indexing="ij"),
                        -1).reshape(-1, 3).astype(np.float32) * sp
        grid -= grid.mean(0)
        grid[:, 1] -= grid[:, 1].min()
        keep = rng.permutation(len(grid))[:n_p]
        p = grid[keep]
        n = len(p)
        n_obj[b] = n
        z0 = p[:, 2].min()
        depth = np.maximum(0.0, t * traffic["push"] - traffic["gap"])  # pusher past the face
        follow = np.exp(-(p[:, 2] - z0) / traffic["decay"]) * (np.abs(p[:, 0]) < offsets.max() + sp)
        frames = p[None].repeat(F, 0)
        frames[:, :, 2] += depth[:, None] * follow[None]
        frames += rng.standard_normal(frames.shape).astype(np.float32) * traffic["noise"]
        frames[0] = p  # the rest state
        pusher = np.stack([offsets, np.full(n_t, p[:, 1].mean()), np.full(n_t, z0 - traffic["gap"])],
                          -1)
        tframes = pusher[None].repeat(F, 0)
        tframes[:, :, 2] += t[:, None] * traffic["push"]
        yaw = rng.uniform(-np.pi, np.pi)
        c, s = np.cos(yaw), np.sin(yaw)
        rot = np.array([[c, 0, -s], [0, 1, 0], [s, 0, c]], np.float32)
        shift = np.array([rng.uniform(-1, 1), 0.0, rng.uniform(-1, 1)], np.float32)
        obj[b, :, :n] = frames @ rot + shift
        tool[b] = tframes @ rot + shift
    return _common(_compact(obj, tool, n_obj, m, n_future), B, m, dynamics, rng)


ROWS = {"fixture": fixture_rows, "block": block_rows}


def train_rows(traffic, m, dynamics, root, rng, B):
    """B rows of the mix's ``rows`` kind, as one compact batch."""
    return ROWS[traffic["rows"]](traffic, m, dynamics, root, rng, B)


def stack(batches):
    """Superbatch (K, B, ...) of K compact batches."""
    return {k: np.stack([b[k] for b in batches]) for k in batches[0]}
