"""Datasets and batch loading for dynamics training (numpy copy of
``adaptigraph_tpu/dynamics/dataset.py``).

On-disk layout written by ``dynamics.preprocess``::

    <prep_dir>/
        episodes/<epi:06d>.npz    # obj_pos (T,No,3), eef_pos (T,Ne,3),
                                  # pairs (P, n_his+n_future), fixed_mask opt.
        physics.npz               # raw (n_epis, phys_dim) + normalized
        meta.json                 # n_his/n_future/dist_thresh

The train/valid split is by episode ratio.
"""

import json
import os
import queue
import threading

import numpy as np

from adaptigraph_tpu_torch.dynamics.graphs import GraphSpec, assemble_sample, collate


def spec_from_config(config):
    dc = config["dataset_config"]
    ds = dc["datasets"][0]
    matc = config["material_config"]
    material = dc["materials"][0]
    phys_dim = sum(1 for p in matc[material]["physics_params"] if p["use"])
    return GraphSpec(
        n_his=dc["n_his"],
        n_future=dc["n_future"],
        max_nobj=ds["max_nobj"],
        max_neef=dc["eef"]["max_neef"],
        fps_radius_range=tuple(ds["fps_radius_range"]),
        adj_radius_range=tuple(ds["adj_radius_range"]),
        topk=ds["topk"],
        knn_range=tuple(ds.get("knn_range", [1.0, 1.0])),
        store_rest_state=dc.get("store_rest_state", False),
        phys_dim=phys_dim,
    )


class DynDataset:
    """Index over (episode, frame-pair) samples for one phase."""

    def __init__(self, prep_dir, spec: GraphSpec, phase="train", ratio=None):
        if phase not in ("train", "valid"):
            raise ValueError(f"phase must be train or valid, got {phase!r}")
        self.spec = spec
        self.phase = phase
        self.prep_dir = prep_dir

        epi_dir = os.path.join(prep_dir, "episodes")
        epi_files = sorted(f for f in os.listdir(epi_dir) if f.endswith(".npz"))
        n_epis = len(epi_files)
        ratio = ratio or {"train": [0, 0.98], "valid": [0.98, 1]}
        lo = int(n_epis * ratio[phase][0])
        hi = int(n_epis * ratio[phase][1])
        self.epi_files = [os.path.join(epi_dir, f) for f in epi_files[lo:hi]]

        with np.load(os.path.join(prep_dir, "physics.npz")) as phys:
            self.physics_norm = phys["normalized"][lo:hi]

        self._episodes = []
        self.index = []
        for ei, f in enumerate(self.epi_files):
            with np.load(f) as z:
                n_pairs = len(z["pairs"])
            self._episodes.append(None)  # lazy cache
            self.index += [(ei, pi) for pi in range(n_pairs)]
        self._lock = threading.Lock()

    def __len__(self):
        return len(self.index)

    # picklable for loader worker processes: drop the lock and the episode
    # cache (each worker reads its own episodes)
    def __getstate__(self):
        state = self.__dict__.copy()
        state["_lock"] = None
        state["_episodes"] = [None] * len(self._episodes)
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        self._lock = threading.Lock()

    def _episode(self, ei):
        with self._lock:
            if self._episodes[ei] is None:
                with np.load(self.epi_files[ei]) as z:
                    self._episodes[ei] = {k: z[k] for k in z.files}
            return self._episodes[ei]

    def sample(self, idx, rng):
        ei, pi = self.index[idx]
        epi = self._episode(ei)
        return assemble_sample(self.spec, epi["obj_pos"], epi["eef_pos"], epi["pairs"][pi],
                               self.physics_norm[ei], rng)


class PackedDataset:
    """Vectorized batch assembly over episodes packed into padded arrays.

    Episodes are packed once into ``(E, maxT, maxN, 3)`` arrays, so a batch
    is a handful of fancy-indexing gathers, and FPS indices are precomputed
    per (sample, variant) with independently drawn starts and radii.
    ``make_batch`` returns ``assemble_sample``'s dict, batched; with
    ``compact=True`` it ships eef keypoints and ``obj_mask`` in place of the
    full-node arrays derived from them (``dynamics.train.expand_compact_batch``
    rebuilds them on the device).
    """

    def __init__(self, prep_dir, spec: GraphSpec, phase="train", ratio=None,
                 seed=0, n_fps_variants=4, compact=False):
        from adaptigraph_tpu_torch.ops.fps import fps_downsample

        self.spec = spec
        self.compact = compact
        base = DynDataset(prep_dir, spec, phase=phase, ratio=ratio)
        self.n_samples = len(base)

        n_his, n_future = spec.n_his, spec.n_future
        Tp = n_his + n_future

        epis = [base._episode(ei) for ei in range(len(base.epi_files))]
        maxT = max(e["obj_pos"].shape[0] for e in epis)
        maxN = max(e["obj_pos"].shape[1] for e in epis)
        n_eef = epis[0]["eef_pos"].shape[1]
        E = len(epis)
        self.obj_pos = np.zeros((E, maxT, maxN, 3), np.float32)
        self.eef_pos = np.zeros((E, maxT, n_eef, 3), np.float32)
        self.n_obj = np.zeros(E, np.int32)
        for ei, e in enumerate(epis):
            T, N = e["obj_pos"].shape[:2]
            self.obj_pos[ei, :T, :N] = e["obj_pos"]
            self.eef_pos[ei, :T] = e["eef_pos"]
            self.n_obj[ei] = N

        self.sample_ei = np.zeros(self.n_samples, np.int32)
        self.frames = np.zeros((self.n_samples, Tp), np.int32)
        for si, (ei, pi) in enumerate(base.index):
            pair = list(epis[ei]["pairs"][pi])
            if spec.store_rest_state and len(pair) == n_his - 1 + n_future:
                pair = [0] + pair
            if len(pair) != Tp:
                raise ValueError(f"frame pair of {len(pair)} frames, expected {Tp}")
            self.sample_ei[si] = ei
            self.frames[si] = pair
        self.physics_norm = base.physics_norm

        rng = np.random.RandomState(seed + 1)
        V = n_fps_variants
        self.fps_idx = np.zeros((self.n_samples, V, spec.max_nobj), np.int64)
        self.fps_cnt = np.zeros((self.n_samples, V), np.int32)
        for si in range(self.n_samples):
            ei = self.sample_ei[si]
            cur = self.obj_pos[ei, self.frames[si, n_his - 1], : self.n_obj[ei]]
            for v in range(V):
                r = rng.uniform(*spec.fps_radius_range)
                idx = fps_downsample(cur, spec.max_nobj, r, rng=rng)
                self.fps_idx[si, v, : len(idx)] = idx
                self.fps_cnt[si, v] = len(idx)

    def __len__(self):
        return self.n_samples

    def make_batch(self, idxs, rng):
        """A whole batch by vectorized gathers (``assemble_sample`` for every
        sample in ``idxs``)."""
        spec = self.spec
        n_his, n_future = spec.n_his, spec.n_future
        B = len(idxs)
        No, Ne, N = spec.max_nobj, self.eef_pos.shape[2], spec.n_nodes

        ei = self.sample_ei[idxs]
        fr = self.frames[idxs]
        vi = rng.randint(0, self.fps_idx.shape[1], size=B)
        fidx = self.fps_idx[idxs, vi]
        cnt = self.fps_cnt[idxs, vi]

        obj = self.obj_pos[ei[:, None, None], fr[:, :, None], fidx[:, None, :]]
        valid = (np.arange(No)[None] < cnt[:, None])
        obj *= valid[:, None, :, None]
        eef = self.eef_pos[ei[:, None], fr]

        state = np.zeros((B, n_his, N, 3), np.float32)
        state[:, :, :No] = obj[:, :n_his]
        state[:, :, No:] = eef[:, :n_his]

        nf1 = max(n_future - 1, 1)
        if self.compact:
            eef_future_kp = np.zeros((B, nf1, Ne, 3), np.float32)
            action_future_kp = np.zeros((B, nf1, Ne, 3), np.float32)
            if n_future > 1:
                eef_future_kp[:, : n_future - 1] = eef[:, n_his : n_his + n_future - 1]
                action_future_kp[:, : n_future - 1] = (
                    eef[:, n_his + 1 : n_his + n_future] - eef[:, n_his : n_his + n_future - 1])
            return {
                "state": state,
                "action_eef": (eef[:, n_his] - eef[:, n_his - 1]).astype(np.float32),
                "eef_future_kp": eef_future_kp,
                "action_future_kp": action_future_kp,
                "state_future": obj[:, n_his:],
                "obj_mask": valid,
                "physics_param": self.physics_norm[ei].reshape(B, spec.phys_dim),
                "adj_thresh": rng.uniform(*spec.adj_radius_range, size=B).astype(np.float32),
                "knn_frac": rng.uniform(*spec.knn_range, size=B).astype(np.float32),
            }

        action = np.zeros((B, N, 3), np.float32)
        action[:, No:] = eef[:, n_his] - eef[:, n_his - 1]

        eef_future = np.zeros((B, nf1, N, 3), np.float32)
        action_future = np.zeros((B, nf1, N, 3), np.float32)
        if n_future > 1:
            eef_future[:, : n_future - 1, No:] = eef[:, n_his : n_his + n_future - 1]
            action_future[:, : n_future - 1, No:] = (
                eef[:, n_his + 1 : n_his + n_future] - eef[:, n_his : n_his + n_future - 1])

        state_mask = np.zeros((B, N), bool)
        state_mask[:, :No] = valid
        state_mask[:, No:] = True
        eef_mask = np.zeros((B, N), bool)
        eef_mask[:, No:] = True

        attrs = np.zeros((B, N, 2), np.float32)
        attrs[:, :No, 0] = valid
        attrs[:, No:, 1] = 1.0

        return {
            "state": state,
            "action": action,
            "eef_future": eef_future,
            "action_future": action_future,
            "state_future": obj[:, n_his:],
            "attrs": attrs,
            "p_instance": valid[:, :, None].astype(np.float32),
            "state_mask": state_mask,
            "eef_mask": eef_mask,
            "obj_mask": valid,
            "physics_param": self.physics_norm[ei].reshape(B, spec.phys_dim),
            "adj_thresh": rng.uniform(*spec.adj_radius_range, size=B).astype(np.float32),
            "knn_frac": rng.uniform(*spec.knn_range, size=B).astype(np.float32),
        }


def _assemble_batch(dataset, batch_size, stack, rng):
    """One (super)batch: ``PackedDataset`` by vectorized gathers,
    ``DynDataset`` sample by sample. ``stack > 1`` returns ``(stack,
    batch_size, ...)`` arrays."""
    if hasattr(dataset, "make_batch"):
        if stack == 1:
            return dataset.make_batch(rng.randint(0, len(dataset), size=batch_size), rng)
        parts = [dataset.make_batch(rng.randint(0, len(dataset), size=batch_size), rng)
                 for _ in range(stack)]
        return {k: np.stack([p[k] for p in parts]) for k in parts[0]}
    batch = collate([dataset.sample(int(i), rng)
                     for i in rng.randint(0, len(dataset), size=batch_size * stack)])
    if stack > 1:
        batch = {k: v.reshape((stack, batch_size) + v.shape[1:]) for k, v in batch.items()}
    return batch


def _mp_loader_worker(dataset, batch_size, stack, seed, q, stop):
    rng = np.random.RandomState(seed)
    while not stop.is_set():
        try:
            batch = _assemble_batch(dataset, batch_size, stack, rng)
        except Exception:  # reported to the consumer, which raises it
            import traceback

            q.put({"__loader_error__": traceback.format_exc()})
            return
        while not stop.is_set():
            try:
                q.put(batch, timeout=1.0)
                break
            except queue.Full:
                continue


class BatchLoader:
    """Infinite shuffled batch iterator.

    ``num_workers=0`` assembles batches in one background thread;
    ``num_workers>=1`` starts that many worker processes, each sampling with
    its own seed. ``stack_steps`` > 1 yields ``(stack_steps, batch_size,
    ...)`` superbatches."""

    def __init__(self, dataset, batch_size, seed=0, prefetch=2,
                 num_workers=0, mp_context="spawn", stack_steps=1):
        self.ds = dataset
        self.batch_size = batch_size
        self.stack_steps = stack_steps
        self.rng = np.random.RandomState(seed)
        self._procs = []
        self._error = None
        if num_workers >= 1:
            import multiprocessing as mp

            ctx = mp.get_context(mp_context)
            self._q = ctx.Queue(maxsize=max(prefetch, 2 * num_workers))
            self._stop = ctx.Event()
            for w in range(num_workers):
                p = ctx.Process(
                    target=_mp_loader_worker,
                    args=(dataset, batch_size, stack_steps, seed + 7919 * w, self._q, self._stop),
                    daemon=True,
                )
                p.start()
                self._procs.append(p)
        else:
            self._q = queue.Queue(maxsize=prefetch)
            self._stop = threading.Event()
            self._thread = threading.Thread(target=self._worker, daemon=True)
            self._thread.start()

    def _make_batch(self):
        return _assemble_batch(self.ds, self.batch_size, self.stack_steps, self.rng)

    def _worker(self):
        while not self._stop.is_set():
            try:
                batch = self._make_batch()
            except Exception:  # reported to the consumer, which raises it
                import traceback

                batch = {"__loader_error__": traceback.format_exc()}
            while not self._stop.is_set():
                try:
                    self._q.put(batch, timeout=1.0)
                    break
                except queue.Full:
                    continue
            if "__loader_error__" in batch:
                return

    def __iter__(self):
        return self

    def __next__(self):
        batch = self._q.get()
        if isinstance(batch, dict) and "__loader_error__" in batch:
            raise RuntimeError("batch-assembly worker failed:\n" + batch["__loader_error__"])
        return batch

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        for p in self._procs:
            p.join(timeout=2.0)
            if p.is_alive():
                p.terminate()
        if not self._procs:
            self._thread.join(timeout=2.0)


def save_episode(path, obj_pos, eef_pos, pairs, fixed_mask=None, push_bounds=None):
    data = dict(
        obj_pos=obj_pos.astype(np.float32),
        eef_pos=eef_pos.astype(np.float32),
        pairs=np.asarray(pairs, np.int32),
    )
    if fixed_mask is not None:
        data["fixed_mask"] = fixed_mask.astype(bool)
    if push_bounds is not None:
        # push p spans frames [push_bounds[p], push_bounds[p+1])
        data["push_bounds"] = np.asarray(push_bounds, np.int32)
    np.savez_compressed(path, **data)


def save_physics(prep_dir, raw, normalized):
    np.savez(
        os.path.join(prep_dir, "physics.npz"),
        raw=np.asarray(raw, np.float32),
        normalized=np.asarray(normalized, np.float32),
    )


def save_meta(prep_dir, meta: dict):
    with open(os.path.join(prep_dir, "meta.json"), "w") as f:
        json.dump(meta, f)
