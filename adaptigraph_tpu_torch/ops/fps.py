"""Farthest point sampling (counterpart of ``adaptigraph_tpu/ops/fps.py``):
on the host, ``fps_numpy``, ``fps_rad_numpy`` and the two-stage
``fps_downsample`` the data pipeline uses (numpy copies); on the device,
``fps_device``, the JAX ``fps_jax``.
"""

import numpy as np
import torch

# points below this count get a precomputed pairwise squared-distance matrix
# (n=2048 -> 16 MB f32); above it per-pick BLAS matvec updates are used. Both
# compare squared distances in f32.
_DENSE_N = 2048


def _sq_dist_matrix(pcd):
    pcd = np.asarray(pcd, np.float32)
    sq = np.einsum("ij,ij->i", pcd, pcd)
    D = sq[:, None] + sq[None, :] - 2.0 * (pcd @ pcd.T)
    np.maximum(D, 0.0, out=D)
    return D


class _SqDist:
    """Row provider for squared distances: the dense matrix when small, an
    on-demand matvec when large or when only a few rows will be visited."""

    def __init__(self, pcd, expected_rows=None):
        self.pcd = np.asarray(pcd, np.float32)
        self.n = self.pcd.shape[0]
        dense = self.n <= _DENSE_N and (expected_rows is None or expected_rows * 4 >= self.n)
        if dense:
            self.D = _sq_dist_matrix(self.pcd)
            self.sq = None
        else:
            self.D = None
            self.sq = np.einsum("ij,ij->i", self.pcd, self.pcd)

    def row(self, i):
        if self.D is not None:
            return self.D[i]
        d = self.sq + self.sq[i] - 2.0 * (self.pcd @ self.pcd[i])
        np.maximum(d, 0.0, out=d)
        return d


def _random_start(n, rng):
    rng = rng or np.random
    return int(rng.randint(0, n)) if hasattr(rng, "randint") else int(rng.integers(0, n))


def fps_numpy(pcd, num, start_idx=None, rng=None):
    """Greedy farthest-point sampling of ``num`` indices from ``pcd (n, d)``."""
    n = pcd.shape[0]
    num = min(num, n)
    if start_idx is None:
        start_idx = _random_start(n, rng)
    sd = _SqDist(pcd, expected_rows=num)
    idxs = np.empty(num, dtype=np.int64)
    idxs[0] = start_idx
    dist = sd.row(start_idx).copy()
    for i in range(1, num):
        nxt = int(dist.argmax())
        idxs[i] = nxt
        np.minimum(dist, sd.row(nxt), out=dist)
    return idxs


def fps_rad_numpy(pcd, radius, rng=None):
    """Radius-capped FPS: add farthest points until the max distance is at
    most ``radius``. Returns indices."""
    return _fps_rad(_SqDist(pcd), radius, _random_start(pcd.shape[0], rng))


def _fps_rad(sd, radius, start):
    r2 = float(radius) * float(radius)
    idxs = [start]
    dist = sd.row(start).copy()
    while dist.max() > r2:
        nxt = int(dist.argmax())
        idxs.append(nxt)
        np.minimum(dist, sd.row(nxt), out=dist)
    return np.asarray(idxs, dtype=np.int64)


def fps_downsample(pcd, max_num, radius, rng=None, start_idx=None):
    """FPS to ``max_num`` points, then radius-dedup the result. Returns
    indices into ``pcd``. When ``max_num >= n`` the two stages are one loop
    that stops at the radius cut (FPS is prefix-closed)."""
    n = np.asarray(pcd).shape[0]
    if max_num >= n:
        if start_idx is None:
            start_idx = _random_start(n, rng)
        sd = _SqDist(pcd)
        r2 = float(radius) * float(radius)
        idxs = [start_idx]
        dist = sd.row(start_idx).copy()
        while len(idxs) < n and dist.max() > r2:
            nxt = int(dist.argmax())
            idxs.append(nxt)
            np.minimum(dist, sd.row(nxt), out=dist)
        return np.asarray(idxs, dtype=np.int64)
    idx1 = fps_numpy(pcd, max_num, start_idx=start_idx, rng=rng)
    # deterministic start for stage 2 keeps the first FPS point first
    idx2 = fps_rad_numpy_from(np.asarray(pcd)[idx1], radius, start=0)
    return idx1[idx2]


def fps_rad_numpy_from(pcd, radius, start=0):
    """Radius-capped FPS from a given start index."""
    return _fps_rad(_SqDist(pcd), radius, start)


def fps_device(pcd, mask, num, start_idx=0):
    """FPS on the points' device returning exactly ``num`` indices (repeated
    when fewer than ``num`` points are valid) and their validity (the JAX
    ``fps_jax``): from ``start_idx``, each pick is the valid point farthest
    (euclidean) from those picked, ties to the smallest index.

    pcd (n, d) float; mask (n,) bool. Returns idxs (num,) int32 and valid
    (num,) bool, False for the slots past the number of valid points. A
    loop of ``num - 1`` small kernels, with no host read."""
    neg = torch.tensor(-float("inf"), dtype=pcd.dtype, device=pcd.device)

    def dist_to(i):
        return torch.where(mask, torch.linalg.norm(pcd - pcd[i], dim=1), neg)

    start = torch.as_tensor(start_idx, dtype=torch.int64, device=pcd.device)
    dist = dist_to(start)
    idxs = [start]
    for _ in range(1, num):
        nxt = torch.argmax(dist)  # the first of equal maxima, as jnp.argmax
        idxs.append(nxt)
        dist = torch.minimum(dist, dist_to(nxt))
    idxs = torch.stack(idxs).to(torch.int32)
    valid = torch.arange(num, device=pcd.device) < mask.sum()
    return idxs, valid
