"""Mesh geometry: OBJ parsing, solid voxelization, closest-point queries
and signed distance fields (copy of ``adaptigraph_tpu/sim/meshutil.py``).

Plays the role of the reference's compiled ``PyFleX/core`` geometry tier
(mesh loading, voxelize, SDF), which FleX scenes use to fill meshes with
particles: an OBJ reader, a ray-parity solid voxelizer whose particle
centers seed ``XPBDScene.from_points`` soft bodies, an AABB tree with exact
closest-point queries (``core/aabbtree.cpp``'s role) and a grid
signed distance field (``core/sdf.cpp``'s CreateSDF).
"""

import numpy as np


def load_obj(path):
    """Minimal OBJ: returns (verts (V, 3) float32, faces (F, 3) int32).
    Polygons are fan-triangulated."""
    verts, faces = [], []
    with open(path) as f:
        for line in f:
            if line.startswith("v "):
                verts.append([float(x) for x in line.split()[1:4]])
            elif line.startswith("f "):
                idx = [int(tok.split("/")[0]) - 1 for tok in line.split()[1:]]
                for k in range(1, len(idx) - 1):
                    faces.append([idx[0], idx[k], idx[k + 1]])
    return np.asarray(verts, np.float32), np.asarray(faces, np.int32)


def _ray_tri_intersections(origins, direction, verts, faces, eps=1e-9):
    """Count ray/triangle crossings per origin (Moller-Trumbore, vectorized
    over origins x triangles). direction: (3,). Returns (N,) int counts."""
    v0 = verts[faces[:, 0]]
    e1 = verts[faces[:, 1]] - v0
    e2 = verts[faces[:, 2]] - v0
    d = np.asarray(direction, np.float64)
    pvec = np.cross(d, e2)  # (F, 3)
    det = np.einsum("fj,fj->f", e1, pvec)
    ok = np.abs(det) > eps
    inv_det = np.where(ok, 1.0 / np.where(ok, det, 1.0), 0.0)

    counts = np.zeros(len(origins), np.int64)
    for i, o in enumerate(origins):
        tvec = o - v0
        u = np.einsum("fj,fj->f", tvec, pvec) * inv_det
        qvec = np.cross(tvec, e1)
        v = np.einsum("j,fj->f", d, qvec) * inv_det
        t = np.einsum("fj,fj->f", e2, qvec) * inv_det
        hit = ok & (u >= 0) & (v >= 0) & (u + v <= 1) & (t > eps)
        counts[i] = int(np.count_nonzero(hit))
    return counts


def voxelize(verts, faces, spacing, jitter=0.0, rng=None):
    """Solid voxelization: particle centers on a ``spacing`` grid whose
    centers are inside the closed mesh (odd ray-crossing parity along +x,
    the reference core/voxelize semantics). Returns (N, 3) float32."""
    verts = np.asarray(verts, np.float64)
    lo = verts.min(axis=0)
    hi = verts.max(axis=0)
    axes = [np.arange(lo[d] + spacing / 2, hi[d], spacing) for d in range(3)]
    if any(len(a) == 0 for a in axes):
        return np.zeros((0, 3), np.float32)
    grid = np.stack(np.meshgrid(*axes, indexing="ij"), axis=-1).reshape(-1, 3)
    counts = _ray_tri_intersections(grid, np.array([1.0, 0.0, 0.0]), verts,
                                    np.asarray(faces, np.int64))
    inside = grid[counts % 2 == 1].astype(np.float32)
    if jitter > 0 and len(inside):
        rng = rng or np.random
        inside = inside + rng.uniform(-jitter, jitter, inside.shape).astype(np.float32)
    return inside


def _point_tri_dist2(p, v0, v1, v2):
    """Squared distance from points ``p (N, 3)`` to ONE triangle (v0, v1, v2)
    (Ericson, Real-Time Collision Detection §5.1.5, vectorized over points)."""
    ab = v1 - v0
    ac = v2 - v0
    ap = p - v0
    d1 = ap @ ab
    d2 = ap @ ac
    bp = p - v1
    d3 = bp @ ab
    d4 = bp @ ac
    cp = p - v2
    d5 = cp @ ab
    d6 = cp @ ac

    va = d3 * d6 - d5 * d4
    vb = d5 * d2 - d1 * d6
    vc = d1 * d4 - d3 * d2
    denom = va + vb + vc
    v = np.where(np.abs(denom) > 1e-30, vb / np.where(denom == 0, 1, denom), 0.0)
    w = np.where(np.abs(denom) > 1e-30, vc / np.where(denom == 0, 1, denom), 0.0)
    closest = v0 + v[:, None] * ab + w[:, None] * ac  # interior case

    # edge/vertex regions override the interior solution
    t_ab = np.clip(np.where(d1 - d3 != 0, d1 / np.where(d1 - d3 == 0, 1, d1 - d3), 0), 0, 1)
    on_ab = v0 + t_ab[:, None] * ab
    t_ac = np.clip(np.where(d2 - d6 != 0, d2 / np.where(d2 - d6 == 0, 1, d2 - d6), 0), 0, 1)
    on_ac = v0 + t_ac[:, None] * ac
    bc = v2 - v1
    t_bc = np.clip(np.where((d4 - d3) + (d5 - d6) != 0,
                            (d4 - d3) / np.where((d4 - d3) + (d5 - d6) == 0, 1,
                                                 (d4 - d3) + (d5 - d6)), 0), 0, 1)
    on_bc = v1 + t_bc[:, None] * bc

    closest = np.where(((vc <= 0) & (d1 >= 0) & (d3 <= 0))[:, None], on_ab, closest)
    closest = np.where(((vb <= 0) & (d2 >= 0) & (d6 <= 0))[:, None], on_ac, closest)
    closest = np.where(((va <= 0) & (d4 - d3 >= 0) & (d5 - d6 >= 0))[:, None],
                       on_bc, closest)
    closest = np.where(((d1 <= 0) & (d2 <= 0))[:, None], v0[None], closest)
    closest = np.where(((d3 >= 0) & (d4 <= d3))[:, None], v1[None], closest)
    closest = np.where(((d6 >= 0) & (d5 <= d6))[:, None], v2[None], closest)
    d = p - closest
    return np.einsum("nj,nj->n", d, d)


class AABBTree:
    """Median-split AABB tree over triangles for closest-point queries
    (role of the reference's compiled ``PyFleX/core/aabbtree.cpp``).

    Nodes are stored in flat arrays; leaves hold triangle index ranges over a
    permuted triangle list. ``closest_dist(points)`` does best-first
    traversal with box lower bounds, pruning anything farther than the
    current best."""

    LEAF_SIZE = 8

    def __init__(self, verts, faces):
        self.verts = np.asarray(verts, np.float64)
        faces = np.asarray(faces, np.int64)
        tris = self.verts[faces]                       # (F, 3, 3)
        cent = tris.mean(axis=1)
        self.order = np.arange(len(faces))
        boxes_lo, boxes_hi, lefts, rights, starts, ends = [], [], [], [], [], []

        def build(idx):
            node = len(boxes_lo)
            t = tris[idx]
            boxes_lo.append(t.reshape(-1, 3).min(axis=0) if len(idx) else np.zeros(3))
            boxes_hi.append(t.reshape(-1, 3).max(axis=0) if len(idx) else np.zeros(3))
            lefts.append(-1)
            rights.append(-1)
            starts.append(-1)
            ends.append(-1)
            if len(idx) <= self.LEAF_SIZE:
                starts[node] = len(self._leaf_tris)
                self._leaf_tris.extend(idx.tolist())
                ends[node] = len(self._leaf_tris)
                return node
            axis = int(np.argmax(boxes_hi[node] - boxes_lo[node]))
            half = np.argsort(cent[idx, axis])
            mid = len(idx) // 2
            lefts[node] = build(idx[half[:mid]])
            rights[node] = build(idx[half[mid:]])
            return node

        self._leaf_tris = []
        import sys

        old = sys.getrecursionlimit()
        sys.setrecursionlimit(max(old, 10000))
        build(np.arange(len(faces)))
        sys.setrecursionlimit(old)
        self.lo = np.asarray(boxes_lo)
        self.hi = np.asarray(boxes_hi)
        self.left = np.asarray(lefts)
        self.right = np.asarray(rights)
        self.start = np.asarray(starts)
        self.end = np.asarray(ends)
        perm = np.asarray(self._leaf_tris, np.int64)
        self.tri_v = tris[perm]  # (F, 3, 3) in leaf order

    def _box_dist2(self, p, node):
        d = np.maximum(np.maximum(self.lo[node] - p, 0.0), p - self.hi[node])
        return float(d @ d)

    def closest_dist(self, points):
        """Unsigned distance from each point to the mesh surface."""
        points = np.asarray(points, np.float64)
        out = np.empty(len(points))
        for i, p in enumerate(points):
            best = np.inf
            stack = [0]
            p1 = p[None]
            while stack:
                node = stack.pop()
                if self._box_dist2(p, node) >= best:
                    continue
                if self.left[node] < 0:  # leaf
                    tv = self.tri_v[self.start[node] : self.end[node]]
                    for v0, v1, v2 in tv:
                        best = min(best, float(_point_tri_dist2(p1, v0, v1, v2)[0]))
                else:
                    l, r = int(self.left[node]), int(self.right[node])
                    # visit the nearer child first for tighter pruning
                    if self._box_dist2(p, l) <= self._box_dist2(p, r):
                        stack.extend((r, l))
                    else:
                        stack.extend((l, r))
            out[i] = np.sqrt(best)
        return out


def make_sdf(verts, faces, dims=16, margin=0.05):
    """Grid signed-distance field of a closed mesh (role of the reference's
    ``PyFleX/core/sdf.cpp`` CreateSDF: unsigned distance via the AABB tree,
    sign via ray-crossing parity). Returns (sdf (nx, ny, nz) float32, origin
    (3,), spacing float): ``sdf`` is negative inside."""
    verts = np.asarray(verts, np.float64)
    lo = verts.min(axis=0)
    hi = verts.max(axis=0)
    pad = margin * float(np.max(hi - lo))
    lo, hi = lo - pad, hi + pad
    spacing = float(np.max(hi - lo)) / (dims - 1)
    axes = [lo[d] + spacing * np.arange(int(np.floor((hi[d] - lo[d]) / spacing)) + 1)
            for d in range(3)]
    grid = np.stack(np.meshgrid(*axes, indexing="ij"), axis=-1)
    pts = grid.reshape(-1, 3)
    tree = AABBTree(verts, faces)
    dist = tree.closest_dist(pts)
    # an irrational-slope ray direction avoids the degenerate edge/vertex
    # hits an axis-aligned grid ray would take through axis-aligned meshes
    # (double-counted crossings flip the parity sign)
    ray = np.array([0.8191725, 0.40490668, 0.40620193])
    inside = _ray_tri_intersections(pts, ray, verts,
                                    np.asarray(faces, np.int64)) % 2 == 1
    sdf = np.where(inside, -dist, dist).reshape(grid.shape[:3]).astype(np.float32)
    return sdf, lo.astype(np.float32), spacing


def box_mesh(size=(1.0, 1.0, 1.0), center=(0.0, 0.0, 0.0)):
    """Axis-aligned box mesh for tests/procedural bodies."""
    sx, sy, sz = np.asarray(size, np.float64) / 2
    c = np.asarray(center, np.float64)
    verts = np.array([[x, y, z] for x in (-sx, sx) for y in (-sy, sy)
                      for z in (-sz, sz)]) + c
    faces = np.array([
        [0, 1, 3], [0, 3, 2], [4, 6, 7], [4, 7, 5],  # x faces
        [0, 4, 5], [0, 5, 1], [2, 3, 7], [2, 7, 6],  # y faces
        [0, 2, 6], [0, 6, 4], [1, 5, 7], [1, 7, 3],  # z faces
    ])
    return verts.astype(np.float32), faces.astype(np.int32)
