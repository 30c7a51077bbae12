"""Point-cloud geometry for tabletop perception (host-side numpy copy of
``adaptigraph_tpu/realworld/pointcloud.py``).

Re-implements the geometric core of the reference's tabletop perception
(reference: ``src/planning/perception.py:151-256``) without Open3D: depth
unprojection, multi-view fusion into the board frame, bbox crop, voxel
downsampling, iterative statistical outlier removal and z-percentile
filtering. Perception runs once per MPC step on the host, so numpy (+ scipy
cKDTree for kNN) is the right tool; the device-side state builder (FPS) is
in ``ops.fps``.
"""

import numpy as np


def depth_to_points(depth, intr):
    """Unproject a depth image to camera-frame points.

    depth: (H, W) metric depth; intr: (fx, fy, cx, cy) or 3x3 K matrix.
    Returns (H*W, 3) points (invalid/zero depth gives z=0 rows).
    Reference: ``depth2fgpcd`` usage at perception.py:167-169.
    """
    depth = np.asarray(depth, np.float32)
    H, W = depth.shape
    if np.shape(intr) == (3, 3):
        fx, fy, cx, cy = intr[0, 0], intr[1, 1], intr[0, 2], intr[1, 2]
    else:
        fx, fy, cx, cy = intr
    u = np.arange(W, dtype=np.float32)[None, :]
    v = np.arange(H, dtype=np.float32)[:, None]
    x = (u - cx) / fx * depth
    y = (v - cy) / fy * depth
    return np.stack([x, y, depth], axis=-1).reshape(-1, 3)


def fuse_views(depth_list, R_list, t_list, intr_list, mask_list=None,
               stride=4, depth_range=(0.0, 2.0)):
    """Merge per-camera depth images into one board-frame cloud
    (reference: perception.py:160-224).

    mask_list: optional per-camera (H, W) bool of pixels to KEEP (the
    reference's object-and-background mask after removing table/sheet).
    Returns (N, 3) float32 board-frame points.
    """
    clouds = []
    for i, depth in enumerate(depth_list):
        depth = np.asarray(depth, np.float32)
        pts = depth_to_points(depth, intr_list[i]).reshape(*depth.shape, 3)
        pts = pts[::stride, ::stride].reshape(-1, 3)
        keep = (depth > depth_range[0]) & (depth < depth_range[1])
        if mask_list is not None and mask_list[i] is not None:
            keep &= np.asarray(mask_list[i], bool)
        keep = keep[::stride, ::stride].reshape(-1)
        pts = pts[keep]
        R = np.asarray(R_list[i], np.float32)
        t = np.asarray(t_list[i], np.float32)
        clouds.append(pts @ R.T + t)
    if not clouds:
        return np.zeros((0, 3), np.float32)
    return np.concatenate(clouds, axis=0).astype(np.float32)


def crop_bbox(points, bbox):
    """Axis-aligned crop; bbox (3, 2) [[xmin, xmax], ...]
    (reference: perception.py:227)."""
    bbox = np.asarray(bbox)
    keep = np.all((points >= bbox[:, 0]) & (points <= bbox[:, 1]), axis=1)
    return points[keep]


def voxel_downsample(points, voxel_size):
    """Average points per occupied voxel (o3d ``voxel_down_sample`` semantics,
    reference: perception.py:230)."""
    if len(points) == 0:
        return points
    idx = np.floor(points / voxel_size).astype(np.int64)
    # lexicographic voxel key
    _, inv, counts = np.unique(idx, axis=0, return_inverse=True, return_counts=True)
    sums = np.zeros((counts.shape[0], 3), np.float64)
    np.add.at(sums, inv, points)
    return (sums / counts[:, None]).astype(np.float32)


def remove_statistical_outliers(points, nb_neighbors=20, std_ratio=1.5,
                                iterative=True, std_ratio_step=0.5, max_iter=10):
    """Statistical outlier removal: drop points whose mean distance to their
    ``nb_neighbors`` nearest neighbors exceeds mean + std_ratio * std of that
    statistic. With ``iterative`` the filter repeats with std_ratio growing by
    ``std_ratio_step`` per round until no new outliers fall out
    (reference: perception.py:232-246).
    """
    from scipy.spatial import cKDTree

    pts = np.asarray(points, np.float32)
    it = 0
    while True:
        if len(pts) <= nb_neighbors:
            return pts
        tree = cKDTree(pts)
        # +1: query includes the point itself at distance 0
        d, _ = tree.query(pts, k=nb_neighbors + 1)
        mean_d = d[:, 1:].mean(axis=1)
        thresh = mean_d.mean() + (std_ratio + it * std_ratio_step) * mean_d.std()
        keep = mean_d <= thresh
        if not iterative:
            return pts[keep]
        if keep.all() or it >= max_iter:
            return pts
        pts = pts[keep]
        it += 1


def z_percentile_filter(points, k_filter, axis=2):
    """Keep points below the k_filter-percentile along ``axis``
    (reference: perception.py:248-254)."""
    if k_filter >= 1.0 or len(points) == 0:
        return points
    z = points[:, axis]
    z_thresh = np.sort(z)[int(k_filter * len(z))]
    return points[z < z_thresh]
