"""Perception: observation -> planner state (numpy copy of
``adaptigraph_tpu/realworld/perception.py``).

Re-implements the reference ``PerceptionModule`` pipeline
(reference: ``src/planning/perception.py:24-349``). The open-vocabulary
detector (GroundingDINO) and segmenter (SAM) need downloaded weights; they
are *injectable callables* here —
``mask_fn(rgb) -> (H, W) bool`` produces the keep-mask per camera (the
reference's "object and background minus table/sheet" mask,
perception.py:192-209). Without one, perception runs in ``use_raw`` mode
(depth-threshold only, perception.py:152's ``use_raw`` flag) which is exact
for the sim-backed environment where the table is an analytic plane.
"""

import dataclasses

import numpy as np

from adaptigraph_tpu_torch.ops.fps import fps_downsample
from adaptigraph_tpu_torch.realworld.pointcloud import (
    crop_bbox,
    fuse_views,
    remove_statistical_outliers,
    voxel_downsample,
    z_percentile_filter,
)


@dataclasses.dataclass
class PerceptionModule:
    """Config + optional learned-mask hook.

    mask_fn: optional callable rgb (H, W, 3) -> keep-mask (H, W) bool.
    k_filter: z-percentile keep fraction (reference: perception.py:248).
    """

    mask_fn: object = None
    k_filter: float = 1.0
    voxel_size: float = 0.0005
    stride: int = 4
    depth_range: tuple = (0.0, 2.0)
    obj_prompts: tuple = ()  # open-vocab detector prompts (task_config obj_list)
    max_n: int = 1           # instance budget for a detector-backed mask_fn

    def get_tabletop_points(self, rgb_list, depth_list, R_list, t_list,
                            intr_list, bbox, use_raw=False):
        """Fused, cropped, filtered board-frame cloud
        (reference: perception.py:151-256). ``use_raw`` skips the voxel
        downsample + statistical outlier removal (the slow host passes) for
        the per-MPC-step loop; the z-percentile filter (k_filter) always
        applies, as in the reference."""
        masks = None
        if not use_raw and self.mask_fn is not None:
            masks = [self.mask_fn(rgb) for rgb in rgb_list]
        pts = fuse_views(depth_list, R_list, t_list, intr_list,
                         mask_list=masks, stride=self.stride,
                         depth_range=self.depth_range)
        pts = crop_bbox(pts, bbox)
        if use_raw:
            return z_percentile_filter(pts, self.k_filter)
        pts = voxel_downsample(pts, self.voxel_size)
        pts = remove_statistical_outliers(pts, nb_neighbors=20, std_ratio=1.5)
        pts = z_percentile_filter(pts, self.k_filter)
        return pts


class EmptyPerceptionError(RuntimeError):
    """Perception returned no object points (object left the workspace)."""


def construct_graph(obj_kps, fps_radius, max_nobj=100, max_neef=8,
                    eef_kps=None, rng=None):
    """Raw points -> fixed-size planner state via two-stage FPS
    (reference: perception.py:259-315): farthest-point sample to ``max_nobj``
    from a random start, then radius-dedup.

    Returns dict with obj_state (max_nobj, 3) zero-padded, obj_state_raw
    (n, 3), eef_state, state (max_nobj+max_neef, 3), plus masks.
    """
    if eef_kps is None:
        eef_kps = np.zeros((0, 3), np.float32)
    obj_kps = np.asarray(obj_kps, np.float32)
    if obj_kps.shape[0] == 0:
        # the object left the workspace crop (pushed out / below the clipping
        # height): fail with an actionable error instead of a bare
        # ValueError out of rng.randint (the reference crashes the same way,
        # perception.py:269)
        raise EmptyPerceptionError(
            "perception produced 0 object points — object outside the "
            "workspace bbox or fully below the clipping height")
    rng = rng or np.random
    start = int(rng.randint(0, obj_kps.shape[0]))
    kps = obj_kps[fps_downsample(obj_kps, max_nobj, fps_radius, start_idx=start)]
    n = kps.shape[0]
    m = eef_kps.shape[0]

    state = np.zeros((max_nobj + max_neef, 3), np.float32)
    state[:n] = kps
    state[max_nobj : max_nobj + m] = eef_kps
    state_mask = np.zeros(max_nobj + max_neef, bool)
    state_mask[:n] = True
    state_mask[max_nobj : max_nobj + m] = True
    eef_mask = np.zeros(max_nobj + max_neef, bool)
    eef_mask[max_nobj : max_nobj + m] = True
    obj_state = np.zeros((max_nobj, 3), np.float32)
    obj_state[:n] = kps
    return {
        "obj_state": obj_state,
        "obj_state_raw": kps,
        "eef_state": eef_kps,
        "state": state,
        "state_mask": state_mask,
        "eef_mask": eef_mask,
    }


def obs_to_sim_coords(points, sim_real_ratio):
    """Board-frame perception points -> sim/model coordinates: scale, swap
    (x, y, z) -> (x, z, y), negate the new y (reference: perception.py:335-337)."""
    pts = np.asarray(points, np.float32) * sim_real_ratio
    pts = pts[:, [0, 2, 1]].copy()
    pts[:, 1] *= -1
    return pts


def get_state_cur(env, pm: PerceptionModule, fps_radius=0.2,
                  sim_real_ratio=10.0, max_nobj=100, use_raw=False, rng=None):
    """Capture + perceive + build the planner state
    (reference: perception.py:318-349).

    Returns (state_cur (n, 3) raw FPS'd object points in sim coords,
    obj_kps all perceived points in sim coords).
    """
    obs = env.get_obs()
    intr_list = env.get_intrinsics()
    R_list, t_list = env.get_extrinsics()
    bbox = env.get_bbox()
    rgbs = [obs.get(f"color_{i}") for i in range(env.n_cameras)]
    depths = [obs[f"depth_{i}"] for i in range(env.n_cameras)]
    pts = pm.get_tabletop_points(rgbs, depths, R_list, t_list, intr_list,
                                 bbox, use_raw=use_raw)
    obj_kps = obs_to_sim_coords(pts, sim_real_ratio)
    graph = construct_graph(obj_kps, fps_radius=fps_radius, max_nobj=max_nobj,
                            rng=rng)
    return graph["obj_state_raw"], obj_kps


def construct_goal_from_perception(env, pm: PerceptionModule = None,
                                   sim_real_ratio=10.0, use_raw=True):
    """Capture the current scene as a goal point cloud in sim coordinates
    (reference: perception.py:352-398 construct_goal_from_perception — the
    operator arranges the target configuration, then captures it)."""
    pm = pm or PerceptionModule(stride=2)
    obs = env.get_obs()
    R_list, t_list = env.get_extrinsics()
    pts = pm.get_tabletop_points(
        [obs.get(f"color_{i}") for i in range(env.n_cameras)],
        [obs[f"depth_{i}"] for i in range(env.n_cameras)],
        R_list, t_list, env.get_intrinsics(), env.get_bbox(), use_raw=use_raw)
    return obs_to_sim_coords(pts, sim_real_ratio)
