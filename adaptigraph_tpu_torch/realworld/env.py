"""The sim-backed real environment (counterpart of
``adaptigraph_tpu/realworld/env.py``): ``SimRealEnv`` gives the planner the
observation contract of the reference's ``RealEnv``
(``src/planning/real_world/real_env.py:22-587``): ``get_obs`` -> per-camera
color/depth, ``get_intrinsics``, ``get_extrinsics`` (camera->board R, t),
``get_bbox`` (board-frame crop box), ``step(decoded_action)`` -> one push
primitive, on top of the C++ XPBD simulator with virtual cameras.
``RealEnv``, the hardware environment, is JAX's stub: it raises.
"""

import numpy as np

from adaptigraph_tpu_torch.realworld.cameras import make_multiview_cameras
from adaptigraph_tpu_torch.sim.env import PushEnv


def sim_to_board(pts, sim_real_ratio):
    """Inverse of ``perception.obs_to_sim_coords``: sim (y-up) -> board
    (z-down) coordinates."""
    pts = np.asarray(pts, np.float32)
    out = np.stack([pts[:, 0], pts[:, 2], -pts[:, 1]], axis=1)
    return out / sim_real_ratio


class SimRealEnv:
    """RealEnv-compatible observation/actuation interface over the XPBD sim.

    Actions are decoded pushes in board-frame coordinates
    ``[x_start, y_start, x_end, y_end]`` (the planner's sim-frame push is
    converted by dividing by sim_real_ratio, matching the reference's
    real-robot path, plan.py:263-272).
    """

    def __init__(self, material="rope", seed=0, sim_real_ratio=10.0,
                 n_cameras=4, img_size=480, render_color=True):
        self.sim_real_ratio = sim_real_ratio
        self.env = PushEnv(material, seed=seed)
        self.env.reset()
        self.n_cameras = n_cameras
        self.render_color = render_color
        # board-frame rig: tabletop spans ~0.6 board units at ratio 10
        self.cams = make_multiview_cameras(
            n=n_cameras, cam_dis=0.9, cam_height=1.2, fov_deg=45.0,
            width=img_size, height=img_size, frame="z_down")

    # -- observation contract (reference: real_env.py:152-198) --------------
    def get_obs(self):
        """Per-camera color + depth. RGB comes from the same point-splat
        renderer data gen uses (per-instance hues over a gray table,
        sim/env.py particle_colors), so learned/color mask_fns have real
        pixels to segment (reference: real_env.py get_obs returns both)."""
        pts = sim_to_board(self.env.get_positions(), self.sim_real_ratio)
        colors = getattr(self.env, "_colors", None)
        obs = {}
        for i, cam in enumerate(self.cams):
            if self.render_color:
                rgb, depth = cam.render_rgbd(pts, colors, table_axis=2,
                                             table_offset=0.0)
                obs[f"color_{i}"] = rgb
                obs[f"depth_{i}"] = depth
            else:
                obs[f"depth_{i}"] = cam.render_depth(pts, table_axis=2,
                                                     table_offset=0.0)
                obs[f"color_{i}"] = None
        return obs

    def get_intrinsics(self):
        return [cam.intr for cam in self.cams]

    def get_extrinsics(self):
        return [cam.R for cam in self.cams], [cam.t for cam in self.cams]

    def get_bbox(self):
        """Board-frame workspace crop (reference: real_env.py:109-118).
        z in [-0.5, -0.0012] keeps above-table points, drops the table plane
        (z-down frame; splat depth noise stays below ~1 mm)."""
        return np.array([[-0.6, 0.6], [-0.6, 0.6], [-0.5, -0.0012]], np.float32)

    # -- actuation (reference: real_env.py:212-309) --------------------------
    def step(self, decoded_action):
        """One push primitive: board coords -> sim coords -> kinematic tool
        push in the simulator."""
        x0, y0, x1, y1 = [float(v) for v in decoded_action[:4]]
        r = self.sim_real_ratio
        sim_action = np.array([x0 * r, y0 * r, x1 * r, y1 * r], np.float32)
        self.env.execute_push(sim_action)

    def step_gripper(self, decoded_action):
        """One grasp primitive: pick at (x0, y0), carry to (x1, y1), release
        (reference: real_env.py step_gripper; plan.py:256-259 dispatches on
        gripper_enable)."""
        x0, y0, x1, y1 = [float(v) for v in decoded_action[:4]]
        r = self.sim_real_ratio
        sim_action = np.array([x0 * r, y0 * r, x1 * r, y1 * r], np.float32)
        self.env.execute_grasp(sim_action)

    # -- test/metric helpers --------------------------------------------------
    def get_particles_sim(self):
        return self.env.get_positions()


class RealEnv:
    """Hardware environment (cameras + xArm6 + calibration), a stub as in the
    JAX package: it needs ``pyrealsense2`` and an xArm SDK, and raises
    ``NotImplementedError`` when they are there. ``SimRealEnv`` implements
    the planner-facing contract."""

    def __init__(self, *args, **kwargs):
        try:
            import pyrealsense2  # noqa: F401
        except ImportError as e:
            raise ImportError(
                "RealEnv needs pyrealsense2 + an xArm SDK; use SimRealEnv "
                "for hardware-free operation") from e
        raise NotImplementedError(
            "hardware bring-up tracked separately; SimRealEnv implements the "
            "full planner-facing contract")
