"""Push environment over the XPBD engine (counterpart of the parts of
``adaptigraph_tpu/sim/env.py`` that the closed loop runs; numpy, the same
draws in the same order).

Plays the role of the reference ``FlexEnv`` (reference:
``src/sim/sim_env/flex_env.py:23-1065``): scene setup, push and grasp
execution with frame capture, and end-effector state recording. The data
generator's action samplers and the softbody poke are not ported. The
reference drives a simulated xArm6 through PyBullet IK to move the pusher
(flex_env.py:308-481); here the pusher is a kinematic tool in the XPBD
engine, or (``robot=True``) the tool follows the arm's IK waypoints.
"""

import numpy as np

from adaptigraph_tpu_torch.sim.engine import XPBDScene
from adaptigraph_tpu_torch.sim.scenes import SCENE_SAMPLERS, PUSHER_GEOMETRY
from adaptigraph_tpu_torch.utils.transforms import quat_from_yaw

PUSH_STEP = 0.02  # tool travel per sim frame
FRAME_EVERY = 5  # capture cadence (0.1 units of travel per captured frame)

# base particle color per material (uint8 RGB); instances are re-hued
MATERIAL_BASE_RGB = {
    "rope": (214, 84, 48),
    "granular": (170, 120, 60),
    "cloth": (60, 150, 160),
    "softbody": (220, 180, 60),
    "multiobj": (90, 110, 200),
    "bunnybath": (80, 140, 220),
    "rigid": (140, 140, 150),
}


class PushEnv:
    # sim-frame (x, z) of the robot arm base and sim-units-per-meter for the
    # robot-driven data path (reference mounts the xArm6 at the table edge,
    # robot_env.py:19-44; sim_real_ratio 10 as in the planning configs)
    ROBOT_BASE_XZ = (-4.5, 0.0)
    ROBOT_RATIO = 10.0

    def __init__(self, material, seed=0, capture_depth=False, n_cameras=4,
                 img_size=240, robot=False):
        assert material in SCENE_SAMPLERS, material
        self.material = material
        self.rng = np.random.RandomState(seed)
        self.geom = PUSHER_GEOMETRY[material]
        self.scene = None
        self.properties = None
        # robot=True executes pushes through the xArm6 FK/IK chain with the
        # tool's full face geometry as collision particles (reference:
        # flex_env.py:308-481 IK waypoint loop + robot_env.py arm-in-scene)
        self.robot = robot
        self.arm_q = None
        self.last_robot_trace = None
        # optional multi-view RGB-D capture per stored frame (the reference
        # records 4x 720x720 RGB-D per frame, flex_env.py:173-236; color is
        # point-splat rendered with per-instance hues, depth z-buffered)
        self.cameras = None
        if capture_depth:
            from adaptigraph_tpu_torch.realworld.cameras import make_multiview_cameras

            self.cameras = make_multiview_cameras(
                n=n_cameras, cam_dis=3.0, cam_height=4.0, width=img_size,
                height=img_size, frame="y_up")

    def reset(self):
        """Sample a scene, settle it (reference: flex_env.py:259-306)."""
        name, params, props = SCENE_SAMPLERS[self.material](self.rng)
        self.scene = XPBDScene(name, params, seed=int(self.rng.randint(1 << 31)))
        self.properties = props
        self._colors = self.particle_colors()
        no_tool = np.zeros((0, 3), np.float32)
        for _ in range(30):
            self.scene.step(no_tool)
        return self.get_positions()

    def particle_colors(self):
        """Per-particle render colors: material base hue, rotated per object
        instance (golden-angle hue walk), fluid tinted blue, fixed particles
        darkened."""
        base = np.asarray(MATERIAL_BASE_RGB[self.material], np.float32)
        inst = self.scene.get_instance()
        colors = np.tile(base, (len(inst), 1))
        if inst.max() > 0:
            # rotate hue per instance so objects are distinguishable
            phase = (inst * 0.61803398875) % 1.0
            rot = np.stack([np.cos(2 * np.pi * phase),
                            np.cos(2 * np.pi * (phase + 1 / 3)),
                            np.cos(2 * np.pi * (phase + 2 / 3))], axis=1)
            colors = np.clip(colors + 55.0 * rot, 30, 245)
        fluid = self.scene.fluid_mask()
        colors[fluid] = (80, 140, 220)
        colors[self.get_fixed_mask()] *= 0.55
        return colors.astype(np.float32)

    def _render_views(self, pts):
        """(rgb, depth) per camera for one frame."""
        return [cam.render_rgbd(pts, self._colors, table_axis=1)
                for cam in self.cameras]

    def get_positions(self):
        return self.scene.get_positions()

    def get_fixed_mask(self):
        return self.scene.get_inv_mass() == 0.0

    def _tool_points(self, x, z, theta, y):
        offs = np.asarray(self.geom["offsets"], np.float32)
        pts = np.zeros((len(offs), 3), np.float32)
        pts[:, 0] = x + offs * np.sin(theta)
        pts[:, 1] = y
        pts[:, 2] = z - offs * np.cos(theta)
        return pts

    def _eef_state(self, x, z, theta, y, prev):
        """14-dof eef state [pos, prev_pos, quat, prev_quat] matching the
        reference h5 schema (src/sim/data_gen/data.py)."""
        st = np.zeros(14, np.float32)
        st[0:3] = [x, y, z]
        st[3:6] = prev[0:3] if prev is not None else st[0:3]
        # our eef keypoint offsets are along local x; rotate by yaw -(theta)
        # so that keypoints line up with the board orientation
        st[6:10] = quat_from_yaw(-theta)
        st[10:14] = prev[6:10] if prev is not None else st[6:10]
        return st

    # ---- robot-driven push execution (reference: flex_env.py:308-481 +
    # robot_env.py:19-107 — the arm's IK waypoints drive the tool, and the
    # tool's full contact-face geometry collides with the scene) ----------

    def _sim_to_robot(self, x, z, y):
        bx, bz = self.ROBOT_BASE_XZ
        r = self.ROBOT_RATIO
        return np.array([(x - bx) / r, (z - bz) / r, y / r], np.float64)

    def _robot_to_sim(self, p):
        bx, bz = self.ROBOT_BASE_XZ
        r = self.ROBOT_RATIO
        return float(p[0] * r + bx), float(p[1] * r + bz), float(p[2] * r)

    def _tool_collision_points(self, x, z, theta, y):
        """Full contact-face collision geometry (board face / stick column),
        denser than the recorded eef keypoints — the reference collides the
        gripper/board meshes loaded into the sim (robot_env.py:19-44), not
        just the keypoints."""
        offs = np.asarray(self.geom["offsets"], np.float32)
        if len(offs) > 1:  # board pusher: 2 rows of face points
            heights = (0.0, 1.5 * self.geom["radius"])
        else:  # stick/cylinder: a short vertical column
            heights = (0.0, 1.2 * self.geom["radius"], 2.4 * self.geom["radius"])
        pts = []
        for h in heights:
            p = np.zeros((len(offs), 3), np.float32)
            p[:, 0] = x + offs * np.sin(theta)
            p[:, 1] = y + h
            p[:, 2] = z - offs * np.cos(theta)
            pts.append(p)
        return np.concatenate(pts, axis=0)

    def _execute_push_robot(self, action):
        """Push through the arm: IK each Cartesian waypoint (DLS, warm-
        started), FK back to the realized eef position, and sweep the tool's
        collision face there. Records (wp_target, fk_realized) pairs in
        ``last_robot_trace`` so tests can assert the eef follows the IK
        waypoints (reference: flex_env.py:308-380)."""
        from adaptigraph_tpu_torch.realworld.kinematics import (
            forward_kinematics, inverse_kinematics, push_waypoints)

        x0, z0, x1, z1 = [float(v) for v in action]
        theta = np.arctan2(z1 - z0, x1 - x0)
        pts = self.get_positions()
        movable = ~self.get_fixed_mask()
        ys = pts[movable, 1] if movable.any() else pts[:, 1]
        y = max(0.03, float(ys.min()))

        total = np.hypot(x1 - x0, z1 - z0)
        n_steps = max(2, int(total / PUSH_STEP))
        s_r = self._sim_to_robot(x0, z0, y)
        e_r = self._sim_to_robot(x1, z1, y)
        wps = push_waypoints(s_r[:2], e_r[:2], height=s_r[2], n_steps=n_steps,
                             approach_height=0.08)

        q = self.arm_q
        tool0 = self._tool_collision_points(x0, z0, theta, y + 0.8)
        self.scene.set_tool(tool0, radius=self.geom["radius"])

        frames_pos, frames_eef, frames_rgbd, trace = [], [], [], []
        prev_state = None
        sweep_start = 2  # wps[0:2] are the approach descent
        for i, wp in enumerate(wps):
            q, ok = inverse_kinematics(wp, q0=q)
            fk = forward_kinematics(q)[:3, 3]
            trace.append((wp.copy(), fk.copy()))
            sx, sz, sy = self._robot_to_sim(fk)
            self.scene.step(self._tool_collision_points(sx, sz, theta, sy))
            s = i - sweep_start
            in_sweep = 0 <= s < n_steps - 1
            if in_sweep and (s % FRAME_EVERY == 0 or s == n_steps - 2):
                frames_pos.append(self.get_positions())
                st = self._eef_state(sx, sz, theta, sy, prev_state)
                prev_state = st
                frames_eef.append(st[None])
                if self.cameras is not None:
                    frames_rgbd.append(self._render_views(frames_pos[-1]))
        self.arm_q = q
        self.last_robot_trace = (np.asarray([t[0] for t in trace]),
                                 np.asarray([t[1] for t in trace]))
        self._store_rgbd(frames_rgbd)
        return np.asarray(frames_pos), np.asarray(frames_eef)

    def execute_push(self, action):
        """Run one push, capturing frames every FRAME_EVERY sim steps
        (reference: flex_env.py:308-481 contact-gated capture loop).

        Returns (positions (T, N, 3), eef_states (T, 1, 14)).
        """
        if self.robot:
            return self._execute_push_robot(action)
        x0, z0, x1, z1 = [float(v) for v in action]
        theta = np.arctan2(z1 - z0, x1 - x0)
        pts = self.get_positions()
        # push at the MOVABLE particles' base: fixed particles (inv mass 0,
        # e.g. the softbody's anchored bottom layer) cannot respond, so a
        # tool swept at the global min-y would do nothing
        movable = ~self.get_fixed_mask()
        ys = pts[movable, 1] if movable.any() else pts[:, 1]
        y = max(0.03, float(ys.min()))

        tool = self._tool_points(x0, z0, theta, y)
        self.scene.set_tool(tool, radius=self.geom["radius"])

        total = np.hypot(x1 - x0, z1 - z0)
        n_steps = max(2, int(total / PUSH_STEP))
        frames_pos, frames_eef, frames_rgbd = [], [], []
        prev_state = None
        for s in range(n_steps):
            frac = (s + 1) / n_steps
            x = x0 + (x1 - x0) * frac
            z = z0 + (z1 - z0) * frac
            target = self._tool_points(x, z, theta, y)
            self.scene.step(target)
            if s % FRAME_EVERY == 0 or s == n_steps - 1:
                frames_pos.append(self.get_positions())
                st = self._eef_state(x, z, theta, y, prev_state)
                prev_state = st
                frames_eef.append(st[None])
                if self.cameras is not None:
                    frames_rgbd.append(self._render_views(frames_pos[-1]))
        # retreat the tool upward so the next push starts clean
        up = self._tool_points(x1, z1, theta, y + 1.0)
        self.scene.step(up)
        self._store_rgbd(frames_rgbd)
        return np.asarray(frames_pos), np.asarray(frames_eef)

    def execute_grasp(self, action):
        """Grasp at the start point, lift, carry to the end point, release
        (reference gripper path flex_env.py:340-480: waypoints
        [s+0.5y, s, s, e+0.5y, e], pick_k=5 particles pinned to the finger,
        mass restored on release, then a long settle).

        Returns (positions (T, N, 3), eef_states (T, 1, 14)).
        """
        x0, z0, x1, z1 = [float(v) for v in action]
        theta = np.arctan2(z1 - z0, x1 - x0)
        pts = self.get_positions()
        movable = ~self.get_fixed_mask()
        p = pts[movable] if movable.any() else pts
        near = np.argmin((p[:, 0] - x0) ** 2 + (p[:, 2] - z0) ** 2)
        # stop the descent just above tool-particle contact distance so the
        # kinematic tool doesn't shove the object aside before the pick (the
        # reference's fingers close AROUND the point, flex_env.py:389-410)
        pr = float(self.properties.get("particle_radius", 0.03))
        y_g = max(0.03, float(p[near, 1])) + (self.geom["radius"] + pr) * 0.95
        y_hi = y_g + 0.5

        frames_pos, frames_eef, frames_rgbd = [], [], []
        state = {"prev": None}

        def capture(x, z, y):
            frames_pos.append(self.get_positions())
            st = self._eef_state(x, z, theta, y, state["prev"])
            state["prev"] = st
            frames_eef.append(st[None])
            if self.cameras is not None:
                frames_rgbd.append(self._render_views(frames_pos[-1]))

        def sweep(a, b, capture_frames=True):
            a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
            n_steps = max(2, int(np.linalg.norm(b - a) / PUSH_STEP))
            for s in range(n_steps):
                t = a + (b - a) * (s + 1) / n_steps
                self.scene.step(np.asarray([t], np.float32))
                if capture_frames and (s % FRAME_EVERY == 0 or s == n_steps - 1):
                    capture(t[0], t[2], t[1])

        # approach above the grasp point, then descend
        self.scene.set_tool(np.asarray([[x0, y_hi, z0]], np.float32),
                            radius=self.geom["radius"])
        sweep([x0, y_hi, z0], [x0, y_g, z0])
        n_grasped = self.scene.grasp(
            k=5, max_dist=max(0.15, 2.5 * (self.geom["radius"] + pr)))
        # carry: lift, translate, lower
        sweep([x0, y_g, z0], [x0, y_hi, z0])
        sweep([x0, y_hi, z0], [x1, y_hi, z1])
        sweep([x1, y_hi, z1], [x1, y_g, z1])
        self.scene.release()
        # settle (reference: 200 free steps after release, flex_env.py:474-476)
        no_tool = self._tool_points(x1, z1, theta, y_hi + 1.0)
        for s in range(60):
            self.scene.step(no_tool)
            if s % 20 == 19:
                capture(x1, z1, y_hi + 1.0)
        self._n_grasped = n_grasped
        self._store_rgbd(frames_rgbd)
        return np.asarray(frames_pos), np.asarray(frames_eef)

    def _store_rgbd(self, frames_rgbd):
        """frames_rgbd: list over T of list over cams of (rgb, depth)."""
        if self.cameras is None:
            return
        self._last_color = np.asarray(
            [[c for c, _ in frame] for frame in frames_rgbd], np.uint8)
        self._last_depth = np.asarray(
            [[d for _, d in frame] for frame in frames_rgbd], np.float32)

    def last_observations(self):
        """Per-camera RGB + depth of the last executed action as the h5
        ``observations`` dict (reference schema: data.py:4-45)."""
        if self.cameras is None or not hasattr(self, "_last_depth"):
            return None
        cams = range(len(self.cameras))
        return {"color": {f"cam_{i}": self._last_color[:, i] for i in cams},
                "depth": {f"cam_{i}": self._last_depth[:, i] for i in cams}}
