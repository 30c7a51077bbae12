"""Planar box-pushing simulator and data generation (copy of
``adaptigraph_tpu/sim/box2d.py``, the auxiliary box task).

Plays the role of the reference's pymunk 2D stack (reference:
``src/sim/sim_env/pymunk_env.py:16`` ``BoxSim`` and
``src/sim/data_gen/data_gen_box.py:14`` ``gen_box_data``): a zero-gravity,
quasi-static plane with one rigid box, a random box size and an off-center
center of mass, and a circular pusher approaching from a random side. At
each step the pusher circle's penetration of the box is resolved by
displacing the box along the contact normal, split into translation and a
rotation about the center of mass by the contact lever arm.

The box's 4 corners play the role of particles in the learning stack.
"""

import os

import numpy as np


def _rot(theta):
    c, s = np.cos(theta), np.sin(theta)
    return np.array([[c, -s], [s, c]])


class BoxSim:
    """Quasi-static planar box + circular pusher.

    State: box pose (x, y, theta) about its center of mass (which may be
    off-geometric-center, reference: data_gen_box.py:33-35).
    """

    def __init__(self, box_width, box_height, center_of_mass=(0.0, 0.0),
                 pusher_radius=5.0, friction=0.5):
        self.w = float(box_width)
        self.h = float(box_height)
        self.com = np.asarray(center_of_mass, np.float64)  # offset from geom center
        self.pusher_radius = float(pusher_radius)
        self.friction = friction
        # pose of the COM frame in the world
        self.pos = np.zeros(2)
        self.theta = 0.0
        self.pusher = None
        # rotational compliance: ratio of rotation to translation response;
        # an off-center COM makes pushes through one side rotate more
        self.rot_compliance = 1.0 / (0.5 * (self.w**2 + self.h**2) / 12.0)

    # corners in the COM frame
    def _corners_local(self):
        gx, gy = -self.com  # geometric center relative to COM
        hw, hh = self.w / 2, self.h / 2
        return np.array([
            [gx - hw, gy - hh], [gx + hw, gy - hh],
            [gx + hw, gy + hh], [gx - hw, gy + hh],
        ])

    def get_corners(self):
        return self._corners_local() @ _rot(self.theta).T + self.pos

    def get_obj_state(self):
        """(x, y, theta) of the COM frame (reference get_obj_state)."""
        return np.array([self.pos[0], self.pos[1], self.theta])

    def get_obj_size(self):
        return np.array([self.w, self.h])

    def set_pusher(self, xy):
        self.pusher = np.asarray(xy, np.float64)

    def _resolve_contact(self):
        """Push the box out of penetration with the pusher circle."""
        # pusher center in the box (COM) frame
        R = _rot(self.theta)
        p = R.T @ (self.pusher - self.pos)
        c = self._corners_local()
        lo = c.min(axis=0)
        hi = c.max(axis=0)
        # closest point of the box rectangle to the pusher center
        q = np.clip(p, lo, hi)
        d = p - q
        dist = np.linalg.norm(d)
        pen = self.pusher_radius - dist
        if pen <= 0:
            return
        if dist < 1e-9:
            # pusher center inside the box: push along the least-penetration axis
            depths = np.array([p[0] - lo[0], hi[0] - p[0], p[1] - lo[1], hi[1] - p[1]])
            k = int(np.argmin(depths))
            n = np.array([[-1, 0], [1, 0], [0, -1], [0, 1]], np.float64)[k]
            pen = depths[k] + self.pusher_radius
            q = p - n * depths[k]
        else:
            n = d / dist  # from box surface toward pusher
        # displacement of the box: away from the pusher
        move_local = -n * pen
        # split into translation + rotation by the contact lever arm about COM
        lever = float(np.cross(q, move_local))  # scalar z torque-like term
        dtheta = lever * self.rot_compliance * 0.5
        self.pos += R @ (move_local * (1.0 - 0.15))
        self.theta += dtheta

    def update(self, pusher_target, n_substeps=4):
        """Move the pusher toward the target, resolving contacts
        (reference: BoxSim.update driving the pusher body at fixed velocity)."""
        if self.pusher is None:
            self.set_pusher(pusher_target)
            return
        start = self.pusher.copy()
        target = np.asarray(pusher_target, np.float64)
        for s in range(1, n_substeps + 1):
            self.pusher = start + (target - start) * (s / n_substeps)
            self._resolve_contact()


def gen_box_episode(out_dir, epi_idx, box_width_range=(80.0, 200.0),
                    box_height_range=(50.0, 150.0), n_steps=60, seed=None):
    """One episode: random box + COM, pusher from a random side pushed
    through the box; record corner keypoints + pusher states
    (reference: data_gen_box.py:14-129)."""
    rng = np.random.RandomState(epi_idx if seed is None else seed)
    bw = rng.uniform(*box_width_range)
    bh = rng.uniform(*box_height_range)
    com = np.array([rng.uniform(-bw / 4, bw / 4), rng.uniform(-bh / 4, bh / 4)])
    sim = BoxSim(bw, bh, center_of_mass=com)

    side = rng.randint(4)
    margin = rng.uniform(100, 200)
    if side == 0:      # top to bottom
        start = np.array([rng.uniform(-bw / 2, bw / 2), bh / 2 + margin])
    elif side == 1:    # bottom to top
        start = np.array([rng.uniform(-bw / 2, bw / 2), -bh / 2 - margin])
    elif side == 2:    # left to right
        start = np.array([-bw / 2 - margin, rng.uniform(-bh / 2, bh / 2)])
    else:              # right to left
        start = np.array([bw / 2 + margin, rng.uniform(-bh / 2, bh / 2)])
    end = -start * rng.uniform(0.3, 0.8)

    sim.set_pusher(start)
    corners, pushers, states = [], [], []
    for t in range(n_steps):
        target = start + (end - start) * ((t + 1) / n_steps)
        sim.update(target)
        corners.append(sim.get_corners())
        pushers.append(sim.pusher.copy())
        states.append(sim.get_obj_state())

    os.makedirs(out_dir, exist_ok=True)
    np.savez(os.path.join(out_dir, f"{epi_idx:06d}.npz"),
             corners=np.asarray(corners, np.float32),
             pusher=np.asarray(pushers, np.float32),
             box_state=np.asarray(states, np.float32),
             com=com.astype(np.float32),
             size=np.array([bw, bh], np.float32))
    return np.asarray(corners), np.asarray(states)


def gen_box_data(save_dir, n_episodes, seed=0):
    """Episode fan-out (reference: data_gen_box.py main)."""
    for e in range(n_episodes):
        gen_box_episode(save_dir, e, seed=seed + e)
    return n_episodes
