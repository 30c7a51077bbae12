"""Virtual multi-view cameras + point-splat depth rendering (numpy copy of
``adaptigraph_tpu/realworld/cameras.py``).

Mirrors the reference camera rig (reference: ``src/sim/sim_env/cameras.py``:
4 views at 45-degree-offset compass points, distance 6, height 10, pitched
down 45 degrees; intrinsics derived from the projection matrix) but without a
GL context: depth is rendered by z-buffered point splatting of the particle
set plus the table plane — enough to drive the full perception pipeline
(fusion, filtering, FPS) in tests and in the sim-backed environment.
"""

import dataclasses

import numpy as np


@dataclasses.dataclass
class VirtualCamera:
    """Pinhole camera; extrinsics map camera frame -> world frame."""

    R: np.ndarray  # (3, 3) cam->world rotation
    t: np.ndarray  # (3,) cam->world translation (= camera position)
    intr: np.ndarray  # (fx, fy, cx, cy)
    width: int = 180
    height: int = 180

    def world_to_cam(self, pts):
        return (pts - self.t) @ self.R

    def project(self, pts_world):
        """(N, 3) world -> (N, 2) pixel coords + (N,) depth."""
        pc = self.world_to_cam(np.asarray(pts_world, np.float32))
        z = pc[:, 2]
        fx, fy, cx, cy = self.intr
        u = pc[:, 0] / np.maximum(z, 1e-9) * fx + cx
        v = pc[:, 1] / np.maximum(z, 1e-9) * fy + cy
        return np.stack([u, v], axis=1), z

    def render_depth(self, pts_world, splat_px=2, table_axis=1,
                     table_offset=0.0, far=100.0):
        """Z-buffer point splat + analytic table plane (normal along
        ``table_axis``, at coordinate ``table_offset``).

        Returns (H, W) float32 depth along the camera z axis.
        """
        H, W = self.height, self.width
        depth = np.full((H, W), np.inf, np.float32)

        # table plane: ray through each pixel intersected with the plane
        fx, fy, cx, cy = self.intr
        u = (np.arange(W, dtype=np.float32) - cx) / fx
        v = (np.arange(H, dtype=np.float32) - cy) / fy
        dirs_cam = np.stack(
            [np.tile(u[None, :], (H, 1)), np.tile(v[:, None], (1, W)),
             np.ones((H, W), np.float32)], axis=-1)
        dirs_world = dirs_cam @ self.R.T
        denom = dirs_world[..., table_axis]
        s = np.where(np.abs(denom) > 1e-9,
                     (table_offset - self.t[table_axis]) / denom, np.inf)
        table_depth = np.where(s > 0, s, np.inf).astype(np.float32)  # z = s * 1
        depth = np.minimum(depth, table_depth)

        if len(pts_world):
            uv, z = self.project(pts_world)
            ok = z > 1e-3
            uv, z = uv[ok], z[ok]
            ui = np.round(uv[:, 0]).astype(int)
            vi = np.round(uv[:, 1]).astype(int)
            for du in range(-splat_px, splat_px + 1):
                for dv in range(-splat_px, splat_px + 1):
                    uu = ui + du
                    vv = vi + dv
                    inb = (uu >= 0) & (uu < W) & (vv >= 0) & (vv < H)
                    np.minimum.at(depth, (vv[inb], uu[inb]), z[inb])
        return np.where(np.isfinite(depth), depth, far).astype(np.float32)


    def render_rgbd(self, pts_world, colors=None, splat_px=2, table_axis=1,
                    table_offset=0.0, far=100.0):
        """Z-buffered point-splat RGB-D (reference capture is 720x720 RGB-D
        from FleX's GL renderer, pyflex.cpp:3537 + flex_env.py:173-236; here
        points are splatted far-to-near with per-particle colors and a
        distance-shaded table plane).

        Returns (rgb (H, W, 3) uint8, depth (H, W) float32).
        """
        H, W = self.height, self.width
        depth = self.render_depth(pts_world, splat_px=splat_px,
                                  table_axis=table_axis,
                                  table_offset=table_offset, far=far)
        # background: flat table, shaded slightly by view distance
        shade = np.clip(1.0 - 0.015 * (depth - depth.min()), 0.6, 1.0)
        rgb = (np.stack([200 * shade, 198 * shade, 192 * shade], axis=-1)
               ).astype(np.float32)
        rgb[depth >= far] = (150.0, 155.0, 165.0)  # no-hit region

        pts_world = np.asarray(pts_world, np.float32)
        if len(pts_world):
            if colors is None:
                colors = np.full((len(pts_world), 3), 90.0, np.float32)
            colors = np.asarray(colors, np.float32)
            uv, z = self.project(pts_world)
            ok = z > 1e-3
            uv, z, col = uv[ok], z[ok], colors[ok]
            order = np.argsort(-z)  # paint far to near so near wins
            ui = np.round(uv[order, 0]).astype(int)
            vi = np.round(uv[order, 1]).astype(int)
            zo, co = z[order], col[order]
            # simple depth cue: farther particles a touch darker
            cue = np.clip(1.05 - 0.02 * (zo - zo.min()), 0.7, 1.0)[:, None]
            co = co * cue
            for du in range(-splat_px, splat_px + 1):
                for dv in range(-splat_px, splat_px + 1):
                    uu = ui + du
                    vv = vi + dv
                    inb = (uu >= 0) & (uu < W) & (vv >= 0) & (vv < H)
                    # only paint where this point is the z-buffer winner
                    # (within half a splat of the recorded depth)
                    near = zo[inb] <= depth[vv[inb], uu[inb]] + 0.05
                    rgb[vv[inb][near], uu[inb][near]] = co[inb][near]
        return np.clip(rgb, 0, 255).astype(np.uint8), depth


def _look_at_rotation(pos, target, up=(0.0, 1.0, 0.0)):
    """cam->world rotation with +z toward the target, +y roughly down-view
    (OpenCV convention: x right, y down, z forward)."""
    pos = np.asarray(pos, np.float64)
    fwd = np.asarray(target, np.float64) - pos
    fwd /= np.linalg.norm(fwd)
    upv = np.asarray(up, np.float64)
    right = np.cross(fwd, upv)
    right /= np.linalg.norm(right)
    down = np.cross(fwd, right)
    return np.stack([right, down, fwd], axis=1)  # columns = cam axes in world


def make_multiview_cameras(n=4, cam_dis=6.0, cam_height=10.0, fov_deg=45.0,
                           width=180, height=180, target=(0.0, 0.0, 0.0),
                           frame="y_up"):
    """The reference rig: n cameras on compass points offset 45 degrees,
    looking at the workspace center (reference: cameras.py:42-55).

    frame: "y_up" — sim convention, table normal +y, cameras above (+y);
           "z_down" — calibration-board convention (the reference's real rig:
           board frame with z pointing down), cameras at negative z.
    """
    xs = np.array([cam_dis, cam_dis, -cam_dis, -cam_dis])
    zs = np.array([cam_dis, -cam_dis, -cam_dis, cam_dis])
    f = 0.5 * height / np.tan(np.deg2rad(fov_deg) / 2)
    intr = np.array([f, f, width / 2.0, height / 2.0], np.float32)
    cams = []
    for i in range(n):
        if frame == "y_up":
            pos = np.array([xs[i % 4], cam_height, zs[i % 4]], np.float32)
            up = (0.0, 1.0, 0.0)
        else:
            pos = np.array([xs[i % 4], zs[i % 4], -cam_height], np.float32)
            up = (0.0, 0.0, -1.0)
        R = _look_at_rotation(pos, target, up=up).astype(np.float32)
        cams.append(VirtualCamera(R=R, t=pos, intr=intr.copy(),
                                  width=width, height=height))
    return cams


def table_axis_for_frame(frame):
    """The table normal's axis: y in the sim's ``y_up`` frame, else z."""
    return 1 if frame == "y_up" else 2
