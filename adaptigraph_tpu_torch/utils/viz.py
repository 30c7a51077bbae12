"""Graph overlays, rollout videos and error plots (numpy copy of
``adaptigraph_tpu/utils/viz.py``).

``cv2`` draws, ``imageio`` writes a gif where no mp4 codec is available, and
``matplotlib`` plots; each is imported inside the function that needs it, so
a machine without them can import this module and skip the files.
"""

import os

import numpy as np


def project_points(points, intr, extr):
    """World points -> pixel coords through a pinhole camera. intr: (fx, fy,
    cx, cy); extr: (4, 4) world->camera matrix. Returns (uv, depth)."""
    pts = np.asarray(points, np.float64)
    ones = np.ones((len(pts), 1))
    pc = (np.concatenate([pts, ones], axis=1) @ np.asarray(extr).T)[:, :3]
    fx, fy, cx, cy = intr
    z = np.maximum(pc[:, 2], 1e-9)
    u = pc[:, 0] / z * fx + cx
    v = pc[:, 1] / z * fy + cy
    return np.stack([u, v], axis=1), pc[:, 2]


def draw_graph(img, points, intr, extr, neighbors=None, nbr_mask=None,
               color=(0, 255, 0), edge_color=(0, 180, 255), radius=3):
    """Projected particles, and the neighbor graph's edges when given,
    drawn on an image (reference: rollout/graph.py:175-250)."""
    import cv2

    img = np.ascontiguousarray(img)
    uv, z = project_points(points, intr, extr)
    ok = z > 0
    px = np.round(uv).astype(int)
    if neighbors is not None:
        nb = np.asarray(neighbors)
        mk = np.asarray(nbr_mask) if nbr_mask is not None else np.ones(nb.shape, bool)
        for i, k in zip(*np.nonzero(mk)):
            j = int(nb[i, k])
            if ok[i] and j < len(uv) and ok[j]:
                cv2.line(img, tuple(px[i]), tuple(px[j]), edge_color, 1)
    for i in np.nonzero(ok)[0]:
        cv2.circle(img, tuple(px[i]), radius, color, -1)
    return img


def render_rollout_frames(pred_seq, gt_seq, intr, extr, img_size=(360, 360), n_valid=None):
    """Side-by-side pred | gt | both frames for a rollout, one per step."""
    frames = []
    n = n_valid if n_valid is not None else pred_seq.shape[1]
    h, w = img_size
    for t in range(len(pred_seq)):
        canvas = np.full((h, w * 3, 3), 255, np.uint8)
        canvas[:, :w] = draw_graph(canvas[:, :w].copy(), pred_seq[t][:n], intr, extr,
                                   color=(0, 0, 255))
        canvas[:, w:2 * w] = draw_graph(canvas[:, w:2 * w].copy(), gt_seq[t][:n], intr, extr,
                                        color=(0, 255, 0))
        both = draw_graph(canvas[:, 2 * w:].copy(), gt_seq[t][:n], intr, extr, color=(0, 255, 0))
        canvas[:, 2 * w:] = draw_graph(both, pred_seq[t][:n], intr, extr, color=(0, 0, 255))
        frames.append(canvas)
    return frames


def save_video(frames, path, fps=10):
    """mp4 through cv2.VideoWriter, or a gif through imageio where no mp4
    codec is available. Returns the path written."""
    import cv2

    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    h, w = frames[0].shape[:2]
    vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
    if vw.isOpened():
        for f in frames:
            vw.write(cv2.cvtColor(f, cv2.COLOR_RGB2BGR))
        vw.release()
        if os.path.getsize(path) > 0:
            return path
    import imageio.v2 as imageio

    gif = os.path.splitext(path)[0] + ".gif"
    imageio.mimsave(gif, frames, fps=fps)
    return gif


def topdown_camera(scale=60.0, center=(0.0, 0.0), img_size=(360, 360), height=12.0):
    """A top-down camera (y-up sim frame) for rollout videos: (intr, extr)."""
    fx = fy = scale
    cx, cy = img_size[1] / 2.0, img_size[0] / 2.0
    # world->camera: looking straight down -y; camera z = height - y
    extr = np.array([
        [1.0, 0.0, 0.0, -center[0]],
        [0.0, 0.0, 1.0, -center[1]],
        [0.0, -1.0, 0.0, height],
        [0.0, 0.0, 0.0, 1.0],
    ])
    return np.array([fx, fy, cx, cy]), extr


def plot_error_curves(stats, path, title="rollout error"):
    """Median/IQR error-vs-step plot of ``rollout_dataset``'s statistics."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    med, q25, q75 = stats["median"], stats["q25"], stats["q75"]
    steps = np.arange(len(med))
    fig, ax = plt.subplots(figsize=(6, 4))
    ax.plot(steps, med, label="median")
    ax.fill_between(steps, q25, q75, alpha=0.3, label="IQR")
    ax.set_xlabel("rollout step")
    ax.set_ylabel("mean particle L2 error")
    ax.set_title(title)
    ax.legend()
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    fig.savefig(path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return path


def plot_planning_progress(errors, path, title="planning error vs target"):
    """Per-MPC-step error curve of a ``plan`` run."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(6, 4))
    ax.plot(np.arange(len(errors)), errors, marker="o")
    ax.set_xlabel("MPC step")
    ax.set_ylabel("error to target")
    ax.set_title(title)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    fig.savefig(path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return path
