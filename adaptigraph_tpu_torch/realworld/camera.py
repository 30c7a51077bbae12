"""Camera process tier (counterpart of ``adaptigraph_tpu/realworld/camera.py``):
one child process per camera streaming frames into the C++ shared-memory ring
(``realworld/shm.py``), a command queue per camera, and a parent-side
``MultiCamera`` that reads timestamp-aligned snapshots.

``SyntheticCameraProcess`` renders point-splat depth frames of a static
point cloud (the sim-backed stand-in for a camera); ``RealsenseCameraProcess``
is gated on ``pyrealsense2``, as in the JAX package.

Departure from the JAX package: the camera processes are spawned, never
forked (``multiprocessing.get_context("spawn")``, for the process and its
events). A fork of a process whose OpenMP threads torch has started can hang;
a spawned child starts from a fresh import, so the camera object and the
points are pickled to it, and it imports only numpy and this package's
numpy modules (no torch, no CUDA). The parent builds the ring's library
before it starts any child.
"""

import multiprocessing as mp
import time

import numpy as np

from adaptigraph_tpu_torch.realworld.shm import ShmQueue, ShmRingBuffer, _load, align_timestamps

_SPAWN = mp.get_context("spawn")

# Command opcodes understood by camera child processes (the reference's
# SingleRealsense.Command enum, routed through a shared-memory queue).
CMD_SET_FPS = 0
CMD_SET_OPTION = 1  # generic (option_id, value) pair for hardware backends

_CMD_SPECS = [("cmd", (), np.int64), ("option", (), np.int64), ("value", (), np.float64)]


class SyntheticCameraProcess(_SPAWN.Process):
    """Child process rendering depth frames of a (static) point cloud into a
    shared ring buffer at ``fps``; runtime-adjustable via a shared-memory
    command queue."""

    def __init__(self, name, camera, points, fps=30.0, capacity=64):
        super().__init__(daemon=True)
        self.ring_name = name
        self.camera = camera
        self.points = np.asarray(points, np.float32)
        self.fps = fps
        self.capacity = capacity
        self._stop = _SPAWN.Event()
        self._ready = _SPAWN.Event()
        self.frame_shape = (camera.height, camera.width)
        self._cmd_queue = None  # parent-side handle, created in start_wait

    @property
    def cmd_name(self):
        return self.ring_name + "_cmd"

    def run(self):
        ring = ShmRingBuffer(self.ring_name, self.frame_shape, np.float32,
                             capacity=self.capacity, create=True)
        cmds = ShmQueue(self.cmd_name, _CMD_SPECS, capacity=64, create=True)
        try:
            period = 1.0 / self.fps
            self._ready.set()
            while not self._stop.is_set():
                t = time.time()
                while not cmds.empty():
                    c = cmds.get()
                    if int(c["cmd"]) == CMD_SET_FPS and float(c["value"]) > 0:
                        period = 1.0 / float(c["value"])
                    # CMD_SET_OPTION is a no-op for the synthetic camera
                depth = self.camera.render_depth(self.points, table_axis=2)
                ring.put(depth, t)
                dt = period - (time.time() - t)
                if dt > 0:
                    time.sleep(dt)
        finally:
            cmds.close()
            ring.close()

    def start_wait(self, timeout=10.0):
        _load()  # build the ring's library here, not in each child
        self.start()
        self.wait_ready(timeout)

    def wait_ready(self, timeout=10.0):
        """Wait until the started child has made its ring and command queue,
        then open the queue."""
        if not self._ready.wait(timeout):
            raise RuntimeError("camera process failed to start")
        self._cmd_queue = ShmQueue(self.cmd_name, _CMD_SPECS, create=False)

    def set_fps(self, fps):
        """Runtime frame-rate change through the command queue."""
        self._cmd_queue.put({"cmd": CMD_SET_FPS, "option": 0, "value": fps})

    def set_option(self, option, value):
        """Generic camera option (exposure, gain, ...; hardware backends)."""
        self._cmd_queue.put({"cmd": CMD_SET_OPTION, "option": option, "value": value})

    def stop(self):
        self._stop.set()
        self.join(timeout=5.0)
        if self._cmd_queue is not None:
            self._cmd_queue.close()
            self._cmd_queue = None


class MultiCamera:
    """Fan-out wrapper: start N camera processes, read aligned snapshots."""

    def __init__(self, cameras, points, fps=30.0, prefix="agtpu_cam"):
        self.procs = [SyntheticCameraProcess(f"/{prefix}_{i}", cam, points, fps=fps)
                      for i, cam in enumerate(cameras)]
        self.rings = []

    def start(self):
        _load()
        for p in self.procs:  # all started first: each child's imports take a while
            p.start()
        for p in self.procs:
            p.wait_ready(timeout=30.0)
        self.rings = [ShmRingBuffer(p.ring_name, p.frame_shape, np.float32, create=False)
                      for p in self.procs]
        # wait for first frames
        deadline = time.time() + 10.0
        while any(r.count == 0 for r in self.rings):
            if time.time() > deadline:
                raise RuntimeError("no frames arrived")
            time.sleep(0.01)

    def get_obs(self, k=4, align_to=None):
        """Last-k frames per camera, aligned to a common timestamp: per camera
        the frame nearest to ``align_to`` (default: the earliest of the
        cameras' newest timestamps)."""
        frames, tss = [], []
        for r in self.rings:
            f, ts = r.get_last_k(k)
            frames.append(f)
            tss.append(ts)
        t_align = align_to if align_to is not None else min(ts[-1] for ts in tss if len(ts))
        idx = align_timestamps(tss, t_align)
        obs = {}
        for i, (f, j) in enumerate(zip(frames, idx)):
            obs[f"depth_{i}"] = f[j]
            obs[f"timestamp_{i}"] = tss[i][j]
        return obs

    def set_fps(self, fps):
        """Fan-out runtime frame-rate change."""
        for p in self.procs:
            p.set_fps(fps)

    def stop(self):
        for r in self.rings:
            r.close()
        for p in self.procs:
            p.stop()


class RealsenseCameraProcess:
    """Hardware camera process (the reference's ``SingleRealsense``). Gated."""

    def __init__(self, *a, **kw):
        try:
            import pyrealsense2  # noqa: F401
        except ImportError as e:
            raise ImportError("pyrealsense2 not available; use SyntheticCameraProcess") from e
        raise NotImplementedError("hardware bring-up tracked separately")
