"""The port's shared-memory ring, queue and camera tier: the cases of
``tests/test_shm.py`` against ``adaptigraph_tpu_torch.realworld``, and rings
and queues written by one package and read by the other's classes (the same
segment layout and record packing). Segment names carry this process's pid,
so that runs on parallel workers never meet; helper processes are spawned
(they import this module, which imports no JAX and no torch)."""

import multiprocessing as mp
import os
import queue
import time

import numpy as np
import pytest

from adaptigraph_tpu_torch.realworld import shm
from adaptigraph_tpu_torch.realworld.shm import ShmQueue, ShmRingBuffer, align_timestamps

SPAWN = mp.get_context("spawn")
PID = os.getpid()


def name(tag):
    return f"/agtt_{PID}_{tag}"


@pytest.fixture(scope="module", autouse=True)
def _build():
    shm._load()


def test_library_is_the_ports_own_build():
    """Built from the port's copy of the source into ``build/torch_shm/``,
    never the JAX package's ``build/shm/`` library; the source is a byte
    copy of the JAX package's."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    path = shm.library_path()
    assert os.path.dirname(path) == os.path.join(root, "build", "torch_shm")
    assert os.path.exists(path)
    with open(shm.SOURCE, "rb") as a, open(os.path.join(
            root, "adaptigraph_tpu", "realworld", "cpp", "shm_ring.cpp"), "rb") as b:
        assert a.read() == b.read()


def test_put_get_roundtrip():
    r = ShmRingBuffer(name("rt"), (4, 3), np.float32, capacity=8, create=True)
    try:
        for i in range(5):
            r.put(np.full((4, 3), i, np.float32), 100.0 + i)
        assert r.count == 5
        f, ts = r.get(0)
        assert ts == 104.0 and f[0, 0] == 4.0
        f, ts = r.get(2)
        assert ts == 102.0 and f[0, 0] == 2.0
        frames, tss = r.get_last_k(3)
        np.testing.assert_allclose(tss, [102.0, 103.0, 104.0])
        np.testing.assert_allclose(frames[:, 0, 0], [2.0, 3.0, 4.0])
        with pytest.raises(ValueError, match="the ring holds"):
            r.put(np.zeros((3, 4), np.float32), 0.0)
    finally:
        r.close()


def test_wraparound():
    r = ShmRingBuffer(name("wrap"), (2,), np.float32, capacity=4, create=True)
    try:
        for i in range(10):
            r.put(np.full(2, i, np.float32), float(i))
        frames, tss = r.get_last_k(8)  # only capacity=4 retained
        assert len(frames) == 4
        np.testing.assert_allclose(tss, [6.0, 7.0, 8.0, 9.0])
        assert r.get(4) is None  # lapped
    finally:
        r.close()


def test_open_existing_and_shape_check():
    r = ShmRingBuffer(name("open"), (3,), np.float32, capacity=4, create=True)
    try:
        r.put(np.ones(3, np.float32), 1.0)
        r2 = ShmRingBuffer(name("open"), (3,), np.float32, create=False)
        f, ts = r2.get()
        assert ts == 1.0
        r2.close()
        with pytest.raises(ValueError):
            ShmRingBuffer(name("open"), (4,), np.float32, create=False)
    finally:
        r.close()
    assert not os.path.exists("/dev/shm" + name("open"))  # the owner unlinked it


def _writer_proc(ring, n_frames, shape):
    r = ShmRingBuffer(ring, shape, np.float32, capacity=8, create=True)
    try:
        for i in range(n_frames):
            # every element of frame i equals i: a torn read would mix values
            r.put(np.full(shape, i, np.float32), float(i))
        time.sleep(1.0)  # keep the segment alive for the reader
    finally:
        r.close()


def test_no_torn_reads_across_processes():
    ring = name("torn")
    shape = (64, 64)
    p = SPAWN.Process(target=_writer_proc, args=(ring, 3000, shape), daemon=True)
    p.start()
    r = None
    deadline = time.time() + 20
    while r is None and time.time() < deadline:  # attach as soon as the segment exists
        try:
            r = ShmRingBuffer(ring, shape, np.float32, create=False)
        except OSError:
            time.sleep(0.005)
    assert r is not None
    reads = 0
    try:
        while p.is_alive() and reads < 5000:
            got = r.get(0)
            if got is None:
                continue
            f, ts = got
            assert f.min() == f.max(), "torn read detected"
            assert f.flat[0] == ts
            reads += 1
    finally:
        r.close()
        p.join(timeout=10)
    assert not p.is_alive()
    assert reads > 100


def test_shm_queue_roundtrip_and_full_empty():
    sq = ShmQueue.from_examples(name("q"), {"cmd": 0, "vec": np.zeros((2, 3), np.float32)},
                                capacity=4, create=True)
    try:
        with pytest.raises(queue.Empty):
            sq.get()
        for i in range(4):
            sq.put({"cmd": i, "vec": np.full((2, 3), i, np.float32)})
        assert sq.qsize() == 4
        with pytest.raises(queue.Full):
            sq.put({"cmd": 9, "vec": np.zeros((2, 3), np.float32)})
        first = sq.get()
        assert int(first["cmd"]) == 0 and first["vec"][1, 2] == 0.0
        rest = sq.get_k(2)
        np.testing.assert_array_equal(rest["cmd"], [1, 2])
        np.testing.assert_allclose(rest["vec"][:, 0, 0], [1.0, 2.0])
        allrem = sq.get_all()
        np.testing.assert_array_equal(allrem["cmd"], [3])
        assert sq.empty()
        sq.put({"cmd": 7, "vec": np.zeros((2, 3), np.float32)})
        sq.clear()
        assert sq.empty()
    finally:
        sq.close()


def _queue_consumer(qname, n, out_q):
    sq = ShmQueue(qname, [("cmd", (), np.int64), ("value", (), np.float64)], create=False)
    got = []
    deadline = time.time() + 20
    try:
        while len(got) < n and time.time() < deadline:
            if sq.empty():
                time.sleep(0.001)
                continue
            c = sq.get()
            got.append((int(c["cmd"]), float(c["value"])))
        out_q.put(got)
    finally:
        sq.close()


def test_shm_queue_cross_process_fifo():
    qname = name("qx")
    sq = ShmQueue(qname, [("cmd", (), np.int64), ("value", (), np.float64)], capacity=128,
                  create=True)
    out_q = SPAWN.Queue()
    p = SPAWN.Process(target=_queue_consumer, args=(qname, 50, out_q), daemon=True)
    p.start()
    try:
        for i in range(50):
            sq.put({"cmd": i, "value": i * 0.5})
        got = out_q.get(timeout=30)
        assert got == [(i, i * 0.5) for i in range(50)]  # FIFO, no loss
    finally:
        p.join(timeout=10)
        sq.close()
    assert not p.is_alive()


def test_camera_command_queue_changes_fps():
    from adaptigraph_tpu_torch.realworld.camera import SyntheticCameraProcess
    from adaptigraph_tpu_torch.realworld.cameras import make_multiview_cameras

    cam = make_multiview_cameras(n=1, cam_dis=0.9, cam_height=1.2, width=32, height=32,
                                 frame="z_down")[0]
    pts = np.zeros((10, 3), np.float32)
    proc = SyntheticCameraProcess(name("cmdcam"), cam, pts, fps=200.0)
    proc.start_wait(timeout=30.0)
    try:
        ring = ShmRingBuffer(proc.ring_name, proc.frame_shape, np.float32, create=False)
        # a frame-count threshold, not a rate over a fixed window: a starved
        # producer under load reaches it late, never not at all
        deadline = time.time() + 10.0
        while ring.count < 20 and time.time() < deadline:
            time.sleep(0.02)
        fast = ring.count
        proc.set_fps(5.0)  # the command round-trips through the shm queue
        time.sleep(0.3)  # let in-flight fast frames drain
        base = ring.count
        t0 = time.time()
        time.sleep(0.8)
        slow_rate = (ring.count - base) / (time.time() - t0)
        ring.close()
        assert fast >= 20
        # a throttled producer sleeps between frames, so load only lowers its rate
        assert slow_rate < 30
    finally:
        proc.stop()
    assert not proc.is_alive()
    assert not os.path.exists("/dev/shm" + proc.ring_name)
    assert not os.path.exists("/dev/shm" + proc.cmd_name)


def test_align_timestamps():
    idx = align_timestamps([[0.0, 0.1, 0.2], [0.05, 0.15], []], 0.12)
    assert idx == [1, 1, -1]


def test_multicamera_tier():
    from adaptigraph_tpu_torch.realworld.camera import MultiCamera
    from adaptigraph_tpu_torch.realworld.cameras import make_multiview_cameras

    cams = make_multiview_cameras(n=2, cam_dis=0.9, cam_height=1.2, width=64, height=64,
                                  frame="z_down")
    pts = np.random.RandomState(0).uniform(-0.1, 0.1, (50, 3)).astype(np.float32)
    pts[:, 2] = -np.abs(pts[:, 2])
    prefix = f"agtt_{PID}_mc"
    mc = MultiCamera(cams, pts, fps=60.0, prefix=prefix)
    mc.start()
    try:
        obs = mc.get_obs(k=4)
        assert obs["depth_0"].shape == (64, 64)
        assert obs["depth_1"].shape == (64, 64)
        assert np.isfinite(obs["depth_0"]).all()
        assert abs(obs["timestamp_0"] - obs["timestamp_1"]) < 0.5
        # every frame is the render of the same points
        for i, cam in enumerate(cams):
            np.testing.assert_array_equal(obs[f"depth_{i}"], cam.render_depth(pts, table_axis=2))
    finally:
        mc.stop()
    assert not any(p.is_alive() for p in mc.procs)
    assert not [f for f in os.listdir("/dev/shm") if f.startswith(prefix)]


CAMERA_SCRIPT = """
import os
import sys

import numpy as np
import torch  # noqa: F401  (a main script that imports torch at its top)

sys.path.insert(0, {root!r})
from chip_smoke import main_file_hidden, maps_torch
from adaptigraph_tpu_torch.realworld.camera import MultiCamera
from adaptigraph_tpu_torch.realworld.cameras import make_multiview_cameras

if __name__ == "__main__":
    cams = make_multiview_cameras(n=2, cam_dis=0.9, cam_height=1.2, width=32, height=32,
                                  frame="z_down")
    pts = np.zeros((10, 3), np.float32) - 0.05
    mc = MultiCamera(cams, pts, fps=30.0, prefix={prefix!r})
    with main_file_hidden():
        mc.start()
    try:
        print(maps_torch(os.getpid()), [maps_torch(p.pid) for p in mc.procs],
              "__file__" in vars(sys.modules["__main__"]))
    finally:
        mc.stop()
"""


def test_cameras_spawned_with_the_main_file_hidden_load_no_torch(tmp_path):
    """``chip_smoke.py`` imports torch at its top, and spawn would run it
    again in each camera child: it starts the cameras under
    ``main_file_hidden``, and ``maps_torch`` reads a process's mapped
    libraries. From such a script the camera children have no torch, the
    script itself has it, and its ``__file__`` is back afterwards."""
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    prefix = f"agtt_{PID}_hidden"
    script = tmp_path / "start_cameras.py"
    script.write_text(CAMERA_SCRIPT.format(root=root, prefix=prefix))
    res = subprocess.run([sys.executable, str(script)], cwd=str(tmp_path), capture_output=True,
                         text=True, timeout=120, env=dict(os.environ, PYTHONPATH=root))
    assert res.returncode == 0, res.stderr
    assert res.stdout.splitlines()[-1] == "True [False, False] True", res.stdout
    assert not [f for f in os.listdir("/dev/shm") if f.startswith(prefix)]


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_ring_layout_is_the_jax_packages(writer):
    """A ring written by one package's ``ShmRingBuffer`` is read by the
    other's: frames, timestamps, count and wraparound."""
    from adaptigraph_tpu.realworld import shm as jax_shm

    classes = {"port": ShmRingBuffer, "jax": jax_shm.ShmRingBuffer}
    reader = "jax" if writer == "port" else "port"
    ring = name(f"x{writer}")
    w = classes[writer](ring, (3, 5), np.float64, capacity=4, create=True)
    try:
        for i in range(6):
            w.put(np.arange(15, dtype=np.float64).reshape(3, 5) * i, 10.0 + i)
        r = classes[reader](ring, (3, 5), np.float64, create=False)
        try:
            assert r.count == 6
            f, ts = r.get(1)
            assert ts == 14.0
            np.testing.assert_array_equal(f, np.arange(15).reshape(3, 5) * 4.0)
            frames, tss = r.get_last_k(6)
            np.testing.assert_array_equal(tss, [12.0, 13.0, 14.0, 15.0])
            np.testing.assert_array_equal(frames[:, 0, 1], [2.0, 3.0, 4.0, 5.0])
            with pytest.raises(ValueError):
                classes[reader](ring, (3, 4), np.float64, create=False)
        finally:
            r.close()
    finally:
        w.close()


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_queue_layout_is_the_jax_packages(writer):
    """A queue of mixed-dtype records (the camera command's layout plus an
    array field) put by one package's ``ShmQueue`` is read by the other's
    in order."""
    from adaptigraph_tpu.realworld import shm as jax_shm

    classes = {"port": ShmQueue, "jax": jax_shm.ShmQueue}
    reader = "jax" if writer == "port" else "port"
    qname = name(f"qx{writer}")
    specs = [("cmd", (), np.int64), ("flag", (), np.uint8), ("value", (), np.float64),
             ("vec", (2, 3), np.float32)]
    w = classes[writer](qname, specs, capacity=8, create=True)
    try:
        for i in range(5):
            w.put({"cmd": i, "flag": i % 2, "value": i * 0.25,
                   "vec": np.full((2, 3), i, np.float32)})
        r = classes[reader](qname, specs, create=False)
        try:
            assert r.qsize() == 5
            got = r.get_k(3)
            np.testing.assert_array_equal(got["cmd"], [0, 1, 2])
            np.testing.assert_array_equal(got["flag"], [0, 1, 0])
            np.testing.assert_array_equal(got["value"], [0.0, 0.25, 0.5])
            np.testing.assert_array_equal(got["vec"][:, 1, 2], [0.0, 1.0, 2.0])
            rest = r.get_all()
            np.testing.assert_array_equal(rest["cmd"], [3, 4])
            with pytest.raises(ValueError):
                classes[reader](qname, specs[:2], create=False)
        finally:
            r.close()
    finally:
        w.close()
