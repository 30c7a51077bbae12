"""Drive the PyTorch port on one CUDA card and check it.

    python3 chip_smoke.py          # needs one CUDA card
    python3 chip_smoke.py --k1     # phases 0-3 alone: the rollout kernel, the solve
    python3 chip_smoke.py --softbody  # phases 0-1 and 17: softbody, datagen to rollout

Phases, each printing JSON lines; any failure exits non-zero:
  0. card name and power limit, torch and CUDA versions; TF32 off.
  1. build the CUDA kernels from the sources in this checkout (timed), with
     ptxas' register and spill report and each K1/K2/K3 instance's HGMMA and
     HMMA count (every K2/K3 instance and bf16 K1 must run wgmma: HGMMA;
     bf16 K1 no mma.sync: no HMMA; ptxas must not have serialised bf16
     K1's wgmma).
  2. the rollout kernel against its plain PyTorch version on the card, on the
     same inputs, in f32 and bf16 each (see ``phase_kernels``): rope width
     (fixture weights, B 2000) and granular width (5-point board, K 20), each
     in min-y and masked mean-y mode with per-sample masks and physics (B
     512); then the kernel's time (CUDA events and device time) and, from
     its profiling build, its cycles per phase.
  3. the main path: the rope MPPI solve of 20,000 samples in chunks of 2,000,
     one warm-up and three timed solves, with the kernel's launch count read
     around the timed solves.
  4. ``demo-ppo`` through the port's CLI on the rope and granular fixtures,
     and the error curve it minimises, through the kernel and the plain
     version.
  5. training: a synthetic rope dataset simulated in memory and written
     through the port's ``preprocess`` (no h5). At B 128 on three inputs,
     rope at the rope fixture's density (~1,000 real edges per sample, the
     baseline), rope on a batch of the synthetic dataset (few valid objects
     after FPS, ~40 real edges) and granular at its fixture's density
     (fixture weights): the single-step forward kernel (K2) against its
     plain version (float32 and bfloat16); the backward kernel (K3), on the
     plain forward's activations and on K2's, against its plain versions
     (on the card and on the CPU, and against a float64 plain version off
     its relu flips), plus a rerun that must be bit-identical. One train step through the kernels
     against the same step through the plain versions; K2, K3 and train-step
     times; K optimizer steps per call (``train_steps``: ``make_train_steps``,
     one step captured in a CUDA graph and replayed, K 10, f32 and bf16,
     bit for bit against the loop of ``make_train_step``, its launches per
     replay by ``torch.profiler`` kernel names, ms per step through the graph
     and the loop); then ``python -m adaptigraph_tpu_torch train --config
     rope`` (in process) for 300 steps at batch 128 (``--steps_per_call
     10``: the graphs), with the K2/K3 launch counts read around it, a
     falling loss, the checkpoint read back, and the same run through the
     plain versions, whose loss curves must agree.
  6. the single-step forward with its graph built in the kernel (K2e): at
     rope and granular width (fixture weights, B 2000) against its plain
     version in f32 and bf16 and, in f32, bit for bit against K2 on the
     tables of the plain graph build; its time, bound and device memory.
  7. the per-substep rope path: a solve's 20,000 samples (10 sorted chunks)
     through ``dynamics_rollout_batched(fused_substeps=False)`` against K1,
     f32 within the graded bound, bf16 timed with its K2e launches counted.
  8. the cloth solve (``make_mppi_solver`` on the cloth task at its
     published width, weights from ``init_params``, a synthetic sheet): a
     warm-up and three timed solves with their K2 launches counted, and one
     f32 chunk against the plain versions.
  9. ``profiling/kernel_parts.py`` (K4): the four builds of K2e with parts
     switched off, each against its plain version, timed (at the JAX
     script's states and at states packed so that every row fills its K
     slots), and the shares of K2e's time they give.
 10. bfloat16 training: K3 in bf16 against its plain bf16 version on the
     three inputs of phase 5, fed the plain forward's activations and
     bf16 K2's, which are held to the plain forward's
     (``backward_kernel_bf16``), one bf16 train step
     against a plain one, K3 bf16 and bare bf16 step times, and 300 bf16
     steps through ``make_train_step(fused_fn=fused_train_fn(..., bf16))``
     in the CLI's loop from the float32 run's initial weights, with its
     K2/K3 launches counted (``train_bf16``).
 11. the rollout evaluator, ``python -m adaptigraph_tpu_torch rollout
     --config rope --all_episodes`` in process on the synthetic dataset, with
     the float32 run's checkpoint and with the rope fixture's weights, each
     against the same evaluator through the plain forward, K2 launches
     counted (``rollout``).
 12. ``dynamics_masked`` on the cloth config (B 2000, float32, per-sample
     masks, actions and physics) against the plain version, K2 launches
     counted (``masked_tools``).
 13. the closed-loop rope plan, ``python -m adaptigraph_tpu_torch plan
     --config rope --ckpt_dir fixtures/rope_demo --n_actions 3 --seed 0``
     in process at the published width (20,000 samples in chunks of 2,000,
     bf16, adaptation on): K1's launches (each solve's chunks, each
     estimate's masked evaluations) held to the count the code implies,
     three finite errors and the step files written, the estimate in
     [-0.2, 1.2], the true parameter recorded, step 0's prediction within
     0.05 of the plain rollout of its push; ms per executed push and its
     split into perceive, solve, execute, adapt and the rest (``plan``).
 14. the granular solve (``make_mppi_solver`` at its published width,
     fixture weights, the config's box target): a warm-up and three timed
     solves with their K1 launches counted, and one float32 chunk against
     the plain version (``granular_solve``).
 15. the Planner's MPPI variant at the rope solve's width (20,000 samples
     from its correlated sampler, chunks of 2,000 through K1 in bf16, 2
     iterations, the best rolled out): K1's launches (2 x 10 + 1), its best
     reward against ``make_mppi_solver``'s on the same samples (0.05), ms
     per iteration (``planner_mppi``).
 16. the Planner's gradient-descent variant through ``dynamics_rollout``
     (512 samples, 10 Adam steps, float32 K2 forward and K3 backward per
     substep): the first gradient with respect to the actions within 5e-4 of
     its norm of the plain versions', K2 = K3 = substeps per iteration, K2
     alone in the final rollouts, a higher mean reward, peak device memory
     and ms per iteration (``planner_gd``).
 17. softbody, the widest configuration the JAX package trains, at its
     published width (N 305, 15 slots, nf 128, pstep 4, n_his 5 with the
     rest frame, ``non_fixed``, B 128): ``datagen --config softbody`` (12
     of the config's 100 episodes, 5 pushes each, 5 workers), ``filter``
     and ``preprocess`` through the CLI; K2 and K3 in f32 and bf16 against
     their plain versions on its batches, at phase 5's and 10's gates; their
     times, bounds and shared memory; K 10 steps per call through the CUDA
     graph against the loop; 200 CLI train steps with their launches and a
     falling loss; ``rollout --all_episodes`` with its K2 launches and step
     1 against the plain version (``softbody``). ``python3 chip_smoke.py
     --softbody`` runs phases 0-1 and this one alone.
The last lines are the script's wall seconds, the kernel table, the card
line, and the ok line. On every way out, the script ends the processes it
started that still run (``stop_processes``).
"""

import ctypes
import json
import os
import shutil
import subprocess
import sys
import time
from unittest import mock

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
B_CHUNK = 2000
# the rollout kernel's phases, in the order of its profiling build's counters
PHASES = ("encoder", "graph", "relation", "projection", "aggregate", "update", "head",
          "restick")
# H100 SXM dense peaks. float32-accurate products run on the tensor cores as
# split TF32 (3xTF32: three TF32 products per float32 one, ~2^-21 relative
# error), so the card's float32 rate for them is a third of TF32's 495
# TFLOP/s, not the CUDA cores' 67.
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 495e12 / 3}
PEAK_BYTES = 3.35e12
TRAIN_DIR = os.path.join(ROOT, "runs", "chip_smoke")  # gitignored; made anew each run
B_TRAIN = 128
TRAIN_ARGS = ["--epochs", "3", "--iters", "100", "--batch_size", str(B_TRAIN),
              "--steps_per_call", "10"]


_emitted = []  # the last line emit() printed


def emit(**kw):
    line = json.dumps(kw)
    _emitted[:] = [line]
    print(line, flush=True)


def fail(msg, **kw):
    """Print the error line and exit 1. The message and the line before it
    (the failed phase's, which holds the numbers its check read) also go to
    standard error, whose end is what a caller that keeps only that end
    sees."""
    before = _emitted[0] if _emitted else ""
    emit(phase="error", error=msg, **kw)
    print(f"chip_smoke: {msg}", file=sys.stderr)
    if before:
        print(before[:16000], file=sys.stderr, flush=True)
    raise SystemExit(1)


def _descendants():
    """The pids of the running processes this one started, and theirs."""
    parent = {}
    for pid in os.listdir("/proc"):
        if pid.isdigit():
            try:
                with open(f"/proc/{pid}/stat") as f:
                    state, ppid = f.read().rsplit(")", 1)[1].split()[:2]
            except OSError:  # ended meanwhile
                continue
            if state != "Z":
                parent[int(pid)] = int(ppid)
    found, todo = [], [os.getpid()]
    while todo:
        kids = [c for c, p in parent.items() if p == todo[-1]]
        todo.pop()
        found += kids
        todo += kids
    return found


def stop_processes():
    """End every process the script started that still runs, on every way
    out. The worker pools end with their calls, but the resource tracker
    that a spawned pool starts stays until the script has exited; it is
    stopped here as multiprocessing stops it (its pipe closed, then waited
    for). Anything else still running is named on standard error, sent
    SIGTERM and, 5 s later, SIGKILL."""
    import multiprocessing as mp
    import signal
    import threading
    from multiprocessing import resource_tracker

    for p in mp.active_children():
        p.terminate()
        p.join(5)
    stop = threading.Thread(target=resource_tracker._resource_tracker._stop, daemon=True)
    stop.start()
    stop.join(5)
    left = _descendants()
    for sig in (signal.SIGTERM, signal.SIGKILL):
        for pid in left:
            try:
                with open(f"/proc/{pid}/cmdline") as f:
                    cmd = f.read().replace("\0", " ").strip()
                print(f"chip_smoke: ending process {pid} ({cmd[:200]}) with {sig.name}",
                      file=sys.stderr, flush=True)
                os.kill(pid, sig)
            except OSError:  # ended meanwhile
                pass
        deadline = time.time() + 5
        while left and time.time() < deadline:
            time.sleep(0.1)
            left = _descendants()
    while True:  # reap the children that ended
        try:
            if os.waitpid(-1, os.WNOHANG)[0] == 0:
                break
        except ChildProcessError:
            break


def card_line():
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def device_ms(fn, make_inputs, reps, kernels):
    """Under ``torch.profiler``, ``reps`` calls fn(*make_inputs(r)): the
    device time per call of the kernels whose names hold one of ``kernels``;
    the host time per call (perf_counter around the call, which returns
    once its work is queued); and the host's CPU operators by self time per
    call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    host = []
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for r in range(reps):
            args = make_inputs(r)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn(*args)
            host.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
    events = prof.key_averages()
    dev = sum(e.self_device_time_total for e in events
              if e.device_type == DeviceType.CUDA and any(k in e.key for k in kernels))
    cpu = sorted((e for e in events if e.device_type == DeviceType.CPU),
                 key=lambda e: -e.self_cpu_time_total)[:8]
    return dict(device_ms=dev / 1e3 / reps, host_ms=float(np.median(host)),
                host_ops=[{"name": e.key[:60], "self_ms_per_call": e.self_cpu_time_total / 1e3 / reps,
                           "calls_per_call": e.count / reps} for e in cpu])


def median_ms(fn, make_inputs, reps):
    """CUDA-event time of fn(*inputs) per call, median over ``reps`` calls,
    each on fresh inputs."""
    times = []
    for r in range(reps):
        args = make_inputs(r)
        torch.cuda.synchronize()
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        fn(*args)
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    return float(np.median(times))


# ---------------------------------------------------------------------------
# set-up shared by the phases
# ---------------------------------------------------------------------------

def material(name, dev):
    """Task objects, fixture weights and the first recorded state of a material."""
    from adaptigraph_tpu_torch.cli import _task_objects, load_params
    from adaptigraph_tpu_torch.utils.config import load_planning_config

    tcfg, _ = _task_objects(load_planning_config(name))
    fixture = os.path.join(ROOT, "fixtures", f"{name}_demo")
    params = load_params(fixture, tcfg.dcfg.gnn, dev)
    with np.load(os.path.join(fixture, "interaction_000.npz")) as z:
        state = z["state_init"].astype(np.float32)
    M = tcfg.dcfg.gnn.max_nobj
    idx = np.random.RandomState(0).choice(len(state), M, replace=len(state) < M)
    return tcfg, params, state[idx], fixture


def chunk_case(tcfg, state, B, seed, dev, cd, n_steps=None, masked=False):
    """Kernel inputs for B pushes drawn from the task's action limits; with
    ``n_steps``, every push is cut to that many substeps."""
    from adaptigraph_tpu_torch.ops.fused_gnn import chunk_inputs
    from adaptigraph_tpu_torch.planning.actions import decode_action
    from adaptigraph_tpu_torch.planning.forward import pusher_keypoints

    dcfg = tcfg.dcfg
    n_p = dcfg.gnn.max_nobj
    rng = np.random.RandomState(seed)
    lo, hi = tcfg.action_lower_lim, tcfg.action_upper_lim
    act = torch.tensor(rng.uniform(lo, hi, (B, 4)).astype(np.float32), device=dev)
    decoded, repeat = decode_action(act, dcfg.push_length)
    if n_steps is not None:
        repeat = torch.full_like(repeat, n_steps)
    obj = torch.tensor(state, device=dev)[None].expand(B, n_p, 3)
    mask, phys = None, torch.tensor([0.5], device=dev)
    if masked:
        counts = rng.randint(n_p // 2, n_p + 1, B)
        mask = torch.tensor(np.arange(n_p)[None] < counts[:, None], device=dev)
        obj = obj * mask[..., None]
        phys = torch.tensor(rng.uniform(0, 1, (B, 1)).astype(np.float32), device=dev)
        m = mask.float()
        y = (obj[..., 1] * m).sum(1) / m.sum(1).clamp(min=1)
    else:
        y = obj[..., 1].amin(1)
    kp, delta = pusher_keypoints(dcfg, decoded, act[:, 2], y)
    return chunk_inputs(obj, kp, delta, repeat, phys, dcfg.gnn, cd, mask)


def k1_work(gnn, pin, sa, weights, out, stats, B):
    """(operations, bytes) the rollout needs on these inputs: the matmul
    FLOPs of the particle encoder, the propagator base and round 1's
    recv|send (the effect starts from the particle encoding) once per sample,
    the other node-level products per substep a sample runs, and the
    relation MLP per real edge; every input read once and the output written
    once."""
    N, n_p, nf = gnn.n_nodes, gnn.max_nobj, gnn.nf_effect
    nfp, nfr, rin, Dp = gnn.nf_particle, gnn.nf_relation, gnn.relation_input_dim, pin.shape[-1]
    recv_send = 2 * N * nf * 2 * nf
    per_sample = 2 * N * (Dp * nfp + nfp * nfp + nfp * nf) + 2 * N * nf * nf + recv_send
    per_step = ((gnn.pstep - 1) * recv_send + gnn.pstep * 2 * N * nf * nf
                + 2 * n_p * (2 * nf * nf + 3 * nf))
    per_edge = 2 * (rin * nfr + nfr * nfr + nfr * nf + nf * nf)
    ops = B * per_sample + stats["sample_steps"] * per_step + stats["edges"] * per_edge
    nbytes = sum(t.numel() * t.element_size() for t in [pin, sa, out] + list(weights))
    nbytes += B * 4 + pin.shape[0] * pin.shape[1] * 4  # repeat, valid
    return ops, nbytes


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

KERNEL_FUNCTIONS = ("gnn_forward_kernel", "gnn_train_bwd_kernel", "rollout_chunk_kernel")


def kernel_label(fn):
    """A template instance's name, e.g. ``rollout_chunk_kernel<bf16>``, from its
    mangled name, or None for another function."""
    name = next((k for k in KERNEL_FUNCTIONS if k in fn), None)
    return None if name is None else name + ("<bf16>" if "bfloat16" in fn else "<float>")


def sass_counts(path):
    """The tensor-core instructions of every K1/K2/K3 template instance in the
    built library (``cuobjdump -sass``): {kernel: {"HGMMA": n, "HMMA": n}}."""
    import re

    from adaptigraph_tpu_torch.ops import kernels

    cuobjdump = os.path.join(os.path.dirname(kernels._nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", path], capture_output=True, text=True,
                          check=True).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = kernel_label(line.split("Function :")[1].strip())
            if name is not None:
                counts[name] = {"HGMMA": 0, "HMMA": 0}
        elif name is not None:
            hit = re.search(r"\b(HGMMA|HMMA)\.", line)
            if hit:
                counts[name][hit.group(1)] += 1
    return counts


def ptxas_kernels(report):
    """Registers and spill bytes of each K1/K2/K3 instance from ptxas' report
    (``-Xptxas -v``): {kernel: {"registers": n, "spill_stores": bytes,
    "spill_loads": bytes}}."""
    import re

    out, name = {}, None
    for line in report:
        hit = re.search(r"(?:Compiling entry function|Function properties for) '?([\w$]+)", line)
        if hit:
            name = kernel_label(hit.group(1))
            continue
        if name is None:
            continue
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if spill:
            out.setdefault(name, {}).update(spill_stores=int(spill.group(1)),
                                            spill_loads=int(spill.group(2)))
        regs = re.search(r"Used (\d+) registers", line)
        if regs:
            out.setdefault(name, {})["registers"] = int(regs.group(1))
    return out


def wgmma_serialized(report):
    """ptxas' notes (C75xx) that it serialised the wgmma instructions of a
    K1/K2/K3 instance: [(kernel, note)]. ptxas builds such an instance
    without failing, and it runs the products one at a time."""
    import re

    out = []
    for line in report:
        hit = re.search(r"\((C75\d\d)\).*wgmma.*serialized.*function '([\w$]+)'", line)
        if hit and kernel_label(hit.group(2)) is not None:
            out.append((kernel_label(hit.group(2)), line.split(":", 1)[-1].strip()[:200]))
    return out


def phase_build():
    """Build the kernels and, at the same time, their profiling builds (the
    per-phase SM-cycle counters of ``kernel_phases`` and the ablations of
    ``kernel_parts``), one nvcc process per source, all started together.
    The line gives ptxas' register and spill report, per K1/K2/K3 instance
    too, and the HGMMA and HMMA counts of each instance: every K2/K3 instance
    must have HGMMA (wgmma: bf16, and float32's split TF32), and bf16 K1
    HGMMA and no HMMA (mma.sync); float32 K1 (the CUDA cores) is reported.
    It fails if ptxas serialised bf16 K1's wgmma (``wgmma_serialized``); the
    K2/K3 instances' notes are reported (their layer routine waits after
    every k-step, and ptxas serialises it: C7520)."""
    from concurrent.futures import ThreadPoolExecutor

    from adaptigraph_tpu_torch.ops import kernels

    t0 = time.time()
    with ThreadPoolExecutor(len(kernels.VARIANTS)) as pool:
        path = list(pool.map(kernels.build, kernels.VARIANTS))[0]
    kernels.library()
    with open(path + ".ptxas.txt") as f:
        report = f.read().splitlines()
    ptxas = [ln.strip() for ln in report if "registers" in ln or "spill" in ln]
    counts = sass_counts(path)
    k1 = counts.get("rollout_chunk_kernel<bf16>", {"HGMMA": 0, "HMMA": 1})
    ok = (len(counts) == 6 and "rollout_chunk_kernel<float>" in counts
          and all(c["HGMMA"] > 0 for k, c in counts.items() if not k.startswith("rollout"))
          and k1["HGMMA"] > 0 and k1["HMMA"] == 0)
    serialized = wgmma_serialized(report)
    k1_serialized = any(k == "rollout_chunk_kernel<bf16>" for k, _ in serialized)
    emit(phase="build", seconds=round(time.time() - t0, 2), library=os.path.relpath(path, ROOT),
         variants=[v for v in kernels.VARIANTS if v], ptxas=ptxas,
         ptxas_kernels=ptxas_kernels(report), tensor_core_instructions=counts,
         wgmma_serialized=serialized, ok=ok and not k1_serialized)
    if not ok:
        fail("a kernel instance lacks its tensor-core instructions, or bf16 K1 keeps mma.sync "
             "(see the build line)")
    if k1_serialized:
        fail("ptxas serialised the wgmma of rollout_chunk_kernel<bf16> (see the build line)")


def run_both(mat, dev, cd, B, n_steps, masked, seed=0, stats=None):
    """The kernel and the plain version on the same inputs. Returns (kernel,
    plain, per-sample repeat, result mask): invalid object rows of a masked
    case are not part of the result."""
    from adaptigraph_tpu_torch.ops.fused_gnn import rollout_chunk, rollout_chunk_plain, weight_list

    tcfg, params, state = mat[:3]
    dcfg = tcfg.dcfg
    gnn = dcfg.gnn
    weights = weight_list(params, gnn, cd)
    pin, sa, rep, valid = chunk_case(tcfg, state, B, seed, dev, cd, n_steps, masked)
    args = (pin, sa, rep, valid, weights, gnn, dcfg.edge.topk, dcfg.adj_thresh, dcfg.max_repeat,
            dcfg.gripper_lift, masked, cd)
    got = rollout_chunk(*args)
    torch.cuda.synchronize()
    want = rollout_chunk_plain(*args, stats=stats)
    keep = (valid[:, :gnn.max_nobj, None] > 0) if masked else torch.ones_like(got, dtype=torch.bool)
    return got, want, rep, keep


def per_sample_err(a, b, keep):
    return ((a - b).abs() * keep).flatten(1).amax(1).cpu().numpy()


def check_kernel(name, mat, dev, cd, tol, n_steps=None, masked=False, B=B_CHUNK):
    """Kernel vs plain version on identical inputs, every sample's error held
    to ``tol``: a float, or a function of the sample's repeat (the graded
    float32 whole-push bound). Returns (max error, ok)."""
    stats = {}
    got, want, rep, keep = run_both(mat, dev, cd, B, n_steps, masked, stats=stats)
    err = per_sample_err(got, want, keep)
    reps = rep.cpu().numpy()
    tols = np.array([tol(int(r)) for r in reps]) if callable(tol) else np.full(B, tol)
    ok = bool(torch.isfinite(got).all() and (err <= tols).all())
    emit(phase="kernel_check", case=name, dtype=str(cd).split(".")[-1], B=B,
         substeps=n_steps or "push", max_abs_err=float(err.max()),
         p99_abs_err=float(np.quantile(err, 0.99)),
         tol=(float(tols.max()) if callable(tol) else tol), graded=callable(tol),
         edges=stats["edges"], sample_steps=stats["sample_steps"], ok=ok)
    return float(err.max()), ok


def check_bf16_push(name, mat, dev, masked=False, B=B_CHUNK, max_tol=None):
    """Whole bf16 pushes, held against the float32 plain version as the bf16
    plain version is. A bf16 rounding that lands one step apart (the tensor
    cores and the plain version's float32 products sum in different orders)
    moves a position by a bf16 step, which the next substep's bf16 inputs and
    top-k picks amplify; so two correct bf16 rollouts drift apart with the
    repeat, as each drifts from float32. The check: the median over samples
    of the per-sample error against float32 is the same for the kernel as
    for the plain version, within 25%; with ``max_tol``, every sample's
    kernel-vs-plain error is also held to it."""
    bf16 = torch.bfloat16
    got, want, _, keep = run_both(mat, dev, bf16, B, None, masked)
    _, ref, _, _ = run_both(mat, dev, torch.float32, B, None, masked)
    e_kernel, e_plain = per_sample_err(got, ref, keep), per_sample_err(want, ref, keep)
    apart = per_sample_err(got, want, keep)
    ratio = float(np.median(e_kernel) / np.median(e_plain))
    ok = bool(torch.isfinite(got).all() and abs(ratio - 1) <= 0.25
              and (max_tol is None or apart.max() <= max_tol))
    emit(phase="kernel_check", case=name, dtype="bfloat16", B=B, substeps="push",
         max_abs_err=float(apart.max()), p99_abs_err=float(np.quantile(apart, 0.99)),
         median_abs_err=float(np.median(apart)), vs_float32_kernel_median=float(np.median(e_kernel)),
         vs_float32_plain_median=float(np.median(e_plain)),
         vs_float32_kernel_p99=float(np.quantile(e_kernel, 0.99)),
         vs_float32_plain_p99=float(np.quantile(e_plain, 0.99)),
         median_ratio=ratio, tol=f"median ratio within 1 +- 0.25; max {max_tol}", ok=ok)
    return float(apart.max()), ok


def graded(r):
    # whole pushes: the bound loosens with the number of autoregressive
    # substeps (tests/test_fused.py:234 grades 2e-3 / 8e-3 / 3e-2 by length)
    return 2e-3 if r <= 1 else 8e-3 if r <= 4 else 3e-2


def phase_kernels(dev):
    """Every body of the kernel at each width: float32 and bfloat16 (separate
    code in the kernel), min-y and masked mean-y (per-sample masks and
    physics), rope and granular. Masked cases run at B 512, the physics
    optimizer's batch (pad_p 32 x pad_i 16).

    float32 is held to 2e-4 for one substep and to the graded bound for whole
    pushes. bf16 is held to 0.05 (the bf16 bound of tests/test_fused.py) for
    pushes of one and of two substeps, which run every line of the bf16 body:
    graph, relation MLP, aggregation, update, head, then the re-stick and the
    history shift, read by the second substep. Whole bf16 pushes are held by
    ``check_bf16_push``; the rope push of the main path also to 0.05."""
    rope = material("rope", dev)
    gran = material("granular", dev)
    f32, bf16 = torch.float32, torch.bfloat16
    masked = "masked mean-y"
    checks, main_err = [], None
    for name, mat, B, is_masked in (("rope", rope, B_CHUNK, False),
                                    (f"rope {masked}", rope, 512, True),
                                    ("granular", gran, B_CHUNK, False),
                                    (f"granular {masked}", gran, 512, True)):
        checks.append(check_kernel(name, mat, dev, f32, 2e-4, n_steps=1, masked=is_masked, B=B))
        checks.append(check_kernel(name, mat, dev, f32, graded, masked=is_masked, B=B))
        for n in (1, 2):
            checks.append(check_kernel(name, mat, dev, bf16, 0.05, n_steps=n, masked=is_masked,
                                       B=B))
        checks.append(check_bf16_push(name, mat, dev, masked=is_masked, B=B,
                                      max_tol=0.05 if name == "rope" else None))
        if name == "rope":  # the main path's shapes
            main_err = checks[-1][0]
    if not all(ok for _, ok in checks):
        fail("the rollout kernel disagrees with its plain version (see kernel_check lines)")
    return rope, main_err


def time_kernel(rope, dev):
    """Kernel and plain-version time per chunk launch at the main path's shapes
    (rope, B 2000, bf16), each repetition on fresh actions: CUDA events around
    the wrapper call (median of 7) and the kernel's device time under
    ``torch.profiler``; the bound, and the kernel's shared memory per block."""
    from adaptigraph_tpu_torch.ops import kernels
    from adaptigraph_tpu_torch.ops.fused_gnn import (rollout_chunk_cuda, rollout_chunk_plain,
                                                     weight_list)

    tcfg, params, state, _ = rope
    dcfg, cd = tcfg.dcfg, torch.bfloat16
    gnn = dcfg.gnn
    weights = weight_list(params, gnn, cd)
    const = (weights, gnn, dcfg.edge.topk, dcfg.adj_thresh, dcfg.max_repeat, dcfg.gripper_lift,
             False, cd)

    def inputs(r):
        return chunk_case(tcfg, state, B_CHUNK, 100 + r, dev, cd) + const

    rollout_chunk_cuda(*inputs(99))  # warm-up: library load, allocator
    ms = median_ms(rollout_chunk_cuda, inputs, 7)
    dev_t = device_ms(rollout_chunk_cuda, inputs, 5, ["rollout_chunk_kernel"])
    plain_ms = median_ms(rollout_chunk_plain, inputs, 5)
    _, Np, Dp = inputs(0)[0].shape
    smem = kernels.library().rollout_chunk_smem_bytes(
        Np, gnn.n_nodes, gnn.max_nobj, dcfg.edge.topk, gnn.n_his, gnn.pstep, Dp, gnn.nf_particle,
        gnn.nf_relation, gnn.nf_effect, gnn.relation_input_dim, 1)
    stats = {}
    pin, sa = inputs(100)[:2]
    out = rollout_chunk_plain(*inputs(100), stats=stats)
    ops, nbytes = k1_work(gnn, pin, sa, weights, out, stats, B_CHUNK)
    t_ops, t_bytes = ops / PEAK_FLOPS[cd] * 1e3, nbytes / PEAK_BYTES * 1e3
    # where a block's time goes: SM cycles per phase, summed over the blocks,
    # from one launch of the profiling build
    clocks = torch.zeros(B_CHUNK, len(PHASES), dtype=torch.int64, device=dev)
    prof = kernels.library("phase_clocks")
    prof.rollout_chunk_set_phase_clocks(clocks.data_ptr())
    with mock.patch.object(kernels, "library", lambda: prof):
        rollout_chunk_cuda(*inputs(100))
    prof.rollout_chunk_set_phase_clocks(None)
    cycles = clocks.sum(0).double()
    # what the counters' code costs with no buffer set (each mark a run-time
    # test): the two builds alternate on the same inputs
    pairs = []
    for r in range(7):
        normal = median_ms(rollout_chunk_cuda, lambda _: inputs(r), 1)
        with mock.patch.object(kernels, "library", lambda: prof):
            pairs.append((normal, median_ms(rollout_chunk_cuda, lambda _: inputs(r), 1)))
    normal_ms, prof_ms = np.median(np.array(pairs), axis=0)
    emit(phase="kernel_phases", cycles_per_sample_step=float(cycles.sum()) / stats["sample_steps"],
         share={k: round(float(v), 4) for k, v in zip(PHASES, cycles / cycles.sum())},
         normal_build_ms=float(normal_ms), profiling_build_counters_off_ms=float(prof_ms))
    return dict(ms=ms, device_ms=dev_t["device_ms"], host_ms=dev_t["host_ms"], plain_ms=plain_ms,
                bound_ms=max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes",
                gflop_per_launch=ops / 1e9, smem_bytes_per_block=smem,
                edges_per_sample_step=stats["edges"] / stats["sample_steps"])


def plain_push(dcfg, params, state, act_seq, phys, dev):
    """The plain bf16 rollout, on the card, of the first push of ``act_seq``
    (L, 4) from ``state`` (max_nobj, 3) at physics ``phys``, as the solve
    rolls it out: (max_nobj, 3)."""
    from adaptigraph_tpu_torch.ops.fused_gnn import chunk_inputs, rollout_chunk_plain, weight_list
    from adaptigraph_tpu_torch.planning.actions import decode_action
    from adaptigraph_tpu_torch.planning.forward import pusher_keypoints

    cd = torch.bfloat16
    best = torch.as_tensor(act_seq, device=dev).reshape(1, -1, 4)
    decoded, repeat = decode_action(best, dcfg.push_length)
    obj = torch.as_tensor(state, device=dev)[None]
    kp, delta = pusher_keypoints(dcfg, decoded[:, 0], best[:, 0, 2], obj[..., 1].amin(1))
    return rollout_chunk_plain(*chunk_inputs(obj, kp, delta, repeat[:, 0],
                                             torch.as_tensor(phys, device=dev), dcfg.gnn, cd),
                               weight_list(params, dcfg.gnn, cd), dcfg.gnn, dcfg.edge.topk,
                               dcfg.adj_thresh, dcfg.max_repeat, dcfg.gripper_lift, False, cd)[0]


def phase_solve(rope, dev):
    from adaptigraph_tpu_torch.ops.fused_gnn import fused_rollout_chunk
    from adaptigraph_tpu_torch.planning.closed_loop import make_reward_fn
    from adaptigraph_tpu_torch.planning.mppi_solve import make_mppi_solver

    tcfg, params, state, _ = rope
    dcfg, mcfg = tcfg.dcfg, tcfg.mcfg
    if (mcfg.n_sample, mcfg.n_sample_chunk) != (20000, 2000):
        fail(f"rope planning config is not the 20,000/2,000 budget: {mcfg}")
    target = state + np.array([0.5, 0.0, 0.3], np.float32)
    solve = make_mppi_solver(dcfg, mcfg, make_reward_fn(tcfg, target, dev),
                             tcfg.action_lower_lim, tcfg.action_upper_lim, device=dev)
    act0 = np.tile((tcfg.action_lower_lim + tcfg.action_upper_lim) / 2, (mcfg.n_look_ahead, 1))
    phys = np.array([0.5], np.float32)

    def run(seed):
        g = torch.Generator(device=dev)
        g.manual_seed(seed)
        return solve(params, state, act0, g, phys)

    run(0)  # warm-up
    torch.cuda.synchronize()
    n_solves = 3
    fused_rollout_chunk.launches = 0
    t0 = time.time()
    results = []
    for seed in range(1, n_solves + 1):
        results.append(run(seed))
        torch.cuda.synchronize()
    secs = time.time() - t0
    launches = fused_rollout_chunk.launches
    per_solve = mcfg.n_sample // mcfg.n_sample_chunk * mcfg.n_look_ahead
    res = results[-1]
    on_card = all(v.is_cuda for v in res.values())
    finite = all(bool(torch.isfinite(r["best_reward"])) for r in results)
    # the solve's best final state against the plain rollout of its best push
    ref = plain_push(dcfg, params, state, res["act_seq"], phys, dev)
    best_err = float((ref - res["best_final_state"]).abs().max())
    emit(phase="solve", n_sample=mcfg.n_sample, n_sample_chunk=mcfg.n_sample_chunk,
         solves=n_solves, ms_per_solve=secs / n_solves * 1e3, solves_per_s=n_solves / secs,
         launches=launches, launches_per_solve=launches / n_solves,
         best_rewards=[float(r["best_reward"]) for r in results],
         best_act_seq=res["act_seq"].cpu().tolist(), best_final_vs_plain=best_err,
         outputs_on_card=on_card)
    if launches != per_solve * n_solves or not on_card or not finite or best_err > 0.05:
        fail("main-path solve check failed")
    return launches


def phase_demo_ppo(dev):
    """demo-ppo through the CLI, then the error it minimises, the mean masked
    Chamfer error of the recorded interactions, on a 29-point grid of the
    parameter, through the kernel and through the plain version on the card:
    the curves must agree within 1e-3 + 1% at every point. The same demo
    with the plain version in place of the kernel gives its estimate for
    comparison; where the curve is flat (granular) the two minimisers may
    lie apart without either being wrong."""
    from adaptigraph_tpu_torch.cli import _task_objects, load_params, main
    from adaptigraph_tpu_torch.ops import fused_gnn
    from adaptigraph_tpu_torch.planning.physics_optimizer import (PARAM_HI, PARAM_LO,
                                                                  PhysicsParamOnlineOptimizer)
    from adaptigraph_tpu_torch.utils.config import load_planning_config

    def plain():  # the plain version in place of the kernel, on the card
        return mock.patch.object(fused_gnn, "rollout_chunk", fused_gnn.rollout_chunk_plain)

    grid = np.linspace(PARAM_LO, PARAM_HI, 29)[:, None]
    for name, jax_est, truth in (("rope", 0.3496, 0.35), ("granular", 0.177, 0.2220)):
        fixture = os.path.join(ROOT, "fixtures", f"{name}_demo")
        argv = ["demo-ppo", "--config", name, "--load_dir", fixture, "--ckpt_dir", fixture]
        t0 = time.time()
        est, err, err0 = main(argv)
        secs = time.time() - t0
        with plain():
            plain_est, plain_err, _ = main(argv)
        tcfg, _ = _task_objects(load_planning_config(name))
        ppo = PhysicsParamOnlineOptimizer(tcfg.dcfg, load_params(fixture, tcfg.dcfg.gnn, dev),
                                          phys_dim=tcfg.dcfg.gnn.phys_dim, device=dev)
        ppo.load_interactions(fixture)
        curve = ppo.evaluate(grid)
        with plain():
            plain_curve = ppo.evaluate(grid)
        curve_err = np.abs(curve - plain_curve)
        est = float(est[0])
        ok = bool(np.isfinite(est) and err <= err0 and np.isfinite(curve).all()
                  and (curve_err <= 1e-3 + 0.01 * np.abs(plain_curve)).all())
        if name == "rope":
            ok = ok and abs(est - truth) <= 0.02
        emit(phase="demo_ppo", fixture=name, estimate=est, plain_estimate=float(plain_est[0]),
             jax_estimate=jax_est, truth=truth, error=err, plain_error=plain_err,
             error_init=err0, seconds=round(secs, 2), curve_max_abs_err=float(curve_err.max()),
             curve_min=float(curve.min()), curve_max=float(curve.max()),
             curve_argmin=float(grid[np.argmin(curve), 0]),
             plain_curve_argmin=float(grid[np.argmin(plain_curve), 0]), ok=ok)
        if not ok:
            fail(f"demo-ppo on {name} out of bounds")


# ---------------------------------------------------------------------------
# the per-substep forward (K2e), its profiling copy (K4), cloth planning (K2)
# ---------------------------------------------------------------------------

def substep_inputs(mat, B, seed, dev, cd):
    """K2e's inputs at the first substep of B pushes drawn from the task's
    action limits: the fixture state with 0.005 of noise per sample and
    history frame, the eef rows at each push's start and their action.
    Returns (packed nodes in cd, newest frame (B, Np, 3) f32, weights in cd,
    the graph dict that ``fused_forward_batch`` takes)."""
    from adaptigraph_tpu_torch.ops.fused_gnn import pack_node_inputs, pad_last, weight_list
    from adaptigraph_tpu_torch.planning.actions import decode_action
    from adaptigraph_tpu_torch.planning.forward import pusher_keypoints

    tcfg, params, state = mat[:3]
    dcfg = tcfg.dcfg
    gnn = dcfg.gnn
    n_p, N, n_his = gnn.max_nobj, gnn.n_nodes, gnn.n_his
    rng = np.random.RandomState(seed)
    lo, hi = tcfg.action_lower_lim, tcfg.action_upper_lim
    act = torch.tensor(rng.uniform(lo, hi, (B, 4)).astype(np.float32), device=dev)
    decoded, _ = decode_action(act, dcfg.push_length)
    obj = torch.tensor(state + rng.randn(B, n_his, n_p, 3).astype(np.float32) * 0.005, device=dev)
    kp, delta = pusher_keypoints(dcfg, decoded, act[:, 2], obj[:, -1, :, 1].amin(1))
    hist = torch.cat([obj, kp[:, None].expand(B, n_his, N - n_p, 3)], dim=2).contiguous()
    is_tool = torch.arange(N, device=dev) >= n_p
    graph = {"state": hist,
             "action": torch.cat([torch.zeros(B, n_p, 3, device=dev), delta], dim=1),
             "attrs": torch.stack([~is_tool, is_tool], -1).float().expand(B, N, 2),
             "p_instance": torch.ones(B, n_p, 1, device=dev),
             "physics_param": torch.full((B, gnn.phys_dim), 0.5, device=dev)}
    nodes, _ = pack_node_inputs(gnn, graph["state"], graph["action"], graph["physics_param"],
                                graph["attrs"], graph["p_instance"], cd)
    return nodes, pad_last(gnn, hist), weight_list(params, gnn, cd), graph


def forward_work(gnn, nodes, msk, weights, outputs):
    """(operations, bytes) of a forward alone (K2e, K2 in planning, K4) on
    these inputs: the matmul FLOPs on the N real rows and the real edges of
    ``msk``; each input read once (nodes, the newest frame, weights, and
    the tables where given) and each output written once; no activations."""
    N, n_p, nf, P = gnn.n_nodes, gnn.max_nobj, gnn.nf_effect, gnn.pstep
    nfp, nfr, rin = gnn.nf_particle, gnn.nf_relation, gnn.relation_input_dim
    B, Np, Dp = nodes.shape[0], nodes.shape[1], nodes.shape[2] - gnn.n_his * 3 - 3
    E = float((msk > 0).sum())
    node = (Dp * nfp + nfp * nfp + nfp * nf + nf * nf + P * (nf * 2 * nf + nf * nf)
            + 2 * nf * nf)
    edge = rin * nfr + nfr * nfr + nfr * nf + nf * nf
    ops = 2 * (B * N * node + B * n_p * nf * 3 + E * edge)
    nbytes = (sum(t.numel() * t.element_size() for t in [nodes] + list(weights))
              + B * Np * 3 * 4 + outputs * B * n_p * 3 * 4)
    return ops, nbytes


def peak_mb(fn):
    """Device memory that fn() allocates at its peak, above what was
    allocated before it, in MB."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    fn()
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - base) / 1e6


def phase_edges_kernel(rope, gran, dev):
    """K2e against its plain version on the same inputs (``substep_inputs``,
    fixture weights, B 2000): rope width (K 10) and granular width (K 20),
    float32 at 2e-4 and bfloat16 at 2% of the plain version's largest
    |motion|, as K2 is held. In float32 it must also equal K2 bit for bit on
    the tables that the plain graph build (``radius_edge_tables``) makes of
    the same state, and K2 equal itself with training's activations kept.
    Returns the rope bfloat16 error (the main path's dtype)."""
    from adaptigraph_tpu_torch.ops.fused_gnn import (gnn_forward_cuda, gnn_forward_edges_cuda,
                                                     gnn_forward_edges_plain, radius_edge_tables)

    errs, ok_all = {}, True
    for name, mat in (("rope", rope), ("granular", gran)):
        dcfg = mat[0].dcfg
        gnn, K, adj = dcfg.gnn, dcfg.edge.topk, dcfg.adj_thresh
        for cd in (torch.float32, torch.bfloat16):
            nodes, last, w, _ = substep_inputs(mat, B_CHUNK, 7, dev, cd)
            pred, mot = gnn_forward_edges_cuda(nodes, last, w, gnn, cd, K, adj)
            torch.cuda.synchronize()
            want_pred, want_mot = gnn_forward_edges_plain(nodes, last, w, gnn, cd, K, adj)
            err = max(float((pred - want_pred).abs().max()), float((mot - want_mot).abs().max()))
            max_mot = float(want_mot.abs().max())
            tol = 2e-4 if cd == torch.float32 else 0.02 * max_mot
            ok = bool(torch.isfinite(pred).all() and torch.isfinite(mot).all() and err <= tol)
            nbr, msk = radius_edge_tables(last, gnn, K, adj)
            extra = {}
            if cd == torch.float32:
                k2 = gnn_forward_cuda(nodes, nbr, msk, last, w, gnn, cd, keep_acts=False)
                k2_keep = gnn_forward_cuda(nodes, nbr, msk, last, w, gnn, cd, keep_acts=True)
                differ = ((k2[0] != pred) | (k2[1] != mot)).flatten(1).any(1)
                keep_same = bool(torch.equal(k2[0], k2_keep[0]) and torch.equal(k2[1], k2_keep[1]))
                first = int(differ.nonzero()[0, 0]) if differ.any() else None
                extra = dict(k2_bit_identical=first is None, first_differing_sample=first,
                             k2_keep_acts_bit_identical=keep_same)
                if first is not None:
                    extra.update(k2e_pred=pred[first].tolist(), k2_pred=k2[0][first].tolist())
                ok = ok and first is None and keep_same
            ok_all &= ok
            errs[(name, str(cd).split(".")[-1])] = err
            emit(phase="edges_kernel_check", case=name, dtype=str(cd).split(".")[-1], B=B_CHUNK,
                 K=K, real_edges_per_sample=real_edges(msk), max_abs_err=err,
                 plain_max_abs_motion=max_mot, tol=tol, ok=ok, **extra)
    if not ok_all:
        fail("K2e disagrees with its plain version or with K2 (see edges_kernel_check)")
    return errs[("rope", "bfloat16")]


def time_edges_kernel(rope, dev):
    """K2e per launch at the main path's shapes (rope, B 2000, bf16, no
    motion), CUDA events, median of 7 on other inputs each; its plain
    version; the bound; and the device memory it takes beside K2's on the
    same graph with training's activations kept."""
    from adaptigraph_tpu_torch.ops.fused_gnn import (gnn_forward_cuda, gnn_forward_edges_cuda,
                                                     gnn_forward_edges_plain, radius_edge_tables)

    dcfg, cd = rope[0].dcfg, torch.bfloat16
    const = (dcfg.gnn, cd, dcfg.edge.topk, dcfg.adj_thresh, False)
    ins = [substep_inputs(rope, B_CHUNK, 100 + r, dev, cd)[:3] for r in range(7)]
    gnn_forward_edges_cuda(*ins[0], *const)  # warm-up
    ms = median_ms(lambda *a: gnn_forward_edges_cuda(*a, *const), lambda r: ins[r], 7)
    plain_ms = median_ms(lambda *a: gnn_forward_edges_plain(*a, *const), lambda r: ins[r], 3)
    nodes, last, w = ins[0]
    nbr, msk = radius_edge_tables(last, dcfg.gnn, dcfg.edge.topk, dcfg.adj_thresh)
    mem = peak_mb(lambda: gnn_forward_edges_cuda(nodes, last, w, *const))
    mem_keep = peak_mb(lambda: gnn_forward_cuda(nodes, nbr, msk, last, w, dcfg.gnn, cd,
                                                want_motion=False, keep_acts=True))
    ops, nbytes = forward_work(dcfg.gnn, nodes, msk, w, outputs=1)
    b_ms, b_by = bound(ops, nbytes, PEAK_FLOPS[cd])
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, gflop_per_launch=ops / 1e9,
                real_edges_per_sample=real_edges(msk), peak_mb=mem, k2_keep_acts_peak_mb=mem_keep)


def phase_substep_solve(rope, dev):
    """One rope solve's worth of samples (20,000 from the sampler, sorted by
    repeat, 10 chunks of 2,000) through ``dynamics_rollout_batched`` per
    substep (K2e) and whole-push (K1). float32: every sample's final state
    within the graded whole-push bound of K1's. bfloat16 (the main path of
    this phase, timed, K2e launches counted from 0): against float32 K1, the
    median per-sample error within 25% of bf16 K1's, as ``check_bf16_push``
    holds K1. The K2e launches must be the sum over chunks of min(largest
    repeat, max_repeat), with no K1 launch."""
    from adaptigraph_tpu_torch.ops import fused_gnn
    from adaptigraph_tpu_torch.ops.fused_gnn import weight_list
    from adaptigraph_tpu_torch.planning.actions import decode_action, sample_action_seq
    from adaptigraph_tpu_torch.planning.forward import dynamics_rollout_batched
    from adaptigraph_tpu_torch.planning.mppi_solve import sort_by_repeat

    tcfg, params, state = rope[:3]
    dcfg, mcfg = tcfg.dcfg, tcfg.mcfg
    lo = torch.tensor(tcfg.action_lower_lim, device=dev)
    hi = torch.tensor(tcfg.action_upper_lim, device=dev)
    g = torch.Generator(device=dev)
    g.manual_seed(3)
    act0 = ((lo + hi) / 2)[None].expand(mcfg.n_look_ahead, 4)
    acts = sort_by_repeat(sample_action_seq(g, act0, lo, hi, mcfg.n_sample, iter_index=0,
                                            noise_level=mcfg.noise_level,
                                            push_length=mcfg.push_length), mcfg.push_length)
    chunks = acts.split(mcfg.n_sample_chunk)
    rep = decode_action(acts, mcfg.push_length)[1]
    steps = sum(min(int(r.max()), dcfg.max_repeat) for c in rep.split(mcfg.n_sample_chunk)
                for r in c.T)
    obj, phys = torch.tensor(state, device=dev), torch.tensor([0.5], device=dev)

    def run(cd, fused):
        w = weight_list(params, dcfg.gnn, cd)
        return torch.cat([dynamics_rollout_batched(w, obj, c, phys, dcfg, compute_dtype=cd,
                                                   fused_substeps=fused)["state_seqs"][:, -1]
                          for c in chunks])

    def timed(cd, fused):
        torch.cuda.synchronize()
        t0 = time.time()
        out = run(cd, fused)
        torch.cuda.synchronize()
        return out, (time.time() - t0) * 1e3

    keep = torch.ones_like(acts[:, 0, :1, None], dtype=torch.bool)
    sub32, sub32_ms = timed(torch.float32, False)
    k1_32, k1_32_ms = timed(torch.float32, True)
    err32 = per_sample_err(sub32, k1_32, keep)
    last_rep = rep[:, -1].cpu().numpy()
    tols = np.array([graded(min(int(r), dcfg.max_repeat)) for r in last_rep])
    fused_gnn.gnn_forward_edges.launches = 0
    fused_gnn.fused_rollout_chunk.launches = 0
    sub16, sub16_ms = timed(torch.bfloat16, False)
    launches, k1_launches = fused_gnn.gnn_forward_edges.launches, fused_gnn.fused_rollout_chunk.launches
    k1_16, k1_16_ms = timed(torch.bfloat16, True)
    e_sub, e_k1 = per_sample_err(sub16, k1_32, keep), per_sample_err(k1_16, k1_32, keep)
    ratio = float(np.median(e_sub) / np.median(e_k1))
    apart16 = per_sample_err(sub16, k1_16, keep)
    ok = bool(torch.isfinite(sub32).all() and torch.isfinite(sub16).all()
              and (err32 <= tols).all() and abs(ratio - 1) <= 0.25
              and launches == steps and k1_launches == 0)
    emit(phase="substep_solve", n_sample=mcfg.n_sample, chunks=len(chunks),
         repeat_mean=float(rep.float().mean()), k2e_launches=launches, expected_launches=steps,
         k1_launches_in_substep_run=k1_launches, f32_max_abs_err_vs_k1=float(err32.max()),
         f32_p99_abs_err_vs_k1=float(np.quantile(err32, 0.99)), f32_tol="graded by repeat",
         bf16_vs_f32_k1_median=float(np.median(e_sub)), bf16_k1_vs_f32_k1_median=float(np.median(e_k1)),
         median_ratio=ratio, bf16_max_abs_diff_vs_k1_bf16=float(apart16.max()),
         bf16_share_of_samples_equal_to_k1=float((apart16 == 0).mean()),
         f32_share_of_samples_equal_to_k1=float((err32 == 0).mean()), ms_substep_bf16=sub16_ms, ms_k1_bf16=k1_16_ms,
         ms_substep_f32=sub32_ms, ms_k1_f32=k1_32_ms, ok=ok)
    if not ok:
        fail("the per-substep rope rollout failed its checks (see the substep_solve line)")
    return launches


def cloth_setup(dev):
    """The cloth task at its published width (checked), weights from
    ``init_params`` seeded 0, the state a 10 x 10 sheet at 0.3 sim units with
    seeded jitter, and the target the same sheet shifted."""
    from adaptigraph_tpu_torch.cli import _task_objects
    from adaptigraph_tpu_torch.models.gnn import init_params, params_from_numpy, params_to_numpy
    from adaptigraph_tpu_torch.sim.synthetic import cloth_sheet
    from adaptigraph_tpu_torch.utils.config import load_planning_config

    tcfg, _ = _task_objects(load_planning_config("cloth"))
    d, m = tcfg.dcfg, tcfg.mcfg
    published = (d.gnn.n_nodes, d.edge.topk, d.gnn.nf_effect, d.gnn.pstep, d.adj_thresh,
                 d.max_repeat, d.gripper_enable, d.edge.policy, m.n_sample, m.n_sample_chunk)
    if published != (101, 5, 128, 3, 0.75, 10, True, "tools_all", 20000, 2000):
        fail(f"cloth config is not the published width: {published}")
    params = params_from_numpy(params_to_numpy(init_params(torch.Generator().manual_seed(0), d.gnn)),
                               dev)
    state = cloth_sheet(0)
    return tcfg, params, state, state + np.array([0.6, 0.0, 0.3], np.float32)


def time_cloth_step(tcfg, params, state, dev):
    """One substep of the cloth solve's tool branch at its shapes (B 2000,
    bf16, the sheet with 0.005 of noise per sample and frame): the graph
    build (``build_neighbor_graph_batch``, contact-gated tools_all) and K2
    on its ``topk + max_neef`` slots, a forward alone (no activations kept),
    held against its plain version on the first input within 2% of the
    plain version's largest |motion| (K2's bf16 limit); CUDA events, median
    of 7 on other actions each; K2's plain version and bound."""
    from adaptigraph_tpu_torch.ops.fused_gnn import gnn_forward_cuda, gnn_forward_plain, pack_inputs
    from adaptigraph_tpu_torch.ops.graph import build_neighbor_graph_batch

    dcfg, cd = tcfg.dcfg, torch.bfloat16
    gnn, edge = dcfg.gnn, dcfg.edge
    N, n_p = gnn.n_nodes, gnn.max_nobj
    tool = (torch.arange(N, device=dev) >= n_p).expand(B_CHUNK, N)
    every = torch.ones(B_CHUNK, N, dtype=torch.bool, device=dev)
    steps = [substep_inputs((tcfg, params, state), B_CHUNK, 200 + r, dev, cd) for r in range(7)]
    graphs, w = [st[3] for st in steps], steps[0][2]

    def build(g):
        return build_neighbor_graph_batch(g["state"][:, -1], every, tool, dcfg.adj_thresh, edge)

    def k2_inputs(g):
        nodes, nbr, msk, last, _ = pack_inputs(gnn, g["state"], g["action"], g["physics_param"],
                                               g["attrs"], g["p_instance"], *build(g),
                                               edge.topk + edge.max_neef, cd)
        return nodes, nbr, msk, last, w

    ins = [k2_inputs(g) for g in graphs]
    pred, mot = gnn_forward_cuda(*ins[0], gnn, cd, True, keep_acts=False)[:2]
    torch.cuda.synchronize()
    want_pred, want_mot = gnn_forward_plain(*ins[0], gnn, cd)
    err = max(float((pred - want_pred).abs().max()), float((mot - want_mot).abs().max()))
    tol = 0.02 * float(want_mot.abs().max())
    check_ok = bool(torch.isfinite(pred).all() and torch.isfinite(mot).all() and err <= tol)
    const = (gnn, cd, False)
    gnn_forward_cuda(*ins[0], *const, keep_acts=False)  # warm-up
    ms = median_ms(lambda *a: gnn_forward_cuda(*a, *const, keep_acts=False), lambda r: ins[r], 7)
    plain_ms = median_ms(lambda *a: gnn_forward_plain(*a, *const), lambda r: ins[r], 3)
    graph_ms = median_ms(build, lambda r: (graphs[r],), 7)
    nodes, nbr, msk = ins[0][:3]
    ops, nbytes = forward_work(gnn, nodes, msk, w, outputs=1)
    b_ms, b_by = bound(ops, nbytes + nbr.numel() * 4 + msk.numel() * 4, PEAK_FLOPS[cd])
    return dict(k2_ms=ms, k2_plain_ms=plain_ms, k2_bound_ms=b_ms, k2_bound_by=b_by,
                k2_gflop_per_launch=ops / 1e9, real_edges_per_sample=real_edges(msk),
                graph_build_ms=graph_ms, k2_bf16_max_abs_err=err, k2_bf16_tol=tol,
                k2_bf16_ok=check_ok)


def f32_chunk_vs_plain(tcfg, params, state, phys, reward, rollout, plain, dev):
    """One float32 chunk of the task's solve (seeded samples around the middle
    of the action box, sorted by repeat) through ``rollout``
    (``dynamics_rollout_batched``) on the kernels and inside the ``plain()``
    context, on the card. Returns each sample's error, its graded whole-push
    bound, and both chunks' rewards."""
    from adaptigraph_tpu_torch.ops.fused_gnn import weight_list
    from adaptigraph_tpu_torch.planning.actions import decode_action, sample_action_seq
    from adaptigraph_tpu_torch.planning.mppi_solve import sort_by_repeat

    dcfg, mcfg = tcfg.dcfg, tcfg.mcfg
    lo = torch.tensor(tcfg.action_lower_lim, device=dev)
    hi = torch.tensor(tcfg.action_upper_lim, device=dev)
    g = torch.Generator(device=dev)
    g.manual_seed(4)
    act0_t = ((lo + hi) / 2)[None].expand(mcfg.n_look_ahead, 4)
    chunk = sort_by_repeat(sample_action_seq(g, act0_t, lo, hi, mcfg.n_sample_chunk,
                                             noise_level=mcfg.noise_level,
                                             push_length=mcfg.push_length), mcfg.push_length)
    obj, ph = torch.tensor(state, device=dev), torch.tensor(phys, device=dev)

    def chunk_run():
        w = weight_list(params, dcfg.gnn, torch.float32)
        out = rollout(w, obj, chunk, ph, dcfg, compute_dtype=torch.float32)["state_seqs"]
        return out[:, -1], reward(out, chunk, obj)

    got, got_r = chunk_run()
    with plain():
        want, want_r = chunk_run()
    err = per_sample_err(got, want, torch.ones_like(got[:, :1, :1], dtype=torch.bool))
    rep = decode_action(chunk, mcfg.push_length)[1][:, -1].cpu().numpy()
    tols = np.array([graded(min(int(r), dcfg.max_repeat)) for r in rep])
    return err, tols, got_r, want_r


def phase_cloth_solve(dev):
    """The cloth solve through ``make_mppi_solver`` (bf16, 20,000 samples in
    chunks of 2,000; per substep the contact-gated tools_all graph and one
    K2 launch): one warm-up and three timed solves, K2 launches counted from
    0 and held to the sum over chunks of min(largest repeat, max_repeat),
    every reward finite. Then one float32 chunk through the kernels against
    the same chunk through the plain versions on the card, held to the
    graded whole-push bound."""
    from adaptigraph_tpu_torch.ops import fused_gnn
    from adaptigraph_tpu_torch.planning import mppi_solve
    from adaptigraph_tpu_torch.planning.actions import decode_action
    from adaptigraph_tpu_torch.planning.closed_loop import make_reward_fn

    tcfg, params, state, target = cloth_setup(dev)
    dcfg, mcfg = tcfg.dcfg, tcfg.mcfg
    expected, finite = [0], []
    real_rollout = mppi_solve.dynamics_rollout_batched
    reward = make_reward_fn(tcfg, target, dev)

    def rollout(*a, **k):  # counts the substeps each chunk needs
        rep = decode_action(a[2], dcfg.push_length)[1]
        expected[0] += sum(min(int(r.max()), dcfg.max_repeat) for r in rep.T)
        return real_rollout(*a, **k)

    def reward_fn(*a):
        r = reward(*a)
        finite.append(torch.isfinite(r).all())
        return r

    solve = mppi_solve.make_mppi_solver(dcfg, mcfg, reward_fn, tcfg.action_lower_lim,
                                        tcfg.action_upper_lim, device=dev)
    act0 = np.tile((tcfg.action_lower_lim + tcfg.action_upper_lim) / 2, (mcfg.n_look_ahead, 1))
    phys = np.array([0.5], np.float32)

    def run(seed):
        g = torch.Generator(device=dev)
        g.manual_seed(seed)
        return solve(params, state, act0, g, phys)

    with mock.patch.object(mppi_solve, "dynamics_rollout_batched", rollout):
        run(0)  # warm-up
        torch.cuda.synchronize()
        expected[0] = 0
        fused_gnn.gnn_forward.launches = 0
        others = fused_gnn.gnn_forward_edges.launches + fused_gnn.fused_rollout_chunk.launches
        t0 = time.time()
        results = [run(seed) for seed in (1, 2, 3)]
        torch.cuda.synchronize()
        secs = time.time() - t0
    launches = fused_gnn.gnn_forward.launches
    others = fused_gnn.gnn_forward_edges.launches + fused_gnn.fused_rollout_chunk.launches - others
    all_finite = bool(torch.stack(finite).all())

    # one float32 chunk: kernels against plain versions, on the card
    err, tols, got_r, want_r = f32_chunk_vs_plain(tcfg, params, state, phys, reward,
                                                  real_rollout, plain_forward, dev)
    step = time_cloth_step(tcfg, params, state, dev)
    ok = bool(launches == expected[0] and others == 0 and all_finite and step["k2_bf16_ok"]
              and all(torch.isfinite(r["best_reward"]) for r in results)
              and (err <= tols).all() and torch.isfinite(got_r).all())
    emit(phase="cloth_solve", n_sample=mcfg.n_sample, n_sample_chunk=mcfg.n_sample_chunk,
         solves=3, ms_per_solve=secs / 3 * 1e3, k2_launches=launches,
         expected_launches=expected[0], other_kernel_launches=others,
         launches_per_solve=launches / 3, rewards_finite=all_finite,
         best_rewards=[float(r["best_reward"]) for r in results],
         f32_chunk_max_abs_err=float(err.max()), f32_chunk_p99_abs_err=float(np.quantile(err, 0.99)),
         f32_chunk_reward_max_abs_diff=float((got_r - want_r).abs().max()),
         f32_tol="graded by repeat", **step, ok=ok)
    if not ok:
        fail("the cloth solve failed its checks (see the cloth_solve line)")
    return launches, step


def phase_kernel_parts(dev):
    """K4: ``python -m adaptigraph_tpu_torch.profiling.kernel_parts``'s run
    (each variant at the JAX script's shapes, B 2000, bf16, a warm-up and 7
    CUDA-event timings) with its launches counted from 0; then each variant
    against its plain version on the same inputs, at 2% of the plain
    version's largest |motion| (K2e's bf16 bound); the shares of the edge
    build, the gather and the MLPs in K2e's time. The same timings at
    states packed so that every row fills its K slots (``state_scale``
    0.05): there the ablations change the parts and not the edge count."""
    from adaptigraph_tpu_torch.ops.fused_gnn import radius_edge_tables
    from adaptigraph_tpu_torch.profiling import kernel_parts as kp

    kp.variant_cuda.launches = dict.fromkeys(kp.VARIANTS, 0)
    ms = kp.profile(dev, reps=7)
    launches = dict(kp.variant_cuda.launches)
    dense_ms = kp.profile(dev, reps=7, state_scale=0.05)
    dense_edges = real_edges(radius_edge_tables(kp.make_inputs(dev, state_scale=0.05)[1], kp.GNN,
                                                kp.TOPK, kp.ADJ)[1])
    nodes, last, w = kp.make_inputs(dev)
    n_p = kp.GNN.max_nobj
    rows, ok_all = {}, True
    for v in kp.VARIANTS:
        got = kp.variant_cuda(v, nodes, last, w)
        torch.cuda.synchronize()
        want = kp.variant_plain(v, nodes, last, w)
        err = float((got - want).abs().max())
        tol = 0.02 * float((want - last[:, :n_p]).abs().max())
        ok = bool(torch.isfinite(got).all() and err <= tol)
        ok_all &= ok
        plain_ms = median_ms(lambda *a: kp.variant_plain(v, *a), lambda r: (nodes, last, w), 3)
        rows[v] = dict(ms=ms[v], plain_ms=plain_ms, launches=launches[v], max_abs_err=err, tol=tol,
                       ok=ok)
    msk = radius_edge_tables(last, kp.GNN, kp.TOPK, kp.ADJ)[1]
    ops, nbytes = forward_work(kp.GNN, nodes, msk, w, outputs=1)
    b_ms, b_by = bound(ops, nbytes, PEAK_FLOPS[torch.bfloat16])
    emit(phase="kernel_parts", B=kp.B, variants=rows, shares=kp.shares(ms),
         real_edges_per_sample=real_edges(msk), no_edge_edges_per_sample=kp.TOPK * nodes.shape[1],
         dense_state_ms=dense_ms, dense_state_shares=kp.shares(dense_ms),
         dense_state_real_edges_per_sample=dense_edges, bound_ms=b_ms, bound_by=b_by, ok=ok_all)
    if not ok_all:
        fail("a K4 variant disagrees with its plain version (see the kernel_parts line)")
    return dict(ms=ms["full"], plain_ms=rows["full"]["plain_ms"], bound_ms=b_ms, bound_by=b_by,
                launches=sum(launches.values()), max_abs_err=max(r["max_abs_err"] for r in rows.values()),
                variants={v: {k: r[k] for k in ("ms", "plain_ms", "launches", "max_abs_err")}
                          for v, r in rows.items()})


# ---------------------------------------------------------------------------
# training (K2, K3)
# ---------------------------------------------------------------------------

def phase_dataset():
    """A synthetic rope dataset simulated in memory, preprocessed by the port
    into TRAIN_DIR/prep (no h5 file is written or read)."""
    from adaptigraph_tpu_torch.cli import _phys_specs
    from adaptigraph_tpu_torch.dynamics.preprocess import preprocess_episodes
    from adaptigraph_tpu_torch.sim.synthetic import SYNTH_EEF_OFFSETS, simulate_rope_dataset
    from adaptigraph_tpu_torch.utils.config import load_dynamics_config

    shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    config = load_dynamics_config("rope")
    dc = config["dataset_config"]
    t0 = time.time()
    episodes = simulate_rope_dataset(n_episodes=32, n_pushes=4, seed=0)
    prep = os.path.join(TRAIN_DIR, "prep")
    n = preprocess_episodes(episodes, prep, SYNTH_EEF_OFFSETS, dc["n_his"], dc["n_future"],
                            dc["dist_thresh"], _phys_specs(config))
    emit(phase="dataset", episodes=n, pushes_per_episode=4, seconds=round(time.time() - t0, 2))
    return config, prep


def train_objects(config):
    from adaptigraph_tpu_torch.cli import _dyn_objects, _train_objects

    gnn, edge = _dyn_objects(config)
    spec, hyper = _train_objects(config)
    return gnn, edge, spec, hyper


def device_batches(config, prep, dev, n, seed):
    """n training batches of B_TRAIN from the prepared dataset, expanded on
    the card (as the trainer sees them before augmentation)."""
    from adaptigraph_tpu_torch.dynamics.dataset import PackedDataset
    from adaptigraph_tpu_torch.dynamics.train import expand_compact_batch

    gnn, _, spec, _ = train_objects(config)
    ds = PackedDataset(prep, spec, "train", config["dataset_config"]["ratio"], compact=True)
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        b = ds.make_batch(rng.randint(0, len(ds), size=B_TRAIN), rng)
        out.append(expand_compact_batch({k: torch.from_numpy(v).to(dev) for k, v in b.items()},
                                        gnn))
    return out


def step_inputs(batch, gnn, edge, params, cd):
    """The K2/K3 inputs of a batch's first prediction: the packed nodes,
    the edge tables built by the port from its last state, the padded last
    state and the weights."""
    from adaptigraph_tpu_torch.ops.fused_gnn import pack_inputs, weight_list
    from adaptigraph_tpu_torch.ops.graph import build_neighbor_graph_batch

    state = batch["state"]
    nbrs, mask = build_neighbor_graph_batch(state[:, -1], batch["state_mask"], batch["eef_mask"],
                                            batch["adj_thresh"], edge)
    nodes, nbr, msk, last, _ = pack_inputs(gnn, state, batch["action"], batch["physics_param"],
                                           batch["attrs"], batch["p_instance"], nbrs, mask,
                                           edge.topk + edge.max_neef, cd)
    return nodes, nbr, msk, last, weight_list(params, gnn, cd)


def fixture_batch(name, dev, B=B_TRAIN, seed=0, n_future=3):
    """A full training batch (as ``expand_compact_batch`` gives it to the
    trainer) at a fixture's density: the fixture's recorded points (rope: 95
    in the 100 object slots; granular: 100) as an n_his-frame history with
    0.005 of noise per frame, n_future frames moving a tenth of the way per
    frame toward the state recorded after the push, and the tool rows (rope's
    pusher, granular's 5-point board) beside them, moving 0.01 along x per
    frame; edges are built by the trainer from the planning config's radius.
    Returns (batch, tcfg, fixture weights)."""
    tcfg, params = material(name, dev)[:2]
    gnn = tcfg.dcfg.gnn
    with np.load(os.path.join(ROOT, "fixtures", f"{name}_demo", "interaction_000.npz")) as z:
        s0, s1 = z["state_init"].astype(np.float32), z["state_real"].astype(np.float32)
    n_p, N, n_his, n_obj = gnn.max_nobj, gnn.n_nodes, gnn.n_his, len(s0)
    n_t, F = N - n_p, n_his + n_future
    rng = np.random.RandomState(seed)
    frac = np.r_[np.zeros(n_his), np.arange(1, n_future + 1) / 10][None, :, None, None]
    obj = np.zeros((B, F, n_p, 3), np.float32)
    obj[:, :, :n_obj] = s0 + frac * (s1 - s0) + rng.randn(B, F, n_obj, 3) * 0.005
    step = np.array([0.01, 0.0, 0.0], np.float32)
    tool = (s0.mean(0) + np.stack([np.linspace(-0.2, 0.2, n_t), np.zeros(n_t), np.full(n_t, 0.6)], -1)
            + np.arange(F)[:, None, None] * step)  # (F, n_t, 3)
    full = np.zeros((F, N, 3), np.float32)
    full[:, n_p:] = tool
    act = np.zeros((N, 3), np.float32)
    act[n_p:] = step
    real = np.arange(n_p) < n_obj
    attrs = np.zeros((N, 2), np.float32)
    attrs[:n_p, 0], attrs[n_p:, 1] = real, 1

    def t(a, per_sample=False):  # one array for every sample unless per_sample
        a = a if per_sample else np.broadcast_to(a, (B,) + a.shape)
        return torch.tensor(np.ascontiguousarray(a, np.float32), device=dev)

    state = np.concatenate([obj[:, :n_his], np.broadcast_to(full[:n_his, n_p:], (B, n_his, n_t, 3))], 2)
    batch = {"state": t(state, True), "state_future": t(obj[:, n_his:], True),
             "action": t(act), "eef_future": t(full[n_his:]),
             "action_future": t(np.broadcast_to(act, (n_future, N, 3))), "attrs": t(attrs),
             "p_instance": t(real[:, None]),
             "obj_mask": torch.tensor(real, device=dev).expand(B, n_p),
             "state_mask": torch.tensor(np.r_[real, np.ones(n_t, bool)], device=dev).expand(B, N),
             "eef_mask": (torch.arange(N, device=dev) >= n_p).expand(B, N),
             "physics_param": t(rng.rand(B, gnn.phys_dim), True),
             "adj_thresh": torch.full((B,), tcfg.dcfg.adj_thresh, device=dev)}
    return batch, tcfg, params


def input_cases(config, synth_batch, dev, cd):
    """K2/K3 inputs (fixture weights) at each density the smoke checks: rope
    at the fixture's density (the baseline), rope on a batch of the
    synthetic dataset (the CLI run's data) and granular at its fixture's
    density. Yields (name, inputs, gnn config)."""
    for name in ("rope", "granular"):
        batch, tcfg, params = fixture_batch(name, dev)
        yield name, step_inputs(batch, tcfg.dcfg.gnn, tcfg.dcfg.edge, params, cd), tcfg.dcfg.gnn
        if name == "rope":
            gnn, edge = train_objects(config)[:2]
            yield ("rope synthetic", step_inputs(synth_batch, gnn, edge, params, cd), gnn)


def real_edges(msk):
    return float((msk > 0).sum()) / msk.shape[0]


def phase_forward_kernel(cases):
    """K2 against its plain version on the same inputs (``cases(cd)`` yields
    (name, inputs, gnn config), e.g. ``input_cases``):
    float32 at 2e-4 (tests/test_fused.py's bound); bfloat16 at 2% of the
    plain version's largest |motion|, about five bf16 steps of it (the JAX
    tests allow 0.05, as large as a push's motion; a kernel that returned
    no motion would pass that). Returns the max abs errors by (case, dtype)."""
    from adaptigraph_tpu_torch.ops.fused_gnn import gnn_forward_cuda, gnn_forward_plain

    errs, ok_all = {}, True
    for cd in (torch.float32, torch.bfloat16):
        for name, args, cfg in cases(cd):
            pred, mot, _ = gnn_forward_cuda(*args, cfg, cd)
            torch.cuda.synchronize()
            want_pred, want_mot = gnn_forward_plain(*args, cfg, cd)
            err = max(float((pred - want_pred).abs().max()), float((mot - want_mot).abs().max()))
            max_mot = float(want_mot.abs().max())
            tol = 2e-4 if cd == torch.float32 else 0.02 * max_mot
            ok = bool(torch.isfinite(pred).all() and torch.isfinite(mot).all() and err <= tol)
            ok_all &= ok
            errs[(name, str(cd).split(".")[-1])] = err
            emit(phase="forward_kernel_check", case=name, dtype=str(cd).split(".")[-1],
                 B=args[0].shape[0], K=args[1].shape[1] // args[0].shape[1],
                 real_edges_per_sample=real_edges(args[2]), max_abs_err=err,
                 plain_max_abs_motion=max_mot, tol=tol, ok=ok)
    if not ok_all:
        fail("the forward kernel disagrees with its plain version (see forward_kernel_check)")
    return errs


def rel_norm(a, b):
    return float((a.double() - b.double()).norm() / b.double().norm().clamp(min=1e-30))


# the relu layer whose units are each weight gradient's last-axis columns
# (weight_list order; the relation propagator's [W2 | W3] has two per unit)
GRAD_LAYER = ["pe0", "pe0", "pe1", "pe1", "pe2", "pe2", "re0", "re0", "re1", "re1", "re2", "re2",
              "msg", "msg", "msg", "eff", "eff", "eff", "nr0", "nr0", "nr1", "nr1", None, None]
# a relu of the kernel may go the other way than float64's only where the
# float64 pre-activation is within this share of the sum of its absolute
# terms (float32's rounding, carried through the layers before it, reaches
# ~700 x 2^-24 there on the granular fixture)
FLIP_MARGIN = 2.0 ** -12


def act_views(acts, cfg, K):
    """K2's kept activations (two flat tensors, B samples) as views by name,
    in the layout the library exports (``ops/fused_gnn.py::act_layout``):
    name -> one (B, rows, width) view per slot."""
    from adaptigraph_tpu_torch.ops import kernels
    from adaptigraph_tpu_torch.ops.fused_gnn import act_layout

    out = {}
    for buf, layout in zip(acts, act_layout(kernels.library(), cfg, K)):
        B = buf.numel() // sum(slots * rows * width for _, _, slots, rows, width in layout)
        flat = buf.view(B, -1)
        for name, off, slots, rows, width in layout:
            n = rows * width
            out[name] = [flat[:, off + s * n:off + (s + 1) * n].view(B, rows, width)
                         for s in range(slots)]
    return out


def kernel_relu_outputs(acts, msk, cfg):
    """K2's relu outputs, read from its activations (``act_views``; their
    dtype is the compute dtype), per relu layer as the plain version's
    ``taps`` list them: node layers (B, Np, F), edge layers on the real
    edges in the kernel's order (by sample, receiver, slot), (E, F)."""
    from adaptigraph_tpu_torch.ops.fused_gnn import round_up

    Np = round_up(cfg.n_nodes, 8)
    K = msk.shape[1] // Np
    v = act_views(acts, cfg, K)
    n_real = (msk > 0).sum(1)
    real = torch.arange(Np * K, device=msk.device)[None] < n_real[:, None]
    return {"pe0": v["pe_h1"], "pe1": v["pe_h2"], "pe2": v["effs"][:1],
            "re0": [v["re_h1"][0][real]], "re1": [v["re_h2"][0][real]],
            "re2": [v["r_enc"][0][real]], "msg": [t[real] for t in v["ms"]],
            "eff": v["effs"][1:], "nr0": v["nr_h1"], "nr1": v["nr_h2"]}


def kernel_decisions(acts, msk, cfg):
    """The relu decisions of K2's kept activations (``kernel_relu_outputs``)
    in the layout of the plain version's pre-activations, as
    ``gnn_train_bwd_plain(decisions=...)`` takes them: node layers (B, Np,
    F), edge layers (B, K, Np, F), False off the real edges."""
    return relu_decisions(kernel_relu_outputs(acts, msk, cfg), msk)


def relu_decisions(out, msk):
    """``kernel_decisions`` from relu outputs laid out as
    ``kernel_relu_outputs`` gives them."""
    B, Np = msk.shape[0], out["pe0"][0].shape[1]
    K = msk.shape[1] // Np
    edges = (msk.view(B, K, Np) > 0).permute(0, 2, 1)  # (B, receiver, slot): the kernel's order
    dec = {}
    for name, entries in out.items():
        dec[name] = []
        for v in entries:
            if v.dim() == 2:  # the real edges' rows, in the kernel's order
                full = torch.zeros(B, Np, K, v.shape[-1], dtype=torch.bool, device=v.device)
                full[edges] = v > 0
                dec[name].append(full.permute(0, 2, 1, 3))
            else:
                dec[name].append(v > 0)
    return dec


def relu_flips(taps, kernel_out, msk, cfg):
    """Per relu layer, the units where the kernel's relu went the other way
    than the float64 plain version's on some real row; and the largest
    |z| / (sum of |terms|) of float64 at such a row."""
    B, N = msk.shape[0], cfg.n_nodes
    Np = kernel_out["pe0"][0].shape[1]
    K = msk.shape[1] // Np
    edges = (msk.view(B, K, Np) > 0).permute(0, 2, 1)  # (B, receiver, slot): the kernel's order
    units, worst = {}, 0.0
    for name, entries in taps.items():
        hit = None
        for (z, terms, _), k in zip(entries, kernel_out[name]):
            if z.dim() == 4:
                z, terms = z.permute(0, 2, 1, 3)[edges], terms.permute(0, 2, 1, 3)[edges]
            else:
                z, terms, k = (t[:, :N].flatten(0, 1) for t in (z, terms, k))
            flip = (k > 0) != (z > 0)
            hit = flip.any(0) if hit is None else hit | flip.any(0)
            if flip.any():
                worst = max(worst, float((z.abs() / terms.clamp(min=1e-300))[flip].max()))
        units[name] = hit
    return units, worst


def plain_activations(nodes, nbr, msk, w, cfg, cd):
    """The plain forward's activations in the layout K2 keeps them for K3
    (``act_views``), in the compute dtype: every value that K3 reads, as the
    plain backward recomputes it (from its ``taps``, on the same device);
    the buffers K3 does not read (pb, rs, rel_base) are zero. K3 fed these
    takes the same relu and rounding decisions as the plain backward, so it
    is held to it alone."""
    from adaptigraph_tpu_torch.ops import kernels
    from adaptigraph_tpu_torch.ops.fused_gnn import act_layout
    from adaptigraph_tpu_torch.ops.fused_gnn_train import gnn_train_bwd_plain

    f32 = torch.float32
    B, Np, D = nodes.shape
    K, P, nh3 = nbr.shape[1] // Np, cfg.pstep, cfg.n_his * 3
    taps = {}
    gnn_train_bwd_plain(nodes, nbr, msk, torch.zeros(B, Np, 3, device=nodes.device), w, cfg,
                        taps=taps, compute_dtype=cd)

    def act(name, t=0):  # the layer's output, rnd(relu(z)), as the plain version keeps it
        return torch.relu(taps[name][t][0]).to(cd)

    def rnd(v):
        return v.to(cd).to(f32)

    emask = (msk.view(B, K, Np) > 0)[..., None]
    x = nodes.to(f32)
    node_g = x[..., D - nh3 - 3:]
    T = node_g[:, None].expand(B, K, Np, node_g.shape[-1])
    G = node_g[torch.arange(B, device=x.device)[:, None, None], nbr.long().view(B, K, Np)]
    rel_in = torch.cat([T[..., nh3:nh3 + 2], G[..., nh3:nh3 + 2],
                        rnd(T[..., nh3 + 2:] - G[..., nh3 + 2:]).abs(),
                        rnd(T[..., :nh3] - G[..., :nh3])], dim=-1).to(cd)
    edges = emask[..., 0].permute(0, 2, 1)  # (B, receiver, slot): the kernel's edge order
    real = torch.arange(Np * K, device=x.device)[None] < edges.sum((1, 2))[:, None]
    bufs = tuple(torch.zeros(B * (layout[-1][1] + layout[-1][2] * layout[-1][3] * layout[-1][4]),
                             dtype=cd, device=x.device)
                 for layout in act_layout(kernels.library(), cfg, K))
    v = act_views(bufs, cfg, K)

    def edge_rows(dst, t):  # (B, K, Np, F) on the real edges -> the kernel's edge rows
        dst[..., :t.shape[-1]][real] = t.permute(0, 2, 1, 3)[edges]

    for name, src in (("pe_h1", [act("pe0")]), ("pe_h2", [act("pe1")]),
                      ("effs", [act("pe2")] + [act("eff", t) for t in range(P)]),
                      ("aggs", [torch.where(emask, act("msg", t).to(f32), 0.0).sum(1).to(cd)
                                for t in range(P)]),
                      ("nr_h1", [act("nr0")]), ("nr_h2", [act("nr1")])):
        for dst, t in zip(v[name], src):
            dst.copy_(t)
    # the relation inputs keep a row stride of a multiple of 8, zeros past rel_in
    for name, src in (("rel_in", [rel_in]), ("re_h1", [act("re0")]), ("re_h2", [act("re1")]),
                      ("r_enc", [act("re2")]), ("ms", [act("msg", t) for t in range(P)])):
        for dst, t in zip(v[name], src):
            edge_rows(dst, t)
    return bufs


def k3_vs_plain(got, refs, dev, taps=None, acts=None, msk=None, cfg=None, plain_taps=None):
    """Each of K3's outputs (dnodes, then the 24 gradients) against the
    plain versions: rows of relative errors, the worst (whole tensors)
    against the nearest of "plain", "plain_cpu" and (where ``refs`` has it)
    "f64", and, with float64
    ``taps`` and the activations K3 read, the worst against "f64_same" (the
    float64 plain version taking the relu decisions of the activations K3
    read, ``kernel_decisions``), the largest flip margin and (for diagnosis)
    the worst against "f64" off the columns of the relu units that went the
    other way than float64's. With the ``plain_taps`` of "plain", also (for
    diagnosis, not a gate) the worst against "plain" off the columns of the
    units where the relu K3 read went the other way than its own (those
    flips' margins count too)."""
    def flips_of(t):
        return ({}, 0.0) if t is None else relu_flips(t, kernel_relu_outputs(acts, msk, cfg),
                                                      msk, cfg)

    def keep_of(units, i, a):
        layer = None if i == 0 else GRAD_LAYER[i - 1]
        if layer is None or layer not in units:
            return torch.ones(a.shape[-1], dtype=torch.bool, device=dev)
        return ~units[layer].repeat(a.shape[-1] // units[layer].numel())

    flips, margin = flips_of(taps)
    pflips, pmargin = flips_of(plain_taps)
    flat = {k: [v[0]] + v[1] for k, v in refs.items()}
    rows, worst, worst64, worst_off, worst_same = [], 0.0, 0.0, 0.0, 0.0
    for i, a in enumerate([got[0]] + got[1]):
        p, c = flat["plain"][i], flat["plain_cpu"][i].to(dev)
        r = min([rel_norm(a, p), rel_norm(a, c)]
                + ([rel_norm(a, flat["f64"][i])] if "f64" in flat else []))
        row = {"name": "dnodes" if i == 0 else f"grad{i - 1}", "rel_vs_plain": rel_norm(a, p),
               "rel_vs_plain_cpu": rel_norm(a, c), "max_abs_vs_plain": float((a - p).abs().max())}
        if plain_taps is not None:  # for diagnosis only: off the plain version's flips
            pk = keep_of(pflips, i, a)
            off = rel_norm(a[..., pk], p[..., pk])
            worst_off = max(worst_off, off)
            row.update(plain_flip_columns=int((~pk).sum()), rel_vs_plain_off_its_flips=off)
        worst = max(worst, r)
        if taps is not None:
            x = flat["f64"][i]
            keep = keep_of(flips, i, a)
            r64 = rel_norm(a[..., keep], x[..., keep])
            worst64 = max(worst64, r64)
            same = rel_norm(a, flat["f64_same"][i])
            worst_same = max(worst_same, same)
            row.update(kernel_rel_vs_f64=rel_norm(a, x), plain_rel_vs_f64=rel_norm(p, x),
                       flip_columns=int((~keep).sum()), kernel_rel_vs_f64_off_flips=r64,
                       kernel_rel_vs_f64_same_decisions=same)
        rows.append(row)
    finite = all(bool(torch.isfinite(t).all()) for t in [got[0]] + got[1])
    return dict(worst_rel_vs_nearer_plain=worst, worst_rel_vs_f64_same_decisions=worst_same,
                worst_rel_vs_f64_off_flips=worst64,
                worst_rel_vs_plain_off_its_flips=worst_off if plain_taps is not None else None,
                largest_flip_margin=max(margin, pmargin),
                relu_flip_units={k: int(v.sum()) for k, v in flips.items()},
                relu_flip_units_vs_plain={k: int(v.sum()) for k, v in pflips.items()},
                finite=finite, rows=rows)


def phase_backward_kernel(cases, dev, cascade_gates=True):
    """K3 against its plain version on the same inputs (f32, ``cases``),
    twice: fed the plain forward's activations (``plain_activations``: K3
    alone, with the plain backward's own relu decisions), and on the
    activations of a K2 launch on the same inputs (K2 then K3, the training
    path), whose rerun must be bit-identical. The node cotangents and every
    weight gradient must lie within 5e-4 of a plain version relative to its
    norm. A ReLU whose input lies within float32 rounding of 0 may fall on
    either side in two correct float32 versions, and one such flip moves a
    whole gradient column; so each tensor is held, as a whole tensor, to the
    nearest of three versions: two plain versions that sum in different
    orders (on the card and on the CPU) and a float64 plain version (where
    both float32 plain versions take the side of a relu that float64 does
    not, a kernel that takes float64's is right). K2 redoes a relu input
    near 0 as a float32 sum that rounds to nearest, as the plain versions
    sum; the figure off the columns of the units where the relu K3 read went
    the other way than the plain version's is reported beside it, for
    diagnosis. So that a drift to one side is still caught,
    every tensor must also lie within 5e-4 of a float64 plain version that
    takes the relu decisions of the activations K3 read
    (``kernel_decisions``), and every unit where those go the other way
    than float64's own must lie within FLIP_MARGIN of 0; and, with
    ``cascade_gates``, within 5e-4 of float64 without the columns of those
    units. Dropping only the flipped units' columns leaves what a flip
    passes back to every earlier layer: at softbody's width (its gate off)
    ~15 flipped message units put the float32 plain versions themselves
    5e-4 to 9e-4 of the norm from float64 off those columns, the figure
    reported. Returns each case's max abs error of K2 then K3 against the
    plain version on the card."""
    from adaptigraph_tpu_torch.ops.fused_gnn import gnn_forward_cuda
    from adaptigraph_tpu_torch.ops.fused_gnn_train import gnn_train_bwd_cuda, gnn_train_bwd_plain

    f32 = torch.float32
    errs, ok_all = {}, True
    for name, (nodes, nbr, msk, last, w), cfg in cases(f32):
        g = torch.Generator(device=dev)
        g.manual_seed(5)
        dmot = torch.randn(nodes.shape[0], nodes.shape[1], 3, generator=g, device=dev) * 1e-2
        dmot[:, cfg.max_nobj:] = 0
        acts = gnn_forward_cuda(nodes, nbr, msk, last, w, cfg, f32)[2]
        got = gnn_train_bwd_cuda(nodes, nbr, msk, dmot, w, cfg, acts)
        again = gnn_train_bwd_cuda(nodes, nbr, msk, dmot, w, cfg, acts)
        pacts = plain_activations(nodes, nbr, msk, w, cfg, f32)
        alone = gnn_train_bwd_cuda(nodes, nbr, msk, dmot, w, cfg, pacts)
        torch.cuda.synchronize()
        identical = bool(torch.equal(got[0], again[0])
                         and all(torch.equal(a, b) for a, b in zip(got[1], again[1])))
        taps, ptaps = {}, {}
        w64 = [t.double() for t in w]
        refs = {"plain": gnn_train_bwd_plain(nodes, nbr, msk, dmot, w, cfg, taps=ptaps),
                "plain_cpu": gnn_train_bwd_plain(nodes.cpu(), nbr.cpu(), msk.cpu(), dmot.cpu(),
                                                 [t.cpu() for t in w], cfg),
                "f64": gnn_train_bwd_plain(nodes.double(), nbr, msk, dmot.double(), w64, cfg,
                                           taps=taps)}

        def f64_same(a):  # float64, taking the relu decisions of the activations ``a``
            return {"f64_same": gnn_train_bwd_plain(nodes.double(), nbr, msk, dmot.double(), w64,
                                                    cfg, decisions=kernel_decisions(a, msk, cfg))}

        res = {"k3_alone": k3_vs_plain(alone, dict(refs, **f64_same(pacts)), dev, taps, pacts,
                                       msk, cfg),
               "k2_then_k3": k3_vs_plain(got, dict(refs, **f64_same(acts)), dev, taps, acts, msk,
                                         cfg, ptaps)}
        del taps, ptaps, refs
        oks = {k: bool(r["finite"] and r["worst_rel_vs_nearer_plain"] <= 5e-4
                       and r["worst_rel_vs_f64_same_decisions"] <= 5e-4
                       and (r["worst_rel_vs_f64_off_flips"] <= 5e-4 or not cascade_gates)
                       and r["largest_flip_margin"] <= FLIP_MARGIN) for k, r in res.items()}
        ok = identical and all(oks.values())
        ok_all &= ok
        errs[name] = max(r["max_abs_vs_plain"] for r in res["k2_then_k3"]["rows"])
        emit(phase="backward_kernel_check", case=name, B=nodes.shape[0],
             real_edges_per_sample=real_edges(msk), rerun_bit_identical=identical,
             tol="5e-4 of the norm: of the nearer plain version, and of float64 taking the relu "
                 "decisions of the activations K3 read",
             flip_margin_tol=FLIP_MARGIN, ok_by_input=oks, ok=ok,
             **{k: dict(r, rows=r["rows"] if not oks[k] else None) for k, r in res.items()})
    if not ok_all:
        fail("the backward kernel disagrees with its plain versions (see backward_kernel_check)")
    return errs


# bf16 K3 against its plain bf16 version, relative to the norm. The tensor
# cores truncate their float32 sums, which on their own flip the bf16
# rounding of some cotangents and activations against the plain version's
# float32 matmuls (3.1e-4 of the norm on the rope fixture's inputs before
# the redo); K2 and K3 redo every output near a bf16 rounding midpoint (or
# a relu input near 0) as the FMA chain in k order that the plain version's
# matmul computes (csrc/gnn_common.cuh's Redo), and so take its rounding
# decisions, as the earlier CUDA-core K3 did at 1e-5. A rounding step that
# is missed or misplaced moves tensors by 2e-3 to 5e-3.
BF16_ROUNDING_TOL = 1e-5  # K3 alone (the plain forward's activations) and K2 then K3
BF16_ACT_DIFFER = 1e-4  # share of K2's kept bf16 activations that differ from the plain forward's
BF16_ACT_OVER_ONE_ULP = 1e-5  # ... that lie more than one bf16 ulp from it


def bf16_ordered(t):
    """bf16 values as integers in the order of the values (one bf16 ulp apart
    = 1 apart; +0 and -0 equal)."""
    bits = t.contiguous().view(torch.int16).int()
    mag = bits & 0x7FFF
    return torch.where(bits < 0, -mag, mag)


EDGE_ACTS = ("rel_in", "re_h1", "re_h2", "r_enc", "rel_base", "ms")


def act_ulps(acts, pacts, cfg, msk):
    """K2's kept bf16 activations against the plain forward's
    (``plain_activations``), buffer by buffer and round by round, on the real
    node rows and the real edges (pb, rs and rel_base, which K3 does not
    read, are left out): the share of elements that differ and the share
    more than one bf16 ulp apart."""
    from adaptigraph_tpu_torch.ops.fused_gnn import round_up

    Np = round_up(cfg.n_nodes, 8)
    K = msk.shape[1] // Np
    got, want = act_views(acts, cfg, K), act_views(pacts, cfg, K)
    real = torch.arange(Np * K, device=msk.device)[None] < (msk > 0).sum(1)[:, None]
    out = {}
    for name in got:
        if name in ("pb", "rs", "rel_base"):
            continue
        for s, (a, b) in enumerate(zip(got[name], want[name])):
            a, b = (a[real], b[real]) if name in EDGE_ACTS else (a[:, :cfg.n_nodes], b[:, :cfg.n_nodes])
            d = (bf16_ordered(a) - bf16_ordered(b)).abs()
            out[f"{name}[{s}]"] = {"differ": float((d > 0).double().mean()),
                                   "over_one_ulp": float((d > 1).double().mean())}
    return out


def act_local_ulps(acts, nodes, nbr, msk, w, cfg):
    """K2's kept bf16 activations, each against the plain forward's layer
    (float32 products on the card, rounded to bf16 where the plain version
    rounds) applied to K2's own kept inputs of that layer, buffer by buffer
    and round by round, on the real node rows and the real edges: the share
    of elements that differ and the share more than one bf16 ulp apart. Not
    carried from round to round as ``act_ulps``'s differences are, these
    measure each layer's rounding decisions alone."""
    f32 = torch.float32
    B, Np, D = nodes.shape
    K, P, N = nbr.shape[1] // Np, cfg.pstep, cfg.n_nodes
    nf, nh3 = cfg.nf_effect, cfg.n_his * 3
    Dp = D - nh3 - 3
    v = {k: [t.to(f32) for t in x] for k, x in act_views(acts, cfg, K).items()}
    (pe0w, pe0b, pe1w, pe1b, pe2w, pe2b, re0w, re0b, re1w, re1b, re2w, re2b,
     rp_w1, rp_w23, rp_b, pp_wa, pp_wb, pp_b, nr0w, nr0b, nr1w, nr1b, _, _) = [t.to(f32) for t in w]
    real = torch.arange(Np * K, device=nodes.device)[None] < (msk > 0).sum(1)[:, None]
    edges = (msk.view(B, K, Np) > 0).permute(0, 2, 1)  # (B, receiver, slot): the kernel's order
    b_i, recv, slot = edges.nonzero(as_tuple=True)
    send = nbr.view(B, K, Np).long()[b_i, slot, recv]

    def rnd(x):
        return x.to(torch.bfloat16).to(f32)

    def relu(x):
        return rnd(torch.relu(x))

    def e(name, t=0):  # an edge buffer's real rows, in the kernel's order
        return v[name][t][real]

    def n(name, t=0):
        return v[name][t]

    rin = cfg.relation_input_dim
    want = {"re_h1[0]": (e("re_h1"), relu(e("rel_in")[:, :rin] @ re0w + re0b)),
            "re_h2[0]": (e("re_h2"), relu(e("re_h1") @ re1w + re1b)),
            "r_enc[0]": (e("r_enc"), relu(e("re_h2") @ re2w + re2b)),
            "rel_base[0]": (e("rel_base"), rnd(e("r_enc") @ rp_w1 + rp_b)),
            "pe_h1[0]": (n("pe_h1"), relu(nodes[..., :Dp].to(f32) @ pe0w + pe0b)),
            "pe_h2[0]": (n("pe_h2"), relu(n("pe_h1") @ pe1w + pe1b)),
            "effs[0]": (n("effs"), relu(n("pe_h2") @ pe2w + pe2b)),
            "pb[0]": (n("pb"), rnd(n("effs") @ pp_wa + pp_b)),
            "nr_h1[0]": (n("nr_h1"), relu(n("effs", P) @ nr0w + nr0b)),
            "nr_h2[0]": (n("nr_h2"), relu(n("nr_h1") @ nr1w + nr1b))}
    for t in range(P):
        rs = rnd(n("effs", t) @ rp_w23)
        z = rnd(rnd(e("rel_base") + rs[b_i, recv, :nf]) + rs[b_i, send, nf:])
        want[f"ms[{t}]"] = (e("ms", t), relu(z))
        dense = torch.zeros(B, Np, K, nf, device=nodes.device)
        dense[edges] = e("ms", t)
        agg = rnd(dense.permute(0, 2, 1, 3).contiguous().sum(1))  # as the plain version sums
        want[f"aggs[{t}]"] = (n("aggs", t), agg)
        want[f"effs[{t + 1}]"] = (n("effs", t + 1),
                                  relu(rnd(rnd(n("pb") + rnd(n("aggs", t) @ pp_wb)) + n("effs", t))))
    out = {}
    for name, (got, exp) in want.items():
        if got.dim() == 3:
            got, exp = got[:, :N], exp[:, :N]
        d = (bf16_ordered(got.to(torch.bfloat16)) - bf16_ordered(exp.to(torch.bfloat16))).abs()
        out[name] = {"differ": float((d > 0).double().mean()),
                     "over_one_ulp": float((d > 1).double().mean())}
    return out


def phase_backward_kernel_bf16(cases, dev, cascade_gates=True):
    """K3 in bfloat16 against its plain bf16 version on the same inputs
    (``cases`` packed in bf16). The node cotangents and each of the 24
    weight gradients are held, as whole tensors relative to their norm, to
    the nearer of two plain bf16 versions (on the card and on the CPU), where
    the bf16 rounding points show, within ``BF16_ROUNDING_TOL``: fed the
    plain bf16 forward's activations (``plain_activations``: K3 alone), and
    on the activations of a bf16 K2 launch on the same inputs (K2 then K3,
    the training path; its rerun must be bit-identical), whose distance from
    the float32 K3 (on the float32 packing of the same batch and weights)
    must also be at most 1.25 times the plain versions'. K2's kept
    activations themselves are held to the plain forward's buffer by buffer:
    at most ``BF16_ACT_DIFFER`` of each buffer's elements differ, at most
    ``BF16_ACT_OVER_ONE_ULP`` by more than one bf16 ulp, each layer against
    the plain layer on K2's own kept inputs (``act_local_ulps``) and the
    whole forward against the plain forward's (``act_ulps``).

    With ``cascade_gates`` False (softbody) K2 then K3 at
    ``BF16_ROUNDING_TOL`` and the whole-forward shares are reported, not
    gated. They hold K2 to take every bf16 rounding decision that the plain
    forward takes, so one decision that falls the other way (its float32
    sum within rounding of a bf16 midpoint) is carried by the message
    passing to the neighbours, round after round: at softbody's 4 rounds
    and ~3,700 real edges a sample, K2's own decisions differ from the
    plain layers' in ~1e-6 of the elements, as at rope, and the whole
    forward's in up to 4e-4 by the motion head, K2 then K3 9e-3 from the
    plain bf16 backward, while its distance from float32 K3 stays the plain
    bf16 version's (the 1.25x gate). Returns each case's max abs error of
    K2 then K3."""
    from adaptigraph_tpu_torch.ops.fused_gnn import gnn_forward_cuda
    from adaptigraph_tpu_torch.ops.fused_gnn_train import gnn_train_bwd_cuda, gnn_train_bwd_plain

    f32, bf16 = torch.float32, torch.bfloat16
    out, ok_all = {}, True
    for (name, a32, cfg), (_, a16, _) in zip(cases(f32), cases(bf16)):
        nodes, nbr, msk, last, w = a16
        g = torch.Generator(device=dev)
        g.manual_seed(5)
        dmot = torch.randn(nodes.shape[0], nodes.shape[1], 3, generator=g, device=dev) * 1e-2
        dmot[:, cfg.max_nobj:] = 0
        plain = gnn_train_bwd_plain(nodes, nbr, msk, dmot, w, cfg, compute_dtype=bf16)
        plain_cpu = gnn_train_bwd_plain(nodes.cpu(), nbr.cpu(), msk.cpu(), dmot.cpu(),
                                        [t.cpu() for t in w], cfg, compute_dtype=bf16)
        refs = {"plain": plain, "plain_cpu": plain_cpu}
        pacts = plain_activations(nodes, nbr, msk, w, cfg, bf16)
        res = k3_vs_plain(gnn_train_bwd_cuda(nodes, nbr, msk, dmot, w, cfg, pacts, bf16), refs, dev)
        acts = gnn_forward_cuda(nodes, nbr, msk, last, w, cfg, bf16)[2]
        ulps = act_ulps(acts, pacts, cfg, msk)
        differ = max(v["differ"] for v in ulps.values())
        over = max(v["over_one_ulp"] for v in ulps.values())
        local = act_local_ulps(acts, nodes, nbr, msk, w, cfg)
        local_differ = max(v["differ"] for v in local.values())
        local_over = max(v["over_one_ulp"] for v in local.values())
        del pacts
        got = gnn_train_bwd_cuda(nodes, nbr, msk, dmot, w, cfg, acts, bf16)
        again = gnn_train_bwd_cuda(nodes, nbr, msk, dmot, w, cfg, acts, bf16)
        torch.cuda.synchronize()
        identical = bool(torch.equal(got[0], again[0])
                         and all(torch.equal(a, b) for a, b in zip(got[1], again[1])))
        del acts, again
        chain = k3_vs_plain(got, refs, dev)
        acts32 = gnn_forward_cuda(*a32, cfg, f32)[2]
        ref32 = gnn_train_bwd_cuda(a32[0], a32[1], a32[2], dmot, a32[4], cfg, acts32)
        del acts32
        out[name] = max(r["max_abs_vs_plain"] for r in chain["rows"])
        ratio = max(rel_norm(a, x) / max(rel_norm(p, x), rel_norm(c.to(dev), x), 1e-30)
                    for a, p, c, x in zip([got[0]] + got[1], [plain[0]] + plain[1],
                                          [plain_cpu[0]] + plain_cpu[1], [ref32[0]] + ref32[1]))
        cascade_ok = (chain["worst_rel_vs_nearer_plain"] <= BF16_ROUNDING_TOL
                      and differ <= BF16_ACT_DIFFER and over <= BF16_ACT_OVER_ONE_ULP)
        ok = bool(identical and res["finite"] and chain["finite"]
                  and res["worst_rel_vs_nearer_plain"] <= BF16_ROUNDING_TOL and ratio <= 1.25
                  and local_differ <= BF16_ACT_DIFFER and local_over <= BF16_ACT_OVER_ONE_ULP
                  and (cascade_ok or not cascade_gates))
        ok_all &= ok
        emit(phase="backward_kernel_bf16_check", case=name, B=nodes.shape[0],
             real_edges_per_sample=real_edges(msk), rerun_bit_identical=identical,
             k3_alone_worst_rel_vs_nearer_plain=res["worst_rel_vs_nearer_plain"],
             k2_then_k3_worst_rel_vs_nearer_plain=chain["worst_rel_vs_nearer_plain"],
             k2_then_k3_worst_f32_error_ratio_vs_plain=ratio,
             k2_acts_worst_share_differing=differ, k2_acts_worst_share_over_one_ulp=over,
             k2_acts_vs_plain={k: v for k, v in ulps.items() if v["differ"] > 0},
             k2_acts_local_worst_share_differing=local_differ,
             k2_acts_local_worst_share_over_one_ulp=local_over,
             k2_acts_local_vs_plain={k: v for k, v in local.items() if v["differ"] > 0},
             gated_k2_then_k3_and_k2_acts=cascade_gates,
             tol=f"K3 alone and K2 then K3 {BF16_ROUNDING_TOL:g} of the norm of the nearer plain "
                 f"bf16 version, K2 then K3's error against float32 K3 at most 1.25x the plain "
                 f"versions'; K2's activations: at most {BF16_ACT_DIFFER:g} of each buffer "
                 f"differing from the plain forward's, {BF16_ACT_OVER_ONE_ULP:g} by more than "
                 f"one ulp, each layer on K2's own inputs and (where gated) the whole forward",
             k3_alone_rows=res["rows"] if not ok else None,
             k2_then_k3_rows=chain["rows"] if not ok else None, ok=ok)
    if not ok_all:
        fail("the bf16 backward kernel disagrees with its plain versions "
             "(see backward_kernel_bf16_check)")
    return out


def plain_kernels():
    """The plain versions in place of K2 and K3, on the card."""
    from contextlib import ExitStack

    from adaptigraph_tpu_torch.ops import fused_gnn, fused_gnn_train

    def forward(nodes, nbr, mask, last, weights, cfg, compute_dtype=torch.float32):
        return (*fused_gnn.gnn_forward_plain(nodes, nbr, mask, last, weights, cfg, compute_dtype),
                None)

    def backward(nodes, nbr, mask, dmot, weights, cfg, acts, compute_dtype=torch.float32):
        return fused_gnn_train.gnn_train_bwd_plain(nodes, nbr, mask, dmot, weights, cfg,
                                                   compute_dtype=compute_dtype)

    stack = ExitStack()
    stack.enter_context(mock.patch.object(fused_gnn_train, "train_forward", forward))
    stack.enter_context(mock.patch.object(fused_gnn_train, "gnn_train_bwd", backward))
    return stack


def phase_train_step(config, synth_batch, dev):
    """One optimizer step (augmentation on, the same draws) through the
    kernels and through the plain versions from the same weights, on the
    rope batch at the fixture's density and on the synthetic one. float32:
    the loss within rtol 1e-5 and the gradients within 5e-4 of the norm.
    Adam's first step moves a weight by ~lr * sign(grad), so a gradient
    element near 0 may take either sign: the updated weights must agree
    within 1e-6 but for at most 0.1% of them, and those within 2 lr.
    bfloat16 (``fused_train_fn(..., bfloat16)``, each version in bf16): the
    loss within 1e-2 relative and the gradients within 2e-2 of the norm."""
    gnn, edge, _, hyper = train_objects(config)
    for cd in (torch.float32, torch.bfloat16):
        for name, batch in (("rope", fixture_batch("rope", dev)[0]),
                            ("rope synthetic", synth_batch)):
            check_train_step(name, gnn, edge, hyper, batch, dev, cd)


def check_train_step(name, gnn, edge, hyper, batch, dev, cd):
    from adaptigraph_tpu_torch.dynamics import train
    from adaptigraph_tpu_torch.models.gnn import init_params
    from adaptigraph_tpu_torch.utils import checkpoint as ckpt

    base = ckpt.tree_leaves(init_params(torch.Generator().manual_seed(0), gnn))
    results = []
    for use_plain in (False, True):
        leaves = [p.to(dev).clone().requires_grad_(True) for p in base]
        state = train.adam_init(leaves)
        gen = torch.Generator(device=dev)
        gen.manual_seed(1)
        grads = {}
        real = train.adam_step

        def spy(lv, gr, st, *a, **k):
            grads["g"] = [x.clone() for x in gr]
            return real(lv, gr, st, *a, **k)

        step = train.make_train_step(gnn, edge, hyper, fused_fn=train.fused_train_fn(gnn, edge, cd))
        with mock.patch.object(train, "adam_step", spy):
            if use_plain:
                with plain_kernels():
                    loss = step(leaves, state, batch, gen)
            else:
                loss = step(leaves, state, batch, gen)
        results.append((float(loss), grads["g"], [p.detach() for p in leaves]))
    (lk, gk, pk), (lp, gp, pp) = results
    grad_rel = max(rel_norm(a, b) for a, b in zip(gk, gp))
    diff = torch.cat([(a - b).abs().flatten() for a, b in zip(pk, pp)])
    frac = float((diff > 1e-6).double().mean())
    if cd == torch.float32:
        ok = (abs(lk - lp) <= 1e-5 * abs(lp) and grad_rel <= 5e-4 and frac <= 1e-3
              and float(diff.max()) <= 2 * hyper.lr + 1e-6)
    else:
        ok = abs(lk - lp) <= 1e-2 * abs(lp) and grad_rel <= 2e-2 and np.isfinite(lk)
    emit(phase="train_step_check", case=name, dtype=str(cd).split(".")[-1], loss_kernel=lk,
         loss_plain=lp,
         grad_worst_rel=grad_rel, param_max_abs_diff=float(diff.max()), param_frac_over_1e6=frac,
         ok=bool(ok))
    if not ok:
        fail("the kernel train step disagrees with the plain one (see train_step_check)")


def gnn_work(gnn, nodes, nbr, msk, weights):
    """K2's work on these inputs: (the matmul FLOPs on the N real rows and
    the real edges, the bytes of the tables and weights read once, the
    activation values that K2 keeps for training and K3 reads, counted on
    the N real rows and the real edges)."""
    N, nf, P = gnn.n_nodes, gnn.nf_effect, gnn.pstep
    nfp, nfr, rin = gnn.nf_particle, gnn.nf_relation, gnn.relation_input_dim
    B = nodes.shape[0]
    E = float((msk > 0).sum())
    fwd = forward_work(gnn, nodes, msk, weights, outputs=0)[0]
    acts = (B * N * (2 * nfp + (P + 1) * nf + 3 * nf + P * nf + 2 * nf)
            + E * (rin + 2 * nfr + 2 * nf + P * nf))
    return fwd, sum(t.numel() * t.element_size() for t in [nodes, nbr, msk] + list(weights)), acts


def k2_train_bound(gnn, nodes, nbr, msk, weights, peak):
    """K2 with training's activations kept: its operations; the bytes of its
    inputs (+ last) read once, pred, motion and the activations (in the
    compute dtype) written once."""
    fwd, nbytes, acts = gnn_work(gnn, nodes, nbr, msk, weights)
    B, Np = nodes.shape[:2]
    return dict(zip(("bound_ms", "bound_by"),
                    bound(fwd, nbytes + B * Np * 3 * 4 + B * gnn.max_nobj * 3 * 4 * 2
                          + acts * nodes.element_size(), peak)), gflop_per_launch=fwd / 1e9)


def k3_bound(gnn, nodes, nbr, msk, weights, peak):
    """K3's bound: the lesser of two designs of the same function. One reads
    the forward's activations, kept in the compute dtype, and does two
    products per layer (dX = dY W^T, dW = X^T dY): the present design; the
    other recomputes the forward, as the TPU kernel does (three products
    per layer, no activation bytes). Both read the inputs (nodes, tables,
    dmot, weights) once and write dnodes and the float32 weight gradients
    once. Also the bound of the present design and the bytes of the
    activations it reads."""
    fwd, nbytes, acts = gnn_work(gnn, nodes, nbr, msk, weights)
    B, Np = nodes.shape[:2]
    io = nbytes + B * Np * 3 * 4 + nodes.numel() * 4 + sum(t.numel() * 4 for t in weights)
    act_bytes = acts * nodes.element_size()
    keep = bound(2 * fwd, io + act_bytes, peak)
    recompute = bound(3 * fwd, io, peak)
    (ms, by), design = min((keep, "keeps the activations in the compute dtype"),
                           (recompute, "recomputes the forward"))
    return dict(bound_ms=ms, bound_by=by, bound_design=design, bound_ms_present_design=keep[0],
                activation_bytes_per_launch=act_bytes, gflop_per_launch=2 * fwd / 1e9)


def bound(ops, nbytes, peak):
    t_ops, t_bytes = ops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


K2_KERNELS = ("gnn_forward_kernel",)
K3_KERNELS = ("gnn_train_bwd_kernel", "sum_samples_kernel")  # the backward and its gradient sum


def train_kernel_times(config, batches, dev, R=9):
    """K2 and K3 per launch on the first R of ``batches`` (full training
    batches of B_TRAIN for ``config``, weights from ``init_params``), each
    repetition on another batch: K2 and K3 in float32, K2 and K3 in bfloat16
    on the bf16 packing of the same batches (``k2_bf16``, ``k3_bf16``), each
    as a CUDA-event median and as device time under ``torch.profiler``; the
    plain versions on the same inputs; the bounds; each kernel's shared
    memory per block; and the bare train step, float32 and bfloat16, through
    the kernels and (float32) through the plain versions."""
    from adaptigraph_tpu_torch.dynamics import train
    from adaptigraph_tpu_torch.models.gnn import init_params
    from adaptigraph_tpu_torch.ops import kernels
    from adaptigraph_tpu_torch.ops.fused_gnn import gnn_forward_cuda, gnn_forward_plain
    from adaptigraph_tpu_torch.ops.fused_gnn_train import gnn_train_bwd_cuda, gnn_train_bwd_plain
    from adaptigraph_tpu_torch.utils import checkpoint as ckpt

    gnn, edge, _, hyper = train_objects(config)
    f32, bf16 = torch.float32, torch.bfloat16
    lib = kernels.library()
    params = init_params(torch.Generator(device=dev).manual_seed(0), gnn)
    leaves = [p.clone().requires_grad_(True) for p in ckpt.tree_leaves(params)]
    step = train.make_train_step(gnn, edge, hyper)
    step16 = train.make_train_step(gnn, edge, hyper, fused_fn=train.fused_train_fn(gnn, edge, bf16))
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    batches = batches[:R]
    ins = [step_inputs(b, gnn, edge, params, f32) for b in batches]
    ins16 = [step_inputs(b, gnn, edge, params, bf16) for b in batches]
    dmots, acts, acts16 = [], [], []
    for (nodes, nbr, msk, last, w), i16 in zip(ins, ins16):
        d = torch.randn(nodes.shape[0], nodes.shape[1], 3, device=dev) * 1e-2
        d[:, gnn.max_nobj:] = 0
        dmots.append(d)
        acts.append(gnn_forward_cuda(nodes, nbr, msk, last, w, gnn, f32)[2])
        acts16.append(gnn_forward_cuda(*i16, gnn, bf16)[2])

    def fwd_args(r):
        return ins[r % R] + (gnn, f32)

    def fwd16_args(r):
        return ins16[r % R] + (gnn, bf16)

    def bwd_args(r):  # the kernel's inputs, K2's activations last
        nodes, nbr, msk, _, w = ins[r % R]
        return nodes, nbr, msk, dmots[r % R], w, gnn, acts[r % R]

    def bwd16_args(r):
        nodes, nbr, msk, _, w = ins16[r % R]
        return nodes, nbr, msk, dmots[r % R], w, gnn, acts16[r % R], bf16

    def bwd_plain(*args):  # recomputes the forward, as the TPU kernel does
        return gnn_train_bwd_plain(*args[:6])

    def bwd16_plain(*args):
        return gnn_train_bwd_plain(*args[:6], compute_dtype=bf16)

    gnn_train_bwd_cuda(*bwd_args(0))  # warm-up
    gnn_train_bwd_cuda(*bwd16_args(0))  # warm-up of the bf16 build
    Np, K = ins[0][0].shape[1], ins[0][1].shape[1] // ins[0][0].shape[1]
    out = {"smem_bytes_per_block": {
        "k2_f32": lib.gnn_forward_smem_bytes(Np, K, 0, 0),
        "k2_bf16": lib.gnn_forward_smem_bytes(Np, K, 0, 1),
        "k3_f32": lib.gnn_train_bwd_smem_bytes(Np, K, 0),
        "k3_bf16": lib.gnn_train_bwd_smem_bytes(Np, K, 1)}, "Np": Np, "K": K}
    for name, kern, plain, args, work, cd, reps in (
            ("k2", gnn_forward_cuda, gnn_forward_plain, fwd_args, k2_train_bound, f32, 9),
            ("k3", gnn_train_bwd_cuda, bwd_plain, bwd_args, k3_bound, f32, 9),
            ("k2_bf16", gnn_forward_cuda, gnn_forward_plain, fwd16_args, k2_train_bound, bf16, 7),
            ("k3_bf16", gnn_train_bwd_cuda, bwd16_plain, bwd16_args, k3_bound, bf16, 7)):
        nodes, nbr, msk, _, w = (ins if cd == f32 else ins16)[0]
        out[name] = dict(ms=median_ms(kern, args, reps), plain_ms=median_ms(plain, args, 5),
                         real_edges_per_sample=real_edges(msk),
                         **device_ms(kern, args, reps,
                                     K3_KERNELS if name.startswith("k3") else K2_KERNELS),
                         **work(gnn, nodes, nbr, msk, w, PEAK_FLOPS[cd]))
    acts.clear()
    acts16.clear()
    state = train.adam_init(leaves)
    step(leaves, state, batches[0], gen)
    out["step_ms"] = median_ms(lambda b: step(leaves, state, b, gen),
                               lambda r: (batches[r % R],), 9)
    step16(leaves, state, batches[0], gen)
    out["step_bf16_ms"] = median_ms(lambda b: step16(leaves, state, b, gen),
                                    lambda r: (batches[r % R],), 9)
    with plain_kernels():
        out["plain_step_ms"] = median_ms(lambda b: step(leaves, state, b, gen),
                                         lambda r: (batches[r % R],), 5)
    return out


def time_train_kernels(config, synth_batches, dev, R=9):
    """``train_kernel_times`` at the main path's shapes (rope, B 128). The
    baseline is the rope batches at the fixture's density (``fixture_batch``,
    R seeds); the same numbers on the synthetic dataset's batches (the CLI
    run's data) are reported beside them. Then where a bare float32 step's
    device time goes (``profile_step``)."""
    from adaptigraph_tpu_torch.dynamics import train
    from adaptigraph_tpu_torch.models.gnn import init_params
    from adaptigraph_tpu_torch.utils import checkpoint as ckpt

    dense = [fixture_batch("rope", dev, seed=20 + r)[0] for r in range(R)]
    out = train_kernel_times(config, dense, dev, R)
    emit(phase="train_kernel_time", data="rope fixture density", **out)
    emit(phase="train_kernel_time", data="synthetic dataset",
         **train_kernel_times(config, synth_batches, dev, R))
    gnn, edge, _, hyper = train_objects(config)
    params = init_params(torch.Generator(device=dev).manual_seed(0), gnn)
    leaves = [p.clone().requires_grad_(True) for p in ckpt.tree_leaves(params)]
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    profile_step(train.make_train_step(gnn, edge, hyper), leaves, train.adam_init(leaves), dense,
                 gen)
    return out


# the SM-cycle counters of K2 and K3's profiling build (GNN_PHASE in
# csrc/gnn_common.cuh, gnn_forward.cu and gnn_train_bwd.cu), by index
K2_PHASES = ["relation_inputs", "re0", "re1_re2_rpw1", "pe0", "pe1_pe2_ppwa", "rpw23_rounds",
             "messages_rounds", "ppwb_rounds", "nr0_nr1", "edge_lists", "motion_head"]
K3_PHASES = ["motion_head", "d_pre_ppwb_rounds", "receiver_sender_sums_rounds", "rpw23_rounds",
             "round_weight_grads_and_bases", "pp_pe2_pe1", "pe0", "rpw1", "re2", "re1", "re0",
             "relation_inputs", "edge_lists"]
SUB_PHASES = ["layer_routine_staging", "layer_routine_products", "layer_routine_epilogues"]
_CLOCKS = []  # the profiling build keeps pointers to these counters


def phase_train_kernel_phases(config, dev):
    """Where K2 and K3 spend their SM cycles at the rope fixture's density
    (B 128, weights from ``init_params``), float32 and bf16: one launch each
    of the profiling build (``kernels.library("phase_clocks")``), cycles per
    block by phase, and thread 0's cycles inside the layer routine (staging,
    products, epilogues; those overlap the phases)."""
    from adaptigraph_tpu_torch.models.gnn import init_params
    from adaptigraph_tpu_torch.ops import kernels
    from adaptigraph_tpu_torch.ops.fused_gnn import launch_forward
    from adaptigraph_tpu_torch.ops.fused_gnn_train import launch_backward

    lib = kernels.library("phase_clocks")
    gnn, edge, _, _ = train_objects(config)
    params = init_params(torch.Generator(device=dev).manual_seed(0), gnn)
    batch = fixture_batch("rope", dev, seed=20)[0]
    for cd in (torch.float32, torch.bfloat16):
        nodes, nbr, msk, last, w = step_inputs(batch, gnn, edge, params, cd)
        dmot = torch.randn(nodes.shape[0], nodes.shape[1], 3, device=dev) * 1e-2
        dmot[:, gnn.max_nobj:] = 0
        out = {}
        for name, setter, labels in (("k2", lib.gnn_forward_set_phase_clocks, K2_PHASES),
                                     ("k3", lib.gnn_train_bwd_set_phase_clocks, K3_PHASES)):
            _CLOCKS.append(torch.zeros(16, dtype=torch.int64, device=dev))
            setter(_CLOCKS[-1].data_ptr())
            acts = launch_forward(lib, nodes, nbr, msk, last, w, gnn, cd, True, True)[2]
            if name == "k3":
                torch.cuda.synchronize()
                _CLOCKS[-1].zero_()
                launch_backward(lib, nodes, nbr, msk, dmot, w, gnn, acts, cd)
            torch.cuda.synchronize()
            c = (_CLOCKS[-1].double() / nodes.shape[0]).tolist()
            total = sum(c[:13])
            out[name] = {"cycles_per_block": total,
                         "share": {k: c[i] / total for i, k in enumerate(labels) if k},
                         "layer_routine_share": {k: c[13 + i] / total
                                                 for i, k in enumerate(SUB_PHASES)}}
            del acts
        emit(phase="train_kernel_phases", dtype=str(cd).split(".")[-1], **out)


def profile_step(step, leaves, state, batches, gen, n=5):
    """Where a bare train step's device time goes: ``torch.profiler`` over n
    steps, device time per step by kernel name (device events only: a CPU
    op's entry repeats the time of the kernels it launched), and the
    device's busy share of the wall time (both under the profiler)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        for r in range(n):
            step(leaves, state, batches[r % len(batches)], gen)
        torch.cuda.synchronize()
        wall = time.time() - t0
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    busy = sum(e.self_device_time_total for e in events) / 1e3 / n
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:10]
    emit(phase="train_step_profile", steps=n, wall_ms_per_step=wall / n * 1e3,
         device_ms_per_step=busy, device_busy_share=busy / (wall / n * 1e3),
         top=[{"name": e.key[:80], "ms_per_step": e.self_device_time_total / 1e3 / n,
               "calls_per_step": e.count / n} for e in top])


PROFILED_WINDOWS = 3  # train_steps: profiled windows, at most, for one replay's launches


def kernel_launches_in(fn, names, trace_dir):
    """Under ``torch.profiler`` (the port's ``utils.profiling.device_trace``,
    which writes the trace to ``trace_dir``), the launches of each kernel
    whose name holds one of ``names`` (device events) while fn() runs."""
    from torch.autograd import DeviceType

    from adaptigraph_tpu_torch.utils.profiling import device_trace

    torch.cuda.synchronize()
    with device_trace(trace_dir) as prof:
        fn()
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    return {n: sum(e.count for e in events if n in e.key) for n in names}


def phase_train_steps(config, dev, K=10, R=9, parts=None, data="rope fixture density"):
    """K optimizer steps per call (``make_train_steps``: on the card one step
    captured in a CUDA graph after one eager step, then replayed per slice)
    on a superbatch of K batches (``parts``; by default at the rope fixture's
    density, ``fixture_batch``, B 128, n_future 3), in float32 and in bf16
    (``fused_train_fn(..., bfloat16)``). The gate: two calls (20 steps) from
    the same weights, Adam state and generator seed give the losses, the
    parameters and the Adam state (moments, count) of 20 ``make_train_step``
    calls, bit for bit, after each call. The K2 and K3 launches of one
    replay, counted by ``torch.profiler`` kernel names, must equal the
    capture's count (3 + 3): the profiled window holds a fresh step object's
    eager slice and capture, then one replay, and the eager step's launches
    (its wrappers' counts) come off; a window short of a launch, which CUPTI
    can lose, is taken again on a fresh step object, PROFILED_WINDOWS in
    all at most, and none may show more. A call of K steps must add 3K + 3K to
    the launch counters. ms per step through the graph and through the loop
    (CUDA events around a call of K steps and around K step calls,
    alternating, median of R) and host ms per step (perf_counter around the
    call, which returns once its work is queued)."""
    from adaptigraph_tpu_torch.dynamics import train
    from adaptigraph_tpu_torch.models.gnn import init_params
    from adaptigraph_tpu_torch.ops.fused_gnn import gnn_forward
    from adaptigraph_tpu_torch.ops.fused_gnn_train import gnn_train_bwd
    from adaptigraph_tpu_torch.utils import checkpoint as ckpt

    gnn, edge, _, hyper = train_objects(config)
    parts = parts or [fixture_batch("rope", dev, seed=40 + k)[0] for k in range(K)]
    sb = {name: torch.stack([p[name] for p in parts]) for name in parts[0]}
    base = ckpt.tree_leaves(init_params(torch.Generator().manual_seed(0), gnn))

    def start(cd, graphed):
        leaves = [p.to(dev).clone().requires_grad_(True) for p in base]
        state = train.adam_init(leaves)
        gen = torch.Generator(device=dev)
        gen.manual_seed(5)
        fused = train.fused_train_fn(gnn, edge, cd)
        if graphed:
            steps = train.make_train_steps(gnn, edge, hyper, fused_fn=fused)
            return steps, lambda batch: steps(leaves, state, batch, gen), leaves, state
        step = train.make_train_step(gnn, edge, hyper, fused_fn=fused)

        def loop(batch):
            return torch.stack([step(leaves, state, {n: v[k] for n, v in batch.items()}, gen)
                                for k in range(next(iter(batch.values())).shape[0])])

        return None, loop, leaves, state

    def snapshot(losses, leaves, state):
        return ([losses.clone()] + [p.detach().clone() for p in leaves]
                + [t.clone() for t in state["mu"] + state["nu"]] + [state["count"].clone()])

    results, launches = {}, [0, 0]
    for cd in (torch.float32, torch.bfloat16):
        name = str(cd).split(".")[-1]
        steps, graph_call, gl, gs = start(cd, True)
        _, loop_call, ll, ls = start(cd, False)
        equal, per_call = [], []
        for _ in range(2):  # the first call warms up and captures, the second only replays
            gnn_forward.launches = gnn_train_bwd.launches = 0
            got = snapshot(graph_call(sb), gl, gs)
            per_call.append([gnn_forward.launches, gnn_train_bwd.launches])
            launches = [a + b for a, b in zip(launches, per_call[-1])]
            want = snapshot(loop_call(sb), ll, ls)
            equal.append(all(torch.equal(a, b) for a, b in zip(got, want)))
        # one replay under the profiler, of a graph captured inside the same
        # window: a CUPTI that attaches after a graph's instantiation need
        # not trace its kernel nodes. A one-slice call on a fresh step object
        # runs the slice eagerly and captures (the counters take the eager
        # step's launches, not the capture's); a second call replays once.
        # CUPTI can lose a record (one K3 of six, in one window of some
        # forty), and a graph runs every node on every replay, so a window
        # short of a launch is taken again, up to PROFILED_WINDOWS times:
        # one must show exactly the eager step's and the capture's, and
        # none more.
        windows, eager, fresh_capture = [], [], None
        for w in range(PROFILED_WINDOWS):
            fresh_steps, fresh_call = start(cd, True)[:2]
            one, eager = {n: v[:1] for n, v in sb.items()}, []

            def capture_then_replay():
                gnn_forward.launches = gnn_train_bwd.launches = 0
                fresh_call(one)
                eager.extend([gnn_forward.launches, gnn_train_bwd.launches])
                fresh_call(one)

            profiled = kernel_launches_in(capture_then_replay,
                                          ("gnn_forward_kernel", "gnn_train_bwd_kernel"),
                                          os.path.join(TRAIN_DIR, f"trace_train_steps_{data}_{name}"
                                                       .replace(" ", "_") + f"_{w}"))
            fresh_capture = list(fresh_steps.graphed.counted)
            windows.append({k: profiled[k] - n for k, n in zip(profiled, eager)})
            del fresh_steps, fresh_call
            if [windows[-1]["gnn_forward_kernel"],
                    windows[-1]["gnn_train_bwd_kernel"]] == fresh_capture:
                break
        per_replay = windows[-1]
        graph_ms, loop_ms, graph_host, loop_host = [], [], [], []
        for _ in range(R):
            for call, ms, host in ((graph_call, graph_ms, graph_host),
                                   (loop_call, loop_ms, loop_host)):
                torch.cuda.synchronize()
                e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                e0.record()
                t0 = time.perf_counter()
                call(sb)
                host.append((time.perf_counter() - t0) * 1e3 / K)
                e1.record()
                e1.synchronize()
                ms.append(e0.elapsed_time(e1) / K)
        capture = list(steps.graphed.counted)
        ok = (all(equal) and capture == fresh_capture == eager == [3, 3]
              and per_call == [[3 * K, 3 * K]] * 2
              and [per_replay["gnn_forward_kernel"], per_replay["gnn_train_bwd_kernel"]] == capture
              and all(w[k] <= n for w in windows for k, n in zip(per_replay, capture)))
        results[name] = dict(bit_equal_per_call=equal, capture_launches={"k2": capture[0],
                                                                         "k3": capture[1]},
                             profiled_launches_eager_and_one_replay=profiled,
                             eager_step_launches={"k2": eager[0], "k3": eager[1]},
                             profiled_launches_one_replay=per_replay,
                             profiled_windows=windows,
                             launches_per_call=[{"k2": a, "k3": b} for a, b in per_call],
                             ms_per_step_graph=float(np.median(graph_ms)),
                             ms_per_step_loop=float(np.median(loop_ms)),
                             host_ms_per_step_graph=float(np.median(graph_host)),
                             host_ms_per_step_loop=float(np.median(loop_host)), ok=bool(ok))
        del steps, graph_call, loop_call
    emit(phase="train_steps", K=K, B=B_TRAIN, data=data, **results)
    if not all(r["ok"] for r in results.values()):
        fail("the graphed K-step train calls failed their checks (see the train_steps line)")
    return launches


CURVE_RTOL = 0.02  # kernel vs plain run, each epoch's mean train and valid loss
CURVE_SPREADS = 3  # ... or within this many times the float32 spread of the curves


def cli_train(prep, tag, plain=False, nudge=False, cd=torch.float32, config="rope",
              args=TRAIN_ARGS):
    """The CLI's train command (``--config config`` and ``args``) into
    TRAIN_DIR/<tag>, through the kernels or
    (``plain``) the plain versions; with ``nudge``, from initial weights
    each one float32 step nearer 0; with ``cd`` bfloat16, its K-step train
    and eval calls built by ``make_train_steps`` / ``make_eval_steps`` with
    ``fused_fn=fused_train_fn(..., bfloat16)`` (the CLI has no dtype
    option). ``--steps_per_call 10``: each call replays a CUDA graph of one
    step 10 times. Returns (params, curves, seconds, argv, the loss of every
    train step)."""
    from contextlib import ExitStack

    from adaptigraph_tpu_torch.cli import main
    from adaptigraph_tpu_torch.dynamics import train
    from adaptigraph_tpu_torch.utils import checkpoint as ckpt

    init, make_steps, make_evals = train.init_params, train.make_train_steps, train.make_eval_steps
    losses = []

    def nudged(generator, cfg):
        return ckpt.tree_from_leaves([torch.nextafter(p, torch.zeros_like(p))
                                      for p in ckpt.tree_leaves(init(generator, cfg))])

    def steps_recorded(gnn, edge, hyper):
        steps = make_steps(gnn, edge, hyper, fused_fn=train.fused_train_fn(gnn, edge, cd))

        def recorded(*a):  # the K losses of each call
            losses.append(steps(*a))
            return losses[-1]

        return recorded

    def eval_steps(gnn, edge, hyper):
        return make_evals(gnn, edge, hyper, fused_fn=train.fused_train_fn(gnn, edge, cd))

    argv = ["train", "--config", config, "--prep_dir", prep,
            "--out_dir", os.path.join(TRAIN_DIR, tag)] + args
    with ExitStack() as stack:
        stack.enter_context(mock.patch.object(train, "make_train_steps", steps_recorded))
        stack.enter_context(mock.patch.object(train, "make_eval_steps", eval_steps))
        if plain:
            stack.enter_context(plain_kernels())
        if nudge:
            stack.enter_context(mock.patch.object(train, "init_params", nudged))
        t0 = time.time()
        params, curves = main(argv)
    return params, curves, time.time() - t0, argv, torch.cat(losses).cpu().numpy()


def phase_train(config, prep, dev):
    """The main path of this slice: the CLI's train command on the synthetic
    dataset, 3 epochs of 100 steps at batch 128 (superbatches of 10), with
    K2/K3 launch counts read around it (3 + 3 per train step, 3 K2 per
    validation step), a falling train loss and the checkpoint read back.

    Then the same run with the plain versions in place of the kernels, on
    the card (no kernel launch): its train and validation curves must agree
    with the kernels' at every epoch, within CURVE_RTOL or within
    CURVE_SPREADS times the spread that float32 rounding alone gives the
    curve there. Two runs that differ only in rounding drift apart over
    hundreds of Adam steps, and the clean validation loss (one held-out
    episode, ~1% of the train loss) moves with the drift; the spread is
    measured by the same two runs from initial weights one float32 step
    apart: the larger of |kernel - kernel'| and |plain - plain'|."""
    from adaptigraph_tpu_torch.cli import load_params
    from adaptigraph_tpu_torch.ops.fused_gnn import gnn_forward
    from adaptigraph_tpu_torch.ops.fused_gnn_train import gnn_train_bwd
    from adaptigraph_tpu_torch.utils import checkpoint as ckpt
    from adaptigraph_tpu_torch.utils.metrics import read_metrics

    gnn = train_objects(config)[0]
    out = os.path.join(TRAIN_DIR, "out")
    gnn_forward.launches = 0
    gnn_train_bwd.launches = 0
    params, curves, secs, argv, losses = cli_train(prep, "out")
    k2, k3 = gnn_forward.launches, gnn_train_bwd.launches
    epochs = [m for m in read_metrics(os.path.join(out, "metrics.jsonl")) if m["tag"] == "epoch"]
    train_steps = sum(m["train_steps"] for m in epochs)
    valid_steps = 10 * len(epochs)  # n_iters_valid 10 per epoch, one superbatch of 10
    last = epochs[-1]
    back = load_params(out, gnn, dev)
    same = all(torch.equal(a, b.to(a.device))
               for a, b in zip(ckpt.tree_leaves(back), ckpt.tree_leaves(params)))
    # the train loss (state noise 0.05 on the history) must fall
    falling = curves["train"][-1] < curves["train"][0]
    launches_ok = k3 == 3 * train_steps and k2 == 3 * (train_steps + valid_steps)

    _, kernel_nudged, _, _, nudged_losses = cli_train(prep, "out_nudged", nudge=True)
    before = gnn_forward.launches + gnn_train_bwd.launches
    _, plain, plain_secs, _, _ = cli_train(prep, "out_plain", plain=True)
    plain_nudged = cli_train(prep, "out_plain_nudged", plain=True, nudge=True)[1]
    plain_launches = gnn_forward.launches + gnn_train_bwd.launches - before
    agree, curve_check = plain_launches == 0, {}
    for k in ("train", "valid"):
        K, P = np.array(curves[k]), np.array(plain[k])
        spread = np.maximum(np.abs(K - np.array(kernel_nudged[k])),
                            np.abs(P - np.array(plain_nudged[k])))
        tol = np.maximum(CURVE_RTOL * np.abs(P), CURVE_SPREADS * spread)
        agree &= bool((np.abs(K - P) <= tol).all())
        curve_check[k] = {"kernel": curves[k], "plain": plain[k],
                          "kernel_nudged": kernel_nudged[k], "plain_nudged": plain_nudged[k],
                          "abs_diff": np.abs(K - P).tolist(), "spread": spread.tolist(),
                          "tol": tol.tolist()}
    ok = bool(falling and launches_ok and same and agree and np.isfinite(curves["train"]).all()
              and np.isfinite(curves["valid"]).all())
    emit(phase="train", argv=argv[1:], seconds=round(secs, 2), train_steps=train_steps,
         valid_steps=valid_steps, k2_launches=k2, k3_launches=k3,
         k2_per_train_step=(k2 - 3 * valid_steps) / train_steps, k3_per_train_step=k3 / train_steps,
         train_loss=curves["train"], valid_loss=curves["valid"], curves=curve_check,
         curve_rtol=CURVE_RTOL, curve_spreads=CURVE_SPREADS, plain_runs_launches=plain_launches,
         plain_seconds=round(plain_secs, 2),
         ms_per_step_cli=last["train_seconds"] / last["train_steps"] * 1e3,
         checkpoint_read_back_equal=same, ok=ok)
    if not ok:
        fail("the train run failed its checks (see the train line)")
    return k2, k3, losses, nudged_losses


def phase_train_bf16(prep, f32_losses, f32_nudged_losses, last=50):
    """The bfloat16 training path: 300 steps of the CLI's loop through
    ``make_train_step(fused_fn=fused_train_fn(..., bfloat16))`` (and its
    eval step) on the synthetic dataset, from the float32 run's initial
    weights, data order and augmentation draws, with the K2/K3 launch counts
    read around it. The loss must stay finite and fall, and its mean over
    the last 50 steps lie within the float32 nudged-run spread of the
    float32 run's (the two float32 runs' last-50 means), widened by 5% of
    the float32 run's mean on each side."""
    from adaptigraph_tpu_torch.ops.fused_gnn import gnn_forward
    from adaptigraph_tpu_torch.ops.fused_gnn_train import gnn_train_bwd
    from adaptigraph_tpu_torch.utils.metrics import read_metrics

    gnn_forward.launches = 0
    gnn_train_bwd.launches = 0
    _, curves, secs, argv, losses = cli_train(prep, "out_bf16", cd=torch.bfloat16)
    k2, k3 = gnn_forward.launches, gnn_train_bwd.launches
    train_steps, valid_steps = len(losses), 10 * len(curves["train"])
    m16, m32, m32n = (float(np.mean(x[-last:])) for x in (losses, f32_losses, f32_nudged_losses))
    epoch = [m for m in read_metrics(os.path.join(TRAIN_DIR, "out_bf16", "metrics.jsonl"))
             if m["tag"] == "epoch"][-1]
    lo, hi = min(m32, m32n) - 0.05 * m32, max(m32, m32n) + 0.05 * m32
    ok = bool(np.isfinite(losses).all() and curves["train"][-1] < curves["train"][0]
              and lo <= m16 <= hi and k3 == 3 * train_steps and k2 == 3 * (train_steps + valid_steps))
    emit(phase="train_bf16", argv=argv[1:], fused_fn="fused_train_fn(..., torch.bfloat16)",
         seconds=round(secs, 2), train_steps=train_steps, valid_steps=valid_steps,
         k2_launches=k2, k3_launches=k3, train_loss=curves["train"], valid_loss=curves["valid"],
         last50_mean_bf16=m16, last50_mean_f32=m32, last50_mean_f32_nudged=m32n,
         band=[lo, hi], ms_per_step_cli=epoch["train_seconds"] / epoch["train_steps"] * 1e3, ok=ok)
    if not ok:
        fail("the bf16 train run failed its checks (see the train_bf16 line)")
    return k2, k3


# ---------------------------------------------------------------------------
# the rollout evaluator (K2) and dynamics_masked for the tool policies (K2)
# ---------------------------------------------------------------------------

def plain_forward():
    """K2's plain version in place of the kernel, on the card."""
    from adaptigraph_tpu_torch.ops import fused_gnn

    def plain(nodes, nbr, mask, last, weights, cfg, cd, want_motion=True):
        return fused_gnn.gnn_forward_plain(nodes, nbr, mask, last, weights, cfg, cd, want_motion)

    return mock.patch.object(fused_gnn, "gnn_forward", plain)


def phase_rollout(config, prep, dev):
    """The rollout evaluator through the CLI, ``rollout --config rope
    --all_episodes`` in process on the synthetic dataset (full rope width, B
    the number of pushes, up to 100 steps, one graph build and one float32
    K2 launch per step): with the float32 CLI run's checkpoint, then with
    the rope fixture's weights (copied under TRAIN_DIR, so nothing is written
    into fixtures/). Each run's K2 launches are counted from 0, and each
    per-push error curve is held against the same evaluator with K2's plain
    version: step 1 within 2e-4, the median over pushes within 1% at every
    step. Then K2 and the graph build at the batched run's shapes (CUDA
    events, median of 7 on one mid-rollout step), K2's plain version and its
    bound. Returns (K2 launches of the first run, timing)."""
    from adaptigraph_tpu_torch.cli import load_params, main
    from adaptigraph_tpu_torch.dynamics import rollout
    from adaptigraph_tpu_torch.dynamics.dataset import spec_from_config
    from adaptigraph_tpu_torch.ops.fused_gnn import (gnn_forward, gnn_forward_cuda,
                                                     gnn_forward_plain, pack_inputs, weight_list)
    from adaptigraph_tpu_torch.ops.graph import build_neighbor_graph_batch

    gnn, edge = train_objects(config)[:2]
    spec = spec_from_config(config)
    fixture = os.path.join(TRAIN_DIR, "rollout_fixture")
    shutil.copytree(os.path.join(ROOT, "fixtures", "rope_demo", "checkpoints"),
                    os.path.join(fixture, "checkpoints"))
    real_forward = rollout.fused_forward_batch
    steps = []  # the first run's steps at its widest batch

    def spy(weights, graph, *a, **k):
        B = graph["state"].shape[0]
        if first_launches is None and (not steps or B >= steps[0]["state"].shape[0]):
            if steps and B > steps[0]["state"].shape[0]:
                steps.clear()
            steps.append({key: v.clone() for key, v in graph.items()})
        return real_forward(weights, graph, *a, **k)

    runs, ok_all, first_launches = {}, True, None
    for tag, out in (("trained", os.path.join(TRAIN_DIR, "out")), ("fixture", fixture)):
        argv = ["rollout", "--config", "rope", "--prep_dir", prep, "--out_dir", out,
                "--all_episodes"]
        torch.cuda.synchronize()
        gnn_forward.launches = 0
        t0 = time.time()
        with mock.patch.object(rollout, "fused_forward_batch", spy):
            stats, summary = main(argv)
        torch.cuda.synchronize()
        secs = time.time() - t0
        launches = gnn_forward.launches
        if first_launches is None:
            first_launches = launches
        with plain_forward():
            plain = rollout.rollout_dataset(load_params(out, gnn, dev), spec, gnn, edge, prep,
                                            phase_ratio=(0.0, 1.0))
        got, want = stats["per_push"], plain["per_push"]
        step1 = max(abs(float(a[0]) - float(b[0])) for a, b in zip(got, want))
        med_rel = np.abs(stats["median"] - plain["median"]) / np.abs(plain["median"])
        ok = bool(len(got) == len(want) == summary["n_pushes"] > 0 and step1 <= 2e-4
                  and (med_rel <= 0.01).all() and np.isfinite(stats["median"]).all()
                  and launches > 0)
        ok_all &= ok
        runs[tag] = dict(summary=summary, seconds=round(secs, 2), k2_launches=launches,
                         steps=len(stats["median"]), ms_per_k2_launch_cli=secs / launches * 1e3,
                         step1_max_abs_diff_vs_plain=step1,
                         median_max_rel_diff_vs_plain=float(med_rel.max()),
                         median=stats["median"].tolist(), plain_median=plain["median"].tolist(),
                         ok=ok)

    # K2 and the graph build at the batched run's shapes, on its middle step
    g = steps[len(steps) // 2]
    w = weight_list(load_params(os.path.join(TRAIN_DIR, "out"), gnn, dev), gnn, torch.float32)
    B = g["state"].shape[0]
    nodes, nbr, msk, last, _ = pack_inputs(gnn, g["state"], g["action"], g["physics_param"],
                                           g["attrs"], g["p_instance"], g["neighbors"],
                                           g["nbr_mask"], edge.topk + edge.max_neef, torch.float32)
    const = (w, gnn, torch.float32, False)
    ms = median_ms(lambda *a: gnn_forward_cuda(*a, *const, keep_acts=False),
                   lambda r: (nodes, nbr, msk, last), 7)
    plain_ms = median_ms(lambda *a: gnn_forward_plain(*a, *const), lambda r: (nodes, nbr, msk, last), 3)
    tool = (torch.arange(gnn.n_nodes, device=dev) >= gnn.max_nobj).expand(B, gnn.n_nodes)
    state_mask = torch.cat([g["attrs"][:, :gnn.max_nobj, 0] > 0, tool[:, gnn.max_nobj:]], dim=1)
    graph_ms = median_ms(lambda s: build_neighbor_graph_batch(s, state_mask, tool,
                                                              float(np.mean(spec.adj_radius_range)),
                                                              edge),
                         lambda r: (g["state"][:, -1],), 7)
    ops, nbytes = forward_work(gnn, nodes, msk, w, outputs=1)
    b_ms, b_by = bound(ops, nbytes + nbr.numel() * 4 + msk.numel() * 4, PEAK_FLOPS[torch.float32])
    timing = dict(B=B, k2_ms=ms, k2_plain_ms=plain_ms, k2_bound_ms=b_ms, k2_bound_by=b_by,
                  k2_gflop_per_launch=ops / 1e9, real_edges_per_sample=real_edges(msk),
                  graph_build_ms=graph_ms)
    emit(phase="rollout", runs=runs, **timing, ok=ok_all)
    if not ok_all:
        fail("the rollout evaluator failed its checks (see the rollout line)")
    return first_launches, timing


def phase_masked_tools(dev):
    """``dynamics_masked`` on the cloth config (contact-gated tools_all,
    gripper lift, published width), B 2000 pushes of the sheet with 0.005 of
    noise, per-sample masks (50-100 of the 100 object slots valid), actions
    from the task's limits and physics; weights from ``init_params``;
    float32, one graph build and one K2 launch per substep to the largest
    repeat. K2's launches are counted from 0 and must be min(largest
    repeat, max_repeat), with no other kernel; each sample's valid objects
    against the same call with K2's plain version, within the float32
    whole-push bound graded by its repeat. Returns (launches, ms)."""
    from adaptigraph_tpu_torch.ops import fused_gnn
    from adaptigraph_tpu_torch.planning.actions import decode_action
    from adaptigraph_tpu_torch.planning.forward import dynamics_masked

    tcfg, params, state, _ = cloth_setup(dev)
    dcfg = tcfg.dcfg
    n_p, B = dcfg.gnn.max_nobj, B_CHUNK
    rng = np.random.RandomState(6)
    counts = rng.randint(n_p // 2, n_p + 1, B)
    mask = torch.tensor(np.arange(n_p)[None] < counts[:, None], device=dev)
    s0 = torch.tensor(state[None] + rng.randn(B, n_p, 3).astype(np.float32) * 0.005,
                      device=dev) * mask[..., None]
    act = torch.tensor(rng.uniform(tcfg.action_lower_lim, tcfg.action_upper_lim,
                                   (B, 4)).astype(np.float32), device=dev)
    phys = torch.tensor(rng.uniform(0, 1, (B, 1)).astype(np.float32), device=dev)
    w = fused_gnn.weight_list(params, dcfg.gnn, torch.float32)
    args = (w, s0, mask, act, phys, dcfg)
    dynamics_masked(*args)  # warm-up
    torch.cuda.synchronize()
    fused_gnn.gnn_forward.launches = 0
    others = fused_gnn.gnn_forward_edges.launches + fused_gnn.fused_rollout_chunk.launches
    t0 = time.time()
    got = dynamics_masked(*args)
    torch.cuda.synchronize()
    ms = (time.time() - t0) * 1e3
    launches = fused_gnn.gnn_forward.launches
    others = fused_gnn.gnn_forward_edges.launches + fused_gnn.fused_rollout_chunk.launches - others
    with plain_forward():
        want = dynamics_masked(*args)
    repeat = decode_action(act[:, None], dcfg.push_length)[1][:, 0].cpu().numpy()
    expected = min(int(repeat.max()), dcfg.max_repeat)
    err = per_sample_err(got, want, mask[..., None])
    tols = np.array([graded(min(int(r), dcfg.max_repeat)) for r in repeat])
    ok = bool(torch.isfinite(got).all() and (err <= tols).all() and launches == expected
              and others == 0)
    emit(phase="masked_tools", B=B, policy=dcfg.edge.policy, k2_launches=launches,
         expected_launches=expected, other_kernel_launches=others, ms=ms,
         ms_per_substep=ms / max(launches, 1), max_abs_err=float(err.max()),
         p99_abs_err=float(np.quantile(err, 0.99)), tol="graded by repeat",
         repeat_mean=float(repeat.mean()), ok=ok)
    if not ok:
        fail("dynamics_masked on cloth failed its checks (see the masked_tools line)")
    return launches, ms / max(launches, 1), float(err.max())

# ---------------------------------------------------------------------------
# the closed-loop rope plan (K1 in the solve and the estimate), the granular solve
# ---------------------------------------------------------------------------

PLAN_DIR = os.path.join(TRAIN_DIR, "plan")
PLAN_PUSHES = 3


def plan_k1_launches(tcfg, n_pushes):
    """K1 launches that ``run_plan`` makes for ``n_pushes`` executed pushes
    (verify off, phys_dim 1): per push one solve of n_sample / n_sample_chunk
    chunks per look-ahead step and update iteration, one launch each
    (``mppi_solve.all_rewards``), and one estimate, one masked launch per
    ``evaluate`` of ``PhysicsParamOnlineOptimizer.optimize``: the initial
    error, the GP's first n_init candidates, its expected-improvement batches
    of 10 up to the ``ppo_iterations`` budget, and the final error."""
    m = tcfg.mcfg
    per_solve = m.n_sample // m.n_sample_chunk * m.n_look_ahead * m.n_update_iter
    budget = tcfg.ppo_iterations
    n_init = min(20, max(budget // 2, 2))
    per_estimate = 1 + 1 + -(-(budget - n_init) // 10) + 1
    return n_pushes * (per_solve + per_estimate), per_solve, per_estimate


def timed_calls(parts, key, fn, sync):
    """``fn`` with the seconds of each call (after a device sync) added to
    parts[key]."""
    def wrapped(*a, **k):
        t0 = time.perf_counter()
        out = fn(*a, **k)
        if sync:
            torch.cuda.synchronize()
        parts[key] += time.perf_counter() - t0
        return out

    return wrapped


def plan_step0_vs_plain(tcfg, params, dev):
    """Step 0's recorded prediction against the plain rollout of the executed
    push from the recorded state, padded as the solve pads it, at the
    initial estimate 0.5."""
    with np.load(os.path.join(PLAN_DIR, "step_000.npz")) as z:
        act, state, pred = z["act"], z["state"], z["pred_state"]
    n = len(pred)
    obj = np.zeros((tcfg.dcfg.gnn.max_nobj, 3), np.float32)
    obj[:n] = state[:n]
    ref = plain_push(tcfg.dcfg, params, obj, act, np.array([0.5], np.float32), dev)
    return float((ref[:n].cpu() - torch.tensor(pred)).abs().max())


def phase_plan(dev):
    """``python -m adaptigraph_tpu_torch plan --config rope --ckpt_dir
    fixtures/rope_demo --n_actions 3 --seed 0`` in process at the published
    width (20,000 samples in chunks of 2,000, bf16, adaptation on): K1's
    launches counted from 0 around the run and held to ``plan_k1_launches``;
    three finite errors, ``initial.npz`` and ``step_00{0,1,2}.npz`` written,
    the estimate inside [-0.2, 1.2], the true parameter recorded; step 0's
    prediction within 0.05 of the plain rollout of its push. ms per executed
    push (``run_plan``'s wall time over its pushes) and its split: perceive
    (camera render, fusion, FPS), solve, execute (the simulator's push),
    adapt (the estimate) and the rest."""
    from adaptigraph_tpu_torch import cli
    from adaptigraph_tpu_torch.ops import fused_gnn
    from adaptigraph_tpu_torch.planning import closed_loop
    from adaptigraph_tpu_torch.planning.physics_optimizer import (PARAM_HI, PARAM_LO,
                                                                  PhysicsParamOnlineOptimizer)
    from adaptigraph_tpu_torch.realworld.env import SimRealEnv
    from adaptigraph_tpu_torch.utils.config import load_planning_config

    fixture = os.path.join(ROOT, "fixtures", "rope_demo")
    tcfg, _ = cli._task_objects(load_planning_config("rope"))
    d, m = tcfg.dcfg, tcfg.mcfg
    published = (d.gnn.n_nodes, d.edge.topk, d.gnn.nf_effect, d.gnn.pstep, d.gnn.phys_dim,
                 m.n_sample, m.n_sample_chunk, m.n_look_ahead, m.n_update_iter)
    if published != (101, 10, 128, 3, 1, 20000, 2000, 1, 1):
        fail(f"rope plan config is not the published width: {published}")
    shutil.rmtree(PLAN_DIR, ignore_errors=True)
    argv = ["plan", "--config", "rope", "--ckpt_dir", fixture, "--n_actions", str(PLAN_PUSHES),
            "--seed", "0", "--save_dir", PLAN_DIR, "--device", dev.type]
    sync = dev.type == "cuda"
    parts = dict.fromkeys(("perceive", "solve", "execute", "adapt", "run_plan"), 0.0)
    real_make = closed_loop.make_mppi_solver

    def make_solver(*a, **k):
        return timed_calls(parts, "solve", real_make(*a, **k), sync)

    patches = [
        mock.patch.object(closed_loop, "make_mppi_solver", make_solver),
        mock.patch.object(closed_loop, "get_state_cur",
                          timed_calls(parts, "perceive", closed_loop.get_state_cur, False)),
        mock.patch.object(SimRealEnv, "step",
                          timed_calls(parts, "execute", SimRealEnv.step, False)),
        mock.patch.object(PhysicsParamOnlineOptimizer, "optimize",
                          timed_calls(parts, "adapt", PhysicsParamOnlineOptimizer.optimize, sync)),
        mock.patch.object(closed_loop, "run_plan",
                          timed_calls(parts, "run_plan", closed_loop.run_plan, sync)),
    ]
    for p in patches:
        p.start()
    try:
        fused_gnn.fused_rollout_chunk.launches = 0
        t0 = time.time()
        hist = cli.main(argv)
        secs = time.time() - t0
        launches = fused_gnn.fused_rollout_chunk.launches
    finally:
        for p in patches:
            p.stop()
    n_push = len(hist["errors"])
    expected, per_solve, per_estimate = plan_k1_launches(tcfg, n_push)
    files = ["initial.npz"] + [f"step_{i:03d}.npz" for i in range(PLAN_PUSHES)]
    written = all(os.path.exists(os.path.join(PLAN_DIR, f)) for f in files)
    est = [float(e[0]) for e in hist["phys"]]
    with np.load(os.path.join(PLAN_DIR, "initial.npz")) as z:
        true_on_disk = "true_phys" in z.files
    params = cli.load_params(fixture, d.gnn, dev)
    pred_err = plan_step0_vs_plain(tcfg, params, dev) if written else float("inf")
    ms = {k: v / max(n_push, 1) * 1e3 for k, v in parts.items()}
    split = {k: ms[k] for k in ("perceive", "solve", "execute", "adapt")}
    split["rest"] = ms["run_plan"] - sum(split.values())
    ok = bool(n_push == PLAN_PUSHES and np.isfinite(hist["errors"]).all() and written
              and len(est) == n_push and all(PARAM_LO <= e <= PARAM_HI for e in est)
              and hist.get("true_phys") is not None and true_on_disk
              and launches == expected and pred_err <= 0.05)
    emit(phase="plan", pushes=n_push, errors=hist["errors"], initial_error=hist["initial_error"],
         estimates=est, true_phys=[float(x) for x in hist.get("true_phys", [])],
         k1_launches=launches, expected_k1_launches=expected, k1_per_solve=per_solve,
         k1_per_estimate=per_estimate, step0_pred_vs_plain=pred_err, pred_tol=0.05,
         files_written=written, seconds=secs, ms_per_push=ms["run_plan"], ms_split=split, ok=ok)
    if not ok:
        fail("the closed-loop plan failed its checks (see the plan line)")
    return launches, ms["run_plan"], split


def phase_granular_solve(dev):
    """``make_mppi_solver`` on the granular task at its published width
    (5-point board, K 20, 20,000 samples in chunks of 2,000, bf16) with the
    fixture's weights and first recorded state and the config's box target:
    one warm-up and three timed solves, K1 launches counted from 0 and held
    to n_chunks x n_look_ahead per solve, every reward finite. Then one
    float32 chunk through K1 against the same chunk through its plain
    version on the card, each sample within the graded whole-push bound."""
    from adaptigraph_tpu_torch.ops import fused_gnn
    from adaptigraph_tpu_torch.planning import mppi_solve
    from adaptigraph_tpu_torch.planning.closed_loop import make_reward_fn

    tcfg, params, state, _ = material("granular", dev)
    dcfg, mcfg = tcfg.dcfg, tcfg.mcfg
    published = (dcfg.gnn.n_nodes, dcfg.edge.topk, dcfg.gnn.nf_effect, dcfg.gnn.pstep,
                 dcfg.max_repeat, mcfg.n_sample, mcfg.n_sample_chunk, tcfg.target_type)
    if published != (105, 20, 128, 3, 10, 20000, 2000, "box"):
        fail(f"granular config is not the published width: {published}")
    target = np.asarray(tcfg.target_path, np.float32).reshape(2, 2) * tcfg.sim_real_ratio
    reward = make_reward_fn(tcfg, target, dev)
    finite = []

    def reward_fn(*a):
        r = reward(*a)
        finite.append(torch.isfinite(r).all())
        return r

    solve = mppi_solve.make_mppi_solver(dcfg, mcfg, reward_fn, tcfg.action_lower_lim,
                                        tcfg.action_upper_lim, device=dev)
    act0 = np.tile((tcfg.action_lower_lim + tcfg.action_upper_lim) / 2, (mcfg.n_look_ahead, 1))
    phys = np.array([0.5], np.float32)

    def run(seed):
        g = torch.Generator(device=dev)
        g.manual_seed(seed)
        return solve(params, state, act0, g, phys)

    run(0)  # warm-up
    torch.cuda.synchronize()
    finite.clear()
    n_solves = 3
    fused_gnn.fused_rollout_chunk.launches = 0
    t0 = time.time()
    results = []
    for seed in range(1, n_solves + 1):
        results.append(run(seed))
        torch.cuda.synchronize()
    secs = time.time() - t0
    launches = fused_gnn.fused_rollout_chunk.launches
    per_solve = mcfg.n_sample // mcfg.n_sample_chunk * mcfg.n_look_ahead * mcfg.n_update_iter
    all_finite = bool(torch.stack(finite).all())

    # one float32 chunk: K1 against its plain version, on the card
    err, tols, got_r, want_r = f32_chunk_vs_plain(
        tcfg, params, state, phys, reward, mppi_solve.dynamics_rollout_batched,
        lambda: mock.patch.object(fused_gnn, "rollout_chunk", fused_gnn.rollout_chunk_plain), dev)
    ok = bool(launches == per_solve * n_solves and all_finite
              and all(torch.isfinite(r["best_reward"]) for r in results)
              and all(r["best_final_state"].is_cuda for r in results)
              and (err <= tols).all() and torch.isfinite(got_r).all())
    emit(phase="granular_solve", n_sample=mcfg.n_sample, n_sample_chunk=mcfg.n_sample_chunk,
         solves=n_solves, ms_per_solve=secs / n_solves * 1e3, k1_launches=launches,
         expected_k1_launches=per_solve * n_solves, rewards_finite=all_finite,
         best_rewards=[float(r["best_reward"]) for r in results],
         best_act_seq=results[-1]["act_seq"].cpu().tolist(),
         f32_chunk_max_abs_err=float(err.max()),
         f32_chunk_p99_abs_err=float(np.quantile(err, 0.99)),
         f32_chunk_reward_max_abs_diff=float((got_r - want_r).abs().max()),
         f32_tol="graded by repeat", ok=ok)
    if not ok:
        fail("the granular solve failed its checks (see the granular_solve line)")
    return launches, secs / n_solves * 1e3


# ---------------------------------------------------------------------------
# the Planner: MPPI on K1, gradient descent through K2/K3
# ---------------------------------------------------------------------------

def rope_task(rope, dev):
    """The rope solve's reward (the fixture's state moved by (0.5, 0, 0.3)
    as the target), its state on the card, physics 0.5, the action limits
    and the middle of the action box as the initial sequence."""
    from adaptigraph_tpu_torch.planning.closed_loop import make_reward_fn

    tcfg, params, state, _ = rope
    target = state + np.array([0.5, 0.0, 0.3], np.float32)
    lo, hi = (np.asarray(x, np.float32) for x in (tcfg.action_lower_lim, tcfg.action_upper_lim))
    act0 = np.tile((lo + hi) / 2, (tcfg.mcfg.n_look_ahead, 1))
    return (make_reward_fn(tcfg, target, dev), torch.tensor(state, device=dev),
            torch.tensor([0.5], device=dev), lo, hi, act0)


def phase_planner_mppi(rope, dev, n_iter=2):
    """The Planner's MPPI variant at the rope solve's width (fixture weights,
    N 101, 20,000 samples from its correlated sampler, ordered by repeat as
    the solve orders them, rolled out in chunks of 2,000 through
    ``dynamics_rollout_batched``, K1 in bf16, and scored per chunk), 2
    update iterations, ``rollout_best`` on: a warm-up, then a timed run with
    K1's launches counted from 0 (2 x 10 + 1). Its best reward is held to
    ``make_mppi_solver``'s on the same samples (its sampler patched to hand
    them over) with the same reward function, within the bf16 whole-push
    tolerance 0.05."""
    import dataclasses

    from adaptigraph_tpu_torch.ops.fused_gnn import fused_rollout_chunk, weight_list
    from adaptigraph_tpu_torch.planning import mppi_solve
    from adaptigraph_tpu_torch.planning.actions import sample_action_seq_correlated
    from adaptigraph_tpu_torch.planning.forward import dynamics_rollout_batched
    from adaptigraph_tpu_torch.planning.planner import Planner, PlannerConfig
    from adaptigraph_tpu_torch.utils.profiling import StageTimer

    tcfg, params = rope[:2]
    dcfg, mcfg = tcfg.dcfg, tcfg.mcfg
    reward_fn, state, phys, lo, hi, act0 = rope_task(rope, dev)
    cd, chunk = torch.bfloat16, mcfg.n_sample_chunk
    weights = weight_list(params, dcfg.gnn, cd)
    lower, upper = torch.tensor(lo, device=dev), torch.tensor(hi, device=dev)

    def rollout(s, act_seqs):
        return {"state_seqs": torch.cat([
            dynamics_rollout_batched(weights, s, act_seqs[i:i + chunk], phys, dcfg,
                                     compute_dtype=cd)["state_seqs"]
            for i in range(0, len(act_seqs), chunk)])}

    def evaluate(state_seqs, act_seqs, state_cur=None):
        return {"reward_seqs": torch.cat([reward_fn(state_seqs[i:i + chunk], act_seqs[i:i + chunk],
                                                    state_cur)
                                          for i in range(0, len(act_seqs), chunk)])}

    drawn = []

    def sample(generator, act_seq, iter_index=0):
        seqs = mppi_solve.sort_by_repeat(sample_action_seq_correlated(
            generator, act_seq, lower, upper, mcfg.n_sample, mcfg.noise_level), mcfg.push_length)
        drawn.append(seqs)
        return seqs

    planner = Planner(PlannerConfig(
        action_dim=4, model_rollout_fn=rollout, evaluate_traj_fn=evaluate,
        n_sample=mcfg.n_sample, n_look_ahead=mcfg.n_look_ahead, n_update_iter=n_iter,
        reward_weight=mcfg.reward_weight, action_lower_lim=lo, action_upper_lim=hi,
        sampling_action_seq_fn=sample, noise_level=mcfg.noise_level, device=dev))

    def run(seed):
        g = torch.Generator(device=dev)
        g.manual_seed(seed)
        return planner.trajectory_optimization(state, act0, g)

    run(0)  # warm-up
    drawn.clear()
    torch.cuda.synchronize()
    fused_rollout_chunk.launches = 0
    timer = StageTimer()
    with timer("planner_mppi"):
        res = run(1)
        torch.cuda.synchronize()
    secs = timer.stats()["planner_mppi"]["total_s"]
    launches = fused_rollout_chunk.launches
    want_launches = n_iter * (mcfg.n_sample // chunk) * mcfg.n_look_ahead + mcfg.n_look_ahead
    solve = mppi_solve.make_mppi_solver(dcfg, dataclasses.replace(mcfg, n_update_iter=n_iter),
                                        reward_fn, lo, hi, device=dev)
    given = iter(drawn)
    with mock.patch.object(mppi_solve, "sample_action_seq", lambda *a, **k: next(given)):
        sres = solve(params, state, act0, torch.Generator(device=dev), phys)
    diff = abs(float(res["best_reward"]) - float(sres["best_reward"]))
    best_state = res["best_model_output"]["state_seqs"]
    ok = (launches == want_launches and diff <= 0.05 and bool(torch.isfinite(best_state).all())
          and best_state.shape == (1, mcfg.n_look_ahead, dcfg.gnn.max_nobj, 3))
    emit(phase="planner_mppi", n_sample=mcfg.n_sample, chunk=chunk, n_update_iter=n_iter,
         compute_dtype="bfloat16", k1_launches=launches, k1_launches_expected=want_launches,
         ms_per_iteration=secs / n_iter * 1e3, seconds=secs,
         best_reward=float(res["best_reward"]), solver_best_reward=float(sres["best_reward"]),
         best_reward_abs_diff=diff, tol=0.05, best_act_seq=res["act_seq"].cpu().tolist(), ok=ok)
    if not ok:
        fail("the MPPI Planner failed its checks (see the planner_mppi line)")
    return launches, secs / n_iter * 1e3


GD_LR = 0.05  # Adam's step on the rope actions (x, z in [-4.5, 4.5], theta in radians)


def phase_planner_gd(rope, dev, n_sample=512, n_iter=10):
    """The Planner's gradient-descent variant through ``dynamics_rollout``
    (float32: per substep the graph build, K2 with its activations kept and,
    in the backward, K3), fixture weights, N 101, 512 correlated samples,
    one look-ahead step, 10 Adam steps (lr ``GD_LR``) on -mean(reward).
    Checks: the first iteration's gradient with respect to the actions
    within 5e-4 of its norm of the same gradient through the plain versions
    on the card (K3's float32 gate); per gradient iteration one K2 and one
    K3 launch per substep run (the samples' largest repeat, at most
    max_repeat: the length gets no gradient, so it stays), the final
    rollouts K2 only; the samples' mean reward after the iterations above
    their initial mean. Peak device memory and ms per iteration."""
    from adaptigraph_tpu_torch.ops.fused_gnn import gnn_forward
    from adaptigraph_tpu_torch.ops.fused_gnn_train import gnn_train_bwd
    from adaptigraph_tpu_torch.planning import planner as planner_mod
    from adaptigraph_tpu_torch.planning.actions import sample_action_seq_correlated
    from adaptigraph_tpu_torch.planning.forward import dynamics_rollout
    from adaptigraph_tpu_torch.planning.planner import Planner, PlannerConfig
    from adaptigraph_tpu_torch.utils.profiling import StageTimer

    tcfg, params = rope[:2]
    dcfg, mcfg = tcfg.dcfg, tcfg.mcfg
    reward_fn, state, phys, lo, hi, act0 = rope_task(rope, dev)
    g = torch.Generator(device=dev)
    g.manual_seed(3)
    samples = sample_action_seq_correlated(g, torch.tensor(act0, device=dev),
                                           torch.tensor(lo, device=dev),
                                           torch.tensor(hi, device=dev), n_sample,
                                           mcfg.noise_level)
    n_steps = min(int(samples[..., 3].max()), dcfg.max_repeat)
    means, records = [], []

    def evaluate(state_seqs, act_seqs, state_cur=None):
        r = reward_fn(state_seqs, act_seqs, state_cur)
        means.append(float(r.detach().mean()))
        return {"reward_seqs": r}

    real_adam = planner_mod.adam_step

    def spy(leaves, grads, opt_state, lr):  # after each iteration's backward
        records.append((grads[0].clone(), gnn_forward.launches, gnn_train_bwd.launches))
        return real_adam(leaves, grads, opt_state, lr)

    planner = Planner(PlannerConfig(
        action_dim=4, model_rollout_fn=lambda s, a: dynamics_rollout(params, s, a, phys, dcfg),
        evaluate_traj_fn=evaluate, n_sample=n_sample, n_look_ahead=1, n_update_iter=n_iter,
        reward_weight=mcfg.reward_weight, action_lower_lim=lo, action_upper_lim=hi,
        planner_type="GD", lr=GD_LR, sampling_action_seq_fn=lambda *a, **k: samples,
        device=dev))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    gnn_forward.launches = gnn_train_bwd.launches = 0
    timer = StageTimer()
    with timer("planner_gd"), mock.patch.object(planner_mod, "adam_step", spy):
        res = planner.trajectory_optimization(state, act0, g)
        torch.cuda.synchronize()
    secs = timer.stats()["planner_gd"]["total_s"]
    peak = torch.cuda.max_memory_allocated(dev)
    k2, k3 = gnn_forward.launches, gnn_train_bwd.launches
    marks = [(0, 0)] + [(a, b) for _, a, b in records]
    per_iter = [[a1 - a0, b1 - b0] for (a0, b0), (a1, b1) in zip(marks, marks[1:])]
    best_steps = min(int(res["act_seq"][0, 3]), dcfg.max_repeat)
    final = [k2 - marks[-1][0], k3 - marks[-1][1]]

    a = samples.clone().requires_grad_(True)
    with plain_kernels():
        out = dynamics_rollout(params, state, a, phys, dcfg)
        plain_grad, = torch.autograd.grad(-reward_fn(out["state_seqs"], a, state).mean(), a)
    grad_rel = rel_norm(records[0][0], plain_grad)
    ok = (grad_rel <= 5e-4 and per_iter == [[n_steps, n_steps]] * n_iter
          and final == [n_steps + best_steps, 0] and means[n_iter] > means[0]
          and np.isfinite(means).all())
    emit(phase="planner_gd", n_sample=n_sample, n_update_iter=n_iter, lr=GD_LR,
         compute_dtype="float32", substeps_per_rollout=n_steps,
         k2_k3_launches_per_iteration=per_iter, final_rollouts_k2_k3=final,
         k2_launches=k2, k3_launches=k3, first_grad_rel_to_plain=grad_rel, grad_tol=5e-4,
         mean_reward_initial=means[0], mean_reward_final=means[n_iter],
         best_reward=float(res["best_reward"]), peak_device_mb=peak / 2 ** 20,
         ms_per_iteration=secs / n_iter * 1e3, seconds=secs, ok=bool(ok))
    if not ok:
        fail("the gradient-descent Planner failed its checks (see the planner_gd line)")
    return (k2, k3), secs / n_iter * 1e3, peak


# ---------------------------------------------------------------------------
# softbody: generated, filtered, trained and rolled out at its published width
# ---------------------------------------------------------------------------

SOFTBODY_EPISODES = 12  # the data_gen config's 100, cut: 10 train and 2 valid episodes at 0.9/0.1
SOFTBODY_TRAIN_ARGS = ["--epochs", "2", "--iters", "100", "--batch_size", str(B_TRAIN),
                       "--steps_per_call", "10"]


def softbody_data():
    """Softbody episodes by the port's generator with the data_gen config's
    settings (5 pushes an episode, 5 spawned workers, seed 0; SOFTBODY_EPISODES
    episodes), flagged by its filter and preprocessed with the softbody
    dynamics config, the flagged pushes dropped, into TRAIN_DIR/softbody/prep.
    This is ``datagen --config softbody``, ``filter`` and ``preprocess
    --filter_file`` with the episodes held in memory (``sim.datagen.simulate``,
    ``sim.filter.flag_episodes``, ``preprocess_episodes``): the card's host
    has no h5py. Returns (prep dir, the data line's fields)."""
    from adaptigraph_tpu_torch.cli import _phys_specs
    from adaptigraph_tpu_torch.dynamics.preprocess import preprocess_episodes
    from adaptigraph_tpu_torch.sim.datagen import simulate
    from adaptigraph_tpu_torch.sim.filter import flag_episodes
    from adaptigraph_tpu_torch.utils.config import config_path, load_dynamics_config, load_yaml

    prep = os.path.join(TRAIN_DIR, "softbody", "prep")
    ds = load_yaml(config_path("softbody", "data_gen"))["dataset"]
    dc = load_dynamics_config("softbody")["dataset_config"]
    t0 = time.time()
    episodes = simulate(ds["obj"], SOFTBODY_EPISODES, n_pushes=ds["n_timestep"],
                        n_workers=ds["n_worker"], seed=ds["seed"])
    t1 = time.time()
    flagged = flag_episodes((f"{e:06d}", [p["positions"] for p in pushes])
                            for e, _, pushes, _ in episodes)
    t2 = time.time()
    n = preprocess_episodes([(props, pushes) for _, props, pushes, _ in episodes], prep,
                            np.asarray(dc["eef"]["pos"], np.float32), dc["n_his"], dc["n_future"],
                            dc["dist_thresh"], _phys_specs(load_dynamics_config("softbody")),
                            store_rest_state=dc["store_rest_state"], filter_actions=flagged)
    t3 = time.time()
    first = episodes[0][2][0]["positions"]
    fields = dict(episodes=len(episodes), bad_episodes=sum(bool(b) for *_, b in episodes),
                  pushes=sum(len(p) for _, _, p, _ in episodes),
                  flagged_pushes=sum(len(v) for v in flagged.values()),
                  preprocessed_episodes=n, particles=int(first.shape[1]),
                  pushes_per_episode=ds["n_timestep"], workers=ds["n_worker"], seed=ds["seed"],
                  datagen_seconds=t1 - t0, filter_seconds=t2 - t1, preprocess_seconds=t3 - t2)
    ok = (len(episodes) == SOFTBODY_EPISODES and n == len(episodes) and fields["pushes"] > 0
          and all(np.isfinite(p["positions"]).all() for _, _, ps, _ in episodes for p in ps))
    emit(phase="softbody_data", **fields, ok=bool(ok))
    if not ok:
        fail("softbody data generation failed (see the softbody_data line)")
    return prep, fields


def phase_softbody(dev):
    """Softbody, the widest configuration the JAX package trains, on the
    card at its published width (N 305: 300 objects + a 5-point pusher, 15
    slots, nf 128, pstep 4, n_his 5 with the rest frame pinned, ``non_fixed``,
    B 128): the data (``softbody_data``); K2 and K3 in float32 and bf16 on
    batches of it against their plain versions at the rope phases' gates
    (``phase_forward_kernel``, ``phase_backward_kernel``,
    ``phase_backward_kernel_bf16``; weights from ``init_params``); their
    times, bounds and shared memory (``train_kernel_times``); K 10 steps per
    call through the CUDA graph against the loop, bit for bit
    (``phase_train_steps``); ``train --config softbody`` through the CLI for
    200 steps (``--steps_per_call 10``) with its K2/K3 launches counted and
    the mean loss of its last 20 steps below its first 20's; and ``rollout
    --config softbody --all_episodes`` on the prep dir with the trained
    checkpoint, its K2 launches counted and each push's step-1 error within
    2e-4 of the evaluator through K2's plain version. Returns the numbers
    of the kernels line."""
    from adaptigraph_tpu_torch.cli import load_params, main
    from adaptigraph_tpu_torch.dynamics import rollout
    from adaptigraph_tpu_torch.models.gnn import init_params
    from adaptigraph_tpu_torch.ops.fused_gnn import gnn_forward
    from adaptigraph_tpu_torch.ops.fused_gnn_train import gnn_train_bwd
    from adaptigraph_tpu_torch.utils.config import load_dynamics_config
    from adaptigraph_tpu_torch.utils.metrics import read_metrics

    t_start = time.time()
    torch.cuda.empty_cache()
    prep, data = softbody_data()
    config = load_dynamics_config("softbody")
    gnn, edge, spec, _ = train_objects(config)
    batches = device_batches(config, prep, dev, 10, seed=13)
    params = init_params(torch.Generator(device=dev).manual_seed(0), gnn)

    def cases(cd):
        yield "softbody", step_inputs(batches[0], gnn, edge, params, cd), gnn

    k2_err = phase_forward_kernel(cases)
    k3_err = phase_backward_kernel(cases, dev, cascade_gates=False)["softbody"]
    k3_bf16_err = phase_backward_kernel_bf16(cases, dev, cascade_gates=False)["softbody"]
    times = train_kernel_times(config, batches, dev, R=5)
    emit(phase="train_kernel_time", data="softbody", **times)
    steps_launches = phase_train_steps(config, dev, parts=batches, data="softbody")

    # the CLI's train run: 3 + 3 kernels per step, 3 K2 per validation step
    out = os.path.join(TRAIN_DIR, "softbody_out")
    gnn_forward.launches = gnn_train_bwd.launches = 0
    t0 = time.time()
    _, curves, _, argv, losses = cli_train(prep, "softbody_out", config="softbody",
                                           args=SOFTBODY_TRAIN_ARGS)
    train_secs = time.time() - t0
    k2_train, k3_train = gnn_forward.launches, gnn_train_bwd.launches
    epochs = [m for m in read_metrics(os.path.join(out, "metrics.jsonl")) if m["tag"] == "epoch"]
    n_train, n_valid = len(losses), 10 * len(epochs)
    first20, last20 = float(np.mean(losses[:20])), float(np.mean(losses[-20:]))
    train_ok = bool(np.isfinite(losses).all() and last20 < first20 and n_train >= 200
                    and k3_train == 3 * n_train and k2_train == 3 * (n_train + n_valid))
    train_line = dict(argv=argv[1:], seconds=train_secs, train_steps=n_train,
                      valid_steps=n_valid, k2_launches=k2_train, k3_launches=k3_train,
                      first20_mean_loss=first20, last20_mean_loss=last20,
                      train_loss=curves["train"], valid_loss=curves["valid"],
                      ms_per_step_cli=epochs[-1]["train_seconds"] / epochs[-1]["train_steps"] * 1e3)

    # the rollout evaluator through the CLI on the trained checkpoint
    argv = ["rollout", "--config", "softbody", "--prep_dir", prep, "--out_dir", out,
            "--all_episodes"]
    torch.cuda.synchronize()
    gnn_forward.launches = 0
    t0 = time.time()
    stats, summary = main(argv)
    torch.cuda.synchronize()
    roll_secs = time.time() - t0
    k2_roll = gnn_forward.launches
    with plain_forward():
        plain = rollout.rollout_dataset(load_params(out, gnn, dev), spec, gnn, edge, prep,
                                        phase_ratio=(0.0, 1.0))
    got, want = stats["per_push"], plain["per_push"]
    step1 = max(abs(float(a[0]) - float(b[0])) for a, b in zip(got, want))
    med_rel = np.abs(stats["median"] - plain["median"]) / np.abs(plain["median"])
    roll_ok = bool(len(got) == len(want) == summary["n_pushes"] > 0 and step1 <= 2e-4
                   and np.isfinite(stats["median"]).all() and k2_roll > 0)
    roll_line = dict(argv=argv[1:], seconds=roll_secs, k2_launches=k2_roll,
                     n_pushes=summary["n_pushes"], steps=len(stats["median"]),
                     step1_max_abs_diff_vs_plain=step1, step1_tol=2e-4,
                     median_max_rel_diff_vs_plain=float(med_rel.max()), summary=summary)
    ok = train_ok and roll_ok
    emit(phase="softbody", B=B_TRAIN, N=gnn.n_nodes, Np=times["Np"], K=times["K"],
         nf=gnn.nf_particle, pstep=gnn.pstep, n_his=gnn.n_his, policy=edge.policy,
         data=data, real_edges_per_sample=times["k2"]["real_edges_per_sample"],
         smem_bytes_per_block=times["smem_bytes_per_block"],
         kernels={k: {f: times[k][f] for f in ("ms", "device_ms", "plain_ms", "bound_ms",
                                                "bound_by")} for k in ("k2", "k3", "k2_bf16",
                                                                       "k3_bf16")},
         step_ms=times["step_ms"], step_bf16_ms=times["step_bf16_ms"],
         plain_step_ms=times["plain_step_ms"], train=dict(train_line, ok=train_ok),
         rollout=dict(roll_line, ok=roll_ok), seconds=time.time() - t_start, ok=bool(ok))
    if not ok:
        fail("the softbody phase failed its checks (see the softbody line)")
    return dict(times=times, k2_err=k2_err[("softbody", "float32")],
                k2_bf16_err=k2_err[("softbody", "bfloat16")], k3_err=k3_err,
                k3_bf16_err=k3_bf16_err, k2_launches=k2_train + k2_roll + steps_launches[0],
                k3_launches=k3_train + steps_launches[1])


def main():
    t_start = time.time()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        raise SystemExit(2)
    sys.path.insert(0, ROOT)
    # the processes the script's children leave behind become its own, so
    # that stop_processes can end them and wait for them: PID 1 of a
    # container need not reap them (PR_SET_CHILD_SUBREAPER)
    ctypes.CDLL(None, use_errno=True).prctl(36, 1, 0, 0, 0)
    # the port and its fixtures must be here before anything is printed
    from adaptigraph_tpu_torch.ops import kernels  # noqa: F401

    if not os.path.isdir(os.path.join(ROOT, "fixtures", "rope_demo")):
        raise SystemExit("chip_smoke: fixtures/ not found beside the script")
    dev = torch.device("cuda", 0)
    # CUPTI stays attached between profiler sessions once the first one has
    # started (torch.profiler's own setting where CUDA graphs run: a CUPTI
    # torn down and attached again need not trace a graph made meanwhile)
    os.environ.setdefault("TEARDOWN_CUPTI", "0")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    emit(phase="device", card=card, torch=torch.__version__, cuda=torch.version.cuda,
         name=torch.cuda.get_device_name(0), count=torch.cuda.device_count())

    phase_build()
    if sys.argv[1:] == ["--softbody"]:
        phase_softbody(dev)
        print(card, flush=True)
        return
    rope, main_err = phase_kernels(dev)
    timing = time_kernel(rope, dev)
    emit(phase="kernel_time", **timing)
    launches = phase_solve(rope, dev)
    if sys.argv[1:] == ["--k1"]:
        print(card, flush=True)
        return
    phase_demo_ppo(dev)

    k2e_err = phase_edges_kernel(rope, material("granular", dev), dev)
    k2e_time = time_edges_kernel(rope, dev)
    emit(phase="edges_kernel_time", **k2e_time)
    k2e_launches = phase_substep_solve(rope, dev)
    k2_cloth_launches, cloth_step = phase_cloth_solve(dev)
    parts = phase_kernel_parts(dev)

    config, prep = phase_dataset()
    batches = device_batches(config, prep, dev, 9, seed=11)
    k2_err = phase_forward_kernel(lambda cd: input_cases(config, batches[0], dev, cd))
    k2_err = k2_err[("rope", "float32")]
    k3_err = phase_backward_kernel(lambda cd: input_cases(config, batches[1], dev, cd), dev)["rope"]
    k3_bf16_err = phase_backward_kernel_bf16(lambda cd: input_cases(config, batches[1], dev, cd),
                                             dev)["rope"]
    phase_train_step(config, batches[2], dev)
    ttime = time_train_kernels(config, batches, dev)
    phase_train_kernel_phases(config, dev)
    k2_steps_launches, k3_steps_launches = phase_train_steps(config, dev)
    k2_launches, k3_launches, losses, nudged_losses = phase_train(config, prep, dev)
    k2_bf16_launches, k3_bf16_launches = phase_train_bf16(prep, losses, nudged_losses)
    k2_rollout_launches, rollout_time = phase_rollout(config, prep, dev)
    k2_masked_launches, masked_ms, masked_err = phase_masked_tools(dev)
    k1_plan_launches, plan_ms_per_push, _ = phase_plan(dev)
    k1_granular_launches, granular_ms_per_solve = phase_granular_solve(dev)
    k1_planner_launches, mppi_ms_per_iter = phase_planner_mppi(rope, dev)
    (k2_gd_launches, k3_gd_launches), gd_ms_per_iter, _ = phase_planner_gd(rope, dev)
    sb = phase_softbody(dev)

    def row(name, source, replaces, n, err, t):
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": n, "max_abs_err": err, "ms": t["ms"], "plain_ms": t["plain_ms"],
                "bound_ms": t["bound_ms"], "bound_by": t["bound_by"], "library_ms": None}

    def softbody(kernel):  # the softbody phase's numbers for K2 ("k2") or K3 ("k3")
        out = {"launches_softbody": sb[f"{kernel}_launches"]}
        for suffix, key in (("", kernel), ("_bf16", f"{kernel}_bf16")):
            t = sb["times"][key]
            out.update({f"ms_softbody{suffix}": t["ms"], f"device_ms_softbody{suffix}": t["device_ms"],
                        f"plain_ms_softbody{suffix}": t["plain_ms"],
                        f"bound_ms_softbody{suffix}": t["bound_ms"],
                        f"bound_by_softbody{suffix}": t["bound_by"],
                        f"max_abs_err_softbody{suffix}": sb[f"{key}_err"]})
        return out

    emit(phase="wall", seconds=time.time() - t_start)
    emit(kernels=[
        dict(row("rollout_chunk", "adaptigraph_tpu_torch/csrc/rollout_chunk.cu",
                 "adaptigraph_tpu/ops/fused_gnn.py:479", launches, main_err, timing),
             device_ms=timing["device_ms"], launches_plan=k1_plan_launches,
             ms_per_push_plan=plan_ms_per_push, launches_granular_solve=k1_granular_launches,
             ms_per_solve_granular=granular_ms_per_solve,
             launches_planner_mppi=k1_planner_launches,
             ms_per_iteration_planner_mppi=mppi_ms_per_iter),
        dict(row("gnn_forward", "adaptigraph_tpu_torch/csrc/gnn_forward.cu",
                 "adaptigraph_tpu/ops/fused_gnn.py:214", k2_launches, k2_err, ttime["k2"]),
             device_ms=ttime["k2"]["device_ms"],
             launches_cloth_solve=k2_cloth_launches, ms_cloth_solve=cloth_step["k2_ms"],
             plain_ms_cloth_solve=cloth_step["k2_plain_ms"],
             bound_ms_cloth_solve=cloth_step["k2_bound_ms"],
             max_abs_err_cloth_solve=cloth_step["k2_bf16_max_abs_err"],
             launches_train_bf16=k2_bf16_launches, launches_train_steps=k2_steps_launches,
             launches_planner_gd=k2_gd_launches, ms_per_iteration_planner_gd=gd_ms_per_iter,
             launches_rollout=k2_rollout_launches, ms_rollout=rollout_time["k2_ms"],
             plain_ms_rollout=rollout_time["k2_plain_ms"],
             bound_ms_rollout=rollout_time["k2_bound_ms"],
             launches_masked_tools=k2_masked_launches,
             ms_per_substep_masked_tools=masked_ms, max_abs_err_masked_tools=masked_err,
             **softbody("k2")),
        dict(row("gnn_train_bwd", "adaptigraph_tpu_torch/csrc/gnn_train_bwd.cu",
                 "adaptigraph_tpu/ops/fused_gnn_train.py:76", k3_launches, k3_err, ttime["k3"]),
             device_ms=ttime["k3"]["device_ms"], device_ms_bf16=ttime["k3_bf16"]["device_ms"],
             ms_bf16=ttime["k3_bf16"]["ms"], plain_ms_bf16=ttime["k3_bf16"]["plain_ms"],
             bound_ms_bf16=ttime["k3_bf16"]["bound_ms"],
             bound_by_bf16=ttime["k3_bf16"]["bound_by"],
             bound_design_bf16=ttime["k3_bf16"]["bound_design"],
             bound_ms_present_design_bf16=ttime["k3_bf16"]["bound_ms_present_design"],
             max_abs_err_bf16=k3_bf16_err,
             launches_bf16=k3_bf16_launches, launches_train_steps=k3_steps_launches,
             launches_planner_gd=k3_gd_launches, **softbody("k3")),
        row("gnn_forward_edges", "adaptigraph_tpu_torch/csrc/gnn_forward.cu",
            "adaptigraph_tpu/ops/fused_gnn.py:115", k2e_launches, k2e_err, k2e_time),
        dict(row("kernel_parts", "adaptigraph_tpu_torch/csrc/gnn_forward.cu",
                 "scripts/profile_kernel_parts.py:43", parts["launches"], parts["max_abs_err"],
                 parts), variants=parts["variants"])])
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    try:
        main()
    finally:
        stop_processes()
