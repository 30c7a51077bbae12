"""Drive the PyTorch port on one CUDA card and check it.

    python3 chip_smoke.py    # needs one CUDA card

Phases, each printing JSON lines; any failure exits non-zero:
  0. card name and power limit, torch and CUDA versions; TF32 off.
  1. build the CUDA kernels from the sources in this checkout (timed).
  2. the rollout kernel against its plain PyTorch version on the card, on the
     same inputs, in f32 and bf16 each (see ``phase_kernels``): rope width
     (fixture weights, B 2000) and granular width (5-point board, K 20), each
     in min-y and masked mean-y mode with per-sample masks and physics (B
     512); then the kernel's time and, from its profiling build, its cycles
     per phase.
  3. the main path: the rope MPPI solve of 20,000 samples in chunks of 2,000,
     one warm-up and three timed solves, with the kernel's launch count read
     around the timed solves.
  4. ``demo-ppo`` through the port's CLI on the rope and granular fixtures,
     and the error curve it minimises, through the kernel and the plain
     version.
The last lines are the kernel table, the card line, and the ok line.
"""

import json
import os
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
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}  # H100 SXM dense
PEAK_BYTES = 3.35e12


def emit(**kw):
    print(json.dumps(kw), flush=True)


def fail(msg, **kw):
    emit(phase="error", error=msg, **kw)
    raise SystemExit(1)


def card_line():
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


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
    FLOPs of the particle encoder once per sample, the node-level products per
    substep a sample runs, and the relation MLP per real edge; every input
    read once and the output written once."""
    N, n_p, nf = gnn.n_nodes, gnn.max_nobj, gnn.nf_effect
    nfp, nfr, rin, Dp = gnn.nf_particle, gnn.nf_relation, gnn.relation_input_dim, pin.shape[-1]
    per_sample = 2 * N * (Dp * nfp + nfp * nfp + nfp * nf) + 2 * N * nf * nf
    per_step = gnn.pstep * (2 * N * nf * 2 * nf + 2 * N * nf * nf) + 2 * n_p * (2 * nf * nf + 3 * nf)
    per_edge = 2 * (rin * nfr + nfr * nfr + nfr * nf + nf * nf)
    ops = B * per_sample + stats["sample_steps"] * per_step + stats["edges"] * per_edge
    nbytes = sum(t.numel() * t.element_size() for t in [pin, sa, out] + list(weights))
    nbytes += B * 4 + pin.shape[0] * pin.shape[1] * 4  # repeat, valid
    return ops, nbytes


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_build():
    """Build the kernels and, at the same time, their profiling build (the
    per-phase SM-cycle counters of ``kernel_phases``)."""
    from concurrent.futures import ThreadPoolExecutor

    from adaptigraph_tpu_torch.ops import kernels

    t0 = time.time()
    with ThreadPoolExecutor(2) as pool:
        path, _ = pool.map(kernels.build, (False, True))
    kernels.library()
    with open(path + ".ptxas.txt") as f:
        ptxas = [ln.strip() for ln in f if "registers" in ln or "spill" in ln]
    emit(phase="build", seconds=round(time.time() - t0, 2), library=os.path.relpath(path, ROOT),
         ptxas=ptxas)


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
    (rope, B 2000, bf16), each repetition on fresh actions; and the bound."""
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
    plain_ms = median_ms(rollout_chunk_plain, inputs, 5)
    stats = {}
    pin, sa = inputs(100)[:2]
    out = rollout_chunk_plain(*inputs(100), stats=stats)
    ops, nbytes = k1_work(gnn, pin, sa, weights, out, stats, B_CHUNK)
    t_ops, t_bytes = ops / PEAK_FLOPS[cd] * 1e3, nbytes / PEAK_BYTES * 1e3
    # where a block's time goes: SM cycles per phase, summed over the blocks,
    # from one launch of the profiling build
    clocks = torch.zeros(B_CHUNK, len(PHASES), dtype=torch.int64, device=dev)
    prof = kernels.library(phase_clocks=True)
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
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes",
                gflop_per_launch=ops / 1e9, edges_per_sample_step=stats["edges"] / stats["sample_steps"])


def phase_solve(rope, dev):
    from adaptigraph_tpu_torch.ops.fused_gnn import fused_rollout_chunk, rollout_chunk_plain
    from adaptigraph_tpu_torch.ops.fused_gnn import chunk_inputs, weight_list
    from adaptigraph_tpu_torch.planning.actions import decode_action
    from adaptigraph_tpu_torch.planning.closed_loop import make_reward_fn
    from adaptigraph_tpu_torch.planning.forward import pusher_keypoints
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
    best = res["act_seq"][None]
    decoded, repeat = decode_action(best, dcfg.push_length)
    obj = torch.tensor(state, device=dev)[None]
    kp, delta = pusher_keypoints(dcfg, decoded[:, 0], best[:, 0, 2], obj[..., 1].amin(1))
    cd = torch.bfloat16
    ref = rollout_chunk_plain(*chunk_inputs(obj, kp, delta, repeat[:, 0], torch.tensor(phys, device=dev),
                                            dcfg.gnn, cd),
                              weight_list(params, dcfg.gnn, cd), dcfg.gnn, dcfg.edge.topk,
                              dcfg.adj_thresh, dcfg.max_repeat, dcfg.gripper_lift, False, cd)[0]
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


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        raise SystemExit(2)
    sys.path.insert(0, ROOT)
    # the port and its fixtures must be here before anything is printed
    from adaptigraph_tpu_torch.ops import kernels  # noqa: F401

    if not os.path.isdir(os.path.join(ROOT, "fixtures", "rope_demo")):
        raise SystemExit("chip_smoke: fixtures/ not found beside the script")
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    emit(phase="device", card=card, torch=torch.__version__, cuda=torch.version.cuda,
         name=torch.cuda.get_device_name(0), count=torch.cuda.device_count())

    phase_build()
    rope, main_err = phase_kernels(dev)
    timing = time_kernel(rope, dev)
    emit(phase="kernel_time", **timing)
    launches = phase_solve(rope, dev)
    phase_demo_ppo(dev)
    emit(kernels=[{
        "name": "rollout_chunk", "route": "cuda",
        "source": "adaptigraph_tpu_torch/csrc/rollout_chunk.cu",
        "replaces": "adaptigraph_tpu/ops/fused_gnn.py:479",
        "launches": launches, "max_abs_err": main_err,
        "ms": timing["ms"], "plain_ms": timing["plain_ms"], "bound_ms": timing["bound_ms"],
        "bound_by": timing["bound_by"], "library_ms": None}])
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
