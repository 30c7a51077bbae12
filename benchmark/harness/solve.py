"""The solve cells: closed-loop MPPI solves, one at a time, as a robot that
waits on each solve before it pushes. Each solve runs the port's
``make_mppi_solver`` with ``make_reward_fn`` (``planning/mppi_solve.py``,
``planning/closed_loop.py``; on the card K1 per chunk), on a scene the
traffic generator made, and ends when its best action and the predicted
final state are on the host, as ``run_plan`` reads them.

``correct``: after the window, the reference (``reference/solve.py``) solves
again a sample of the window's solves from the same generator state, scene
and weights; compared are every sample's final state from the rollout (the
mean and a high quantile over the samples), every sample's reward (the
reference's reward of the program's own final states), and the returned
best action, reward and final state against the solve's own rewards
(``_numbers``).
"""

import gc
import time

import numpy as np
import torch

from harness import trace
from harness import traffic as gen
from reference import gnn as ref_gnn
from reference import solve as ref_solve
from work import k1 as k1_work

K1_KERNELS = ("rollout_chunk_kernel",)


class Recorder:
    """The reward function the solver gets: the scene's own reward, with
    each chunk's samples, final states and rewards kept (references, no
    copies) for the current solve."""

    def __init__(self, reward_fns):
        self.fns = reward_fns
        self.scene = 0
        self.chunks = []

    def __call__(self, state_seqs, act_seqs, state_cur):
        r = self.fns[self.scene](state_seqs, act_seqs, state_cur)
        self.chunks.append((act_seqs, state_seqs[:, -1], r))
        return r


def control_reward(target, task):
    """The reference's reward in bfloat16, a precision below the float32 the
    program scores in, in the place of the scene's reward function."""
    def reward_fn(state_seqs, act_seqs, state_cur):
        return ref_solve.reward(state_seqs[:, -1], act_seqs[:, 0], state_cur,
                                torch.as_tensor(target, device=state_seqs.device), task,
                                dtype=torch.bfloat16)

    return reward_fn


def control_rollout(params, m):
    """The reference's float8 rollout in the place of the port's
    ``fused_gnn.rollout_chunk``, on the chunk inputs it is given."""
    on_device = {}

    def rollout_chunk(pin, sa, repeat, valid, weights, cfg, K, adj_radius, max_repeat,
                      gripper_lift=0.0, mean_y=False, compute_dtype=torch.bfloat16):
        dev = sa.device
        if dev not in on_device:
            on_device[dev] = ref_gnn.tree_from_leaves(
                [t.to(dev) for t in ref_gnn.tree_leaves(params)])
        n_p, N = m["max_nobj"], m["n_nodes"]
        phys = pin[:, 0, 2:2 + m["phys_dim"]].float()
        with torch.no_grad():
            return ref_gnn.rollout(on_device[dev], m, sa[:, :n_p, :3], sa[:, n_p:N, :3],
                                   sa[:, n_p:N, 3:6], repeat, phys, adj_radius, max_repeat,
                                   ref_gnn.FP8)

    return rollout_chunk


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(run):
    from adaptigraph_tpu_torch.cli import _task_objects
    from adaptigraph_tpu_torch.ops import fused_gnn
    from adaptigraph_tpu_torch.planning import mppi_solve
    from adaptigraph_tpu_torch.planning.closed_loop import make_reward_fn

    cfg, tr = run.config, run.traffic
    m = ref_gnn.model_sizes(cfg["dynamics"])
    run.plant()
    task = dict(cfg["planning"], _dynamics_config=cfg["dynamics"])
    tcfg, _ = _task_objects(task)
    dev = run.device
    cd = getattr(torch, cfg["planning_compute_dtype"])

    params = run.weights(m, dev)
    rng = gen.host_rng(run.seed, 0)
    scenes = gen.solve_scenes(tr, m, run.root, rng)
    rec = Recorder([make_reward_fn(tcfg, target, dev) for _, target, _ in scenes])
    if run.control == "fp8":
        ref_task = ref_solve.task_settings(cfg["planning"], dev)
        rec.fns = [control_reward(target, ref_task) for _, target, _ in scenes]
        run.patch(fused_gnn, "rollout_chunk", control_rollout(params, m))
    solver = mppi_solve.make_mppi_solver(tcfg.dcfg, tcfg.mcfg, rec, tcfg.action_lower_lim,
                                         tcfg.action_upper_lim, device=dev, compute_dtype=cd)
    generator = torch.Generator(device=dev)
    generator.manual_seed(int(rng.integers(1 << 62)))
    mid = (tcfg.action_lower_lim + tcfg.action_upper_lim) / 2.0
    act_seq = torch.as_tensor(np.asarray(mid, np.float32), device=dev)[None].repeat(
        tcfg.mcfg.n_look_ahead, 1)

    def one(i):
        k = i % len(scenes)
        state, _, phys = scenes[k]
        rec.scene, rec.chunks = k, []
        gen_state = generator.get_state()
        with torch.profiler.record_function("bench.solve"):
            t0 = time.perf_counter()
            res = solver(params, state, act_seq, generator, phys)
            with torch.profiler.record_function("bench.best_to_host"):
                best = res["act_seq"].float().cpu().numpy()
                final = res["best_final_state"].float().cpu().numpy()
            t1 = time.perf_counter()
        return t1 - t0, {"scene": k, "gen_state": gen_state, "chunks": rec.chunks,
                         "best": best, "final": final, "best_reward": res["best_reward"]}

    for i in range(tr["warmup_solves"]):  # loads the kernels; the allocator's pools grow
        one(i)
    _sync(dev)
    run.setup_done()

    launches = fused_gnn.fused_rollout_chunk
    if run.trace:
        before = launches.launches
        n_traced = tr["trace_solves"]
        with trace.traced() as tw:
            for i in range(n_traced):
                one(i)
        summary = trace.reduce(tw["events"], 1)
        k1_s, k1_n = trace.kernel_time(summary, K1_KERNELS)
        run.layer.update(trace=summary, trace_window_s=tw["window_s"], trace_units=n_traced,
                         k1_device_s=k1_s, k1_records=k1_n,
                         k1_launches=launches.launches - before,
                         k1_busiest_s=trace.kernel_time_busiest(tw["events"], K1_KERNELS))

    check_at = int(rng.integers(tr["check_first"]))
    kept = {}
    latencies = []
    before = launches.launches
    _sync(dev)
    t0 = time.perf_counter()
    i = 0
    while i == 0 or time.perf_counter() - t0 < run.seconds:  # at least one solve
        dt, out = one(i)
        latencies.append(dt)
        if i == check_at:
            kept[i] = out
        last = out
        i += 1
    _sync(dev)
    window_s = time.perf_counter() - t0
    kept[i - 1] = last
    run.layer.update(window_s=window_s, latencies_s=latencies,
                     k1_window_launches=launches.launches - before, n_cards=1)
    run.attempted = len(latencies)
    run.e2e["solve_ms"] = window_s * 1e3 / len(latencies)
    run.e2e["solve_p95_ms"] = float(np.percentile(np.asarray(latencies) * 1e3, 95))
    run.read_memory([dev])

    del solver, rec, last, out
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    run.restore()
    compare(run, m, cfg, scenes, kept, dev, tcfg.mcfg.n_sample_chunk, params)


def _numbers(chunks, ref, out, dev, task, state, target):
    """The compared numbers of one solve (the program's sorted samples, final
    states and rewards, chunk by chunk, against the reference's samples and
    final states). ``state_err``: each sample's final state from the
    rollout against the reference's, as the mean particle distance, averaged
    over the samples; ``state_err_chunk``: the largest of its averages over
    one chunk's samples, so that a fault in one chunk's samples is not
    averaged away over the solve (both inf where the program's samples are
    not the reference's). ``reward_err``: the largest gap between a
    sample's reward and the reference's reward of that sample's final state
    from the program, chunk by chunk as the solve scores them.
    ``best_mismatch``: 0 where the solve returned the sample that its own
    rewards rank first, with that reward and that sample's final state, bit
    for bit; else 1 (an exact comparison)."""
    p_acts = torch.cat([a for a, _, _ in chunks])
    p_finals = torch.cat([f for _, f, _ in chunks])
    p_rewards = torch.cat([r for _, _, r in chunks])
    samples, finals = ref
    nums = dict.fromkeys(("state_err", "state_err_chunk"), float("inf"))
    if p_acts.shape == samples.shape and torch.equal(p_acts, samples):
        per = torch.linalg.norm(p_finals - finals, dim=-1).mean(dim=-1)
        chunk_means = [float(c.mean()) for c in per.split([len(a) for a, _, _ in chunks])]
        nums.update(state_err=float(per.mean()), state_err_chunk=max(chunk_means))
    r_rewards = torch.cat([ref_solve.reward(f, a, state, target, task) for a, f, _ in chunks])
    nums["reward_err"] = float((p_rewards - r_rewards).abs().max())
    j = int(torch.argmax(p_rewards))
    best = torch.as_tensor(out["best"], device=dev).reshape(-1)
    same = (torch.equal(best, p_acts[j]) and float(out["best_reward"]) == float(p_rewards[j])
            and torch.equal(torch.as_tensor(out["final"], device=dev), p_finals[j]))
    nums["best_mismatch"] = 0.0 if same else 1.0
    return nums


def compare(run, m, cfg, scenes, kept, dev, chunk, params):
    task = ref_solve.task_settings(cfg["planning"], dev)
    nums = []
    ops, nbytes = [], []
    for i, out in sorted(kept.items()):
        state, target, phys = scenes[out["scene"]]
        samples, finals, rewards, stats = ref_solve.solve(
            params, m, task, torch.as_tensor(state), torch.as_tensor(target),
            torch.as_tensor(phys), out["gen_state"], chunk, dev)
        for st in stats:
            o, b = k1_work.work(m, chunk, st["sample_steps"], st["edges"])
            ops.append(o)
            nbytes.append(b)
        chunks = [(a[:, 0].to(dev).float(), f.to(dev).float(), r.to(dev).float())
                  for a, f, r in out["chunks"]]
        nums.append(_numbers(chunks, (samples, finals), out, dev, task,
                             torch.as_tensor(state, device=dev).float(),
                             torch.as_tensor(target, device=dev).float()))
        del samples, finals, rewards
    run.layer.update(k1_ops_per_launch=float(np.mean(ops)),
                     k1_bytes_per_launch=float(np.mean(nbytes)))
    run.judge(nums)
