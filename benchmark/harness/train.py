"""The train cells: the trainer's step path without validation, checkpoints
or plots. ``dynamics/train.py::make_train_steps`` runs K optimizer steps a
call (on the card one step captured in a CUDA graph and replayed K times,
K2 forward and K3 backward in each of the ``n_future`` predictions), fed by
``DevicePrefetcher`` from an in-memory loader of the traffic generator's
compact batches.

Set-up builds the one step object, its parameter leaves and Adam state, and
drives it from the seed through its first three steps: one call of one step
(the eager step and the graph's capture), then one call of two. The window
runs the same object on. ``correct``: the reference (``reference/train.py``)
follows those three steps from the same weights, batches and generator
state; compared are the first step's loss, the first gradient as Adam got
it (its first moment after one step over 1 - b1, worst leaf) and the
parameters' change after the three (median leaf). It also follows one call
of the window, drawn from the seed among its first ``check_first``: from the
leaves, Adam state and generator state the program held before that call
(kept on the card, outside the program's use), through the call's K steps
on the call's batches; compared are the call's first (replayed) step's
loss, the gradients that Adam gathered over the call (its first moment's
gain; worst leaf, or the median leaf where ``checks/`` says so) and the
parameters' change over the call (median leaf).
"""

import gc
import itertools
import time

import numpy as np
import torch

from harness import trace
from harness import traffic as gen
from reference import gnn as ref_gnn
from reference import train as ref_train
from work import gnn_step, k2 as k2_work, k3 as k3_work, peaks

K2_KERNELS = ("gnn_forward_kernel",)
K3_KERNELS = ("gnn_train_bwd_kernel", "sum_samples_kernel")  # the backward and its gradient sum
FIRST_STEPS = 3
GRAD_FLOOR = 1e-3  # leaves whose reference gradient is under this share of the median leaf's


def train_settings(dynamics):
    """What the reference reads of the dynamics configuration."""
    dc = dynamics["dataset_config"]
    ds = dc["datasets"][0]
    rand = dc.get("randomness", {})
    policy = ("non_fixed" if ds.get("connect_tool_all_non_fixed")
              else "tools_all" if ds.get("connect_tool_all") else "none")
    return {"policy": policy, "n_future": dc["n_future"],
            "store_rest_state": dc.get("store_rest_state", False),
            "lr": float(dynamics["train_config"].get("lr", 1e-3)),
            "use_augmentation": rand.get("use", True),
            "state_noise": rand.get("state_noise", {}).get("train", 0.05),
            "phys_noise": rand.get("phys_noise", {}).get("train", 0.0)}


def control_forward(m):
    """The reference's step in the place of the port's fused forward; run
    with TF32 on, the control's precision."""
    def forward(params, state, action, physics, attrs, p_instance, neighbors, nbr_mask):
        return ref_gnn.step_forward(params, m, state, action, physics, attrs, p_instance,
                                    neighbors, nbr_mask)

    return forward


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(run):
    from adaptigraph_tpu_torch.cli import _dyn_objects, _train_objects
    from adaptigraph_tpu_torch.dynamics import train as ptrain
    from adaptigraph_tpu_torch.ops import fused_gnn, fused_gnn_train
    from adaptigraph_tpu_torch.utils import checkpoint as ckpt

    dyn, tr = run.config["dynamics"], run.traffic
    m = ref_gnn.model_sizes(dyn)
    run.plant()
    gnn_cfg, edge_cfg = _dyn_objects(dyn)
    _, hyper = _train_objects(dyn)
    B, K = tr["batch"], tr["steps_per_call"]
    if hyper.batch_size != B:
        raise ValueError(f"the traffic's batch {B} is not the configuration's {hyper.batch_size}")
    dev = run.device
    params = run.weights(m, dev)
    leaves = [p.detach().clone().requires_grad_(True) for p in ckpt.tree_leaves(params)]
    opt = ptrain.adam_init(leaves)
    fused_fn = None
    if run.control == "tf32":
        fused_fn = control_forward(m)
        torch.backends.cuda.matmul.allow_tf32 = True
    steps = ptrain.make_train_steps(gnn_cfg, edge_cfg, hyper, fused_fn=fused_fn)

    rng = gen.host_rng(run.seed, 1)
    first = [gen.train_rows(tr, m, dyn, run.root, rng, B) for _ in range(FIRST_STEPS)]
    pool = [gen.stack([gen.train_rows(tr, m, dyn, run.root, rng, B) for _ in range(K)])
            for _ in range(tr["pool"])]
    loader = itertools.chain([gen.stack(first[:1]), gen.stack(first[1:])], itertools.cycle(pool))
    generator = torch.Generator(device=dev)
    generator.manual_seed(int(rng.integers(1 << 62)))
    gen_state = generator.get_state()
    check_at = int(rng.integers(tr["check_first"]))  # the window's call that is compared
    calls = 0  # the pool's calls run so far: call n reads pool[n % len(pool)]
    prefetch = ptrain.DevicePrefetcher(loader, dev)
    try:
        losses = [steps(leaves, opt, next(prefetch), generator)]
        grad1 = [mu.detach().clone() / 0.1 for mu in opt["mu"]]  # mu = (1 - b1) g after one step
        losses.append(steps(leaves, opt, next(prefetch), generator))
        after = [p.detach().clone() for p in leaves]
        first_losses = torch.cat(losses).tolist()
        _sync(dev)
        run.setup_done()

        k2, k3 = fused_gnn.gnn_forward, fused_gnn_train.gnn_train_bwd
        if run.trace:
            before = (k2.launches, k3.launches)
            n_calls = tr["trace_calls"]
            with trace.traced() as tw:
                for _ in range(n_calls):
                    with torch.profiler.record_function("bench.steps"):
                        steps(leaves, opt, next(prefetch), generator)
            calls += n_calls
            summary = trace.reduce(tw["events"], 1)
            k2_s, k2_n = trace.kernel_time(summary, K2_KERNELS)
            k3_s, _ = trace.kernel_time(summary, K3_KERNELS)
            _, k3_n = trace.kernel_time(summary, K3_KERNELS[:1])
            run.layer.update(trace=summary, trace_window_s=tw["window_s"],
                             trace_units=n_calls * K, k2_device_s=k2_s, k2_records=k2_n,
                             k2_launches=k2.launches - before[0], k3_device_s=k3_s,
                             k3_records=k3_n, k3_launches=k3.launches - before[1])

        outs = []
        _sync(dev)
        t0 = time.perf_counter()
        # at least as far as the compared call
        while len(outs) <= check_at or time.perf_counter() - t0 < run.seconds:
            if len(outs) == check_at:
                held = {"batch": pool[(calls + check_at) % len(pool)],
                        "before": _held(leaves, opt), "gen_state": generator.get_state()}
            with torch.profiler.record_function("bench.steps"):
                outs.append(steps(leaves, opt, next(prefetch), generator))
            if len(outs) == check_at + 1:
                held["after"] = _held(leaves, opt)
        _sync(dev)
        window_s = time.perf_counter() - t0
    finally:
        prefetch.close()
    n_steps = len(outs) * K
    run.attempted = n_steps
    run.failed = int((~torch.isfinite(torch.cat(outs))).sum())
    held["losses"] = outs[check_at].tolist()
    run.e2e["train_step_ms"] = window_s * 1e3 / n_steps
    run.layer.update(window_s=window_s, steps=n_steps)
    run.read_memory([dev])

    del steps, opt, outs, leaves, prefetch
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    torch.backends.cuda.matmul.allow_tf32 = False
    run.restore()
    compare(run, m, dyn, params, first, gen_state, first_losses, grad1, after, held, dev,
            edge_cfg.topk + edge_cfg.max_neef)


def _held(leaves, opt):
    """Copies of the leaves and the Adam state, on their device."""
    return {"leaves": [p.detach().clone() for p in leaves],
            "mu": [t.detach().clone() for t in opt["mu"]],
            "nu": [t.detach().clone() for t in opt["nu"]],
            "count": opt["count"].detach().clone()}


def _leaf_gaps(prog, ref, include):
    """Each leaf's gap of norms, |norm(prog) - norm(ref)|, over the larger of
    the reference leaf's norm and the median included leaf's; 0 for a leaf
    not included."""
    p = torch.stack([torch.linalg.norm(t.double()) for t in prog])
    r = torch.stack([torch.linalg.norm(t.double()) for t in ref])
    floor = torch.median(r[include])
    return torch.where(include, (p - r).abs() / torch.maximum(r, floor), 0.0)


def _call_numbers(m, train, held, dev):
    """The compared numbers of the window's held call: the reference follows
    its K steps from the state the program held before it."""
    before, after = held["before"], held["after"]
    K = len(held["losses"])
    superbatch = {k: torch.as_tensor(v, device=dev) for k, v in held["batch"].items()}
    batches = [{k: v[i] for k, v in superbatch.items()} for i in range(K)]
    adam = {"count": int(before["count"]), "mu": before["mu"], "nu": before["nu"]}
    losses, _, leaves, _, mu = ref_train.steps(
        ref_gnn.tree_from_leaves(before["leaves"]), m, train, batches, held["gen_state"], dev,
        adam=adam)
    b1k = ref_train.B1 ** K
    p_gain = [a - b1k * b for a, b in zip(after["mu"], before["mu"])]
    r_gain = [a - b1k * b for a, b in zip(mu, before["mu"])]
    g_norms = torch.stack([torch.linalg.norm(g.double()) for g in r_gain])
    moved = g_norms >= GRAD_FLOOR * torch.median(g_norms)
    grad_gaps = _leaf_gaps(p_gain, r_gain, torch.ones_like(moved))
    update_gaps = _leaf_gaps([a - b for a, b in zip(after["leaves"], before["leaves"])],
                             [a - b for a, b in zip(leaves, before["leaves"])], moved)
    loss_gaps = [abs(p - r) / abs(r) for p, r in zip(held["losses"], losses)]
    # the worst leaf's gain swings with the later steps' drift on some
    # cells; its median leaf is the steady reading (checks/ picks per cell)
    return ({"call_loss_gap": loss_gaps[0], "call_grad_gap": float(grad_gaps.max()),
             "call_grad_gap_median": float(torch.median(grad_gaps[moved])),
             "call_update_gap": float(torch.median(update_gaps[moved]))},
            {"call_loss_gaps": loss_gaps, "call_grad_gaps": grad_gaps.tolist(),
             "call_update_gaps": update_gaps.tolist()})


def compare(run, m, dyn, params, first, gen_state, first_losses, grad1, after, held, dev,
            slots):
    train = train_settings(dyn)
    batches = [{k: torch.as_tensor(v, device=dev) for k, v in b.items()} for b in first]
    losses, grads, leaves, edges, _ = ref_train.steps(params, m, train, batches, gen_state, dev)
    start = ref_gnn.tree_leaves(params)
    g_norms = torch.stack([torch.linalg.norm(g.double()) for g in grads])
    moved = g_norms >= GRAD_FLOOR * torch.median(g_norms)
    everyone = torch.ones_like(moved)
    grad_gaps = _leaf_gaps([g.to(dev) for g in grad1], grads, everyone)
    update_gaps = _leaf_gaps([a.to(dev) - s for a, s in zip(after, start)],
                             [l - s for l, s in zip(leaves, start)], moved)
    loss_gaps = [abs(p - r) / abs(r) for p, r in zip(first_losses, losses)]
    # each step's loss and the worst leaf's change swing with the elements
    # whose first gradient is at rounding level, which Adam moves by +-lr
    # either way; the first step's loss and the median leaf's change do not
    numbers = {"first_loss_gap": loss_gaps[0], "grad_gap": float(grad_gaps.max()),
               "update_gap": float(torch.median(update_gaps[moved]))}
    run.layer["leaf_gaps"] = {name: [float(g), float(u), float(n)] for name, g, u, n in
                              zip(ref_gnn.leaf_names(), grad_gaps, update_gaps, g_norms)}
    run.layer["loss_gaps"] = loss_gaps
    call, readings = _call_numbers(m, train, held, dev)
    numbers.update(call)
    run.layer.update(readings)
    B = first[0]["state"].shape[0]
    e = float(np.mean(edges))
    ops2, bytes2 = k2_work.work(m, B, e * B, slots)
    ops3, bytes3 = k3_work.work(m, B, e * B, slots)
    run.layer.update(edges_per_sample=e, k2_ops=ops2, k2_bytes=bytes2, k3_ops=ops3,
                     k3_bytes=bytes3, leaves_compared=int(moved.sum()),
                     step_model_flops=train["n_future"] * 3 * gnn_step.forward_ops(m, B, e * B),
                     train_peak_flops=peaks.F32_SPLIT_TF32_FLOPS)
    run.judge([numbers])
