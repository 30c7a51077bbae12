"""Where the single-step forward with its in-kernel graph (K2e) spends its
time: the four variants of ``scripts/profile_kernel_parts.py`` (the JAX
profiling copy of the kernel, K4) at its shapes, each timed on the card::

    python -m adaptigraph_tpu_torch.profiling.kernel_parts            # CUDA card
    python -m adaptigraph_tpu_torch.profiling.kernel_parts --state_scale 0.05
    python -m adaptigraph_tpu_torch.profiling.kernel_parts --device cpu --batch 4

Variants (rope GNN: n_his 4, max_nobj 100, max_neef 1, nf 128, pstep 3; B
2000, topk 10, adjacency radius 0.5, bfloat16):

- ``full``: K2e itself (``csrc/gnn_forward.cu`` with ``nbr`` null);
- ``no_edge``: no distance work; every row i < Np gets the senders
  (i + k) mod Np, every slot real (the JAX ``noedge``);
- ``no_gather``: every sender's features are its receiver's, on the real
  graph's mask (the JAX ``nogather``);
- ``mlp_only``: both.

Each ablation is a profiling build of the same source (``ops/kernels.py``
variants ``no_edge``, ``no_gather``, ``mlp_only``); each variant has its plain
version (``fused_gnn.gnn_forward_edges_plain`` with ``ablate``). The inputs
are the JAX script's: states ``randn * 0.5`` and particle inputs ``[attrs |
0.5 | randn * 0.05]`` from ``numpy.random.RandomState(0)``; the weights come
from the port's ``init_params`` with a ``torch.Generator`` seeded 0. On the
card each variant prints its CUDA-event median ms; on the CPU, the plain
versions' wall time, which says nothing of the card.

Here a block computes only the real edges, so switching the graph off
changes the work: ``no_edge`` makes all K slots of all Np rows real
(1,040 edges per sample) where the JAX script's states give the real graph
~715. Its shares then mix the edge build with that extra work;
``--state_scale 0.05`` packs the states so that every row fills its K slots
(1,010 real edges), and the variants differ by the parts alone.

Where the JAX copy differs from K2e and this module follows K2e: the JAX copy
keeps the relation propagator's ``rp_w2`` / ``rp_w3`` apart (the same numbers
as K2e's fused ``(nf, 2 nf)`` product); it multiplies the messages by the
edge mask where K2e adds a -3e38 bias before the relu (the same result); and
it clips the motion at +-100, the default ``motion_clamp``. Its block of
``S = 4`` samples is a TPU block size with no counterpart here.
"""

import argparse
import json
import time

import numpy as np
import torch

from adaptigraph_tpu_torch.models.gnn import (GNNConfig, init_params, params_from_numpy,
                                               params_to_numpy)
from adaptigraph_tpu_torch.ops.fused_gnn import (gnn_forward_edges_plain, launch_forward,
                                                 round_up, weight_list)

GNN = GNNConfig(n_his=4, max_nobj=100, max_neef=1, nf_particle=128, nf_relation=128,
                nf_effect=128, pstep=3)
B = 2000
TOPK = 10
ADJ = 0.5
VARIANTS = ("full", "no_edge", "no_gather", "mlp_only")


def make_inputs(device, batch=B, compute_dtype=torch.bfloat16, cfg=GNN, state_scale=0.5):
    """The JAX script's inputs as the kernel takes them (states ``randn x
    state_scale``, 0.5 there): packed nodes ``[p_inputs | state_norm | attrs
    | g]`` (B, Np, D) in ``compute_dtype``, the newest frame (B, Np, 3)
    float32, and the 24 weights."""
    rng = np.random.RandomState(0)
    N, n_p, n_his = cfg.n_nodes, cfg.max_nobj, cfg.n_his
    Np = round_up(N, 8)
    state = rng.randn(batch, n_his, N, 3).astype(np.float32) * state_scale
    state_norm = np.concatenate([state[:, 1:] - state[:, :-1], state[:, -1:]], 1)
    state_norm = np.moveaxis(state_norm, 1, 2).reshape(batch, N, n_his * 3)
    attrs = np.zeros((batch, N, 2), np.float32)
    attrs[:, :n_p, 0] = 1.0
    attrs[:, n_p:, 1] = 1.0
    g = np.ones((batch, N, 1), np.float32)
    g[:, n_p:] = 0.0
    p_inputs = np.concatenate([attrs, np.full((batch, N, 1), 0.5, np.float32),
                               rng.randn(batch, N, 3).astype(np.float32) * 0.05], -1)
    nodes = np.concatenate([p_inputs, state_norm, attrs, g], -1)
    pad = [(0, 0), (0, Np - N), (0, 0)]
    nodes = torch.tensor(np.pad(nodes, pad), device=device).to(compute_dtype).contiguous()
    last = torch.tensor(np.pad(state[:, -1], pad), device=device).contiguous()
    params = params_to_numpy(init_params(torch.Generator().manual_seed(0), cfg))
    return nodes, last, weight_list(params_from_numpy(params, device), cfg, compute_dtype)


def variant_cuda(variant, nodes, last, weights, cfg=GNN, compute_dtype=torch.bfloat16, K=TOPK,
                 adj_radius=ADJ):
    """One launch of a variant's build on the current stream -> pred (B,
    max_nobj, 3)."""
    from adaptigraph_tpu_torch.ops import kernels

    lib = kernels.library(None if variant == "full" else variant)
    pred = launch_forward(lib, nodes, None, None, last, weights, cfg, compute_dtype, False, False,
                          K, adj_radius)[0]
    variant_cuda.launches[variant] += 1
    return pred


variant_cuda.launches = dict.fromkeys(VARIANTS, 0)


def variant_plain(variant, nodes, last, weights, cfg=GNN, compute_dtype=torch.bfloat16, K=TOPK,
                  adj_radius=ADJ):
    """A variant's plain version -> pred (B, max_nobj, 3)."""
    return gnn_forward_edges_plain(nodes, last, weights, cfg, compute_dtype, K, adj_radius,
                                   want_motion=False,
                                   ablate=None if variant == "full" else variant)[0]


def run_variant(variant, nodes, last, weights, **kw):
    """The variant's kernel on CUDA tensors, its plain version on CPU tensors."""
    if nodes.is_cuda:
        return variant_cuda(variant, nodes, last, weights, **kw)
    return variant_plain(variant, nodes, last, weights, **kw)


def shares(ms):
    """The parts of ``full``'s time that the ablations remove: the edge build
    (full - no_edge), the gather (full - no_gather) and what remains with
    both off (mlp_only), each over full."""
    return {"edge_build": (ms["full"] - ms["no_edge"]) / ms["full"],
            "gather": (ms["full"] - ms["no_gather"]) / ms["full"],
            "mlp": ms["mlp_only"] / ms["full"]}


def profile(device="cuda", batch=B, reps=7, state_scale=0.5):
    """Each variant's time per launch at the JAX script's shapes: on the card
    the median of ``reps`` CUDA-event timings after a warm-up launch
    (``ms``); on the CPU the plain versions' median wall time
    (``cpu_plain_ms``)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device is available (use --device cpu for the plain versions)")
    nodes, last, weights = make_inputs(device, batch, state_scale=state_scale)
    out = {}
    for v in VARIANTS:
        run_variant(v, nodes, last, weights)  # warm-up: the build and its load
        times = []
        for _ in range(reps):
            if device.type == "cuda":
                e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                e0.record()
                run_variant(v, nodes, last, weights)
                e1.record()
                e1.synchronize()
                times.append(e0.elapsed_time(e1))
            else:
                t0 = time.perf_counter()
                run_variant(v, nodes, last, weights)
                times.append((time.perf_counter() - t0) * 1e3)
        out[v] = float(np.median(times))
    return out


def main(argv=None):
    p = argparse.ArgumentParser(prog="python -m adaptigraph_tpu_torch.profiling.kernel_parts")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--batch", type=int, default=B)
    p.add_argument("--reps", type=int, default=7)
    p.add_argument("--state_scale", type=float, default=0.5,
                   help="states are randn x this (0.5: the JAX script's)")
    args = p.parse_args(argv)
    ms = profile(args.device, args.batch, args.reps, args.state_scale)
    key = "ms" if args.device != "cpu" else "cpu_plain_ms"
    for v in VARIANTS:
        print(json.dumps({"variant": v, "batch": args.batch, "state_scale": args.state_scale,
                          key: ms[v]}), flush=True)
    if args.device != "cpu":
        print(json.dumps({"device": torch.cuda.get_device_name(0), "shares": shares(ms)}),
              flush=True)
    return ms


if __name__ == "__main__":
    main()
