"""Whether two checkouts of the port compute the same kernel outputs on the
same inputs, bit for bit but for K3's weight gradients:

- K1: one look-ahead step of B 2000 pushes through
  ``dynamics_rollout_batched`` (its whole-push branch), rope and granular
  width, fixture weights and state, float32 and bfloat16;
- K2: one step with prebuilt edges at B 128, float32 and bfloat16, at rope
  width (fixture weights and state) and softbody width (N 305, weights
  from ``init_params``, a seeded particle cloud), the activations it keeps
  for training included (the edge buffers on the rows K2 writes, a sample's
  real edges: the rest of each buffer is never written and holds whatever
  the allocator left there), and the same step as a forward alone (no
  activations kept: bf16 then skips the redos);
- K2e: the same rope step with the graph built in the kernel;
- K3: on K2's activations and a seeded motion gradient, both dtypes and
  widths: the node cotangents bit for bit; each weight gradient within
  ``GRAD_TOL`` of the other checkout's relative to its norm (float32 5e-4,
  bf16 1e-5: ``chip_smoke.py``'s gates against the plain backward), since
  K3 sums a gradient's rows batch-wide, in another order than per sample.

Each checkout runs in a subprocess with its own root first on ``sys.path``
and builds its kernels into its own ``build/torch_kernels/``. The inputs are
made in each subprocess from seeds with numpy and the checkout's fixtures,
and are compared too. Only entry points that both checkouts share are used.
Needs a CUDA card::

    python3 adaptigraph_tpu_torch/profiling/same_outputs.py OLD_ROOT NEW_ROOT

prints one JSON line per tensor (``equal`` and the largest difference; for a
weight gradient its relative distance and whether it is within tolerance),
then one with the verdict per kernel (``kernels``: K1, K2, K2e, K3's node
cotangents, ``k3_grads`` its weight gradients), and exits 1 if any differs.
"""

import json
import os
import subprocess
import sys
import tempfile

# K3's weight gradients, relative to their norm: chip_smoke.py's gates against
# the plain backward (float32, and BF16_ROUNDING_TOL)
GRAD_TOL = {"float32": 5e-4, "bfloat16": 1e-5}


def worker(root, out):
    sys.path.insert(0, root)
    import numpy as np
    import torch

    from adaptigraph_tpu_torch.cli import _dyn_objects, _task_objects, load_params
    from adaptigraph_tpu_torch.models.gnn import init_params
    from adaptigraph_tpu_torch.ops import kernels
    from adaptigraph_tpu_torch.ops.fused_gnn import (act_layout, gnn_forward_cuda,
                                                     gnn_forward_edges_cuda, pack_inputs,
                                                     round_up, weight_list)
    from adaptigraph_tpu_torch.ops.fused_gnn_train import gnn_train_bwd_cuda
    from adaptigraph_tpu_torch.ops.graph import build_neighbor_graph_batch
    from adaptigraph_tpu_torch.planning.actions import decode_action
    from adaptigraph_tpu_torch.planning.forward import dynamics_rollout_batched, pusher_keypoints
    from adaptigraph_tpu_torch.utils.config import load_dynamics_config, load_planning_config

    dev = torch.device("cuda", 0)
    res = {}

    def material(name):
        tcfg, _ = _task_objects(load_planning_config(name))
        fixture = os.path.join(root, "fixtures", f"{name}_demo")
        params = load_params(fixture, tcfg.dcfg.gnn, dev)
        with np.load(os.path.join(fixture, "interaction_000.npz")) as z:
            state = z["state_init"].astype(np.float32)
        M = tcfg.dcfg.gnn.max_nobj
        idx = np.random.RandomState(0).choice(len(state), M, replace=len(state) < M)
        return tcfg, params, state[idx]

    for name in ("rope", "granular"):
        tcfg, params, state = material(name)
        rng = np.random.RandomState(1)
        acts = rng.uniform(tcfg.action_lower_lim, tcfg.action_upper_lim,
                           (2000, 1, 4)).astype(np.float32)
        res[f"in:{name}_acts"] = torch.tensor(acts)
        res[f"in:{name}_state"] = torch.tensor(state)
        for cd in (torch.float32, torch.bfloat16):
            seqs = dynamics_rollout_batched(params, torch.tensor(state, device=dev),
                                            torch.tensor(acts, device=dev),
                                            torch.tensor([0.5], device=dev), tcfg.dcfg,
                                            compute_dtype=cd)["state_seqs"]
            res[f"k1:{name}:{str(cd)[6:]}"] = seqs.cpu()

    def k2_k3(name, gnn, params, hist, action, nbrs, mask, K, adj_radius=None):
        """K2 (activations kept, and alone), K3 on K2's activations and, with
        adj_radius, K2e: float32 and bfloat16."""
        B, N, n_p = hist.shape[0], gnn.n_nodes, gnn.max_nobj
        is_tool = torch.arange(N, device=dev) >= n_p
        attrs = torch.stack([~is_tool, is_tool], -1).float().expand(B, N, 2)
        p_inst = torch.ones(B, n_p, gnn.n_instance, device=dev)
        phys = torch.full((B, gnn.phys_dim), 0.5, device=dev)
        layout = act_layout(kernels.library(), gnn, K)[1]
        dmot = torch.tensor(np.random.RandomState(3).randn(B, round_up(N, 8), 3)
                            .astype(np.float32), device=dev)
        dmot[:, n_p:] = 0
        for cd in (torch.float32, torch.bfloat16):
            nodes, nbr, msk, last, _ = pack_inputs(gnn, hist, action, phys, attrs, p_inst, nbrs,
                                                   mask, K, cd)
            w = weight_list(params, gnn, cd)
            pred, mot, acts = gnn_forward_cuda(nodes, nbr, msk, last, w, gnn, cd)
            tag = f"{name}:{str(cd)[6:]}"
            real = (msk.view(B, -1) > 0).sum(1).tolist()  # real edges per sample
            edge_acts = acts[1].view(B, -1)
            written = [edge_acts[b, off + s * rows * width:off + (s + 1) * rows * width]
                       .view(rows, width)[:real[b]].reshape(-1)
                       for _, off, slots, rows, width in layout for s in range(slots)
                       for b in range(B)]
            res.update({f"k2:{tag}:pred": pred.cpu(), f"k2:{tag}:motion": mot.cpu(),
                        f"k2:{tag}:acts_node": acts[0].cpu(),
                        f"k2:{tag}:acts_edge": torch.cat(written).cpu()})
            alone = gnn_forward_cuda(nodes, nbr, msk, last, w, gnn, cd, keep_acts=False)
            res.update({f"k2:{tag}:alone_pred": alone[0].cpu(),
                        f"k2:{tag}:alone_motion": alone[1].cpu()})
            if adj_radius is not None:
                pred_e, mot_e = gnn_forward_edges_cuda(nodes, last, w, gnn, cd, K, adj_radius)
                res.update({f"k2e:{tag}:pred": pred_e.cpu(), f"k2e:{tag}:motion": mot_e.cpu()})
            dnodes, grads = gnn_train_bwd_cuda(nodes, nbr, msk, dmot, w, gnn, acts, cd)
            res[f"k3:{tag}:dnodes"] = dnodes.cpu()
            res.update({f"k3:{tag}:grad{i}": g.cpu() for i, g in enumerate(grads)})

    # rope width, fixture weights and state (B 128)
    tcfg, params, state = material("rope")
    dcfg = tcfg.dcfg
    gnn, edge = dcfg.gnn, dcfg.edge
    B, n_p, N, n_his = 128, gnn.max_nobj, gnn.n_nodes, gnn.n_his
    rng = np.random.RandomState(2)
    act = torch.tensor(rng.uniform(tcfg.action_lower_lim, tcfg.action_upper_lim,
                                   (B, 4)).astype(np.float32), device=dev)
    decoded, _ = decode_action(act, dcfg.push_length)
    obj = torch.tensor(state + rng.randn(B, n_his, n_p, 3).astype(np.float32) * 0.005, device=dev)
    kp, delta = pusher_keypoints(dcfg, decoded, act[:, 2], obj[:, -1, :, 1].amin(1))
    hist = torch.cat([obj, kp[:, None].expand(B, n_his, N - n_p, 3)], dim=2).contiguous()
    is_tool = torch.arange(N, device=dev) >= n_p
    nbrs, mask = build_neighbor_graph_batch(hist[:, -1], torch.ones(B, N, dtype=torch.bool,
                                                                     device=dev),
                                            is_tool.expand(B, N), dcfg.adj_thresh, edge)
    action = torch.cat([torch.zeros(B, n_p, 3, device=dev), delta], dim=1)
    res["in:k2_state"] = hist.cpu()
    k2_k3("rope", gnn, params, hist, action, nbrs, mask, edge.topk + edge.max_neef,
          dcfg.adj_thresh)

    # softbody width (N 305: 300 particles and a 5-point pusher, 15 slots),
    # weights from init_params, particles spread at ~10 neighbours each (B 128)
    gnn, edge = _dyn_objects(load_dynamics_config("softbody"))
    params = init_params(torch.Generator(device=dev).manual_seed(0), gnn)
    n_p, N, n_his = gnn.max_nobj, gnn.n_nodes, gnn.n_his
    rng = np.random.RandomState(4)
    cloud = rng.uniform(0.0, 2.4, (n_p, 3)).astype(np.float32)
    pusher = np.stack([np.linspace(-0.5, 0.5, N - n_p), np.full(N - n_p, -0.3),
                       np.full(N - n_p, 1.2)], -1).astype(np.float32) + [1.2, 0.0, 0.0]
    frames = np.concatenate([np.broadcast_to(cloud, (B, n_his, n_p, 3)),
                             np.broadcast_to(pusher, (B, n_his, N - n_p, 3))], 2)
    frames = frames + rng.randn(B, n_his, N, 3).astype(np.float32) * 0.01
    hist = torch.tensor(frames.astype(np.float32), device=dev)
    is_tool = torch.arange(N, device=dev) >= n_p
    nbrs, mask = build_neighbor_graph_batch(hist[:, -1], torch.ones(B, N, dtype=torch.bool,
                                                                     device=dev),
                                            is_tool.expand(B, N),
                                            torch.full((B,), 0.5, device=dev), edge)
    action = torch.zeros(B, N, 3, device=dev)
    action[:, n_p:, 0] = 0.02
    res["in:softbody_state"] = hist.cpu()
    k2_k3("softbody", gnn, params, hist, action, nbrs, mask, edge.topk + edge.max_neef)
    torch.cuda.synchronize()
    torch.save(res, out)


def main():
    import torch

    roots = [os.path.abspath(r) for r in sys.argv[1:3]]
    if len(roots) != 2:
        raise SystemExit(__doc__)
    results = []
    with tempfile.TemporaryDirectory() as tmp:
        for i, root in enumerate(roots):
            out = os.path.join(tmp, f"{i}.pt")
            subprocess.run([sys.executable, os.path.abspath(__file__), "--worker", root, out],
                           cwd=root, check=True)
            results.append(torch.load(out))
    old, new = results
    differ = sorted(set(old) ^ set(new))
    for key in sorted(set(old) & set(new)):
        a, b = old[key], new[key]
        same = a.shape == b.shape and a.dtype == b.dtype and torch.equal(a, b)
        diff = (float((a.float() - b.float()).abs().max()) if a.shape == b.shape and a.numel()
                else None)
        line = {"tensor": key, "shape": list(a.shape), "equal": same, "max_abs_diff": diff}
        if key.startswith("k3:") and ":grad" in key and a.shape == b.shape:
            rel = float(torch.linalg.norm((a - b).double())
                        / torch.linalg.norm(a.double()).clamp(min=1e-30))
            same = rel <= GRAD_TOL[key.split(":")[2]]
            line.update(rel_norm_diff=rel, tol=GRAD_TOL[key.split(":")[2]], within_tol=same)
        print(json.dumps(line), flush=True)
        if not same:
            differ.append(key)

    def verdict(keys):
        return not any(keys(d) for d in differ) and any(keys(k) for k in old)

    kernels = {k: verdict(lambda key, k=k: key.startswith(k + ":") and ":grad" not in key)
               for k in ("k1", "k2", "k2e", "k3")}
    kernels["k3_grads"] = verdict(lambda key: key.startswith("k3:") and ":grad" in key)
    print(json.dumps({"same_outputs": not differ, "kernels": kernels, "roots": roots,
                      "differ": differ}), flush=True)
    if differ:
        raise SystemExit(1)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--worker"]:
        worker(sys.argv[2], sys.argv[3])
    else:
        main()
