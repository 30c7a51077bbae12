"""Whether two checkouts of the port compute the same kernel outputs, bit for
bit, on the same inputs:

- K1: one look-ahead step of B 2000 pushes through
  ``dynamics_rollout_batched`` (its whole-push branch), rope and granular
  width, fixture weights and state, float32 and bfloat16;
- K2: one step with prebuilt edges at B 128, rope width, float32 and
  bfloat16, the activations it keeps for training included (the edge
  buffers on the rows K2 writes, a sample's real edges: the rest of each
  buffer is never written and holds whatever the allocator left there);
- K3: float32, on K2's float32 activations and a seeded motion gradient.

Each checkout runs in a subprocess with its own root first on ``sys.path``
and builds its kernels into its own ``build/torch_kernels/``. The inputs are
made in each subprocess from seeds with numpy and the checkout's fixtures,
and are compared too. Only entry points that both checkouts share are used.
Needs a CUDA card::

    python3 adaptigraph_tpu_torch/profiling/same_outputs.py OLD_ROOT NEW_ROOT

prints one JSON line per tensor (``equal`` and the largest difference) and
exits 1 if any differs.
"""

import json
import os
import subprocess
import sys
import tempfile


def worker(root, out):
    sys.path.insert(0, root)
    import numpy as np
    import torch

    from adaptigraph_tpu_torch.cli import _task_objects, load_params
    from adaptigraph_tpu_torch.ops import kernels
    from adaptigraph_tpu_torch.ops.fused_gnn import (act_layout, gnn_forward_cuda, pack_inputs,
                                                     weight_list)
    from adaptigraph_tpu_torch.ops.fused_gnn_train import gnn_train_bwd_cuda
    from adaptigraph_tpu_torch.ops.graph import build_neighbor_graph_batch
    from adaptigraph_tpu_torch.planning.actions import decode_action
    from adaptigraph_tpu_torch.planning.forward import dynamics_rollout_batched, pusher_keypoints
    from adaptigraph_tpu_torch.utils.config import load_planning_config

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
    attrs = torch.stack([~is_tool, is_tool], -1).float().expand(B, N, 2)
    p_inst = torch.ones(B, n_p, 1, device=dev)
    phys = torch.full((B, gnn.phys_dim), 0.5, device=dev)
    res["in:k2_state"] = hist.cpu()
    for cd in (torch.float32, torch.bfloat16):
        nodes, nbr, msk, last, _ = pack_inputs(gnn, hist, action, phys, attrs, p_inst, nbrs, mask,
                                               edge.topk, cd)
        w = weight_list(params, gnn, cd)
        pred, mot, acts = gnn_forward_cuda(nodes, nbr, msk, last, w, gnn, cd)
        tag = str(cd)[6:]
        real = (msk.view(B, -1) > 0).sum(1).tolist()  # real edges per sample
        edge_acts = acts[1].view(B, -1)
        layout = act_layout(kernels.library(), gnn, edge.topk)[1]
        written = [edge_acts[b, off + s * rows * width:off + (s + 1) * rows * width]
                   .view(rows, width)[:real[b]].reshape(-1)
                   for _, off, slots, rows, width in layout for s in range(slots) for b in range(B)]
        res.update({f"k2:{tag}:pred": pred.cpu(), f"k2:{tag}:motion": mot.cpu(),
                    f"k2:{tag}:acts_node": acts[0].cpu(),
                    f"k2:{tag}:acts_edge": torch.cat(written).cpu()})
        if cd == torch.float32:
            dmot = torch.tensor(np.random.RandomState(3).randn(*last.shape).astype(np.float32),
                                device=dev)
            dnodes, grads = gnn_train_bwd_cuda(nodes, nbr, msk, dmot, w, gnn, acts)
            res["k3:float32:dnodes"] = dnodes.cpu()
            res.update({f"k3:float32:grad{i}": g.cpu() for i, g in enumerate(grads)})
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
        print(json.dumps({"tensor": key, "shape": list(a.shape), "equal": same,
                          "max_abs_diff": diff}), flush=True)
        if not same:
            differ.append(key)
    print(json.dumps({"same_outputs": not differ, "roots": roots, "differ": differ}), flush=True)
    if differ:
        raise SystemExit(1)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--worker"]:
        worker(sys.argv[2], sys.argv[3])
    else:
        main()
