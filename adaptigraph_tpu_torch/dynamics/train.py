"""Multi-step training of the GNN dynamics model (counterpart of
``adaptigraph_tpu/dynamics/train.py``).

A train step expands a compact batch, augments it (state noise, a random
rotation about the vertical axis, physics noise), builds the radius∧topk
graph once from the augmented pre-rollout state, runs ``n_future``
autoregressive steps through the differentiable fused forward
(``ops.fused_gnn_train``: K2 forward and K3 backward on the card), sums the
per-step MSE and applies Adam with optax's defaults, optionally after
optax's global-norm clip. ``make_train_steps`` / ``make_eval_steps`` run K
steps per call over a stacked superbatch: on the card one step captured in a
CUDA graph and replayed K times (the JAX ``lax.scan``). ``train`` adds the
epoch loop with validation, the metrics log, checkpoints that the JAX
package can read, loss curves and ``resume``. One device; no mesh.
"""

import dataclasses
import json
import os
import queue
import threading
import time

import numpy as np
import torch

from adaptigraph_tpu_torch.models.gnn import GNNConfig, init_params, params_from_numpy, params_to_numpy
from adaptigraph_tpu_torch.ops import fused_gnn, fused_gnn_train
from adaptigraph_tpu_torch.ops.fused_gnn_train import make_fused_train_forward
from adaptigraph_tpu_torch.ops.graph import EdgeConfig, build_neighbor_graph_batch
from adaptigraph_tpu_torch.utils import checkpoint as ckpt


@dataclasses.dataclass(frozen=True)
class TrainHyper:
    """Training hyperparameters (same fields as the JAX ``TrainHyper``)."""

    n_future: int
    batch_size: int = 128
    n_epochs: int = 100
    n_iters_train: int = 1000
    n_iters_valid: int = 100
    lr: float = 1e-3
    use_augmentation: bool = True
    state_noise_train: float = 0.05
    state_noise_valid: float = 0.0
    phys_noise_train: float = 0.0
    phys_noise_valid: float = 0.0
    store_rest_state: bool = False
    seed: int = 42
    grad_clip_norm: float = 0.0  # global-norm clip; 0 disables


def expand_compact_batch(batch, gnn_cfg: GNNConfig):
    """The full batch dict from a compact one (``PackedDataset(compact=True)``:
    eef keypoints and ``obj_mask`` in place of the full-node arrays derived
    from them), on the batch's device. A full batch is returned as it is."""
    if "action_eef" not in batch:
        return batch
    No, N = gnn_cfg.max_nobj, gnn_cfg.n_nodes
    obj_mask = batch["obj_mask"]
    B = obj_mask.shape[0]
    dev = obj_mask.device
    f = obj_mask.float()
    nf1 = batch["eef_future_kp"].shape[1]

    def full(eef, lead):  # eef rows into a zero full-node array
        out = torch.zeros(*lead, N, 3, dtype=torch.float32, device=dev)
        out[..., No:, :] = eef
        return out

    attrs = torch.zeros(B, N, 2, dtype=torch.float32, device=dev)
    attrs[:, :No, 0] = f
    attrs[:, No:, 1] = 1.0
    eef_cols = torch.arange(N, device=dev) >= No
    state_mask = torch.cat([obj_mask, torch.ones(B, N - No, dtype=torch.bool, device=dev)], dim=1)
    return {
        "state": batch["state"],
        "action": full(batch["action_eef"], (B,)),
        "eef_future": full(batch["eef_future_kp"], (B, nf1)),
        "action_future": full(batch["action_future_kp"], (B, nf1)),
        "state_future": batch["state_future"],
        "attrs": attrs,
        "p_instance": f[:, :, None],
        "state_mask": state_mask,
        "eef_mask": eef_cols[None].expand(B, N),
        "obj_mask": obj_mask,
        "physics_param": batch["physics_param"],
        "adj_thresh": batch["adj_thresh"],
        "knn_frac": batch["knn_frac"],
    }


def draw_augment(batch, generator, state_noise, phys_noise):
    """The random draws of one augmentation, from ``generator`` on the
    batch's device: uniform state noise in [-state_noise, state_noise], one
    angle per sample in [-pi, pi], uniform physics noise."""
    state, phys = batch["state"], batch["physics_param"]

    def uniform(shape, lo, hi):
        u = torch.rand(shape, generator=generator, device=state.device, dtype=torch.float32)
        return lo + (hi - lo) * u

    return {"noise": uniform(state.shape, -state_noise, state_noise),
            "theta": uniform(state.shape[:1], -np.pi, np.pi),
            "phys_noise": uniform(phys.shape, -phys_noise, phys_noise)}


def augment(batch, noise, theta, phys_noise):
    """State noise, then one rotation per sample applied by right
    multiplication to every geometric field, then physics noise (the JAX
    ``_augment`` with its random draws passed in)."""
    c, s = torch.cos(theta), torch.sin(theta)
    z, o = torch.zeros_like(c), torch.ones_like(c)
    rot = torch.stack([torch.stack([c, -s, z], -1), torch.stack([s, c, z], -1),
                       torch.stack([z, z, o], -1)], dim=-2)  # (B, 3, 3)

    def rmul(x):
        return torch.einsum("b...i,bij->b...j", x, rot)

    return dict(batch, state=rmul(batch["state"] + noise), action=rmul(batch["action"]),
                eef_future=rmul(batch["eef_future"]), action_future=rmul(batch["action_future"]),
                state_future=rmul(batch["state_future"]),
                physics_param=batch["physics_param"] + phys_noise)


def _splice_history(state_hist, next_state, store_rest_state):
    """History update between autoregressive steps."""
    if store_rest_state:  # keep the rest frame 0, drop frame 1
        return torch.cat([state_hist[:, :1], state_hist[:, 2:], next_state[:, None]], dim=1)
    return torch.cat([state_hist[:, 1:], next_state[:, None]], dim=1)


def multi_step_loss(params, batch, gnn_cfg: GNNConfig, edge_cfg: EdgeConfig, n_future,
                    store_rest_state, fused_fn):
    """Sum of per-step MSE over ``n_future`` autoregressive predictions
    through ``fused_fn`` (``make_fused_train_forward``'s function). Edges
    are built once from the current (augmented) state and reused."""
    state = batch["state"]
    tool = batch["eef_mask"]
    nbrs, nbr_mask = build_neighbor_graph_batch(state[:, -1], batch["state_mask"], tool,
                                                batch["adj_thresh"], edge_cfg,
                                                batch.get("knn_frac", 1.0))
    n_p = gnn_cfg.max_nobj
    state_hist, action = state, batch["action"]
    total = 0.0
    for fi in range(n_future):
        pred = fused_fn(params, state_hist, action, batch["physics_param"], batch["attrs"],
                        batch["p_instance"], nbrs, nbr_mask)
        total = total + torch.mean((pred - batch["state_future"][:, fi]) ** 2)
        if fi < n_future - 1:
            next_state = torch.cat([pred, batch["eef_future"][:, fi, n_p:]], dim=1)
            state_hist = _splice_history(state_hist, next_state, store_rest_state)
            action = batch["action_future"][:, fi]
    return total


def fused_train_fn(gnn_cfg: GNNConfig, edge_cfg: EdgeConfig, compute_dtype=None):
    """The differentiable fused forward for training in ``compute_dtype``
    (float32 or bfloat16; None means float32, the JAX trainer's default)."""
    return make_fused_train_forward(gnn_cfg, edge_cfg.topk + edge_cfg.max_neef,
                                    compute_dtype or torch.float32)


def adam_init(leaves):
    """optax's Adam state: the step count, an int32 tensor on the leaves'
    device (so that a step captured in a CUDA graph counts on every
    replay), and the zeroed moments."""
    return {"count": torch.zeros((), dtype=torch.int32, device=leaves[0].device),
            "mu": [torch.zeros_like(p) for p in leaves],
            "nu": [torch.zeros_like(p) for p in leaves]}


@torch.no_grad()
def adam_step(leaves, grads, state, lr, clip_norm=0.0):
    """One optax step, in place: ``clip_by_global_norm(clip_norm)`` when
    ``clip_norm > 0`` (scale by clip_norm / norm only when norm >= clip_norm),
    then ``adam(lr)`` with optax's defaults (b1 0.9, b2 0.999, eps 1e-8
    outside the root; bias-corrected moments)."""
    b1, b2, eps = 0.9, 0.999, 1e-8
    if clip_norm > 0:
        norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
        grads = [torch.where(norm < clip_norm, g, (g / norm) * clip_norm) for g in grads]
    state["count"].add_(1)
    # 1 - decay**count in float32 on the device, as optax forms the bias
    # corrections; no host value, so the step can be captured in a graph
    c1, c2 = (1 - torch.pow(b, state["count"]) for b in (b1, b2))
    for p, g, mu, nu in zip(leaves, grads, state["mu"], state["nu"]):
        mu.copy_((1 - b1) * g + b1 * mu)
        nu.copy_((1 - b2) * (g * g) + b2 * nu)
        p.add_(-lr * ((mu / c1) / (torch.sqrt(nu / c2) + eps)))


def make_train_step(gnn_cfg: GNNConfig, edge_cfg: EdgeConfig, hyper: TrainHyper, fused_fn=None):
    """``step(leaves, opt_state, batch, generator) -> loss``: one optimizer
    step in place on the parameter leaves (``LEAF_ORDER``, float32,
    requiring grad) and the Adam state, through ``fused_fn``
    (``fused_train_fn``'s function; None builds the float32 one). The
    parameters, the Adam state, the loss and the gradients stay float32
    whatever dtype ``fused_fn`` computes in."""
    fused_fn = fused_fn or fused_train_fn(gnn_cfg, edge_cfg)

    def step(leaves, opt_state, batch, generator):
        batch = expand_compact_batch(batch, gnn_cfg)
        if hyper.use_augmentation:
            batch = augment(batch, **draw_augment(batch, generator, hyper.state_noise_train,
                                                  hyper.phys_noise_train))
        loss = multi_step_loss(ckpt.tree_from_leaves(leaves), batch, gnn_cfg, edge_cfg,
                               hyper.n_future, hyper.store_rest_state, fused_fn)
        grads = torch.autograd.grad(loss, leaves)
        adam_step(leaves, grads, opt_state, hyper.lr, hyper.grad_clip_norm)
        return loss.detach()

    return step


def make_eval_step(gnn_cfg: GNNConfig, edge_cfg: EdgeConfig, hyper: TrainHyper, fused_fn=None):
    """``evaluate(leaves, batch, generator) -> loss`` with the validation
    noise, through ``fused_fn`` (None: the float32 one)."""
    fused_fn = fused_fn or fused_train_fn(gnn_cfg, edge_cfg)

    @torch.no_grad()
    def evaluate(leaves, batch, generator):
        batch = expand_compact_batch(batch, gnn_cfg)
        if hyper.use_augmentation:
            batch = augment(batch, **draw_augment(batch, generator, hyper.state_noise_valid,
                                                  hyper.phys_noise_valid))
        return multi_step_loss(ckpt.tree_from_leaves(leaves), batch, gnn_cfg, edge_cfg,
                               hyper.n_future, hyper.store_rest_state, fused_fn)

    return evaluate


# the wrappers whose ``launches`` counters a train or eval step bumps (K2,
# K3), held here so that a caller's patch of the module attribute (a plain
# version in place of the kernel) leaves the counters in place
_LAUNCH_COUNTERS = (fused_gnn.gnn_forward, fused_gnn_train.gnn_train_bwd)


def _n_slices(superbatch):
    return next(iter(superbatch.values())).shape[0]


def _slice(superbatch, k):
    return {name: v[k] for name, v in superbatch.items()}


class GraphedStep:
    """``fn(*state, batch, generator) -> loss`` run on each slice of a
    (K, B, ...) superbatch on the card, captured once in a CUDA graph.

    The first call (and the first after the state's tensors, the generator
    or the batch's shapes change) runs slice 0 eagerly on a side stream,
    which also warms up what a step sets up at first use, then captures one
    call on static batch buffers. Every later slice is copied into those
    buffers and the graph replayed. The state (parameter leaves, optimizer
    state) is updated in place, so its addresses, baked into the graph, stay
    valid; the generator is registered with the graph, so replay k draws
    the numbers the eager step k would. A failed capture raises.
    ``counted``: the launches per kernel counter that the capture recorded
    (``_LAUNCH_COUNTERS``); a replay adds them, as the kernels' wrappers,
    which do not run on replay, would."""

    def __init__(self, fn):
        self.fn = fn
        self.key = None
        self.graph = None
        self.counted = None

    @staticmethod
    def _key(state, superbatch, generator):
        tensors = []
        for part in state:
            items = part.values() if isinstance(part, dict) else part
            for x in items:
                tensors += x if isinstance(x, (list, tuple)) else [x]
        return (tuple(t.data_ptr() for t in tensors), id(generator),
                tuple((name, tuple(v.shape[1:]), v.dtype, v.device)
                      for name, v in superbatch.items()))

    def _capture(self, state, superbatch, generator, out):
        dev = out.device
        cur = torch.cuda.current_stream(dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(cur)
        with torch.cuda.stream(side):  # slice 0, eagerly: the warm-up
            out[0].copy_(self.fn(*state, _slice(superbatch, 0), generator))
        cur.wait_stream(side)
        self.graph = self.key = None  # frees an earlier capture's memory first
        self.static = {name: v[0].clone() for name, v in superbatch.items()}
        graph = torch.cuda.CUDAGraph()
        if generator is not None:
            graph.register_generator_state(generator)
        before = [c.launches for c in _LAUNCH_COUNTERS]
        # thread_local: the batch prefetcher's thread pins and copies meanwhile
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            self.loss = self.fn(*state, self.static, generator)
        self.counted = [c.launches - b for c, b in zip(_LAUNCH_COUNTERS, before)]
        for c, n in zip(_LAUNCH_COUNTERS, self.counted):  # the capture launched nothing
            c.launches -= n
        self.graph = graph
        self.key = self._key(state, superbatch, generator)

    def __call__(self, state, superbatch, generator):
        K = _n_slices(superbatch)
        dev = next(iter(superbatch.values())).device
        out = torch.empty(K, dtype=torch.float32, device=dev)
        start = 0
        if self.graph is None or self.key != self._key(state, superbatch, generator):
            self._capture(state, superbatch, generator, out)
            start = 1
        for k in range(start, K):
            for name, buf in self.static.items():
                buf.copy_(superbatch[name][k])
            self.graph.replay()
            out[k].copy_(self.loss)  # the next replay overwrites it
            for c, n in zip(_LAUNCH_COUNTERS, self.counted):
                c.launches += n
        return out


def make_train_steps(gnn_cfg: GNNConfig, edge_cfg: EdgeConfig, hyper: TrainHyper, fused_fn=None):
    """``steps(leaves, opt_state, superbatch, generator) -> losses (K,)``: K
    optimizer steps over a (K, B, ...) superbatch, each with the numerics of
    ``make_train_step`` (the JAX ``make_train_steps``, a ``lax.scan`` whose
    body is compiled once). On CUDA tensors one step is captured in a CUDA
    graph and replayed per slice (``GraphedStep``, ``steps.graphed``); on
    CPU tensors it is a loop of the step."""
    step = make_train_step(gnn_cfg, edge_cfg, hyper, fused_fn)
    graphed = GraphedStep(step)

    def steps(leaves, opt_state, superbatch, generator):
        if leaves[0].is_cuda:
            return graphed((leaves, opt_state), superbatch, generator)
        return torch.stack([step(leaves, opt_state, _slice(superbatch, k), generator)
                            for k in range(_n_slices(superbatch))])

    steps.graphed = graphed
    return steps


def make_eval_steps(gnn_cfg: GNNConfig, edge_cfg: EdgeConfig, hyper: TrainHyper, fused_fn=None):
    """``evaluate(leaves, superbatch, generator) -> losses (K,)``: K eval
    steps (``make_eval_step``'s) over a (K, B, ...) superbatch; on CUDA
    tensors one captured in a CUDA graph and replayed per slice."""
    evaluate = make_eval_step(gnn_cfg, edge_cfg, hyper, fused_fn)
    graphed = GraphedStep(evaluate)

    def steps(leaves, superbatch, generator):
        if leaves[0].is_cuda:
            return graphed((leaves,), superbatch, generator)
        return torch.stack([evaluate(leaves, _slice(superbatch, k), generator)
                            for k in range(_n_slices(superbatch))])

    steps.graphed = graphed
    return steps


class DevicePrefetcher:
    """Stages host batches (dicts of numpy arrays) onto the device from a
    background thread: each array is copied into pinned host memory and
    sent on a side CUDA stream, so the copy overlaps the previous step; the
    consumer's stream waits for the copy's event. On the CPU it only wraps
    the arrays as tensors. An exception in the thread is raised in the
    consumer."""

    def __init__(self, loader, device, depth=2):
        self._loader = loader
        self._device = torch.device(device)
        self._cuda = self._device.type == "cuda"
        self._stream = torch.cuda.Stream(self._device) if self._cuda else None
        self._q = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _stage(self, batch):
        host = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}
        if not self._cuda:
            return host, None
        host = {k: v.pin_memory() for k, v in host.items()}
        with torch.cuda.stream(self._stream):
            dev = {k: v.to(self._device, non_blocking=True) for k, v in host.items()}
            done = torch.cuda.Event()
            done.record(self._stream)
        return dev, (done, host)

    def _put(self, item):
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=1.0)
                return
            except queue.Full:
                continue

    def _worker(self):
        while not self._stop.is_set():
            try:
                item = self._stage(next(self._loader))
            except Exception as e:  # raised in the consumer
                self._put(e)
                return
            self._put(item)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if isinstance(item, Exception):
            raise item
        batch, pending = item
        if pending is not None:
            done, _host = pending  # the pinned buffers live until the copy is waited for
            stream = torch.cuda.current_stream(self._device)
            stream.wait_event(done)
            for v in batch.values():
                v.record_stream(stream)
        return batch

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=5.0)


def _start_epoch(out_dir):
    """The epoch after the last one ``metrics.jsonl`` recorded (0 if none)."""
    start = 0
    path = os.path.join(out_dir, "metrics.jsonl")
    if os.path.exists(path):
        with open(path) as f:
            for line in f:
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue
                if rec.get("tag") == "epoch":
                    start = max(start, rec["step"] + 1)
    return start


def train(gnn_cfg: GNNConfig, edge_cfg: EdgeConfig, hyper: TrainHyper, train_loader, valid_loader,
          out_dir, device="cuda", log_every=50, params=None, resume=False):
    """The training loop: ``hyper.n_epochs`` epochs of ``n_iters_train``
    optimizer steps and ``n_iters_valid`` validation batches each, a metrics
    line (``metrics.jsonl``), a checkpoint (``checkpoints/``) and the loss
    curves per epoch. Loaders yield numpy batch dicts; with ``stack_steps``
    K > 1 they yield (K, B, ...) superbatches, run by ``make_train_steps`` /
    ``make_eval_steps`` (on the card a CUDA graph per step kind). The train
    loss of an epoch is the mean over the logged calls' steps. With
    ``resume``, the latest parameters and optimizer state in ``out_dir`` are
    restored and the epoch count continues. Returns (params, curves)."""
    from adaptigraph_tpu_torch.utils.metrics import MetricsLogger

    device = torch.device(device)
    os.makedirs(out_dir, exist_ok=True)
    if params is None:
        params = init_params(torch.Generator().manual_seed(hyper.seed), gnn_cfg)
    leaves = [p.detach().to(device, torch.float32).clone().requires_grad_(True)
              for p in ckpt.tree_leaves(params)]
    opt_state = adam_init(leaves)
    start_epoch = 0
    if resume and os.path.exists(ckpt.latest_name(out_dir)):
        restored = params_from_numpy(ckpt.load_checkpoint(out_dir, cfg=gnn_cfg), device)
        with torch.no_grad():
            for p, r in zip(leaves, ckpt.tree_leaves(restored)):
                p.copy_(r)
        if os.path.exists(ckpt.optim_name(out_dir)):
            saved = ckpt.load_optimizer(out_dir)
            opt_state["count"].fill_(saved["count"])
            for name in ("mu", "nu"):
                for t, a in zip(opt_state[name], saved[name]):
                    t.copy_(torch.from_numpy(a))
        start_epoch = _start_epoch(out_dir)
        print(f"resumed from {ckpt.latest_name(out_dir)} at epoch {start_epoch}")

    gen = torch.Generator(device=device)
    gen.manual_seed(hyper.seed + 1)

    # K steps per call when the loaders stack superbatches, as the JAX loop
    K = getattr(train_loader, "stack_steps", 1)
    KV = getattr(valid_loader, "stack_steps", 1)
    if K > 1:
        step = make_train_steps(gnn_cfg, edge_cfg, hyper)
    else:
        one_step = make_train_step(gnn_cfg, edge_cfg, hyper)

        def step(leaves, opt_state, batch, generator):
            return one_step(leaves, opt_state, batch, generator)[None]
    if KV > 1:
        evaluate = make_eval_steps(gnn_cfg, edge_cfg, hyper)
    else:
        one_eval = make_eval_step(gnn_cfg, edge_cfg, hyper)

        def evaluate(leaves, batch, generator):
            return one_eval(leaves, batch, generator)[None]
    train_stage = DevicePrefetcher(train_loader, device)
    valid_stage = DevicePrefetcher(valid_loader, device)
    metrics = MetricsLogger(out_dir)
    curves = {"train": [], "valid": []}
    n_calls_train = max(1, hyper.n_iters_train // K)
    n_calls_valid = max(1, hyper.n_iters_valid // KV)

    try:
        for epoch in range(start_epoch, start_epoch + hyper.n_epochs):
            t0 = time.time()
            losses = []
            for it in range(n_calls_train):
                out = step(leaves, opt_state, next(train_stage), gen)
                if it % max(1, log_every // K) == 0:
                    losses.append(out)
            train_loss = float(torch.cat(losses).mean())  # waits for the epoch's steps
            train_seconds = time.time() - t0
            vlosses = [evaluate(leaves, next(valid_stage), gen) for _ in range(n_calls_valid)]
            curves["train"].append(train_loss)
            curves["valid"].append(float(torch.cat(vlosses).mean()))
            metrics.log("epoch", step=epoch, train_loss=curves["train"][-1],
                        valid_loss=curves["valid"][-1], seconds=time.time() - t0,
                        train_seconds=train_seconds, train_steps=n_calls_train * K)
            ckpt.save_checkpoint(out_dir, epoch, params_to_numpy(ckpt.tree_from_leaves(leaves)),
                                 {"count": int(opt_state["count"]),
                                  "mu": [t.cpu().numpy() for t in opt_state["mu"]],
                                  "nu": [t.cpu().numpy() for t in opt_state["nu"]]})
            np.savez(os.path.join(out_dir, "loss_curves.npz"),
                     **{k: np.asarray(v) for k, v in curves.items()})
            _plot_curves(curves, out_dir)
            print(f"epoch {epoch}: train {curves['train'][-1]:.6f} valid {curves['valid'][-1]:.6f} "
                  f"({time.time() - t0:.1f}s)")
    finally:
        train_stage.close()
        valid_stage.close()
        metrics.close()
    return ckpt.tree_from_leaves([p.detach() for p in leaves]), curves


def _plot_curves(curves, out_dir):
    """Loss-curve PNG; matplotlib is optional."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return
    plt.figure(figsize=(10, 4))
    plt.plot(curves["train"], label="train")
    plt.plot(curves["valid"], label="valid")
    plt.legend()
    plt.savefig(os.path.join(out_dir, "loss.png"), dpi=150)
    plt.close()
