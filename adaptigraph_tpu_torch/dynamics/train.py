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
package can read, loss curves and ``resume``.

Data parallel (the JAX ``shard_map`` step): with a ``mesh`` of more than one
entry (``parallel/mesh.py``, a device list) the parameter leaves and the
Adam state are replicated, one copy per entry, and the batch is split into
one equal part per entry. Each shard runs ``multi_step_loss`` and its
gradient (K2 and K3 on a card) on its device and its own CUDA stream, all
shards at once (``parallel.mesh.run_shards``: no host wait inside the
step); each shard's loss and gradients go into one flat buffer, and the
buffers are averaged as JAX's ``pmean`` averages them, the plain mean of the
shard means, summed on ``mesh[0]`` in shard order; every replica then takes
the same Adam step, on its own stream, with the mean copied to it, so the
replicas stay equal. On a mesh of cards a call, of one step or of K, replays
CUDA graphs (``ShardedGraphs``: per shard one graph of its loss and
gradients and one of its Adam step, the draws and the mean between them;
the JAX step is one compiled program), equal bit for bit to the eager
sharded step, call for call. One departure, kept: the augmentation is
drawn for the whole batch from the caller's generator and split by shard
(JAX folds the shard index into each shard's key), so the sharded step
augments as the unsharded one does. On a one-entry mesh the sharded step is
the unsharded step bit for bit, and its K steps are the unsharded ones,
graph included.

Spans (``utils/profiling.py::span``, recorded only under ``torch.profiler``):
``train.batch_wait``, the consumer's wait on ``DevicePrefetcher``'s queue;
``train.copy_in``, a replayed slice's copy into the graph's static buffers
(stream time too); ``train.replay``, the graph's launch;
``train.capture``, ``GraphedStep``'s eager first slice and capture.
Counters, always kept: ``DevicePrefetcher.starved`` (batches asked for
while the queue was empty), ``GraphedStep.captures`` and
``GraphedStep.capture_s`` (over every instance).
"""

import dataclasses
import gc
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
from adaptigraph_tpu_torch.parallel.mesh import (count_launches, launch_tallies, replicate,
                                                 run_shards, shard_scope, shard_streams,
                                                 split_batch, tree_map)
from adaptigraph_tpu_torch.utils import checkpoint as ckpt
from adaptigraph_tpu_torch.utils.profiling import span


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
    return _draws(batch["state"].shape, batch["physics_param"].shape, batch["state"].device,
                  generator, state_noise, phys_noise)


def _draws(state_shape, phys_shape, device, generator, state_noise, phys_noise):
    def uniform(shape, lo, hi):
        u = torch.rand(shape, generator=generator, device=device, dtype=torch.float32)
        return lo + (hi - lo) * u

    return {"noise": uniform(state_shape, -state_noise, state_noise),
            "theta": uniform(state_shape[:1], -np.pi, np.pi),
            "phys_noise": uniform(phys_shape, -phys_noise, phys_noise)}


def draw_augment_shards(shards, generator, state_noise, phys_noise):
    """``draw_augment`` for the batch whose parts are ``shards``: the whole
    batch's draws, made on the first shard's device in the unsharded step's
    order, split by shard (views on that device; each shard copies its part
    to its own device)."""
    sizes = [b["state"].shape[0] for b in shards]
    state, phys = shards[0]["state"], shards[0]["physics_param"]
    whole = _draws((sum(sizes),) + tuple(state.shape[1:]), (sum(sizes),) + tuple(phys.shape[1:]),
                   state.device, generator, state_noise, phys_noise)
    parts = {k: torch.split(v, sizes) for k, v in whole.items()}
    return [{k: parts[k][i] for k in whole} for i in range(len(shards))]


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


# the wrappers whose ``launches`` counters a train or eval step bumps (K2,
# K3), held here so that a caller's patch of the module attribute (a plain
# version in place of the kernel) leaves the counters in place
_LAUNCH_COUNTERS = (fused_gnn.gnn_forward, fused_gnn_train.gnn_train_bwd)
# every launch counter of those wrappers, which a graph replay bumps as the
# wrappers would: the launches, and K3's batch-wide weight-gradient kernel's
_REPLAY_COUNTERS = ([(c, "launches") for c in _LAUNCH_COUNTERS]
                    + [(fused_gnn_train.gnn_train_bwd, "wgrad_launches")])


def pmean(values, device):
    """The plain mean of per-shard values, as JAX's ``pmean`` takes it: the
    values summed on ``device`` in shard order, then divided by their count."""
    total = values[0].to(device)
    for v in values[1:]:
        total = total + v.to(device)
    return total / len(values)


def flat_loss_grads(loss, grads=()):
    """A shard's loss and gradients in one float32 buffer, the loss first:
    the mean over shards then copies and sums one tensor a shard.
    ``pmean`` of such buffers is, element for element, ``pmean`` of each
    leaf."""
    return torch.cat([loss.detach().reshape(1)] + [g.reshape(-1) for g in grads])


def unflat_grads(flat, like):
    """The gradients of ``flat_loss_grads``' buffer, as views shaped like
    the leaves ``like``."""
    grads = torch.split(flat[1:], [t.numel() for t in like])
    return [g.view_as(t) for g, t in zip(grads, like)]


class ShardedStep:
    """The data-parallel train or eval step over a mesh (the JAX
    ``shard_map`` step): the augmentation draws on ``mesh[0]``
    (``draw_augment_shards``), every shard's loss and, training, gradients
    at once (``loss_part``, each shard on its own stream,
    ``parallel.mesh.run_shards``), their ``pmean`` on ``mesh[0]``, then
    every replica's Adam step at once (``update_part``). ``run`` takes the
    parts per shard as callables, so that ``ShardedGraphs`` can put graph
    replays in their place. ``shard_launches``: each shard's K2 and K3
    launches, summed over the calls."""

    def __init__(self, gnn_cfg, edge_cfg, hyper, fused_fn, mesh, train_mode):
        self.gnn_cfg, self.edge_cfg, self.hyper, self.fused_fn = gnn_cfg, edge_cfg, hyper, fused_fn
        self.mesh = [torch.device(d) for d in mesh]
        self.train_mode = train_mode
        self.streams = shard_streams(self.mesh)
        self.shard_launches = launch_tallies(_LAUNCH_COUNTERS, len(self.mesh))

    def draws(self, shards, generator):
        """Each shard's part of the whole batch's draws (None each without
        augmentation), on ``mesh[0]``."""
        h = self.hyper
        if not h.use_augmentation:
            return [None] * len(shards)
        noise = ((h.state_noise_train, h.phys_noise_train) if self.train_mode
                 else (h.state_noise_valid, h.phys_noise_valid))
        return draw_augment_shards(shards, generator, *noise)

    def loss_part(self, leaves, batch, draws):
        """One shard's expanded, augmented batch through ``multi_step_loss``:
        its loss and, training, its gradients, as ``flat_loss_grads``."""
        h = self.hyper
        batch = expand_compact_batch(batch, self.gnn_cfg)
        if draws is not None:
            dev = batch["state"].device
            batch = augment(batch, **{k: v.to(dev) for k, v in draws.items()})
        with torch.set_grad_enabled(self.train_mode):
            loss = multi_step_loss(ckpt.tree_from_leaves(leaves), batch, self.gnn_cfg,
                                   self.edge_cfg, h.n_future, h.store_rest_state, self.fused_fn)
        if not self.train_mode:
            return flat_loss_grads(loss)
        return flat_loss_grads(loss, torch.autograd.grad(loss, leaves))

    def update_part(self, leaves, state, mean):
        """One replica's Adam step with the mean gradients of ``mean``,
        copied to the replica's device."""
        adam_step(leaves, unflat_grads(mean.to(leaves[0].device), leaves), state, self.hyper.lr,
                  self.hyper.grad_clip_norm)

    def run(self, shards, draws, loss_parts, update_parts=None):
        """One step: ``loss_parts[s](shards[s], draws[s])`` on every shard,
        the mean on ``mesh[0]``, then ``update_parts[s](mean)`` on every
        shard. Returns the mean loss on ``mesh[0]``."""
        flats = run_shards(self.mesh, self.streams,
                           [(s, fn, (shards[s], draws[s])) for s, fn in enumerate(loss_parts)],
                           _LAUNCH_COUNTERS, self.shard_launches)
        mean = pmean(flats, self.mesh[0])
        if update_parts is not None:
            run_shards(self.mesh, self.streams, [(s, fn, (mean,)) for s, fn in
                                                 enumerate(update_parts)],
                       _LAUNCH_COUNTERS, self.shard_launches)
        return mean[0]

    def eager_parts(self, replicas, opt_states=None):
        """The parts of ``run`` computed as they are issued: each shard's
        ``loss_part`` and, given the Adam states, ``update_part``."""
        loss_parts = [lambda b, dr, r=r: self.loss_part(r, b, dr) for r in replicas]
        if opt_states is None:
            return loss_parts, None
        return loss_parts, [lambda m, r=r, st=st: self.update_part(r, st, m)
                            for r, st in zip(replicas, opt_states)]

    def eager_step(self, *args):
        """``eager_step(replicas[, opt_states], shards, generator)``: one
        step with every operation issued as it runs (the reference that the
        graph replays are held to, bit for bit)."""
        *state, shards, generator = args
        return self.run(shards, self.draws(shards, generator), *self.eager_parts(*state))


def make_train_step(gnn_cfg: GNNConfig, edge_cfg: EdgeConfig, hyper: TrainHyper, fused_fn=None,
                    mesh=None):
    """``step(leaves, opt_state, batch, generator) -> loss``: one optimizer
    step in place on the parameter leaves (``LEAF_ORDER``, float32,
    requiring grad) and the Adam state, through ``fused_fn``
    (``fused_train_fn``'s function; None builds the float32 one). The
    parameters, the Adam state, the loss and the gradients stay float32
    whatever dtype ``fused_fn`` computes in.

    With ``mesh``: ``step(replicas, opt_states, shards, generator) -> loss``
    on ``mesh[0]``, with ``replicate``'s copies of the leaves and the Adam
    state and ``shard_batch``'s parts of the batch, one per entry (see the
    module docstring); on a mesh of cards it replays per-shard CUDA graphs
    after its first call (``step.graphed``, a ``ShardedGraphs``; None
    elsewhere), and ``step.sharded.eager_step`` is the same step issued
    eagerly. ``step.shard_launches`` holds, per shard, the K2 and K3
    launches (``gnn_forward``, ``gnn_train_bwd``) its work made, summed over
    the calls."""
    fused_fn = fused_fn or fused_train_fn(gnn_cfg, edge_cfg)
    if mesh is not None:
        return _sharded_step(gnn_cfg, edge_cfg, hyper, fused_fn, list(mesh), train_mode=True)

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


def make_eval_step(gnn_cfg: GNNConfig, edge_cfg: EdgeConfig, hyper: TrainHyper, fused_fn=None,
                   mesh=None):
    """``evaluate(leaves, batch, generator) -> loss`` with the validation
    noise, through ``fused_fn`` (None: the float32 one). With ``mesh``:
    ``evaluate(replicas, shards, generator)``, the ``pmean`` of the shards'
    losses on ``mesh[0]``, as graph replays on a mesh of cards (as
    ``make_train_step``)."""
    fused_fn = fused_fn or fused_train_fn(gnn_cfg, edge_cfg)
    if mesh is not None:
        return _sharded_step(gnn_cfg, edge_cfg, hyper, fused_fn, list(mesh), train_mode=False)

    @torch.no_grad()
    def evaluate(leaves, batch, generator):
        batch = expand_compact_batch(batch, gnn_cfg)
        if hyper.use_augmentation:
            batch = augment(batch, **draw_augment(batch, generator, hyper.state_noise_valid,
                                                  hyper.phys_noise_valid))
        return multi_step_loss(ckpt.tree_from_leaves(leaves), batch, gnn_cfg, edge_cfg,
                               hyper.n_future, hyper.store_rest_state, fused_fn)

    return evaluate


def _on_cards(mesh):
    """Whether a sharded step on ``mesh`` runs as CUDA graph replays
    (``ShardedGraphs``): every entry a card."""
    return all(torch.device(d).type == "cuda" for d in mesh)


def _sharded_step(gnn_cfg, edge_cfg, hyper, fused_fn, mesh, train_mode):
    """The sharded train (``train_mode``) or eval step of ``make_train_step``
    / ``make_eval_step`` with a mesh. On a mesh of cards one call runs as
    ``ShardedGraphs`` over a one-slice superbatch (the JAX ``shard_map`` step
    is one compiled program): the first call, and the first after the
    state's tensors or the batch's shapes change, is the eager sharded step
    and the capture; every later one copies its shards into the graphs'
    buffers and replays them. Elsewhere every call is the eager sharded step
    (``ShardedStep.eager_step``)."""
    sharded = ShardedStep(gnn_cfg, edge_cfg, hyper, fused_fn, mesh, train_mode)
    graphed = ShardedGraphs(sharded) if _on_cards(mesh) else None

    def step(*args):
        if graphed is None:
            return sharded.eager_step(*args)
        *state, shards, generator = args
        return graphed(*state, [{k: v[None] for k, v in b.items()} for b in shards],
                       generator)[0]

    step.sharded, step.graphed, step.shard_launches = sharded, graphed, sharded.shard_launches
    return step


def _n_slices(superbatch):
    return next(iter(superbatch.values())).shape[0]


def _slice(superbatch, k):
    return {name: v[k] for name, v in superbatch.items()}


def _graph_key(state, superbatches, generator=None):
    """What a capture bakes in: the addresses of the state's tensors, the
    generator registered with it, and the slices' shapes."""
    ptrs = []
    tree_map(lambda x: ptrs.append(x.data_ptr()) if isinstance(x, torch.Tensor) else None, state)
    return (tuple(ptrs), id(generator), tuple((name, tuple(v.shape[1:]), v.dtype, v.device)
                                              for sb in superbatches for name, v in sb.items()))


def _copy_into(static, values):
    """Copies each tensor of ``values`` into the tensor at its place in
    ``static`` (dicts, lists and tuples of tensors or None)."""
    if isinstance(static, torch.Tensor):
        static.copy_(values)
    elif isinstance(static, dict):
        for k, v in static.items():
            _copy_into(v, values[k])
    elif isinstance(static, (list, tuple)):
        for a, b in zip(static, values):
            _copy_into(a, b)


class _Replay:
    """``fn(*inputs)`` captured once in a CUDA graph on the current device
    and stream, on copies of ``inputs`` made on ``device`` (with
    ``generator`` registered, so that replay k draws the numbers the eager
    call k would); a call copies its inputs into those copies and replays
    the graph on the current stream. Returns the captured output, which the
    next replay overwrites. ``counted``: the launches per kernel counter
    (``_LAUNCH_COUNTERS``) that the capture recorded; a replay adds them, as
    the kernels' wrappers, which do not run on replay, would. A failed
    capture raises. Python's cyclic garbage collector is off during the
    capture (see ``__init__``)."""

    def __init__(self, fn, inputs, device, generator=None):
        self.device = device
        self.static = tree_map(lambda x: x.to(device, copy=True)
                               if isinstance(x, torch.Tensor) else x, inputs)
        self.graph = torch.cuda.CUDAGraph()
        if generator is not None:
            self.graph.register_generator_state(generator)
        before = [getattr(c, a) for c, a in _REPLAY_COUNTERS]
        # No cyclic collection during the capture: a CUDA graph that the
        # collector frees (one left in a reference cycle) is destroyed by
        # torch.cuda.CUDAGraph's destructor, whose cudaGraphExecDestroy CUDA
        # refuses while a capture is underway ("operation not permitted when
        # stream is capturing", only a warning from PyTorch), and the capture
        # is then invalidated (cudaErrorStreamCaptureInvalidated). A
        # collection can start on any thread that allocates, autograd's
        # backward thread included. Garbage is collected after the capture.
        collecting = gc.isenabled()
        gc.disable()
        try:
            # thread_local: the batch prefetcher's thread pins and copies meanwhile
            with torch.cuda.graph(self.graph, stream=torch.cuda.current_stream(device),
                                  capture_error_mode="thread_local"):
                self.out = fn(*self.static)
        finally:
            if collecting:
                gc.enable()
        self._counts = [getattr(c, a) - b for (c, a), b in zip(_REPLAY_COUNTERS, before)]
        self.counted = self._counts[:len(_LAUNCH_COUNTERS)]
        for (c, a), n in zip(_REPLAY_COUNTERS, self._counts):  # the capture launched nothing
            setattr(c, a, getattr(c, a) - n)

    def __call__(self, *inputs):
        with span("train.copy_in", stream=self.device):
            _copy_into(self.static, inputs)
        with span("train.replay"):
            self.graph.replay()
        for (c, a), n in zip(_REPLAY_COUNTERS, self._counts):
            setattr(c, a, getattr(c, a) + n)
        return self.out


class GraphedStep:
    """``fn(*state, batch, generator) -> loss`` run on each slice of a
    (K, B, ...) superbatch on the card, captured once in a CUDA graph.

    The first call (and the first after the state's tensors, the generator
    or the batch's shapes change) runs slice 0 eagerly on a side stream,
    which also warms up what a step sets up at first use, then captures one
    call there on static batch buffers (``_Replay``). Every later slice is
    copied into those buffers and the graph replayed. The state (parameter
    leaves, optimizer state) is updated in place, so its addresses, baked
    into the graph, stay valid; the generator is registered with the graph,
    so replay k draws the numbers the eager step k would. A failed capture
    raises. ``counted``: the launches per kernel counter that the capture
    recorded; ``replays``: the replays so far. ``captures`` and
    ``capture_s`` (class attributes): the captures of every instance and
    their host seconds, the eager first slice included."""

    captures = 0
    capture_s = 0.0

    def __init__(self, fn):
        self.fn = fn
        self.key = None
        self.replay = None
        self.replays = 0

    @property
    def counted(self):
        return self.replay.counted

    def _capture(self, state, superbatch, generator, out):
        t0 = time.perf_counter()
        dev = out.device
        cur = torch.cuda.current_stream(dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(cur)
        with span("train.capture"), torch.cuda.stream(side):
            # slice 0, eagerly: the warm-up; then the capture
            out[0].copy_(self.fn(*state, _slice(superbatch, 0), generator))
            self.replay = self.key = None  # frees an earlier capture's memory first
            self.replay = _Replay(lambda batch: self.fn(*state, batch, generator),
                                  (_slice(superbatch, 0),), dev, generator)
        cur.wait_stream(side)
        self.key = _graph_key(state, [superbatch], generator)
        GraphedStep.captures += 1
        GraphedStep.capture_s += time.perf_counter() - t0

    def __call__(self, state, superbatch, generator):
        K = _n_slices(superbatch)
        dev = next(iter(superbatch.values())).device
        out = torch.empty(K, dtype=torch.float32, device=dev)
        start = 0
        if self.replay is None or self.key != _graph_key(state, [superbatch], generator):
            self._capture(state, superbatch, generator, out)
            start = 1
        for k in range(start, K):
            out[k].copy_(self.replay(_slice(superbatch, k)))  # the next replay overwrites it
            self.replays += 1
        return out


class ShardedGraphs:
    """K steps per call of a ``ShardedStep`` over per-shard (K, B, ...)
    superbatches as CUDA graph replays (the JAX sharded ``lax.scan``; K 1
    for the one-step call, the JAX ``shard_map`` step). The
    first call, and the first after the state's tensors or the batch's
    shapes change, runs slice 0 as the eager sharded step, which also warms
    up what a step sets up at first use, then captures per shard, on its own
    stream, one graph of ``loss_part`` and, training, one of
    ``update_part``. Every later slice runs ``ShardedStep.run`` with the
    replays in place of the parts: the draws and the mean stay between the
    graphs on ``mesh[0]`` (they cross cards), and the shards' graphs run at
    once. Equal bit for bit to K calls of the sharded step. ``replays``:
    the graph replays so far."""

    def __init__(self, sharded):
        self.sharded = sharded
        self.key = None
        self.parts = None
        self.replays = 0

    def _capture(self, state, shards, draws):
        sh = self.sharded
        self.parts = self.key = None  # frees an earlier capture's graphs first
        eager_loss, eager_update = sh.eager_parts(*state)
        loss_parts, update_parts = [], []
        for s, (d, stream) in enumerate(zip(sh.mesh, sh.streams)):
            with shard_scope(d, stream):
                loss_parts.append(_Replay(eager_loss[s], (shards[s], draws[s]), d))
                if eager_update is not None:  # a mean buffer's shape: the loss, then the leaves
                    size = 1 + sum(t.numel() for t in state[0][s])
                    update_parts.append(_Replay(eager_update[s], (torch.zeros(size, device=d),),
                                                d))
        self.parts = (loss_parts, update_parts or None)

    def __call__(self, *args):
        *state, superbatches, generator = args
        sh = self.sharded
        K = _n_slices(superbatches[0])
        out = torch.empty(K, dtype=torch.float32, device=sh.mesh[0])
        key = _graph_key(state, superbatches)
        start = 0
        if self.parts is None or self.key != key:
            shards = [_slice(sb, 0) for sb in superbatches]
            draws = sh.draws(shards, generator)
            out[0].copy_(sh.run(shards, draws, *sh.eager_parts(*state)))
            self._capture(state, shards, draws)
            self.key = key
            start = 1
        for k in range(start, K):
            shards = [_slice(sb, k) for sb in superbatches]
            out[k].copy_(sh.run(shards, sh.draws(shards, generator), *self.parts))
            self.replays += sum(len(p) for p in self.parts if p is not None)
        return out


def make_train_steps(gnn_cfg: GNNConfig, edge_cfg: EdgeConfig, hyper: TrainHyper, fused_fn=None,
                     mesh=None):
    """``steps(leaves, opt_state, superbatch, generator) -> losses (K,)``: K
    optimizer steps over a (K, B, ...) superbatch, each with the numerics of
    ``make_train_step`` (the JAX ``make_train_steps``, a ``lax.scan`` whose
    body is compiled once). On CUDA tensors one step is captured in a CUDA
    graph and replayed per slice (``GraphedStep``, ``steps.graphed``); on
    CPU tensors it is a loop of the step.

    With ``mesh``: ``steps(replicas, opt_states, superbatches, generator)``
    with ``shard_batch(superbatch, mesh, batch_axis=1)``'s parts; a
    one-entry mesh runs the unsharded steps on its copies (the graph on a
    card), a longer one ``make_train_step(mesh=mesh)``'s step as
    ``ShardedGraphs`` replays on the cards, a loop of it on the CPU
    (``steps.shard_launches``, ``steps.graphed``)."""
    step = make_train_step(gnn_cfg, edge_cfg, hyper, fused_fn)
    graphed = GraphedStep(step)

    def steps(leaves, opt_state, superbatch, generator):
        if leaves[0].is_cuda:
            return graphed((leaves, opt_state), superbatch, generator)
        return torch.stack([step(leaves, opt_state, _slice(superbatch, k), generator)
                            for k in range(_n_slices(superbatch))])

    steps.graphed = graphed
    return _steps_on(steps, mesh, lambda: make_train_step(gnn_cfg, edge_cfg, hyper, fused_fn,
                                                          mesh))


def make_eval_steps(gnn_cfg: GNNConfig, edge_cfg: EdgeConfig, hyper: TrainHyper, fused_fn=None,
                    mesh=None):
    """``evaluate(leaves, superbatch, generator) -> losses (K,)``: K eval
    steps (``make_eval_step``'s) over a (K, B, ...) superbatch; on CUDA
    tensors one captured in a CUDA graph and replayed per slice. With
    ``mesh``: ``evaluate(replicas, superbatches, generator)``, as
    ``make_train_steps``."""
    evaluate = make_eval_step(gnn_cfg, edge_cfg, hyper, fused_fn)
    graphed = GraphedStep(evaluate)

    def steps(leaves, superbatch, generator):
        if leaves[0].is_cuda:
            return graphed((leaves,), superbatch, generator)
        return torch.stack([evaluate(leaves, _slice(superbatch, k), generator)
                            for k in range(_n_slices(superbatch))])

    steps.graphed = graphed
    return _steps_on(steps, mesh, lambda: make_eval_step(gnn_cfg, edge_cfg, hyper, fused_fn,
                                                         mesh))


def _steps_on(steps, mesh, make_sharded):
    """K steps per call for a mesh's calling convention (per-entry lists of
    the state arguments and of the superbatch, then the generator). A
    one-entry mesh runs ``steps`` (the unsharded K steps, the graph on a
    card) on the entry's parts; the sharded step of one entry is the
    unsharded step bit for bit. A longer mesh runs ``make_sharded()``'s
    step: on the cards as its ``ShardedGraphs`` replays, on the CPU as a
    loop. ``graphed``: the graphs (``.replays``; None on a longer CPU mesh);
    ``shard_launches``: each shard's K2 and K3 launches, summed over the
    calls."""
    if mesh is None:
        return steps
    if len(mesh) == 1:
        # ``run`` must not refer to itself: a function in a reference cycle
        # keeps its graphs until Python's collector finds the cycle, which
        # may be during another capture (``_Replay``)
        tallies = launch_tallies(_LAUNCH_COUNTERS, 1)

        def run(*args):
            with count_launches(_LAUNCH_COUNTERS, tallies[0]):
                return steps(*[a[0] for a in args[:-1]], args[-1])

        run.graphed = steps.graphed
        run.shard_launches = tallies
        return run
    sharded = make_sharded()

    def run(*args):
        *state, superbatches, generator = args
        if sharded.graphed is not None:  # every entry a card
            return sharded.graphed(*args)
        return torch.stack([sharded(*state, [_slice(sb, k) for sb in superbatches], generator)
                            for k in range(_n_slices(superbatches[0]))])

    run.graphed = sharded.graphed
    run.shard_launches = sharded.shard_launches
    return run


class DevicePrefetcher:
    """Stages host batches (dicts of numpy arrays) onto the device from a
    background thread: each array is copied into pinned host memory and
    sent on a side CUDA stream, so the copy overlaps the previous step; the
    consumer's stream waits for the copy's event. On the CPU it only wraps
    the arrays as tensors. An exception in the thread is raised in the
    consumer. With ``mesh``, each batch is split along ``batch_axis`` into
    one part per entry (``parallel.mesh.split_batch``), each staged onto its
    own device, and the consumer gets the list of parts. ``starved`` (a
    class attribute): the batches asked for, over every instance, while the
    queue was empty."""

    starved = 0

    def __init__(self, loader, device, depth=2, mesh=None, batch_axis=0):
        self._loader = loader
        self._mesh = None if mesh is None else [torch.device(d) for d in mesh]
        self._devices = self._mesh or [torch.device(device)]
        self._batch_axis = batch_axis
        self._streams = [torch.cuda.Stream(d) if d.type == "cuda" else None
                         for d in self._devices]
        self._q = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _stage(self, batch):
        host = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}
        parts = ([host] if self._mesh is None
                 else split_batch(host, len(self._mesh), self._batch_axis))
        staged = []
        for d, stream, part in zip(self._devices, self._streams, parts):
            if stream is None:
                staged.append((part, None))
                continue
            part = {k: v.pin_memory() for k, v in part.items()}
            with torch.cuda.stream(stream):
                dev = {k: v.to(d, non_blocking=True) for k, v in part.items()}
                done = torch.cuda.Event()
                done.record(stream)
            staged.append((dev, (done, part)))
        return staged

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
        with span("train.batch_wait"):
            try:
                item = self._q.get_nowait()
            except queue.Empty:
                DevicePrefetcher.starved += 1
                item = self._q.get()
        if isinstance(item, Exception):
            raise item
        batches = []
        for d, (batch, pending) in zip(self._devices, item):
            if pending is not None:
                done, _host = pending  # the pinned buffers live until the copy is waited for
                stream = torch.cuda.current_stream(d)
                stream.wait_event(done)
                for v in batch.values():
                    v.record_stream(stream)
            batches.append(batch)
        return batches if self._mesh is not None else batches[0]

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
          out_dir, device="cuda", log_every=50, params=None, resume=False, mesh=None):
    """The training loop: ``hyper.n_epochs`` epochs of ``n_iters_train``
    optimizer steps and ``n_iters_valid`` validation batches each, a metrics
    line (``metrics.jsonl``), a checkpoint (``checkpoints/``) and the loss
    curves per epoch. Loaders yield numpy batch dicts; with ``stack_steps``
    K > 1 they yield (K, B, ...) superbatches, run by ``make_train_steps`` /
    ``make_eval_steps`` (on the card a CUDA graph per step kind). The train
    loss of an epoch is the mean over the logged calls' steps. With
    ``resume``, the latest parameters and optimizer state in ``out_dir`` are
    restored and the epoch count continues. With ``mesh`` (a device list,
    ``parallel.mesh.make_mesh``) each batch is split over its entries and
    every step is data parallel (the module docstring); the run's device is
    ``mesh[0]``. Returns (params, curves)."""
    from adaptigraph_tpu_torch.utils.metrics import MetricsLogger

    if mesh is not None:
        mesh = [torch.device(d) for d in mesh]
        device = mesh[0]
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
        step = make_train_steps(gnn_cfg, edge_cfg, hyper, mesh=mesh)
    else:
        one_step = make_train_step(gnn_cfg, edge_cfg, hyper, mesh=mesh)

        def step(leaves, opt_state, batch, generator):
            return one_step(leaves, opt_state, batch, generator)[None]
    if KV > 1:
        evaluate = make_eval_steps(gnn_cfg, edge_cfg, hyper, mesh=mesh)
    else:
        one_eval = make_eval_step(gnn_cfg, edge_cfg, hyper, mesh=mesh)

        def evaluate(leaves, batch, generator):
            return one_eval(leaves, batch, generator)[None]
    # on a mesh the steps take one copy of the leaves and of the Adam state
    # per entry; the first copies are the ones saved
    if mesh is not None:
        leaves, opt_state = replicate(leaves, mesh), replicate(opt_state, mesh)
    train_stage = DevicePrefetcher(train_loader, device, mesh=mesh, batch_axis=int(K > 1))
    valid_stage = DevicePrefetcher(valid_loader, device, mesh=mesh, batch_axis=int(KV > 1))
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
            saved, saved_state = (leaves, opt_state) if mesh is None else (leaves[0], opt_state[0])
            ckpt.save_checkpoint(out_dir, epoch, params_to_numpy(ckpt.tree_from_leaves(saved)),
                                 {"count": int(saved_state["count"]),
                                  "mu": [t.cpu().numpy() for t in saved_state["mu"]],
                                  "nu": [t.cpu().numpy() for t in saved_state["nu"]]})
            np.savez(os.path.join(out_dir, "loss_curves.npz"),
                     **{k: np.asarray(v) for k, v in curves.items()})
            _plot_curves(curves, out_dir)
            print(f"epoch {epoch}: train {curves['train'][-1]:.6f} valid {curves['valid'][-1]:.6f} "
                  f"({time.time() - t0:.1f}s)")
    finally:
        train_stage.close()
        valid_stage.close()
        metrics.close()
    saved = leaves if mesh is None else leaves[0]
    return ckpt.tree_from_leaves([p.detach() for p in saved]), curves


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
