"""MPPI solve on one device or sharded over a device list (counterpart of
``adaptigraph_tpu/planning/mppi_solve.py``).

One solve iteration samples ``n_sample`` action sequences, orders them by
their summed push repeats, rolls them out ``n_sample_chunk`` at a time
through ``dynamics_rollout_batched`` (on CUDA, for edge policy ``none`` one
rollout-kernel launch per chunk and look-ahead step; for the tool policies,
cloth, one single-step-forward launch per chunk and substep, each chunk's
substep counts read on the host once per iteration, before the chunk loop),
scores each chunk with the reward, and applies the softmax update and
argmax. The best sequence is tracked on the device.

With a ``mesh`` (``parallel/mesh.py``: a list of devices) the samples are
drawn once on ``mesh[0]`` from the caller's generator and sorted, and whole
chunks are dealt round-robin: chunk c goes to shard c % n, as the JAX
``sort_by_repeat(interleave=n)`` deals them, so each shard gets an even
spread of push lengths. Each shard rolls out and scores its chunks on its
device and its own stream, with the weights and the state copied there;
the chunks are issued round-robin over the shards and nothing in the chunk
loop waits on the host, so the shards run at once (``shard_rewards``).
Rewards and final states are gathered onto ``mesh[0]`` in chunk order,
where the update and argmax run. A chunk's members and its place in the
sample order do not change under the deal, so the sharded solve equals the
unsharded one bit for bit. (JAX permutes the samples into the dealt order,
so its MPPI average sums in another order than its unsharded solve's; the
port keeps the unsharded order.) Without a mesh the solve is this one on the
single device ``[device]``, on the caller's stream.

Spans (``utils/profiling.py::span``, recorded only under ``torch.profiler``):
``mppi.solve`` the whole solve; ``mppi.inputs`` the state, action and
physics copies to the device; ``mppi.weights`` the parameter dict's copy to
the kernel's weight list; ``mppi.sample``; ``mppi.sort``; ``mppi.chunk``
each chunk, with ``mppi.reward`` its reward (and, in the rollout,
``k1.inputs`` and ``k1.launch``); ``mppi.update`` the softmax update;
``mppi.best`` the argmax and the best row's gather. All but ``mppi.solve``,
``mppi.chunk`` and ``k1.launch`` take stream time too.
"""

import dataclasses
from typing import Callable

import torch

from adaptigraph_tpu_torch.ops.fused_gnn import (fused_rollout_chunk, gnn_forward,
                                                 gnn_forward_edges, weight_list)
from adaptigraph_tpu_torch.parallel.mesh import launch_tallies, run_shards, shard_streams
from adaptigraph_tpu_torch.planning.actions import (decode_action, optimize_action_mppi,
                                                    sample_action_seq)
from adaptigraph_tpu_torch.planning.forward import (DynamicsConfig, dynamics_rollout_batched,
                                                    substep_counts)
from adaptigraph_tpu_torch.utils.profiling import span


@dataclasses.dataclass(frozen=True)
class MPPIConfig:
    """Solve budget (same fields as the JAX ``MPPIConfig``)."""

    n_sample: int = 20000
    n_sample_chunk: int = 2000
    n_look_ahead: int = 1
    n_update_iter: int = 1
    reward_weight: float = 500.0
    noise_level: float = 1.0
    push_length: float = 0.1


def sort_by_repeat(act_seqs, push_length):
    """Order samples by their summed push repeats, so that each chunk holds
    pushes of similar length. The sort is stable: the sums take few distinct
    values, and the per-chunk reward normalisation makes chunk membership
    matter, so ties keep the sampled order as ``jnp.argsort`` does."""
    _, repeat = decode_action(act_seqs, push_length)
    order = torch.argsort(repeat.sum(dim=1), stable=True)
    return act_seqs[order]


# the kernel wrappers whose launch counters a sharded solve reads around each
# shard's chunks (K1, K2e, K2)
_LAUNCH_COUNTERS = (fused_rollout_chunk, gnn_forward_edges, gnn_forward)


def shard_rewards(chunk_fn, mesh, streams, tallies, shared, act_seqs, n_chunks, counts):
    """One iteration's chunk loop over ``mesh``: the sorted ``act_seqs``
    dealt in ``n_chunks`` chunks (chunk c to shard c % n), each shard's
    copies of ``shared`` (the weights, the state and the physics parameter,
    on ``mesh[0]``) made on its device, then ``chunk_fn(weights, state,
    chunk, physics, count)`` for every chunk, issued round-robin over the
    shards, all through one ``run_shards`` (each on its shard's stream,
    ``streams``, None: the device's current one; its launches added to
    ``tallies``); ``counts[c]`` is chunk c's substep counts (None each for
    the kernel's whole pushes). Nothing here waits on the host. Returns the
    rewards and final states on ``mesh[0]``, in chunk order."""
    n = len(mesh)
    dealt = act_seqs.reshape(n_chunks // n, n, -1, *act_seqs.shape[1:])
    inputs = [None] * n

    def load(s, weights, state, physics, acts):  # shard s's own copies
        d = mesh[s]
        inputs[s] = ([t.to(d, copy=s > 0) for t in weights], state.to(d, copy=s > 0),
                     physics.to(d, copy=s > 0), acts.to(d))

    def rewards(s, j, count):  # chunk j * n + s, on shard s
        weights, state, physics, acts = inputs[s]
        return chunk_fn(weights, state, acts[j], physics, count)

    work = [(s, load, (s, *shared, dealt[:, s])) for s in range(n)]
    work += [(c % n, rewards, (c % n, c // n, counts[c])) for c in range(n_chunks)]
    out = run_shards(mesh, streams, work, _LAUNCH_COUNTERS, tallies)[n:]
    rewards, finals = zip(*out)
    return torch.cat(rewards), torch.cat(finals)


def make_mppi_solver(dcfg: DynamicsConfig, mcfg: MPPIConfig, reward_fn: Callable, lower, upper,
                     device="cuda", compute_dtype=torch.bfloat16, mesh=None):
    """Build ``solve(params, state_cur, act_seq, generator, physics_param)``.

    ``reward_fn(state_seqs, act_seqs, state_cur)`` scores one chunk on the
    chunk's device. The solve runs ``n_update_iter`` iterations and returns
    the last MPPI sequence and the best sampled sequence, its reward and its
    final state, all on ``device``. ``generator`` is a ``torch.Generator`` on
    ``device``. With ``mesh`` the chunks are sharded over its devices and
    ``device`` is ``mesh[0]``; ``n_sample / n_sample_chunk`` must divide
    evenly over the entries.
    ``solve.shard_launches`` holds, per shard (one without a mesh), the
    launches of each kernel wrapper (``_LAUNCH_COUNTERS``' names) its chunks
    made, summed over the solves.
    """
    sharded = mesh is not None
    mesh = [torch.device(d) for d in (mesh or [device])]
    device = mesh[0]
    for d in mesh:
        if d.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"make_mppi_solver: device {d} but no CUDA device is available")
    lower = torch.as_tensor(lower, dtype=torch.float32, device=device)
    upper = torch.as_tensor(upper, dtype=torch.float32, device=device)
    n_chunks = mcfg.n_sample // mcfg.n_sample_chunk
    chunk = mcfg.n_sample_chunk
    n = len(mesh)
    if n_chunks * chunk != mcfg.n_sample:
        raise ValueError(f"n_sample {mcfg.n_sample} is not a multiple of "
                         f"n_sample_chunk {chunk}")
    if n_chunks % n:
        raise ValueError(f"{n_chunks} chunks do not divide evenly over {n} devices")

    per_substep = dcfg.edge.policy != "none"  # the tool policies: K2 per substep
    streams = shard_streams(mesh) if sharded else [None]

    def chunk_rewards(weights, state_cur, act_chunk, physics_param, count):
        with span("mppi.chunk"):
            out = dynamics_rollout_batched(weights, state_cur, act_chunk, physics_param, dcfg,
                                           compute_dtype=compute_dtype, n_substeps=count)
            with span("mppi.reward", stream=state_cur.device):
                rewards = reward_fn(out["state_seqs"], act_chunk, state_cur)
            return rewards, out["state_seqs"][:, -1]

    def all_rewards(weights, state_cur, act_seqs, physics_param):
        with span("mppi.sort", stream=device):
            act_seqs = sort_by_repeat(act_seqs, mcfg.push_length)
        counts = [None] * n_chunks
        if per_substep:  # every chunk's substeps per look-ahead step: one host read
            _, repeat = decode_action(act_seqs, mcfg.push_length)
            counts = substep_counts(repeat.reshape(n_chunks, chunk, -1).transpose(1, 2),
                                    dcfg.max_repeat)
        rewards, finals = shard_rewards(chunk_rewards, mesh, streams, solve.shard_launches,
                                        (weights, state_cur, physics_param), act_seqs, n_chunks,
                                        counts)
        return act_seqs, rewards, finals

    def solve_iter(weights, state_cur, act_seq, generator, physics_param, iter_index):
        with span("mppi.sample", stream=device):
            act_seqs = sample_action_seq(generator, act_seq, lower, upper, mcfg.n_sample,
                                         iter_index=iter_index, noise_level=mcfg.noise_level,
                                         push_length=mcfg.push_length)
        act_seqs, rewards, finals = all_rewards(weights, state_cur, act_seqs, physics_param)
        with span("mppi.update", stream=device):
            new_seq = optimize_action_mppi(act_seqs, rewards, mcfg.reward_weight, lower, upper,
                                           mcfg.push_length)
        with span("mppi.best", stream=device):
            best = torch.argmax(rewards)[None]  # a tensor index: no host read
            return new_seq, act_seqs[best][0], rewards[best][0], finals[best][0]

    def solve(params, state_cur, act_seq, generator, physics_param):
        with span("mppi.solve"):
            if isinstance(params, (list, tuple)):
                weights = params
            else:
                with span("mppi.weights", stream=device):
                    weights = weight_list(params, dcfg.gnn, compute_dtype)
            with span("mppi.inputs", stream=device):
                state_cur = torch.as_tensor(state_cur, dtype=torch.float32, device=device)
                act_seq = torch.as_tensor(act_seq, dtype=torch.float32, device=device)
                physics_param = torch.as_tensor(physics_param, dtype=torch.float32,
                                                device=device)
            best_seq = best_reward = best_final = None
            for i in range(mcfg.n_update_iter):
                act_seq, it_seq, it_reward, it_final = solve_iter(
                    weights, state_cur, act_seq, generator, physics_param, min(i, 1))
                if best_seq is None:
                    best_seq, best_reward, best_final = it_seq, it_reward, it_final
                else:
                    with span("mppi.best", stream=device):
                        better = it_reward > best_reward
                        best_seq = torch.where(better, it_seq, best_seq)
                        best_final = torch.where(better, it_final, best_final)
                        best_reward = torch.maximum(it_reward, best_reward)
        return {"act_seq": best_seq, "mppi_seq": act_seq, "best_reward": best_reward,
                "best_final_state": best_final}

    solve.shard_launches = launch_tallies(_LAUNCH_COUNTERS, n)
    return solve
