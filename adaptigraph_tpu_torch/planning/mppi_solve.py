"""MPPI solve on one device or sharded over a device list (counterpart of
``adaptigraph_tpu/planning/mppi_solve.py``).

One solve iteration samples ``n_sample`` action sequences, orders them by
their summed push repeats, rolls them out ``n_sample_chunk`` at a time
through ``dynamics_rollout_batched`` (on CUDA, for edge policy ``none`` one
rollout-kernel launch per chunk and look-ahead step; for the tool policies,
cloth, one single-step-forward launch per chunk and substep, with one host
read of the chunk's largest repeat per look-ahead step), scores each chunk
with the reward, and applies the softmax update and argmax. The best
sequence is tracked on the device.

With a ``mesh`` (``parallel/mesh.py``: a list of devices) the samples are
drawn once on ``mesh[0]`` from the caller's generator and sorted, and whole
chunks are dealt round-robin: chunk c goes to shard c % n, as the JAX
``sort_by_repeat(interleave=n)`` deals them, so each shard gets an even
spread of push lengths. Each shard rolls out and scores its chunks on its
device, with the weights and the state copied there; the launches go
round-robin over the shards, so that separate cards run at once. Rewards and
final states are gathered onto ``mesh[0]`` in chunk order, where the update
and argmax run. A chunk's members and its place in the sample order do not
change under the deal, so the sharded solve equals the unsharded one bit for
bit. (JAX permutes the samples into the dealt order, so its MPPI average
sums in another order than its unsharded solve's; the port keeps the
unsharded order.) Without a mesh the solve is this one on the single
device ``[device]``.
"""

import dataclasses
from typing import Callable

import torch

from adaptigraph_tpu_torch.ops.fused_gnn import (fused_rollout_chunk, gnn_forward,
                                                 gnn_forward_edges, weight_list)
from adaptigraph_tpu_torch.parallel.mesh import (count_launches, device_scope,
                                                 launch_tallies)
from adaptigraph_tpu_torch.planning.actions import (decode_action, optimize_action_mppi,
                                                    sample_action_seq)
from adaptigraph_tpu_torch.planning.forward import DynamicsConfig, dynamics_rollout_batched


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

    def chunk_rewards(weights, state_cur, act_chunk, physics_param):
        out = dynamics_rollout_batched(weights, state_cur, act_chunk, physics_param, dcfg,
                                       compute_dtype=compute_dtype)
        return reward_fn(out["state_seqs"], act_chunk, state_cur), out["state_seqs"][:, -1]

    def all_rewards(weights, state_cur, act_seqs, physics_param):
        act_seqs = sort_by_repeat(act_seqs, mcfg.push_length)
        # chunk c to shard c % n: shard s holds chunks s, s + n, s + 2n, ...
        dealt = act_seqs.reshape(n_chunks // n, n, chunk, *act_seqs.shape[1:])
        shards = []
        for s, d in enumerate(mesh):  # each shard's inputs on its device, its own copies
            with device_scope(d):
                shards.append(([w.to(d, copy=s > 0) for w in weights],
                               state_cur.to(d, copy=s > 0), physics_param.to(d, copy=s > 0),
                               dealt[:, s].to(d)))
        out = []
        for j in range(n_chunks // n):  # round-robin: chunk j * n + s on shard s
            for d, (w, st, ph, acts), tally in zip(mesh, shards, solve.shard_launches):
                with device_scope(d), count_launches(_LAUNCH_COUNTERS, tally):
                    out.append(chunk_rewards(w, st, acts[j], ph))
        rewards, finals = zip(*out)  # in chunk order
        return (act_seqs, torch.cat([r.to(device) for r in rewards]),
                torch.cat([f.to(device) for f in finals]))

    def solve_iter(weights, state_cur, act_seq, generator, physics_param, iter_index):
        act_seqs = sample_action_seq(generator, act_seq, lower, upper, mcfg.n_sample,
                                     iter_index=iter_index, noise_level=mcfg.noise_level,
                                     push_length=mcfg.push_length)
        act_seqs, rewards, finals = all_rewards(weights, state_cur, act_seqs, physics_param)
        new_seq = optimize_action_mppi(act_seqs, rewards, mcfg.reward_weight, lower, upper,
                                       mcfg.push_length)
        best = torch.argmax(rewards)
        return new_seq, act_seqs[best], rewards[best], finals[best]

    def solve(params, state_cur, act_seq, generator, physics_param):
        weights = (params if isinstance(params, (list, tuple))
                   else weight_list(params, dcfg.gnn, compute_dtype))
        state_cur = torch.as_tensor(state_cur, dtype=torch.float32, device=device)
        act_seq = torch.as_tensor(act_seq, dtype=torch.float32, device=device)
        physics_param = torch.as_tensor(physics_param, dtype=torch.float32, device=device)
        best_seq = best_reward = best_final = None
        for i in range(mcfg.n_update_iter):
            act_seq, it_seq, it_reward, it_final = solve_iter(
                weights, state_cur, act_seq, generator, physics_param, min(i, 1))
            if best_seq is None:
                best_seq, best_reward, best_final = it_seq, it_reward, it_final
            else:
                better = it_reward > best_reward
                best_seq = torch.where(better, it_seq, best_seq)
                best_final = torch.where(better, it_final, best_final)
                best_reward = torch.maximum(it_reward, best_reward)
        return {"act_seq": best_seq, "mppi_seq": act_seq, "best_reward": best_reward,
                "best_final_state": best_final}

    solve.shard_launches = launch_tallies(_LAUNCH_COUNTERS, n)
    return solve
