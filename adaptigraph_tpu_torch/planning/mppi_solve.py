"""MPPI solve on one device (counterpart of ``adaptigraph_tpu/planning/mppi_solve.py``).

One solve iteration samples ``n_sample`` action sequences, orders them by
their summed push repeats, rolls them out ``n_sample_chunk`` at a time
through ``dynamics_rollout_batched`` (on CUDA, for edge policy ``none`` one
rollout-kernel launch per chunk and look-ahead step; for the tool policies,
cloth, one single-step-forward launch per chunk and substep, with one host
read of the chunk's largest repeat per look-ahead step), scores each chunk
with the reward, and applies the softmax update and argmax. The best
sequence is tracked on the device.
"""

import dataclasses
from typing import Callable

import torch

from adaptigraph_tpu_torch.ops.fused_gnn import weight_list
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


def make_mppi_solver(dcfg: DynamicsConfig, mcfg: MPPIConfig, reward_fn: Callable, lower, upper,
                     device="cuda", compute_dtype=torch.bfloat16):
    """Build ``solve(params, state_cur, act_seq, generator, physics_param)``.

    ``reward_fn(state_seqs, act_seqs, state_cur)`` scores one chunk. The solve
    runs ``n_update_iter`` iterations and returns the last MPPI sequence and
    the best sampled sequence, its reward and its final state, all on
    ``device``. ``generator`` is a ``torch.Generator`` on ``device``.
    """
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("make_mppi_solver: device='cuda' but no CUDA device is available")
    lower = torch.as_tensor(lower, dtype=torch.float32, device=device)
    upper = torch.as_tensor(upper, dtype=torch.float32, device=device)
    n_chunks = mcfg.n_sample // mcfg.n_sample_chunk
    if n_chunks * mcfg.n_sample_chunk != mcfg.n_sample:
        raise ValueError(f"n_sample {mcfg.n_sample} is not a multiple of "
                         f"n_sample_chunk {mcfg.n_sample_chunk}")

    def all_rewards(weights, state_cur, act_seqs, physics_param):
        act_seqs = sort_by_repeat(act_seqs, mcfg.push_length)
        rewards, finals = [], []
        for c in range(n_chunks):
            chunk = act_seqs[c * mcfg.n_sample_chunk:(c + 1) * mcfg.n_sample_chunk]
            out = dynamics_rollout_batched(weights, state_cur, chunk, physics_param, dcfg,
                                           compute_dtype=compute_dtype)
            rewards.append(reward_fn(out["state_seqs"], chunk, state_cur))
            finals.append(out["state_seqs"][:, -1])
        return act_seqs, torch.cat(rewards), torch.cat(finals)

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

    return solve
