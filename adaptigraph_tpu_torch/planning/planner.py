"""Sampling-MPC planner, MPPI and gradient-descent variants (counterpart of
``adaptigraph_tpu/planning/planner.py``).

The same injectable structure as the JAX ``Planner``: ``model_rollout_fn``,
``evaluate_traj_fn`` and the sampling, clip and MPPI-update functions, with
a ``torch.Generator`` in place of the key. The ``n_update_iter`` loop runs
on the host; what runs on the card is what the injected model does (the
rope solve's chunks through ``dynamics_rollout_batched``, K1; the
gradient-descent variant through ``dynamics_rollout``, K2 and K3). The
gradient-descent variant runs Adam (``dynamics.train.adam_step``) on
-mean(reward) over the action sequences, differentiating through the model.
"""

import dataclasses
from typing import Any, Callable, Optional

import numpy as np
import torch

from adaptigraph_tpu_torch.dynamics.train import adam_init, adam_step
from adaptigraph_tpu_torch.planning.actions import (clip_actions, optimize_action_mppi,
                                                    sample_action_seq_correlated)


@dataclasses.dataclass
class PlannerConfig:
    """The JAX ``PlannerConfig``'s fields but ``verbose`` (which nothing
    reads there), and the device the action tensors live on."""

    action_dim: int
    model_rollout_fn: Callable  # (state_cur, act_seqs) -> {"state_seqs": ...}
    evaluate_traj_fn: Callable  # (state_seqs, act_seqs, state_cur=) -> {"reward_seqs": ...}
    n_sample: int
    n_look_ahead: int
    n_update_iter: int
    reward_weight: float
    action_lower_lim: Any
    action_upper_lim: Any
    planner_type: str = "MPPI"
    sampling_action_seq_fn: Optional[Callable] = None  # (generator, act_seq, iter_index) -> act_seqs
    clip_action_seq_fn: Optional[Callable] = None
    optimize_action_mppi_fn: Optional[Callable] = None
    noise_level: float = 0.1
    rollout_best: bool = True
    lr: float = 1e-3
    device: str = "cuda"


class Planner:
    def __init__(self, config: PlannerConfig):
        if config.planner_type not in ("MPPI", "GD"):
            raise ValueError(f"planner_type must be MPPI or GD, got {config.planner_type}")
        self.device = torch.device(config.device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Planner: device 'cuda' but no CUDA device is available")
        self.c = config
        lower = torch.as_tensor(config.action_lower_lim, dtype=torch.float32, device=self.device)
        upper = torch.as_tensor(config.action_upper_lim, dtype=torch.float32, device=self.device)
        self.lower, self.upper = lower, upper
        self.sample_fn = config.sampling_action_seq_fn or (
            lambda generator, act_seq, iter_index=0: sample_action_seq_correlated(
                generator, act_seq, lower, upper, config.n_sample, config.noise_level))
        self.clip_fn = config.clip_action_seq_fn or (lambda a: clip_actions(a, lower, upper))
        self.mppi_fn = config.optimize_action_mppi_fn or (
            lambda acts, rewards: optimize_action_mppi(acts, rewards, config.reward_weight,
                                                       lower, upper))

    def trajectory_optimization(self, state_cur, act_seq, generator):
        """Optimise from ``act_seq`` (n_look_ahead, action_dim); returns
        act_seq (the best sequence), best_reward, and with ``rollout_best``
        the model's and the evaluation's outputs for the best sequence."""
        act_seq = torch.as_tensor(act_seq, dtype=torch.float32, device=self.device)
        if self.c.planner_type == "MPPI":
            return self.trajectory_optimization_mppi(state_cur, act_seq, generator)
        return self.trajectory_optimization_gd(state_cur, act_seq, generator)

    def _rollout_best(self, res, state_cur, best):
        if self.c.rollout_best:
            with torch.no_grad():
                bm = self.c.model_rollout_fn(state_cur, best[None])
                be = self.c.evaluate_traj_fn(bm["state_seqs"], best[None], state_cur=state_cur)
            res["best_model_output"] = bm
            res["best_eval_output"] = be
        return res

    @torch.no_grad()
    def trajectory_optimization_mppi(self, state_cur, act_seq, generator):
        """n_update_iter x {sample, rollout, evaluate, MPPI update}, tracking
        the best sampled sequence across iterations."""
        c = self.c
        best_act_seq = None
        best_reward = None
        for i in range(c.n_update_iter):
            act_seqs = self.sample_fn(generator, act_seq, iter_index=i)
            model_out = c.model_rollout_fn(state_cur, act_seqs)
            reward_seqs = c.evaluate_traj_fn(model_out["state_seqs"], act_seqs,
                                             state_cur=state_cur)["reward_seqs"]
            act_seq = self.mppi_fn(act_seqs, reward_seqs)
            idx = torch.argmax(reward_seqs)
            it_best = reward_seqs[idx]
            if best_act_seq is None or bool(it_best > best_reward):
                best_reward = it_best
                best_act_seq = act_seqs[idx]
        res = {"act_seq": best_act_seq, "best_reward": best_reward,
               "best_model_output": None, "best_eval_output": None}
        return self._rollout_best(res, state_cur, best_act_seq)

    def trajectory_optimization_gd(self, state_cur, act_seq, generator):
        """Adam on -mean(reward) through the differentiable model, each step
        followed by the clip; then the samples' rewards and the best."""
        c = self.c
        with torch.no_grad():
            act_seqs = self.sample_fn(generator, act_seq, iter_index=0)
        act_seqs = act_seqs.detach().clone().requires_grad_(True)
        opt_state = adam_init([act_seqs])
        for _ in range(c.n_update_iter):
            out = c.model_rollout_fn(state_cur, act_seqs)
            ev = c.evaluate_traj_fn(out["state_seqs"], act_seqs, state_cur=state_cur)
            grad, = torch.autograd.grad(-torch.mean(ev["reward_seqs"]), act_seqs)
            adam_step([act_seqs], [grad], opt_state, c.lr)
            with torch.no_grad():
                act_seqs.copy_(self.clip_fn(act_seqs))
        act_seqs = act_seqs.detach()
        with torch.no_grad():
            out = c.model_rollout_fn(state_cur, act_seqs)
            rewards = c.evaluate_traj_fn(out["state_seqs"], act_seqs,
                                         state_cur=state_cur)["reward_seqs"]
        idx = torch.argmax(rewards)
        best = act_seqs[idx]
        res = {"act_seq": best, "best_reward": rewards[idx],
               "best_model_output": None, "best_eval_output": None}
        return self._rollout_best(res, state_cur, best)

    @staticmethod
    def merge_res(res_list):
        """The result whose best sequence's re-rolled-out reward is highest."""
        rewards = [float(torch.as_tensor(r["best_eval_output"]["reward_seqs"]).mean())
                   for r in res_list]
        return res_list[int(np.argmax(rewards))]
