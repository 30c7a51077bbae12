"""Closed-loop MPC: perceive -> plan (MPPI) -> act -> adapt (counterpart of
``adaptigraph_tpu/planning/closed_loop.py``).

``run_plan`` drives a target-driven loop and ``run_random_interact`` an
exploration loop for system identification, both against the environment
contract of ``realworld.env.SimRealEnv``. Per executed push: perception
(numpy, on the host), one MPPI solve (``mppi_solve``; on the card one
rollout-kernel launch per chunk and look-ahead step), the push in the
environment, and with adaptation on one physics-parameter estimate
(``physics_optimizer``; one masked rollout-kernel launch per evaluated
population). Randomness of the solve comes from one ``torch.Generator`` on
the run's device seeded from ``seed`` (the JAX loop splits a ``PRNGKey``);
the loop's numpy ``RandomState`` is drawn in the JAX loop's order.
"""

import dataclasses
import glob
import os
import time

import numpy as np
import torch

from adaptigraph_tpu_torch.ops.costs import (bbox_penalty, box_loss, chamfer, cloth_penalty,
                                             granular_penalty, rope_penalty)
from adaptigraph_tpu_torch.planning.actions import decode_action
from adaptigraph_tpu_torch.planning.forward import DynamicsConfig
from adaptigraph_tpu_torch.planning.mppi_solve import MPPIConfig, make_mppi_solver
from adaptigraph_tpu_torch.planning.physics_optimizer import PhysicsParamOnlineOptimizer
from adaptigraph_tpu_torch.realworld.perception import (EmptyPerceptionError, PerceptionModule,
                                                        get_state_cur)

PENALTIES = {"rope": rope_penalty, "cloth": cloth_penalty,
             "granular": granular_penalty, "none": None}


@dataclasses.dataclass
class TaskConfig:
    """Planning task settings (the JAX fields but ``use_fused``: CUDA tensors
    always take the kernels)."""

    dcfg: DynamicsConfig
    mcfg: MPPIConfig
    action_lower_lim: np.ndarray
    action_upper_lim: np.ndarray
    n_actions: int = 10
    penalty_type: str = "rope"
    target_type: str = "pcd"  # or "box"
    fps_radius: float = 0.2
    sim_real_ratio: float = 10.0
    workspace_bbox: np.ndarray = None  # (2, 2) sim-frame [x, z] bounds
    ppo_iterations: int = 50
    # perception
    use_raw: bool = True         # depth-threshold-only perception per MPC step;
                                 # False runs the PerceptionModule mask_fn and
                                 # the voxel/outlier passes
    k_filter: float = 1.0        # z-percentile keep fraction
    obj_list: tuple = ()         # open-vocabulary detector prompts
    max_n: int = 1               # object instances in the perceived state
    target_path: str = None      # default target point cloud (task_config.target)
    # hardware tier
    clipping_height: float = None  # min z of the pusher finger vs the table
    rotate_pusher: bool = False    # re-orient the board pusher along the push
    # end-game guard (opt-in, ``plan --verify``): execute only a push whose
    # predicted final error improves on the current error; re-solve from a
    # fresh uniform warm start up to verify_retries times, and stop the loop
    # when no improving push exists while the error already sits at its best
    verify_improvement: bool = False
    verify_retries: int = 2
    min_pred_improvement: float = 0.0
    converge_tolerance: float = 0.02


def make_reward_fn(task: TaskConfig, target, device="cuda"):
    """reward = -normalised final error - 5 * mean collision penalty
    - 5 * mean workspace penalty. The error is normalised by 2/max within
    each scored batch (one MPPI chunk). The target and the workspace box
    are made on ``device`` and copied once to any other device whose chunks
    are scored (the shards of a sharded solve)."""
    penalty = PENALTIES[task.penalty_type]
    bbox = (torch.as_tensor(task.workspace_bbox, dtype=torch.float32, device=device)
            if task.workspace_bbox is not None else None)
    target = torch.as_tensor(target, dtype=torch.float32, device=device)
    on_device = {target.device: (target, bbox)}

    def reward_fn(state_seqs, act_seqs, state_cur):
        dev = state_seqs.device
        if dev not in on_device:
            on_device[dev] = (target.to(dev), bbox.to(dev) if bbox is not None else None)
        target_d, bbox_d = on_device[dev]
        B = state_seqs.shape[0]
        final = state_seqs[:, -1]
        if task.target_type == "box":
            error = box_loss(final, target_d)
        else:
            error = chamfer(final, target_d[None].expand(B, *target_d.shape))
        error_weight = 2.0 / (error.max() + 1e-6)
        r = -error_weight * error
        if penalty is not None:
            r = r - 5.0 * penalty(state_seqs, act_seqs, state_cur).mean(dim=1)
        if bbox_d is not None:
            r = r - 5.0 * bbox_penalty(state_seqs, bbox_d).mean(dim=1)
        return r

    return reward_fn


def sim_action_to_board(action, sim_real_ratio):
    """Sim push (x0, z0, theta, length) -> board-frame [x0, y0, x1, y1]: the
    decoded start and the end after ``length`` sub-pushes of 0.1."""
    decoded, _ = decode_action(torch.as_tensor(np.asarray(action, np.float32))[None],
                               push_length=0.1)
    x0, z0, x1, z1 = decoded[0].numpy()
    rep = float(action[3])
    # full push = repeat sub-pushes of push_length along theta
    dx, dz = (x1 - x0) * rep, (z1 - z0) * rep
    r = sim_real_ratio
    return np.array([x0 / r, z0 / r, (x0 + dx) / r, (z0 + dz) / r], np.float32)


def _pad_state(state, max_nobj):
    """Zero-pad a perceived state to ``max_nobj`` rows, as the JAX loop does:
    the solve treats every row as an object."""
    s = np.zeros((max_nobj, 3), np.float32)
    n = min(len(state), max_nobj)
    s[:n] = state[:n]
    return s, n


def _compute_dtype(device):
    """The solve and the estimate follow the device, as ``demo-ppo`` does:
    bfloat16 through the kernel on the card, float32 on the CPU."""
    return torch.bfloat16 if torch.device(device).type == "cuda" else torch.float32


def _host(t):
    return t.float().cpu().numpy()


def _make_perceive(env, pm, task: TaskConfig, rng, state_fn):
    def perceive():
        if state_fn is not None:
            return np.asarray(state_fn(), np.float32)
        st, _ = get_state_cur(env, pm, fps_radius=task.fps_radius,
                              sim_real_ratio=task.sim_real_ratio,
                              max_nobj=task.dcfg.gnn.max_nobj, use_raw=task.use_raw, rng=rng)
        return st

    return perceive


def _mid_action_seq(task: TaskConfig, device):
    mid = (np.asarray(task.action_lower_lim) + np.asarray(task.action_upper_lim)) / 2.0
    return torch.as_tensor(np.asarray(mid, np.float32), device=device)[None].repeat(
        task.mcfg.n_look_ahead, 1)


def run_plan(env, params, task: TaskConfig, target, pm: PerceptionModule = None,
             save_dir=None, seed=0, use_ppo=True, verbose=True, state_fn=None, resume=False,
             true_phys=None, phys_override=None, ppo_warmup=0, device="cuda", mesh=None):
    """Target-driven closed loop.

    env: an environment with ``SimRealEnv``'s contract. params: the nested
    parameter dict on ``device``. target: (n, 3) sim-frame point cloud (pcd
    target) or (2, 2) box. state_fn: optional override returning the current
    sim-frame state (default: camera perception). resume: re-hydrate the
    step history and recorded interactions from ``save_dir`` and run the
    remaining actions.

    true_phys: the scene's true normalised physics parameter, recorded in
    ``initial.npz`` and the history, never given to the planner.
    phys_override: plan with this fixed parameter instead of 0.5 when
    adaptation is off. ppo_warmup: execute this many uniformly random pushes
    before the MPC loop, recorded as interactions for the estimate.
    mesh: a device list (``parallel.mesh.make_mesh``) over which each
    solve's sample budget is sharded; the run's device is then ``mesh[0]``.

    Returns a dict with the per-step errors, actions and estimates, the
    initial error and the final estimate.
    """
    device = torch.device(mesh[0] if mesh is not None else device)
    cd = _compute_dtype(device)
    pm = pm or PerceptionModule(stride=2)
    rng = np.random.RandomState(seed)
    generator = torch.Generator(device=device)
    generator.manual_seed(seed)
    max_nobj = task.dcfg.gnn.max_nobj

    reward_fn = make_reward_fn(task, target, device)
    solve = make_mppi_solver(task.dcfg, task.mcfg, reward_fn, task.action_lower_lim,
                             task.action_upper_lim, device=device, compute_dtype=cd, mesh=mesh)
    ppo = PhysicsParamOnlineOptimizer(
        task.dcfg, params, phys_dim=task.dcfg.gnn.phys_dim, save_dir=save_dir, seed=seed,
        device=device, compute_dtype=cd) if use_ppo else None
    if true_phys is not None:
        true_phys = np.asarray(true_phys, np.float32)
    if phys_override is not None:
        phys_override = np.asarray(phys_override, np.float32)

    start_step = 0
    if resume and save_dir and os.path.isdir(save_dir):
        start_step = len(glob.glob(os.path.join(save_dir, "step_*.npz")))
        if ppo is not None and start_step:
            ppo.load_interactions(save_dir)
            if ppo._interactions:  # the earlier run may have had adaptation off
                est, _, _ = ppo.optimize(start_step - 1, iterations=task.ppo_iterations)
                if verbose:
                    print(f"resumed at step {start_step}, physics estimate {est}")

    perceive = _make_perceive(env, pm, task, rng, state_fn)
    target_t = torch.as_tensor(np.asarray(target, np.float32), device=device)

    def error_to_target(state):
        state = torch.as_tensor(np.asarray(state, np.float32), device=device)[None]
        if task.target_type == "box":
            return float(box_loss(state, target_t)[0])
        return float(chamfer(state, target_t[None])[0])

    def execute(board_act):
        if task.dcfg.gripper_enable and hasattr(env, "step_gripper"):
            env.step_gripper(board_act)  # grasp primitive
        else:
            env.step(board_act)

    if ppo_warmup > 0 and start_step == 0 and (ppo is None or not ppo._interactions):
        # excitation pushes, recorded as interactions only (not plan steps);
        # they execute with adaptation off too, so that matched-seed arms
        # plan from the same scene. state_pred is a placeholder: the fit
        # recomputes its predictions per candidate
        for w in range(ppo_warmup):
            try:
                st = perceive()
            except EmptyPerceptionError:
                break
            wact = rng.uniform(np.asarray(task.action_lower_lim),
                               np.asarray(task.action_upper_lim)).astype(np.float32)
            execute(sim_action_to_board(wact, task.sim_real_ratio))
            try:
                st_next = perceive()
            except EmptyPerceptionError:
                break
            if ppo is not None:
                ppo.add_interaction(wact, st, st, st_next)
            if verbose:
                print(f"warmup {w}: excitation push" + (" recorded" if ppo is not None else ""))

    act_seq = _mid_action_seq(task, device)
    history = {"errors": [], "actions": [], "phys": []}
    if start_step:
        steps = sorted(glob.glob(os.path.join(save_dir, "step_*.npz")))[:start_step]
        for i, f in enumerate(steps):
            with np.load(f) as d:
                history["errors"].append(float(d["error"]))
                history["actions"].append(d["act"])
            pf = os.path.join(save_dir, f"ppo_{i}.npz")
            if ppo is not None and os.path.exists(pf):
                with np.load(pf) as d:
                    history["phys"].append(d["physics_param"])
        ifile = os.path.join(save_dir, "initial.npz")
        if os.path.exists(ifile):
            with np.load(ifile) as d:
                history["initial_error"] = float(d["error"])
    for i in range(start_step, task.n_actions):
        t0 = time.time()
        try:
            state_raw = perceive()
        except EmptyPerceptionError as e:
            # the object left the workspace: stop with what we have
            if verbose:
                print(f"step {i}: aborting MPC loop — {e}")
            break
        state_pad, n_obj = _pad_state(state_raw, max_nobj)
        if ppo is not None:
            phys = ppo.physics_param
        elif phys_override is not None:
            phys = phys_override  # a fixed-parameter arm plans with a known parameter
        else:
            phys = np.full((task.dcfg.gnn.phys_dim,), 0.5, np.float32)

        cur_err = error_to_target(state_raw)
        if i == 0:
            history["initial_error"] = cur_err
            if true_phys is not None:
                history["true_phys"] = true_phys
            if save_dir:
                os.makedirs(save_dir, exist_ok=True)
                np.savez(os.path.join(save_dir, "initial.npz"), error=cur_err, state=state_raw,
                         **({"true_phys": true_phys} if true_phys is not None else {}))

        res = solve(params, state_pad, act_seq, generator, phys)
        if task.verify_improvement:
            # execute only a push whose predicted outcome improves on the
            # current error; otherwise re-solve from a fresh uniform warm start
            pred_err = error_to_target(_host(res["best_final_state"])[:n_obj])
            retries = 0
            while (pred_err >= cur_err - task.min_pred_improvement
                   and retries < task.verify_retries):
                fresh_seq = rng.uniform(task.action_lower_lim, task.action_upper_lim,
                                        size=(task.mcfg.n_look_ahead,
                                              len(task.action_lower_lim))).astype(np.float32)
                res2 = solve(params, state_pad, fresh_seq, generator, phys)
                pred_err2 = error_to_target(_host(res2["best_final_state"])[:n_obj])
                if pred_err2 < pred_err:
                    res, pred_err = res2, pred_err2
                retries += 1
            best_so_far = min(history["errors"], default=np.inf)
            if (np.isfinite(best_so_far)
                    and pred_err >= cur_err - task.min_pred_improvement
                    and cur_err <= best_so_far + task.converge_tolerance):
                # no improving push exists and the error sits at its best
                if verbose:
                    print(f"step {i}: converged (cur {cur_err:.4f}, predicted "
                          f"{pred_err:.4f} would not improve) — stopping")
                # history["errors"] holds only post-push errors, one per action
                history["converged_error"] = cur_err
                break
        best_act = _host(res["act_seq"])
        act_seq = res["mppi_seq"]  # receding-horizon warm start
        # the model's prediction for the executed push
        pred_state = _host(res["best_final_state"])[:n_obj]
        pred_err = error_to_target(pred_state)

        first_act = best_act[0] if best_act.ndim == 2 else best_act
        execute(sim_action_to_board(first_act, task.sim_real_ratio))

        state_next = perceive()
        err = error_to_target(state_next)
        history["errors"].append(err)
        history["actions"].append(best_act)
        if verbose:
            print(f"step {i}: error {err:.4f} (predicted {pred_err:.4f}, "
                  f"{time.time() - t0:.1f}s)")

        if ppo is not None:
            ppo.add_interaction(first_act, state_raw, pred_state, state_next)
            est, _, _ = ppo.optimize(i, iterations=task.ppo_iterations)
            history["phys"].append(est.copy())
            if verbose:
                print(f"  physics estimate -> {est}"
                      + (f" (true {true_phys})" if true_phys is not None else ""))

        if save_dir:
            os.makedirs(save_dir, exist_ok=True)
            np.savez(os.path.join(save_dir, f"step_{i:03d}.npz"), act=best_act, state=state_raw,
                     state_next=state_next, error=err, pred_error=pred_err,
                     pred_state=pred_state)
    history["final_phys"] = ppo.physics_param.copy() if ppo is not None else None
    return history


def run_random_interact(env, params, task: TaskConfig, pm=None, save_dir=None, seed=0,
                        n_actions=20, verbose=True, state_fn=None, resume=False, device="cuda"):
    """Exploration loop for system identification: each push maximises the
    predicted state change (Chamfer distance between the predicted final and
    the current state, less the collision penalty) and is recorded as an
    interaction. Returns the ``PhysicsParamOnlineOptimizer`` holding them."""
    device = torch.device(device)
    cd = _compute_dtype(device)
    pm = pm or PerceptionModule(stride=2)
    rng = np.random.RandomState(seed)
    generator = torch.Generator(device=device)
    generator.manual_seed(seed + 1)

    ppo = PhysicsParamOnlineOptimizer(task.dcfg, params, phys_dim=task.dcfg.gnn.phys_dim,
                                      save_dir=save_dir, seed=seed, device=device,
                                      compute_dtype=cd)
    start_step = 0
    if resume and save_dir and os.path.isdir(save_dir):
        ppo.load_interactions(save_dir)
        start_step = len(ppo._interactions)
        if verbose and start_step:
            print(f"resumed with {start_step} recorded interactions")

    perceive = _make_perceive(env, pm, task, rng, state_fn)
    act_seq = _mid_action_seq(task, device)
    pen = PENALTIES[task.penalty_type]

    def explore_reward(state_seqs, act_seqs, state_cur):
        B = state_seqs.shape[0]
        r = chamfer(state_seqs[:, -1], state_cur[None].expand(B, *state_cur.shape))
        if pen is not None:
            r = r - 5.0 * pen(state_seqs, act_seqs, state_cur).mean(dim=1)
        return r

    solve = make_mppi_solver(task.dcfg, task.mcfg, explore_reward, task.action_lower_lim,
                             task.action_upper_lim, device=device, compute_dtype=cd)
    for i in range(start_step, n_actions):
        state_raw = perceive()
        state_pad, n_obj = _pad_state(state_raw, task.dcfg.gnn.max_nobj)
        res = solve(params, state_pad, act_seq, generator, ppo.physics_param)
        best_act = _host(res["act_seq"])
        first_act = best_act[0] if best_act.ndim == 2 else best_act
        env.step(sim_action_to_board(first_act, task.sim_real_ratio))
        state_next = perceive()
        pred = _host(res["best_final_state"])[:n_obj]
        ppo.add_interaction(first_act, state_raw, pred, state_next)
        if verbose:
            print(f"interact {i}: recorded ({len(state_raw)} pts)")
    return ppo
