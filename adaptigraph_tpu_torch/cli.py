"""Command-line entry point of the PyTorch port (counterpart of
``adaptigraph_tpu/cli.py``)::

    python -m adaptigraph_tpu_torch demo-ppo --config rope \\
        --load_dir fixtures/rope_demo --ckpt_dir fixtures/rope_demo
    python -m adaptigraph_tpu_torch datagen --config softbody --data_dir <h5 dir> --n_episodes 12
    python -m adaptigraph_tpu_torch filter --data_dir <h5 dir>
    python -m adaptigraph_tpu_torch preprocess --config rope --data_dir <h5 dir> --prep_dir <dir>
    python -m adaptigraph_tpu_torch train --config rope --prep_dir <dir> --out_dir <dir>
    python -m adaptigraph_tpu_torch rollout --config rope --prep_dir <dir> --out_dir <dir>
    python -m adaptigraph_tpu_torch plan --config rope --ckpt_dir fixtures/rope_demo \
        --save_dir runs/plan
    python -m adaptigraph_tpu_torch random-interact --config rope --ckpt_dir fixtures/rope_demo
    python -m adaptigraph_tpu_torch perception --calibrate

Commands run on the CUDA card unless ``--device cpu`` is given; ``datagen``,
``filter`` and ``preprocess`` run on the host and take no device.
``train --n_devices N`` (N > 1) trains data parallel over the first N cards
(with ``--device cpu``, N shards on the CPU), and ``plan --mesh auto|N``
shards each solve's samples likewise; either exits non-zero when N cards are
not there. ``plan --learned_perception`` perceives through GroundingDINO + SAM
(``realworld/detect.py``) on the run's device; it needs ``transformers`` and
the models' weights, and exits non-zero without ``transformers``.
"""

import argparse
import dataclasses
import json
import os

import numpy as np
import torch


# ---------------------------------------------------------------------------
# config -> framework objects
# ---------------------------------------------------------------------------

def edge_policy(dataset_cfg):
    """The tool-connection policy a dataset config selects."""
    ds = dataset_cfg
    if ds.get("connect_tool_all_non_fixed"):
        return "non_fixed"
    if ds.get("connect_tool_all"):
        return "tools_all"
    if ds.get("connect_tools_surface") or ds.get("connect_tool_surface"):
        return "surface"
    return "none"


def _dyn_objects(config):
    """dynamics config dict -> (gnn_cfg, edge_cfg)."""
    from adaptigraph_tpu_torch.models.gnn import model_config_from_yaml
    from adaptigraph_tpu_torch.ops.graph import EdgeConfig

    gnn_cfg = model_config_from_yaml(config)
    ds = config["dataset_config"]["datasets"][0]
    edge_cfg = EdgeConfig(
        max_nobj=ds["max_nobj"], max_neef=config["dataset_config"]["eef"]["max_neef"],
        topk=ds["topk"], policy=edge_policy(ds),
        surface_ratio=float(ds.get("connect_tool_surface_ratio", 1.0)),
    )
    return gnn_cfg, edge_cfg


def _train_objects(config):
    """dynamics config dict -> (GraphSpec, TrainHyper)."""
    from adaptigraph_tpu_torch.dynamics.dataset import spec_from_config
    from adaptigraph_tpu_torch.dynamics.train import TrainHyper

    spec = spec_from_config(config)
    tc = config["train_config"]
    rand = config["dataset_config"].get("randomness", {})
    # n_iters_per_epoch is a {train, valid} dict in the yaml files, or an int
    ipe = tc.get("n_iters_per_epoch", 1000)
    if isinstance(ipe, dict):
        n_it_train, n_it_valid = int(ipe.get("train", 1000)), int(ipe.get("valid", 100))
    else:
        n_it_train, n_it_valid = int(ipe), int(tc.get("n_iters_per_epoch_valid", 100))
    hyper = TrainHyper(
        n_future=spec.n_future,
        batch_size=tc.get("batch_size", 128),
        n_epochs=tc.get("n_epochs", 100),
        n_iters_train=n_it_train,
        n_iters_valid=n_it_valid,
        lr=float(tc.get("lr", 1e-3)),
        use_augmentation=rand.get("use", True),
        state_noise_train=rand.get("state_noise", {}).get("train", 0.05),
        state_noise_valid=rand.get("state_noise", {}).get("valid", 0.0),
        store_rest_state=spec.store_rest_state,
        grad_clip_norm=float(tc.get("grad_clip_norm", 0.0)),
    )
    return spec, hyper


def _phys_specs(config):
    material = config["dataset_config"]["materials"][0]
    return config["material_config"][material]["physics_params"]


def _task_objects(task):
    """planning task config -> (TaskConfig, dynamics config dict)."""
    from adaptigraph_tpu_torch.planning.closed_loop import TaskConfig
    from adaptigraph_tpu_torch.planning.forward import DynamicsConfig
    from adaptigraph_tpu_torch.planning.mppi_solve import MPPIConfig

    config = task["_dynamics_config"]
    gnn_cfg, edge_cfg = _dyn_objects(config)
    if edge_cfg.policy == "tools_all":
        # planning gates the tool connections per sample on contact
        edge_cfg = dataclasses.replace(edge_cfg, gate_on_contact=True)
    dcfg = DynamicsConfig(
        gnn=gnn_cfg, edge=edge_cfg, n_his=task.get("n_his", gnn_cfg.n_his),
        push_length=task.get("push_length", 0.1),
        sim_real_ratio=task.get("sim_real_ratio", 10.0),
        max_repeat=int(np.ceil(task["action_upper_lim"][3])),
        pusher_offsets=tuple(task.get("pusher_points", [])) or (),
        gripper_enable=task.get("gripper_enable", False),
        adj_thresh=task.get("adj_thresh", 0.5),
    )
    mcfg = MPPIConfig(
        n_sample=task.get("n_sample", 20000),
        n_sample_chunk=task.get("n_sample_chunk", 2000),
        n_look_ahead=task.get("n_look_ahead", 1),
        n_update_iter=task.get("n_update_iter", 1),
        reward_weight=task.get("reward_weight", 500.0),
        noise_level=task.get("noise_level", 1.0),
        push_length=task.get("push_length", 0.1),
    )
    ratio = task.get("sim_real_ratio", 10.0)
    tcfg = TaskConfig(
        dcfg=dcfg, mcfg=mcfg,
        action_lower_lim=np.asarray(task["action_lower_lim"], np.float32),
        action_upper_lim=np.asarray(task["action_upper_lim"], np.float32),
        n_actions=task.get("n_actions", 10),
        penalty_type=task.get("penalty_type", "none"),
        target_type=task.get("target_type", "pcd"),
        fps_radius=task.get("fps_radius", 0.2),
        sim_real_ratio=ratio,
        k_filter=task.get("k_filter", 1.0),
        obj_list=tuple(task.get("obj_list", [])),
        max_n=task.get("max_n", 1),
        target_path=task.get("target", None),
        clipping_height=task.get("clipping_height", None),
        rotate_pusher=task.get("rotate_pusher", False),
        # board-frame [x_min, x_max, z_min, z_max, ...] -> sim-frame (2, 2)
        workspace_bbox=(np.asarray(task["bbox"][:4], np.float32).reshape(2, 2) * ratio
                        if task.get("bbox") is not None else None),
    )
    return tcfg, config


def load_params(ckpt_dir, gnn_cfg, device, epoch=None):
    """Checkpoint in ``ckpt_dir`` -> the nested parameter dict on ``device``."""
    from adaptigraph_tpu_torch.models.gnn import params_from_numpy
    from adaptigraph_tpu_torch.utils.checkpoint import load_checkpoint

    return params_from_numpy(load_checkpoint(ckpt_dir, epoch=epoch, cfg=gnn_cfg), device)


def resolve_device(name):
    """The device a command runs on; 'cuda' without a card is an error."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device is available (use --device cpu to run the plain "
                         "PyTorch versions on the CPU)")
    return device


def device_mesh(n_devices, device):
    """The mesh of ``n_devices`` entries for a command on ``device``: the
    first n cards, or n shards on the CPU; an error exit when the cards are
    not there."""
    from adaptigraph_tpu_torch.parallel.mesh import make_mesh

    try:
        if device.type == "cpu":
            return make_mesh(devices=["cpu"] * n_devices)
        return make_mesh(n_devices)
    except RuntimeError as e:
        raise SystemExit(f"--mesh/--n_devices {n_devices}: {e}")


def mesh_chunk(mcfg, n_dev):
    """The solve budget for a mesh of ``n_dev`` devices, as the JAX
    ``plan --mesh`` sizes it: the sharded solve needs n_chunks % n_dev == 0,
    so the chunk shrinks until the chunks divide evenly over the devices;
    an error exit when n_sample itself is not a multiple of n_dev."""
    n_chunks = mcfg.n_sample // mcfg.n_sample_chunk
    if n_chunks % n_dev == 0:
        return mcfg
    if mcfg.n_sample % n_dev:
        raise SystemExit(f"n_sample={mcfg.n_sample} must be divisible by the device count "
                         f"({n_dev}) for --mesh; adjust n_sample or n_sample_chunk in the task "
                         "config")
    chunk = mcfg.n_sample // (n_dev * max(1, n_chunks // n_dev))
    while chunk > 1 and mcfg.n_sample % (chunk * n_dev):
        chunk -= 1
    return dataclasses.replace(mcfg, n_sample_chunk=chunk)


# ---------------------------------------------------------------------------
# subcommands
# ---------------------------------------------------------------------------

def cmd_demo_ppo(args):
    """Replay recorded interaction fixtures through the physics-parameter
    optimizer and print the estimate."""
    from adaptigraph_tpu_torch.planning.physics_optimizer import PhysicsParamOnlineOptimizer
    from adaptigraph_tpu_torch.utils.config import load_planning_config

    device = resolve_device(args.device)
    task = load_planning_config(args.config)
    tcfg, _ = _task_objects(task)
    if not args.ckpt_dir:
        raise SystemExit("demo-ppo needs --ckpt_dir")
    params = load_params(args.ckpt_dir, tcfg.dcfg.gnn, device, args.epoch)
    # the device picks the path, as the JAX package's backend does: bfloat16
    # through the kernel on the card, float32 through the plain version on the CPU
    cd = torch.bfloat16 if device.type == "cuda" else torch.float32
    ppo = PhysicsParamOnlineOptimizer(tcfg.dcfg, params, phys_dim=tcfg.dcfg.gnn.phys_dim,
                                      device=device, compute_dtype=cd)
    ppo.load_interactions(args.load_dir)
    est, err, err0 = ppo.optimize(iterations=args.iterations)
    print(f"physics estimate: {est} (error {err:.5f} <- init {err0:.5f})")
    return est, err, err0


def cmd_datagen(args):
    """Simulated push episodes as h5 files (host numpy and the C++
    simulator), from a ``configs/data_gen`` config or from ``--material``
    and ``--data_dir``; flags override the config."""
    from adaptigraph_tpu_torch.utils.config import config_path, load_yaml

    if args.config:
        ds = load_yaml(config_path(args.config, "data_gen"))["dataset"]
        material = args.material or ds["obj"]
        data_dir = args.data_dir or ds["data_dir"]
        n_episodes = args.n_episodes or ds["n_episode"]
        n_pushes = args.n_pushes or ds.get("n_timestep", 5)
        n_workers = args.n_workers or ds.get("n_worker", 1)
        seed = ds.get("seed", 0) if args.seed is None else args.seed
    else:
        material, data_dir = args.material, args.data_dir
        n_episodes, n_pushes = args.n_episodes or 10, args.n_pushes or 5
        n_workers, seed = args.n_workers or 1, args.seed or 0
    if not (material and data_dir):
        raise SystemExit("datagen needs --material and --data_dir, or --config")

    if material == "box":
        from adaptigraph_tpu_torch.sim.box2d import gen_box_data

        gen_box_data(data_dir, n_episodes, seed=seed)
        print(f"generated {n_episodes} box episodes -> {data_dir}")
        return []
    from adaptigraph_tpu_torch.sim.datagen import generate

    bad = generate(data_dir, material, n_episodes, n_pushes=n_pushes, n_workers=n_workers,
                   seed=seed, capture_depth=args.capture, robot=args.robot,
                   start_episode=args.start_episode)
    print(f"generated {n_episodes} episodes ({len(bad)} bad) -> {data_dir}")
    return bad


def cmd_filter(args):
    """Flag simulated pushes with solver artifacts (drift from the rest
    state, non-finite positions, frame-to-frame spikes) into a json that
    ``preprocess --filter_file`` reads."""
    from adaptigraph_tpu_torch.sim.filter import filter_dataset

    res = filter_dataset(args.data_dir, out_file=args.out, drift_thresh=args.drift_thresh,
                         spike_thresh=args.spike_thresh)
    print(f"flagged {sum(len(v) for v in res.values())} pushes across {len(res)} episodes")
    return res


def cmd_preprocess(args):
    """Simulated h5 episodes -> training artifacts (needs ``h5py``)."""
    from adaptigraph_tpu_torch.dynamics.preprocess import preprocess
    from adaptigraph_tpu_torch.utils.config import load_dynamics_config

    config = load_dynamics_config(args.config)
    dc = config["dataset_config"]
    data_dir = args.data_dir or os.path.join(dc["data_dir"], dc["data_name"])
    prep_dir = args.prep_dir or os.path.join(dc["prep_data_dir"], dc["data_name"])
    filter_actions = None
    if args.filter_file:
        from adaptigraph_tpu_torch.sim.filter import load_filter_file

        filter_actions = load_filter_file(args.filter_file)
    n = preprocess(data_dir, prep_dir, np.asarray(dc["eef"]["pos"], np.float32), dc["n_his"],
                   dc["n_future"], dc["dist_thresh"], _phys_specs(config),
                   store_rest_state=dc.get("store_rest_state", False),
                   filter_actions=filter_actions)
    print(f"preprocessed {n} episodes -> {prep_dir}")
    return n


def cmd_train(args):
    """Train the GNN dynamics model on a preprocessed dataset."""
    from adaptigraph_tpu_torch.dynamics.dataset import BatchLoader, DynDataset, PackedDataset
    from adaptigraph_tpu_torch.dynamics.train import train
    from adaptigraph_tpu_torch.utils.config import load_dynamics_config

    device = resolve_device(args.device)
    # N > 1: data parallel over a mesh of N (JAX: a mesh only for n_devices > 1)
    mesh = device_mesh(args.n_devices, device) if args.n_devices > 1 else None
    config = load_dynamics_config(args.config)
    gnn_cfg, edge_cfg = _dyn_objects(config)
    spec, hyper = _train_objects(config)
    over = {}
    if args.epochs:
        over["n_epochs"] = args.epochs
    if args.iters:
        over["n_iters_train"] = args.iters
        over["n_iters_valid"] = max(1, args.iters // 10)
    if args.batch_size:
        over["batch_size"] = args.batch_size
    hyper = dataclasses.replace(hyper, **over)
    dc = config["dataset_config"]
    prep_dir = args.prep_dir or os.path.join(dc["prep_data_dir"], dc["data_name"])
    out_dir = args.out_dir or config["train_config"]["out_dir"]
    ratio = dc["ratio"]
    K = max(1, args.steps_per_call)
    if args.slow_loader:
        # per-sample assembly in worker processes
        nw = args.num_workers
        tr = BatchLoader(DynDataset(prep_dir, spec, "train", ratio), hyper.batch_size,
                         num_workers=nw, stack_steps=K)
        va = BatchLoader(DynDataset(prep_dir, spec, "valid", ratio), hyper.batch_size,
                         num_workers=max(2, nw // 2) if nw else 0, stack_steps=K)
    else:
        tr = BatchLoader(PackedDataset(prep_dir, spec, "train", ratio, compact=True),
                         hyper.batch_size, stack_steps=K)
        va = BatchLoader(PackedDataset(prep_dir, spec, "valid", ratio, compact=True),
                         hyper.batch_size, stack_steps=K)
    try:
        params, curves = train(gnn_cfg, edge_cfg, hyper, tr, va, out_dir, device=device,
                               resume=args.resume, mesh=mesh)
    finally:
        tr.close()
        va.close()
    print(f"trained: final valid loss {curves['valid'][-1]:.6f} -> {out_dir}")
    return params, curves


def cmd_rollout(args):
    """Autoregressive rollout evaluation of a checkpoint: per-push error
    curves, their median and IQR, ``summary.json`` and, where cv2 and
    matplotlib import, a video and a plot, under ``<out_dir>/rollout``."""
    from adaptigraph_tpu_torch.dynamics.dataset import spec_from_config
    from adaptigraph_tpu_torch.dynamics.rollout import rollout_dataset
    from adaptigraph_tpu_torch.utils.config import load_dynamics_config

    device = resolve_device(args.device)
    config = load_dynamics_config(args.config)
    gnn_cfg, edge_cfg = _dyn_objects(config)
    spec = spec_from_config(config)
    dc = config["dataset_config"]
    prep_dir = args.prep_dir or os.path.join(dc["prep_data_dir"], dc["data_name"])
    out_dir = args.out_dir or config["train_config"]["out_dir"]
    params = load_params(out_dir, gnn_cfg, device, args.epoch)
    roll_dir = os.path.join(out_dir, "rollout")
    # the held-out slice (default 2%), clamped to the train split's end so
    # that a wide --eval_frac never evaluates trained episodes; a fresh prep
    # dir is evaluated whole with --all_episodes
    frac = 0.02 if args.eval_frac is None else args.eval_frac
    eval_lo = 1.0 - frac
    if args.all_episodes:
        eval_lo = 0.0
    else:
        train_hi = float(dc.get("ratio", {}).get("train", [0, 0.98])[1])
        if eval_lo < train_hi:
            print(f"warning: --eval_frac {frac} overlaps the train split "
                  f"[0, {train_hi}]; clamping eval slice to [{train_hi}, 1.0]"
                  " (use --all_episodes for a fresh prep dir)")
            eval_lo = train_hi
    stats = rollout_dataset(params, spec, gnn_cfg, edge_cfg, prep_dir, phase_ratio=(eval_lo, 1.0),
                            out_dir=roll_dir, keep_prev_fps=args.keep_prev_fps)
    med = stats["median"]
    if len(med):
        from adaptigraph_tpu_torch.utils.viz import plot_error_curves

        try:
            plot_error_curves(stats, os.path.join(roll_dir, "error_median_iqr.png"))
        except ImportError as e:
            print(f"error plot not written: {e}")
    per_push = stats.get("per_push", [])
    summary = {
        "n_pushes": len(per_push),
        "median_last_step": float(med[-1]) if len(med) else None,
        "median_mean": float(np.mean(med)) if len(med) else None,
        "push_final_median": (float(np.median([e[-1] for e in per_push if len(e)]))
                              if per_push else None),
    }
    # strict JSON: a NaN median is written as null
    summary = {k: (None if isinstance(v, float) and not np.isfinite(v) else v)
               for k, v in summary.items()}
    os.makedirs(roll_dir, exist_ok=True)
    with open(os.path.join(roll_dir, "summary.json"), "w") as f:
        json.dump(summary, f)
    print(f"rollout: {len(per_push)} pushes, "
          f"median error @last step {med[-1] if len(med) else float('nan'):.5f}")
    return stats, summary


def _load_plan_params(args, tcfg, device):
    if args.ckpt_dir:
        return load_params(args.ckpt_dir, tcfg.dcfg.gnn, device, args.epoch)
    from adaptigraph_tpu_torch.models.gnn import init_params

    print("WARNING: no --ckpt_dir, using random init (smoke mode)")
    return init_params(torch.Generator(device=device).manual_seed(0), tcfg.dcfg.gnn)


def _true_phys(props, config, phys_dim):
    """The scene's true physics parameter, normalised by the dataset's
    min/max, or None where its properties do not cover the model's."""
    true = np.array([(float(props[s["name"]]) - s["min"]) / (s["max"] - s["min"])
                     for s in _phys_specs(config) if s["use"] and s["name"] in props],
                    np.float32)
    return true if true.size == phys_dim else None


def _plan_target(args, tcfg, env):
    if args.target:  # an explicit file beats the yaml target
        target = np.load(args.target)
        target = target[target.files[0]] if hasattr(target, "files") else target
    elif tcfg.target_type == "box" and isinstance(tcfg.target_path, (list, tuple)):
        # board-frame [x_min, x_max, z_min, z_max] -> sim-frame (2, 2)
        target = np.asarray(tcfg.target_path, np.float32).reshape(2, 2) * tcfg.sim_real_ratio
    elif isinstance(tcfg.target_path, str) and os.path.exists(tcfg.target_path):
        target = np.load(tcfg.target_path)
        target = target[target.files[0]] if hasattr(target, "files") else target
    else:
        # default target: the current object translated
        target = env.get_particles_sim() + np.array([0.5, 0.0, 0.3], np.float32)
    if tcfg.target_type != "box" and np.ndim(target) == 2:
        # resample a point-cloud target to exactly max_nobj points, as the
        # JAX command does (the same points for the same seed)
        M = tcfg.dcfg.gnn.max_nobj
        if len(target) != M:
            idx = np.random.RandomState(args.seed).choice(len(target), M,
                                                          replace=len(target) < M)
            target = np.asarray(target)[idx]
    return target


def cmd_plan(args):
    """The closed loop on the sim-backed environment: perceive, solve,
    execute, re-estimate the physics parameter; one ``step_*.npz`` per push
    under ``--save_dir``."""
    from adaptigraph_tpu_torch.planning.closed_loop import run_plan
    from adaptigraph_tpu_torch.realworld.detect import color_spread_mask_fn, make_mask_fn
    from adaptigraph_tpu_torch.realworld.env import SimRealEnv
    from adaptigraph_tpu_torch.realworld.perception import PerceptionModule
    from adaptigraph_tpu_torch.utils.config import load_planning_config

    device = resolve_device(args.device)
    mesh = None
    if args.mesh:  # a mesh only for more than one device, as the JAX command
        n_dev = int(args.mesh) if args.mesh != "auto" else (
            torch.cuda.device_count() if device.type == "cuda" else 1)
        mesh = device_mesh(n_dev, device) if n_dev > 1 else None
    task = load_planning_config(args.config)
    tcfg, config = _task_objects(task)
    if args.n_actions:
        tcfg.n_actions = args.n_actions
    if args.verify:
        tcfg.verify_improvement = True
    if args.fps_radius is not None:
        tcfg.fps_radius = args.fps_radius
    if args.reward_weight is not None:
        tcfg.mcfg = dataclasses.replace(tcfg.mcfg, reward_weight=args.reward_weight)
    if args.n_sample or args.n_sample_chunk:
        n_sample = args.n_sample or tcfg.mcfg.n_sample
        chunk = args.n_sample_chunk or min(n_sample, tcfg.mcfg.n_sample_chunk)
        if n_sample % chunk:  # the solve needs chunk | n_sample
            chunk = next(c for c in range(min(chunk, n_sample), 0, -1) if n_sample % c == 0)
        tcfg.mcfg = dataclasses.replace(tcfg.mcfg, n_sample=n_sample, n_sample_chunk=chunk)
    material = config["dataset_config"]["materials"][0]
    env = SimRealEnv(material, seed=args.seed, sim_real_ratio=tcfg.sim_real_ratio)
    true_phys = _true_phys(env.env.properties, config, tcfg.dcfg.gnn.phys_dim)
    phys_override = None
    if args.phys is not None:
        phys_override = np.asarray(args.phys, np.float32)
    elif args.oracle:
        if true_phys is None:
            raise SystemExit("--oracle needs the scene's true physics parameters")
        phys_override = true_phys
    if phys_override is not None:
        args.no_ppo = True  # fixed-parameter arms do not adapt
    params = _load_plan_params(args, tcfg, device)
    target = _plan_target(args, tcfg, env)
    mask_fn = None
    if args.sim_mask:
        # colour segmentation of the rendered scene: the non-use_raw path
        # (mask_fn and the voxel/outlier passes) without a detector
        mask_fn = color_spread_mask_fn()
        tcfg.use_raw = False
    elif args.learned_perception:
        # GroundingDINO + SAM, loaded at the first perception
        mask_fn = make_mask_fn(tcfg.obj_list, max_n=tcfg.max_n, device=device)
        if mask_fn is None:
            raise SystemExit("--learned_perception needs torch+transformers "
                             "and task obj_list prompts")
        tcfg.use_raw = False
    pm = PerceptionModule(stride=2, k_filter=tcfg.k_filter, obj_prompts=tcfg.obj_list,
                          max_n=tcfg.max_n, mask_fn=mask_fn)
    if mesh is not None:
        tcfg.mcfg = mesh_chunk(tcfg.mcfg, len(mesh))
    hist = run_plan(env, params, tcfg, target, pm=pm, save_dir=args.save_dir, seed=args.seed,
                    use_ppo=not args.no_ppo, resume=args.resume, true_phys=true_phys,
                    phys_override=phys_override, ppo_warmup=args.ppo_warmup, device=device,
                    mesh=mesh)
    if args.save_dir:
        from adaptigraph_tpu_torch.utils.viz import plot_planning_progress

        try:
            plot_planning_progress(hist["errors"], os.path.join(args.save_dir, "plan_errors.png"))
        except ImportError as e:
            print(f"error plot not written: {e}")
    print(f"plan done: errors {['%.4f' % e for e in hist['errors']]}")
    return hist


def cmd_random_interact(args):
    """Exploration pushes recorded as interactions, then one physics estimate."""
    from adaptigraph_tpu_torch.planning.closed_loop import run_random_interact
    from adaptigraph_tpu_torch.realworld.env import SimRealEnv
    from adaptigraph_tpu_torch.realworld.perception import PerceptionModule
    from adaptigraph_tpu_torch.utils.config import load_planning_config

    device = resolve_device(args.device)
    task = load_planning_config(args.config)
    tcfg, config = _task_objects(task)
    material = config["dataset_config"]["materials"][0]
    env = SimRealEnv(material, seed=args.seed, sim_real_ratio=tcfg.sim_real_ratio)
    params = _load_plan_params(args, tcfg, device)
    pm = PerceptionModule(stride=2, k_filter=tcfg.k_filter, obj_prompts=tcfg.obj_list,
                          max_n=tcfg.max_n)
    ppo = run_random_interact(env, params, tcfg, pm=pm, save_dir=args.save_dir,
                              seed=args.seed, n_actions=args.n_actions or 20,
                              resume=args.resume, device=device)
    est, err, err0 = ppo.optimize(iterations=50)
    print(f"random-interact done: physics estimate {est} (err {err:.5f} <- {err0:.5f})")
    return est, err, err0


def cmd_perception(args):
    """Perception on the sim-backed environment (host numpy): ``--construct_goal``
    saves the perceived scene as a goal point cloud; ``--calibrate`` compares
    the perceived state with the simulator's particles (Chamfer, sim units,
    computed on ``--device``)."""
    from adaptigraph_tpu_torch.ops.costs import chamfer
    from adaptigraph_tpu_torch.realworld.env import SimRealEnv
    from adaptigraph_tpu_torch.realworld.perception import (PerceptionModule,
                                                            construct_goal_from_perception,
                                                            get_state_cur)

    device = resolve_device(args.device)
    env = SimRealEnv(material=args.material, seed=args.seed)
    pm = PerceptionModule(stride=2)
    if args.construct_goal:
        goal = construct_goal_from_perception(env, pm)
        np.savez(args.out, goal=goal)
        print(f"captured goal point cloud ({goal.shape[0]} pts) -> {args.out}")
        return goal
    if args.calibrate:
        state, _ = get_state_cur(env, pm)
        gt = env.get_particles_sim()
        err = float(chamfer(torch.tensor(state, device=device), torch.tensor(gt, device=device)))
        print(f"calibration check: {state.shape[0]} perceived keypoints, "
              f"chamfer to ground truth {err:.4f} (sim units)")
        return err
    print("please specify --calibrate or --construct_goal")
    return None


def build_parser():
    p = argparse.ArgumentParser(prog="adaptigraph_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)
    dp = sub.add_parser("demo-ppo", help="physics-param demo on recorded fixtures")
    dp.add_argument("--config", required=True)
    dp.add_argument("--load_dir", required=True)
    dp.add_argument("--ckpt_dir")
    dp.add_argument("--epoch", type=int)
    dp.add_argument("--iterations", type=int, default=50)
    dp.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    dp.set_defaults(fn=cmd_demo_ppo)

    d = sub.add_parser("datagen", help="generate simulation episodes")
    d.add_argument("--config", help="data_gen config name or path")
    d.add_argument("--material")
    d.add_argument("--data_dir")
    d.add_argument("--n_episodes", type=int)
    d.add_argument("--n_pushes", type=int)
    d.add_argument("--n_workers", type=int)
    d.add_argument("--seed", type=int)
    d.add_argument("--start_episode", type=int, default=0,
                   help="first episode index: extend an existing dataset in place (episode "
                        "seeds depend only on the base seed and the index, so an extended "
                        "run equals one longer run)")
    d.add_argument("--capture", action="store_true",
                   help="record 4-camera RGB-D observations per frame")
    d.add_argument("--robot", action="store_true",
                   help="execute pushes through the xArm6 IK chain with the tool's "
                        "contact-face collision geometry")
    d.set_defaults(fn=cmd_datagen)

    pr = sub.add_parser("preprocess", help="h5 episodes -> training artifacts")
    pr.add_argument("--config", required=True)
    pr.add_argument("--data_dir")
    pr.add_argument("--prep_dir")
    pr.add_argument("--filter_file",
                    help="json from the `filter` command: {episode: [push numbers]} to drop")
    pr.set_defaults(fn=cmd_preprocess)

    fl = sub.add_parser("filter", help="flag sim episodes with solver artifacts")
    fl.add_argument("--data_dir", required=True)
    fl.add_argument("--out", help="the json to write (default <data_dir>/filter_artifacts.json)")
    fl.add_argument("--drift_thresh", type=float, default=1.0)
    fl.add_argument("--spike_thresh", type=float, default=0.5)
    fl.set_defaults(fn=cmd_filter)

    t = sub.add_parser("train", help="train the GNN dynamics model")
    t.add_argument("--config", required=True)
    t.add_argument("--prep_dir")
    t.add_argument("--out_dir")
    t.add_argument("--epochs", type=int)
    t.add_argument("--iters", type=int, help="train iters per epoch override")
    t.add_argument("--batch_size", type=int)
    t.add_argument("--n_devices", type=int, default=1,
                   help="data parallel over this many cards (with --device cpu, shards on "
                        "the CPU); 1 = one device")
    t.add_argument("--num_workers", type=int, default=4,
                   help="batch-assembly worker processes; only with --slow_loader")
    t.add_argument("--steps_per_call", type=int, default=20,
                   help="optimizer steps per stacked superbatch (on the card one "
                        "step captured in a CUDA graph and replayed per step)")
    t.add_argument("--slow_loader", action="store_true",
                   help="per-sample batch assembly instead of PackedDataset")
    t.add_argument("--resume", action="store_true",
                   help="restore the latest params + optimizer state from out_dir")
    t.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    t.set_defaults(fn=cmd_train)

    r = sub.add_parser("rollout", help="autoregressive rollout evaluation")
    r.add_argument("--config", required=True)
    r.add_argument("--prep_dir")
    r.add_argument("--out_dir")
    r.add_argument("--epoch", type=int)
    r.add_argument("--eval_frac", type=float,
                   help="held-out episode fraction to evaluate (default 0.02; clamped to the "
                        "train split's end)")
    r.add_argument("--all_episodes", action="store_true",
                   help="evaluate the whole prep dir (a fresh test set never trained on)")
    r.add_argument("--keep_prev_fps", action="store_true",
                   help="reuse the first push's FPS indices for all pushes in an episode")
    r.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    r.set_defaults(fn=cmd_rollout)

    pl = sub.add_parser("plan", help="closed-loop planning on the sim-backed environment")
    pl.add_argument("--config", required=True)
    pl.add_argument("--ckpt_dir")
    pl.add_argument("--epoch", type=int)
    pl.add_argument("--save_dir")
    pl.add_argument("--target", help="npz/npy target point cloud")
    pl.add_argument("--n_actions", type=int)
    pl.add_argument("--n_sample", type=int, help="override the MPPI sample budget")
    pl.add_argument("--n_sample_chunk", type=int, help="override the MPPI chunk size")
    pl.add_argument("--fps_radius", type=float,
                    help="override the task's FPS radius (perceived-state density)")
    pl.add_argument("--reward_weight", type=float, help="override the MPPI softmax temperature")
    pl.add_argument("--seed", type=int, default=0)
    pl.add_argument("--no_ppo", action="store_true", help="disable online physics adaptation")
    pl.add_argument("--phys", type=float, nargs="+",
                    help="plan with this fixed physics parameter (adaptation off)")
    pl.add_argument("--oracle", action="store_true",
                    help="plan with the scene's true physics parameter (adaptation off)")
    pl.add_argument("--ppo_warmup", type=int, default=0,
                    help="random excitation pushes recorded before the MPC loop")
    pl.add_argument("--resume", action="store_true",
                    help="continue an interrupted run from --save_dir")
    pl.add_argument("--verify", action="store_true",
                    help="execute only pushes predicted to improve; stop when converged")
    pl.add_argument("--mesh", help="shard each solve's sample budget over 'auto' (every card) "
                                   "or this many devices (with --device cpu, shards on the CPU)")
    pl.add_argument("--sim_mask", action="store_true",
                    help="colour-spread mask_fn: the non-use_raw perception path")
    pl.add_argument("--learned_perception", action="store_true",
                    help="GroundingDINO + SAM mask_fn from the task's obj_list prompts "
                         "(needs transformers and the models' weights)")
    pl.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    pl.set_defaults(fn=cmd_plan)

    ri = sub.add_parser("random-interact", help="exploration pushes for system identification")
    ri.add_argument("--config", required=True)
    ri.add_argument("--ckpt_dir")
    ri.add_argument("--epoch", type=int)
    ri.add_argument("--save_dir")
    ri.add_argument("--n_actions", type=int)
    ri.add_argument("--seed", type=int, default=0)
    ri.add_argument("--resume", action="store_true")
    ri.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ri.set_defaults(fn=cmd_random_interact)

    pc = sub.add_parser("perception", help="perception utilities on the sim-backed environment")
    pc.add_argument("--calibrate", action="store_true",
                    help="perceived state against the simulator's particles")
    pc.add_argument("--construct_goal", action="store_true",
                    help="capture the current scene as a goal point cloud")
    pc.add_argument("--material", default="rope")
    pc.add_argument("--seed", type=int, default=0)
    pc.add_argument("--out", default="goal.npz")
    pc.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    pc.set_defaults(fn=cmd_perception)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    main()
