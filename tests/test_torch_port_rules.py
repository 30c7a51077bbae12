"""Rules of the PyTorch port: it imports neither JAX nor the JAX package, its
entry points default to the CUDA card, and its copied yaml files equal the
originals."""

import ast
import inspect
import os
import subprocess
import sys

import pytest
import yaml

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "adaptigraph_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "adaptigraph_tpu")


def _port_files():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, files in os.walk(PKG):
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _port_modules():
    mods = []
    for path in _port_files():
        if path.startswith(PKG):
            rel = os.path.relpath(path, ROOT)[:-3].replace(os.sep, ".")
            mods.append(rel[:-len(".__init__")] if rel.endswith(".__init__") else rel)
    return [m for m in mods if not m.endswith("__main__")]


def test_importing_the_port_loads_no_jax():
    code = ("import importlib, sys\n"
            f"for m in {_port_modules()!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r})\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_import_in_source(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, f"{path}:{node.lineno} imports {name}"


def test_entry_points_default_to_cuda():
    from adaptigraph_tpu_torch.cli import build_parser
    from adaptigraph_tpu_torch.dynamics.train import train
    from adaptigraph_tpu_torch.planning.mppi_solve import make_mppi_solver
    from adaptigraph_tpu_torch.planning.physics_optimizer import (
        PhysicsParamOnlineOptimizer, dynamics_error_population)

    for fn in (make_mppi_solver, PhysicsParamOnlineOptimizer.__init__, dynamics_error_population,
               train):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    for argv in (["demo-ppo", "--config", "rope", "--load_dir", "x"], ["train", "--config", "rope"]):
        assert build_parser().parse_args(argv).device == "cuda"


def test_rollout_command_defaults_to_cuda(monkeypatch):
    """``rollout`` runs on the card unless ``--device cpu``: without a card it
    stops before reading anything."""
    from adaptigraph_tpu_torch.cli import build_parser, main

    assert build_parser().parse_args(["rollout", "--config", "rope"]).device == "cuda"
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        main(["rollout", "--config", "rope", "--prep_dir", "missing", "--out_dir", "missing"])


def test_datagen_and_filter_parse_without_a_device():
    """``datagen`` and ``filter`` run on the host: they parse their JAX flags
    and take no ``--device``."""
    from adaptigraph_tpu_torch.cli import build_parser

    args = build_parser().parse_args(
        ["datagen", "--config", "softbody", "--material", "softbody", "--data_dir", "d",
         "--n_episodes", "2", "--n_pushes", "3", "--n_workers", "2", "--seed", "1",
         "--start_episode", "4", "--capture", "--robot"])
    assert (args.config, args.material, args.data_dir, args.n_episodes, args.n_pushes,
            args.n_workers, args.seed, args.start_episode, args.capture, args.robot) == (
        "softbody", "softbody", "d", 2, 3, 2, 1, 4, True, True)
    args = build_parser().parse_args(["filter", "--data_dir", "d", "--out", "f.json",
                                      "--drift_thresh", "0.5", "--spike_thresh", "0.25"])
    assert (args.data_dir, args.out, args.drift_thresh, args.spike_thresh) == ("d", "f.json",
                                                                                 0.5, 0.25)
    for argv in (["datagen", "--device", "cpu"], ["filter", "--data_dir", "d", "--device", "cpu"]):
        with pytest.raises(SystemExit):
            build_parser().parse_args(argv)


@pytest.mark.parametrize("rel", ["dynamics/rope.yaml", "dynamics/granular.yaml",
                                 "dynamics/cloth.yaml", "planning/rope.yaml",
                                 "planning/granular.yaml", "planning/cloth.yaml",
                                 "dynamics/softbody.yaml", "dynamics/multiobj.yaml",
                                 "dynamics/bunnybath.yaml", "dynamics/rope_f8.yaml",
                                 "dynamics/granular_f6.yaml", "data_gen/box.yaml",
                                 "data_gen/bunnybath.yaml", "data_gen/cloth.yaml",
                                 "data_gen/granular.yaml", "data_gen/multiobj.yaml",
                                 "data_gen/rope.yaml", "data_gen/softbody.yaml"])
def test_copied_yaml_equals_original(rel):
    with open(os.path.join(ROOT, "adaptigraph_tpu", "configs", rel)) as f:
        want = yaml.safe_load(f)
    with open(os.path.join(PKG, "configs", rel)) as f:
        got = yaml.safe_load(f)
    assert got == want


@pytest.mark.parametrize("name", ["rope", "granular", "cloth"])
def test_planning_config_loads_like_jax(name):
    from adaptigraph_tpu.utils.config import load_planning_config as jax_load
    from adaptigraph_tpu_torch.utils.config import load_planning_config

    assert load_planning_config(name) == jax_load(name)


def _shipped_planning_configs():
    return sorted(f[:-5] for f in os.listdir(os.path.join(PKG, "configs", "planning"))
                  if f.endswith(".yaml"))


@pytest.mark.parametrize("name", _shipped_planning_configs())
def test_planning_config_reads_only_the_port_copies(monkeypatch, name):
    """Every planning config the port ships names a dynamics file of the
    JAX package; the port reads its own copy instead, and no file under
    adaptigraph_tpu/."""
    from adaptigraph_tpu_torch.utils import config

    read = []
    real = config.load_yaml
    monkeypatch.setattr(config, "load_yaml", lambda path: read.append(path) or real(path))
    task = config.load_planning_config(name)
    assert task["config"].startswith("adaptigraph_tpu/configs/dynamics/")
    own = os.path.join(PKG, "configs") + os.sep
    assert [os.path.abspath(p).startswith(own) for p in read] == [True, True], read
    assert os.path.basename(read[1]) == os.path.basename(task["config"])


def test_missing_dynamics_copy_is_an_error(tmp_path, monkeypatch):
    """A planning config naming a JAX dynamics file that the port has no copy
    of fails, naming the file, instead of reading the JAX package's. The port
    copies every JAX dynamics file, so the port's config directory is
    replaced by one that lacks the softbody copy."""
    import shutil

    from adaptigraph_tpu_torch.utils import config

    configs = tmp_path / "configs"
    shutil.copytree(os.path.join(PKG, "configs"), configs)
    os.remove(configs / "dynamics" / "softbody.yaml")
    monkeypatch.setattr(config, "config_dir", lambda: str(configs))
    with open(configs / "planning" / "rope.yaml") as f:
        plan = yaml.safe_load(f)
    plan["task_config"]["config"] = "adaptigraph_tpu/configs/dynamics/softbody.yaml"
    path = tmp_path / "softbody_planning.yaml"
    path.write_text(yaml.safe_dump(plan))
    assert os.path.exists(os.path.join(ROOT, "adaptigraph_tpu", "configs", "dynamics",
                                       "softbody.yaml"))
    with pytest.raises(FileNotFoundError, match="softbody.yaml"):
        config.load_planning_config(str(path))
