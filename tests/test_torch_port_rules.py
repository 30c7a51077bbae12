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


@pytest.mark.parametrize("rel", ["dynamics/rope.yaml", "dynamics/granular.yaml",
                                 "dynamics/cloth.yaml", "planning/rope.yaml",
                                 "planning/granular.yaml", "planning/cloth.yaml"])
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


def test_missing_dynamics_copy_is_an_error(tmp_path):
    """A planning config naming a JAX dynamics file that the port has no copy
    of fails, naming the file, instead of reading the JAX package's."""
    from adaptigraph_tpu_torch.utils.config import load_planning_config

    with open(os.path.join(PKG, "configs", "planning", "rope.yaml")) as f:
        plan = yaml.safe_load(f)
    plan["task_config"]["config"] = "adaptigraph_tpu/configs/dynamics/softbody.yaml"
    path = tmp_path / "softbody_planning.yaml"
    path.write_text(yaml.safe_dump(plan))
    assert os.path.exists(os.path.join(ROOT, "adaptigraph_tpu", "configs", "dynamics",
                                       "softbody.yaml"))
    with pytest.raises(FileNotFoundError, match="softbody.yaml"):
        load_planning_config(str(path))
