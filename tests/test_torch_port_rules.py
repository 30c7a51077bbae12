"""Rules of the PyTorch port: it imports neither JAX nor the JAX package, its
entry points default to the CUDA card, and its copied yaml files equal the
originals."""

import ast
import importlib
import inspect
import os
import subprocess
import sys
import types

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


def test_mesh_defaults_to_the_card():
    """``make_mesh`` lists cards unless asked for other devices; ``train
    --n_devices`` defaults to one device and ``plan --mesh`` to none."""
    from adaptigraph_tpu_torch.cli import build_parser
    from adaptigraph_tpu_torch.parallel.mesh import make_mesh

    assert inspect.signature(make_mesh).parameters["device_type"].default == "cuda"
    assert build_parser().parse_args(["train", "--config", "rope"]).n_devices == 1
    args = build_parser().parse_args(["plan", "--config", "rope"])
    assert args.mesh is None and args.device == "cuda"
    assert build_parser().parse_args(["plan", "--config", "rope", "--mesh", "auto"]).mesh == "auto"


def test_io_tier_imports_neither_torch_nor_jax():
    """The camera child processes import the I/O tier's modules afresh
    (spawned): those modules load numpy only, no torch (so no CUDA) and no
    JAX."""
    code = ("import sys\n"
            "import adaptigraph_tpu_torch.realworld.camera, adaptigraph_tpu_torch.realworld.calibrate\n"
            "import adaptigraph_tpu_torch.realworld.xarm, adaptigraph_tpu_torch.utils.nested\n"
            "import adaptigraph_tpu_torch.ops.padding\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN + ('torch',)!r})\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


JAX_PKG = os.path.join(ROOT, "adaptigraph_tpu")
# JAX modules and names the port leaves out or renames, each with its reason
NOT_PORTED_MODULES = {
    "utils/jaxcache.py": "the persistent XLA compilation cache of the remote TPU backend",
    "utils/finalize.py": "the remote TPU backend's hard-exit teardown",
}
NOT_PORTED_NAMES = {
    ("cli.py", "console_main"): "the remote TPU backend's hard-exit teardown around main",
}
RENAMED_NAMES = {
    ("ops/fps.py", "fps_jax"): "fps_device",
    ("ops/__init__.py", "fps_jax"): "fps_device",
    ("utils/profiling.py", "time_jitted"): "time_synced",
}


def _public_top_level_names(path):
    """Names a module defines or assigns at top level, and in an
    ``__init__.py`` also the names it imports; without a leading underscore."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names.update(t.id for t in node.targets if isinstance(t, ast.Name))
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            names.add(node.target.id)
        elif isinstance(node, (ast.Import, ast.ImportFrom)) and path.endswith("__init__.py"):
            names.update(a.asname or a.name for a in node.names)
    return {n for n in names if not n.startswith("_")}


def _jax_modules():
    out = []
    for d, _, files in os.walk(JAX_PKG):
        out += [os.path.relpath(os.path.join(d, f), JAX_PKG) for f in files if f.endswith(".py")]
    return sorted(out)


def test_every_jax_module_has_a_counterpart():
    missing = [rel for rel in _jax_modules() if rel not in NOT_PORTED_MODULES
               and not os.path.exists(os.path.join(PKG, rel))]
    assert missing == []
    assert all(os.path.exists(os.path.join(JAX_PKG, rel)) for rel in NOT_PORTED_MODULES)


@pytest.mark.parametrize("rel", [r for r in _jax_modules() if r not in NOT_PORTED_MODULES])
def test_public_names_match_jax(rel):
    """Every public top-level name of the JAX module is an attribute of the
    port's (imported, so lazy package exports count), under the port's name
    where it was renamed."""
    if rel.endswith("__main__.py"):  # importing it would run the CLI
        port = types.SimpleNamespace(**dict.fromkeys(
            _public_top_level_names(os.path.join(PKG, rel))))
    else:
        mod = rel[:-3].replace(os.sep, ".")
        mod = "" if mod == "__init__" else mod.removesuffix(".__init__")
        port = importlib.import_module("adaptigraph_tpu_torch" + (f".{mod}" if mod else ""))
    missing = sorted(n for n in _public_top_level_names(os.path.join(JAX_PKG, rel))
                     if (rel, n) not in NOT_PORTED_NAMES
                     and not hasattr(port, RENAMED_NAMES.get((rel, n), n)))
    assert missing == []


def test_listed_exceptions_exist_in_jax():
    """The exception lists name only what the JAX package has."""
    for rel, name in list(NOT_PORTED_NAMES) + list(RENAMED_NAMES):
        assert name in _public_top_level_names(os.path.join(JAX_PKG, rel)), (rel, name)


def test_lazy_exports_keep_the_io_tier_torch_free():
    """Importing the I/O tier's packages (``realworld``, ``ops``, ``utils``)
    loads no torch; reading one of their lazy exports does."""
    code = ("import sys\n"
            "import adaptigraph_tpu_torch.realworld as rw, adaptigraph_tpu_torch.realworld.camera\n"
            "import adaptigraph_tpu_torch.ops.padding, adaptigraph_tpu_torch.utils.nested\n"
            "before = sorted(m for m in sys.modules if m.split('.')[0] == 'torch')\n"
            "assert 'SimRealEnv' in dir(rw) and rw.ShmRingBuffer\n"
            "rw.PerceptionModule\n"
            "after = 'torch' in sys.modules\n"
            "print(before, after)\n"
            "sys.exit(0 if not before and after else 1)\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr

