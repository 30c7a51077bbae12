"""BENCHMARK.json and the files it names: the contract's shape, names and
units, every file found by name, a dropped-in traffic mix found without an
edit, the no-JAX scan."""

import json
import os
import shutil

import pytest

from harness import spec as specs

SPEC = specs.load_spec()
KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


def test_spec_parses_with_the_contract_keys():
    assert set(SPEC) == KEYS
    assert SPEC["command"][:2] == ["python3", "benchmark/run.py"]
    assert SPEC["paths"] == ["benchmark"]
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/")
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in SPEC["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["moves"] in {e["name"] for e in SPEC["end_to_end"]}


def test_run_seconds_fits_a_full_check_of_24_cells():
    assert 1 <= SPEC["run_seconds"] <= 51
    runs = 2 + 14 * 24
    assert runs * (SPEC["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_and_units_keep_to_the_allowed_characters():
    assert specs.check_names(SPEC) == []
    assert not specs.NAME.match("has space") and not specs.NAME.match("a/b")
    assert not specs.UNIT.match("tokens per second") and specs.UNIT.match("tokens/s")


def test_unique_names_and_cells():
    for key in ("configs", "workloads"):
        names = [e["name"] for e in SPEC[key]]
        assert len(names) == len(set(names))
    metrics = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert len(metrics) == len(set(metrics))
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(pairs) == len(set(pairs))


@pytest.mark.parametrize("workload", [w["name"] for w in SPEC["workloads"]])
def test_every_cell_finds_its_files_by_name(workload):
    cell, config, traffic, e2e, layer = specs.resolve_cell(SPEC, workload)
    assert config["name"] == cell["config"] and traffic["kind"] in ("solve", "train")
    names = {m["name"] for m in e2e}
    assert "setup_s" in names and len(names) >= 2 and layer
    for metric in layer:
        assert callable(specs.load_reader(metric["name"]))
    with open(os.path.join(specs.BENCH_DIR, "checks", workload + ".json")) as f:
        assert json.load(f)["numbers"]


def test_a_dropped_in_traffic_mix_is_found_without_an_edit(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(specs.BENCH_DIR, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    spec = json.loads(json.dumps(SPEC))
    extra = dict(specs.load_json(specs.traffic_path("closed_loop")), pool=3)
    (root / "benchmark" / "traffic" / "closed_loop_small_pool.json").write_text(json.dumps(extra))
    spec["workloads"].append({"name": "rope_nf128.solve.small_pool", "config": "rope_nf128",
                              "traffic": "closed_loop_small_pool", "chips": 1, "why": "a test"})
    shutil.copytree(os.path.join(specs.ROOT, "benchmark", "configs"),
                    root / "benchmark" / "configs", dirs_exist_ok=True)
    cell, config, traffic, e2e, layer = specs.resolve_cell(
        spec, "rope_nf128.solve.small_pool", root=str(root), bench_dir=str(root / "benchmark"))
    assert traffic["pool"] == 3 and config["name"] == "rope_nf128"
    # metrics listed by cell name do not follow a new cell; the others do
    assert {m["name"] for m in e2e} == {"setup_s"}


def test_the_no_jax_scan_compares_whole_top_level_names():
    assert specs.forbidden_modules({"adaptigraph_tpu": 1}) == ["adaptigraph_tpu"]
    assert specs.forbidden_modules({"adaptigraph_tpu.ops.fused_gnn": 1}) == [
        "adaptigraph_tpu.ops.fused_gnn"]
    assert specs.forbidden_modules({"jax": 1, "jaxlib.xla_client": 1, "flax": 1}) == [
        "flax", "jax", "jaxlib.xla_client"]
    assert specs.forbidden_modules({"adaptigraph_tpu_torch": 1,
                                    "adaptigraph_tpu_torch.ops": 1, "jaxtyping": 1}) == []


def test_the_harness_imports_nothing_of_jax_or_the_jax_package():
    import ast

    for dirpath, _, files in os.walk(specs.BENCH_DIR):
        for name in files:
            if not name.endswith(".py"):
                continue
            with open(os.path.join(dirpath, name)) as f:
                tree = ast.parse(f.read())
            for node in ast.walk(tree):
                mods = ([a.name for a in node.names] if isinstance(node, ast.Import)
                        else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
                assert not specs.forbidden_modules(dict.fromkeys(mods)), (name, mods)
