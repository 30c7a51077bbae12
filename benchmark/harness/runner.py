"""One run of one cell: ``python benchmark/run.py --workload <name> --seed <n>
--seconds <s> --trace <0|1>``.

The run finds its cell, configuration, traffic mix, metric readers and the
limits of its comparison by name (``harness/spec.py``), checks that the
cards the cell asks for are there, sets up (weights, inputs, the warm-up
that loads and builds the kernels), measures for ``--seconds``, checks that
no module of JAX or of the JAX package was loaded, compares what the timed
path produced with the plain reference, and prints one JSON line. With
``--trace 1`` a short traced window of the cell's work (``traffic``'s
``trace_solves`` or ``trace_calls``) comes first, and the line holds the
cell's per-layer metrics instead of its end-to-end ones.
"""

import argparse
import json
import math
import os
import sys
import time

from harness import spec as specs


class Run:
    """A run's settings and what it measured. The drivers fill ``e2e`` (the
    end-to-end values), ``layer`` (what the metric readers read), ``attempted``
    and, through ``judge``, the compared numbers and ``failed``."""

    def __init__(self, cell, config, traffic, seed, seconds, trace, root, device, limits,
                 t_start, control=None):
        self.cell, self.config, self.traffic = cell, config, traffic
        self.seed, self.seconds, self.trace, self.root = seed, seconds, trace, root
        self.device, self.limits, self.control = device, limits, control
        self.t_start = t_start
        self.setup_s = None
        self.e2e, self.layer, self.checks = {}, {}, {}
        self.attempted = self.failed = 0
        self.correct = None
        self.memory_peak_bytes = 0
        self.faults = []
        self._patches = []

    def weights(self, m, device):
        from harness import weights

        return weights.make(self.config, self.seed, m, device, self.root)

    def setup_done(self):
        self.setup_s = time.perf_counter() - self.t_start

    def patch(self, obj, name, value):
        """Put ``value`` in the place of ``obj.name`` until ``restore``."""
        self._patches.append((obj, name, getattr(obj, name)))
        setattr(obj, name, value)

    def plant(self):
        """Plant the faults this run was given (``harness/faults.py``)."""
        from harness import faults

        for name in self.faults:
            faults.FAULTS[name](self)

    def restore(self):
        while self._patches:
            obj, name, value = self._patches.pop()
            setattr(obj, name, value)

    def read_memory(self, devices):
        import torch

        self.memory_peak_bytes = max(
            (torch.cuda.max_memory_allocated(d) for d in devices if d.type == "cuda"), default=0)

    def judge(self, numbers):
        """``numbers``: one dict of compared numbers per checked unit. Each
        number's value is its worst over the units; the run is correct when
        every value lies at or under its limit (``checks/<workload>.json``).
        ``failed``: the units with a number over its limit. Without limits
        (a run that only reads the numbers) ``correct`` stays None."""
        names = list(numbers[0]) if numbers else []
        if self.limits is not None:  # only the numbers that have a limit are compared
            names = [k for k in names if k in self.limits]
        for name in names:
            value = max(n[name] for n in numbers)
            entry = {"value": value}
            if self.limits is not None:
                entry["limit"] = self.limits[name]["limit"]
            self.checks[name] = entry
        if self.limits is None:
            return

        def ok(n):
            return all(math.isfinite(n[k]) and n[k] <= self.limits[k]["limit"] for k in names)

        self.failed += sum(not ok(n) for n in numbers)
        missing = [k for k in self.limits if k not in names]
        self.correct = bool(numbers) and not missing and all(ok(n) for n in numbers)


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def cache_dirs(root):
    """Every build and kernel cache of the run in fixed directories inside
    the checkout (the port builds its kernels into ``build/torch_kernels``)."""
    base = os.path.join(root, "build", "bench_cache")
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = os.path.join(base, sub)
        os.makedirs(os.environ[var], exist_ok=True)


def load_limits(workload, bench_dir=specs.BENCH_DIR):
    path = os.path.join(bench_dir, "checks", workload + ".json")
    return specs.load_json(path)["numbers"]


def execute(run):
    """Set up, measure and compare one run: the driver of the traffic's
    ``kind``, ``harness/<kind>.py``'s ``run``, found by name."""
    import importlib

    importlib.import_module("harness." + run.traffic["kind"]).run(run)


def result_line(run, end_to_end, per_layer, n_chips):
    """The result's JSON object, ``checks`` last."""
    import torch

    metrics = {}
    if run.trace:
        for metric in per_layer:
            value = specs.load_reader(metric["name"])(run)
            if value is not None:
                metrics[metric["name"]] = {"value": value, "unit": metric["unit"]}
    else:
        values = dict(run.e2e, setup_s=run.setup_s)
        for metric in end_to_end:
            metrics[metric["name"]] = {"value": values[metric["name"]], "unit": metric["unit"]}
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": n_chips,
              "memory_peak_bytes": run.memory_peak_bytes}
    line = {"correct": bool(run.correct), "attempted": run.attempted, "failed": run.failed,
            "metrics": metrics, "device": device}
    if run.trace:
        summary = run.layer["trace"]
        device["busy_s"] = summary["busy_s"]
        device["window_s"] = run.layer["trace_window_s"]
        line["breakdown"] = {"device_ops": summary["device_ops"], "idle_gaps": summary["idle_gaps"]}
    line["work"] = {k: run.layer[k] for k in ("edges_per_sample", "k1_ops_per_launch")
                    if k in run.layer}
    # a number that could not be formed (inf) is written as text: JSON has no inf
    line["checks"] = {k: {f: (v if v is None or math.isfinite(v) else str(v)) for f, v in e.items()}
                      for k, e in run.checks.items()}
    return line


def main(argv, t_start):
    args = parse(argv)
    root = specs.ROOT
    spec = specs.load_spec(root)
    cell, config, traffic, end_to_end, per_layer = specs.resolve_cell(spec, args.workload, root)
    limits = load_limits(args.workload)
    cache_dirs(root)
    if args.trace:
        os.environ["TEARDOWN_CUPTI"] = "0"

    import torch

    n_chips = cell["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < n_chips:
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{args.workload} needs {n_chips} CUDA card(s); {count} available",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    run = Run(cell, config, traffic, args.seed, args.seconds, bool(args.trace), root,
              torch.device("cuda", 0), limits, t_start)
    execute(run)
    found = specs.forbidden_modules(sys.modules)
    if found:
        print(f"modules of JAX or of the JAX package were loaded: {', '.join(found)}",
              file=sys.stderr)
        return 3
    line = result_line(run, end_to_end, per_layer, n_chips)
    for name, entry in run.checks.items():
        print(f"check {name} {entry['value']!r} limit {entry.get('limit')!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line))
    return 0
