"""What a run reads by name: BENCHMARK.json, a cell's configuration and
traffic files, its correctness limits, the per-layer metric readers and
the kernel families.

Everything that belongs to one configuration, traffic mix, metric or
kernel family is a file of its own under ecwbench/, found from the name
BENCHMARK.json gives it, so a cell or a metric is added by adding files:

  configs/<config>.json        the deployment (molecule, basis, precision)
  traffic/<traffic>.json       the job and its arguments
  limits/<workload>.json       the limit of each number `correct` compares
  metrics/<metric>.py          read(ctx) -> value or None
  kernels/<family>.py          PATTERN (kernel names) and the work of a
                               product
"""

from __future__ import annotations

import importlib.util
import json
import os
import types

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load_json(path):
    with open(path) as f:
        return json.load(f)


class Spec:
    """The benchmark of the checkout at `root`, its harness in
    root/ecwbench."""

    def __init__(self, root=ROOT):
        self.root = root
        self.dir = os.path.join(root, "ecwbench")
        self.bench = load_json(os.path.join(root, "BENCHMARK.json"))

    def path(self, rel):
        return os.path.join(self.root, rel)

    def cell(self, name):
        """The workload `name`: its entry, configuration entry and file,
        traffic file, limits (None where it has none), and its end-to-end
        and per-layer metric entries."""
        work = {w["name"]: w for w in self.bench["workloads"]}
        if name not in work:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json; "
                           f"known: {sorted(work)}")
        w = work[name]
        conf = {c["name"]: c for c in self.bench["configs"]}[w["config"]]
        lim = os.path.join(self.dir, "limits", name + ".json")

        def applies(m):
            return "workloads" not in m or name in m["workloads"]

        return types.SimpleNamespace(
            work=w, conf=conf, cfg=load_json(self.path(conf["file"])),
            traffic=load_json(os.path.join(self.dir, "traffic",
                                           w["traffic"] + ".json")),
            limits=load_json(lim) if os.path.exists(lim) else None,
            e2e=[m for m in self.bench["end_to_end"] if applies(m)],
            layer=[m for m in self.bench["per_layer"] if applies(m)])

    def metric_reader(self, name):
        """The read(ctx) of metrics/<name>.py."""
        return _module(os.path.join(self.dir, "metrics", name + ".py"),
                       "ecwbench_metric_" + name.replace(".", "_")).read

    def kernel_families(self):
        """{family: module} of every kernels/<family>.py."""
        d = os.path.join(self.dir, "kernels")
        return {f[:-3]: _module(os.path.join(d, f),
                                "ecwbench_kernels_" + f[:-3])
                for f in sorted(os.listdir(d))
                if f.endswith(".py") and not f.startswith("_")}


def _module(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
