"""Nothing the benchmark runs imports JAX or the JAX package: every module
that ecwbench/run.py reaches, its metric readers and kernel families
included, is scanned, each import's top-level name compared whole (the
port's name, ecw_cc_torch, begins with the JAX package's); and a tiny cell
runs with those imports made to fail."""

import ast
import json
import os
import subprocess
import sys

from ecwbench.spec import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "ecw_cc_tpu"}


def _file(mod):
    base = os.path.join(ROOT, *mod.split("."))
    for f in (base + ".py", os.path.join(base, "__init__.py")):
        if os.path.exists(f):
            return f
    return None


def _imports(path):
    """[(module, imported names)] of every import statement in the file,
    those inside functions included; relative imports resolved."""
    pkg = os.path.relpath(os.path.dirname(path), ROOT).replace(os.sep, ".")
    out = []
    for node in ast.walk(ast.parse(open(path).read())):
        if isinstance(node, ast.Import):
            out += [(a.name, ()) for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            mod = node.module or ""
            if node.level:
                parts = pkg.split(".")
                base = ".".join(parts[:len(parts) - node.level + 1])
                mod = f"{base}.{mod}" if mod else base
            out.append((mod, tuple(a.name for a in node.names)))
    return out


def reached():
    """{module: file} of the repository's modules reached from the
    benchmark's entry point, and the set of every imported top-level
    name."""
    roots = [os.path.join(ROOT, "ecwbench", "run.py"),
             os.path.join(ROOT, "ecwbench", "harness.py")]
    for sub in ("metrics", "kernels"):
        d = os.path.join(ROOT, "ecwbench", sub)
        roots += [os.path.join(d, f) for f in os.listdir(d)
                  if f.endswith(".py")]
    seen, tops, todo = {}, set(), list(roots)
    while todo:
        path = todo.pop()
        if path in seen.values():
            continue
        seen[os.path.relpath(path, ROOT)] = path
        for mod, names in _imports(path):
            tops.add(mod.split(".")[0])
            for m in [mod] + [f"{mod}.{n}" for n in names]:
                f = _file(m)
                if f is not None and f not in seen.values():
                    todo.append(f)
    return seen, tops


def test_no_module_the_benchmark_reaches_imports_jax():
    seen, tops = reached()
    assert "ecwbench/reference/solve.py" in seen
    assert "ecw_cc_torch/models/ecw.py" in seen
    assert "ecw_cc_torch/solvers/gs.py" in seen
    assert not tops & FORBIDDEN, sorted(tops & FORBIDDEN)


def test_the_reference_imports_nothing_of_the_program():
    d = os.path.join(ROOT, "ecwbench", "reference")
    for f in os.listdir(d):
        if f.endswith(".py"):
            for mod, _ in _imports(os.path.join(d, f)):
                assert mod.split(".")[0] not in FORBIDDEN | {"ecw_cc_torch"}


BLOCKED_RUN = r'''
import importlib.abc, json, sys, time, types

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in {"jax", "jaxlib", "flax", "ecw_cc_tpu"}:
            raise ImportError(f"{name} is blocked in this run")
        return None

sys.meta_path.insert(0, Block())
sys.path.insert(0, sys.argv[1])
from ecwbench import harness, spec
from ecwbench.reference import aoints, solve
cfg = json.load(open(sys.argv[1] + "/ecwbench/configs/c2h2_6-31pgss.json"))
cfg.update(basis="sto-3g", basis_file="ecwbench/reference/basis/sto-3g.json")
traffic = {"job": "sweep", "target": {"prop": "mat", "posthf": "CCSD(T)"},
           "lambdas": {"start": 0.0, "stop": 0.7, "num": 2},
           "ccsd_gs": {"diis": "tl", "conv_thres": 1e-6, "maxiter": 80}}
from ecwbench import check, jobs
atoms = jobs.geometry(cfg, 2**31 + 5)
work = jobs.Work(cfg, traffic, atoms, device="cpu")
rec = {**work.run(), "traced": False}
got = check.answers("sweep", work.setup_answers(), [rec])
ref = solve.solve(atoms, aoints.load_basis(
    sys.argv[1] + "/" + cfg["basis_file"]), jobs.lambdas(traffic))
nums, _ = check.numbers("sweep", got, ref)
print(json.dumps({"loaded": harness.forbidden_loaded(), "nums": nums}))
'''


def test_a_tiny_cell_runs_with_jax_imports_failing():
    p = subprocess.run([sys.executable, "-c", BLOCKED_RUN, ROOT],
                       capture_output=True, text=True, timeout=600,
                       cwd=ROOT)
    assert p.returncode == 0, p.stderr[-3000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["loaded"] == []
    assert out["nums"]["ep_gap"] < 1e-6
