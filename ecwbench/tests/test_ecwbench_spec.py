"""BENCHMARK.json against the benchmark's contract, and loading a cell's
files by name."""

import json
import os
import re

import pytest

from ecwbench.spec import ROOT, Spec

SP = Spec()
B = SP.bench
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
WIDTH = re.compile(r"(_dim|_rank)$|hidden|intermediate|latent|state|"
                   r"projection|head|expansion|experts_per_tok")


def line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level_keys():
    assert set(B) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert len(json.dumps(B)) <= 64 * 1024
    assert 1 <= B["run_seconds"] <= 51 and isinstance(B["run_seconds"], int)
    # a full check with 24 cells fits into its 43200 s
    assert (2 + 14 * 24) * (B["run_seconds"] + 60) + 24 * 180 + 1200 \
        <= 43200


def test_command_and_paths():
    assert 1 <= len(B["paths"]) <= 16
    for p in B["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert os.path.isdir(os.path.join(ROOT, p))
    assert 1 <= len(B["command"]) <= 32
    assert all(line(w) for w in B["command"])
    files = [w for w in B["command"] if w.endswith(".py")]
    assert files and all(any(f.startswith(p + "/") for p in B["paths"])
                         for f in files)


def test_names_units_and_entries():
    names = set()
    for c in B["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert line(c["source"]) and line(c["why"])
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) and not WIDTH.search(k)
                   for k in c["reduced"])
    for w in B["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and line(w["why"])
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
    for m in B["end_to_end"] + B["per_layer"]:
        extra = {"workloads"} if "workloads" in m else set()
        keys = {"name", "unit", "better", "source"} | extra
        keys |= ({"bound"} if m in B["end_to_end"]
                 else {"layer", "moves"})
        assert set(m) == keys, m["name"]
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in B[kind]:
            assert NAME.match(e["name"]), e["name"]
            assert e["name"] not in names
            names.add(e["name"])
    pairs = [(w["config"], w["traffic"]) for w in B["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_end_to_end_bounds():
    by = {m["name"]: m for m in B["end_to_end"]}
    assert "setup_s" in by and by["setup_s"]["bound"] <= 0.25
    for m in B["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


def test_every_cell_reports_what_it_must():
    for w in B["workloads"]:
        c = SP.cell(w["name"])
        e2e = {m["name"] for m in c.e2e}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert c.layer
        for m in c.layer:
            assert m["moves"] in e2e, (w["name"], m["name"])


def test_configs():
    used = {w["config"] for w in B["workloads"]}
    files = set()
    for c in B["configs"]:
        assert c["name"] in used
        assert any(c["file"].startswith(p + "/") for p in B["paths"])
        assert c["file"] not in files
        files.add(c["file"])
        cfg = json.load(open(os.path.join(ROOT, c["file"])))
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        for k in c["reduced"]:
            assert k in cfg and k in cfg["reduced"]


def test_layers_name_alike():
    layers = {m["layer"] for m in B["per_layer"]}
    assert all(line(x) for x in layers)


@pytest.mark.parametrize("name", [w["name"] for w in B["workloads"]])
def test_cell_loads_by_name(name):
    c = SP.cell(name)
    assert c.cfg["name"] == c.work["config"]
    assert c.traffic["job"] in ("sweep", "target")
    assert c.limits is not None and all(v >= 0 for v in c.limits.values())
    assert os.path.exists(os.path.join(ROOT, c.cfg["basis_file"]))


def test_unknown_workload():
    with pytest.raises(KeyError):
        SP.cell("no.such_cell")


def test_files_are_named_from_name_characters():
    for p in B["paths"]:
        for d, _, fs in os.walk(os.path.join(ROOT, p)):
            if "__pycache__" in d:
                continue
            for f in fs:
                rel = os.path.relpath(os.path.join(d, f), ROOT)
                assert PATH.match(rel), rel
