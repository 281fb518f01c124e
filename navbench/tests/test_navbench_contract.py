"""BENCHMARK.json against the benchmark's rules, and every cell's files
found by name."""

import importlib
import inspect
import json
import os
import re

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"},
    "config": {"name", "source", "file", "reduced", "why"},
    "cell": {"name", "config", "traffic", "chips", "why"},
    "e2e": {"name", "unit", "better", "bound", "source"},
    "layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def _bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def bench():
    return _bench()


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_keys_and_names(bench):
    assert set(bench) == KEYS["top"]
    for c in bench["configs"]:
        assert set(c) == KEYS["config"]
    for w in bench["workloads"]:
        assert set(w) == KEYS["cell"]
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == KEYS["e2e"]
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == KEYS["layer"]
    names = [x["name"] for sec in ("configs", "workloads", "end_to_end",
                                   "per_layer") for x in bench[sec]]
    for n in names:
        assert NAME.match(n), n
    for sec in ("configs", "workloads"):
        ns = [x["name"] for x in bench[sec]]
        assert len(ns) == len(set(ns))
    ms = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(ms) == len(set(ms))


def test_command_and_paths(bench):
    cmd = bench["command"]
    assert 1 <= len(cmd) <= 32 and all(_line(w) for w in cmd)
    assert 1 <= len(bench["paths"]) <= 16
    for p in bench["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert not p.endswith("_torch")
    for w in cmd[1:]:
        if "/" in w:
            assert any(w.startswith(p + "/") for p in bench["paths"])


def test_metrics_follow_the_rules(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    cells = {w["name"] for w in bench["workloads"]}
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    layers = {}
    for m in bench["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert _line(m["layer"])
        # one per-layer metric, one end-to-end metric it moves, reported
        # in every cell that reports the per-layer one
        mv = e2e[m["moves"]]
        assert set(m["workloads"]) <= set(mv.get("workloads", cells))
        layers.setdefault(m["layer"], set()).add(m["name"])
        if m["unit"] == "%" and ("roofline" in m["name"]
                                 or "mfu" in m["name"]):
            assert m["better"] == "higher"
    assert {"kernels", "whole step", "device"} <= set(layers)
    for cell in cells:
        mine = {n for n, m in e2e.items() if cell in m.get("workloads",
                                                           cells)}
        assert "setup_s" in mine and len(mine) >= 2
        assert any(cell in m["workloads"] for m in bench["per_layer"])


def test_run_seconds_fit_a_full_check(bench):
    rs = bench["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    runs = 2 + 14 * 24
    assert runs * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_cells_resolve(bench):
    from navbench import harness
    confs = {c["name"]: c for c in bench["configs"]}
    n4 = sum(w["chips"] == 4 for w in bench["workloads"])
    assert n4 <= max(1, len(bench["workloads"]) // 4)
    for w in bench["workloads"]:
        assert w["chips"] in (1, 4) and _line(w["why"])
        assert w["config"] in confs
        _, cell, config, traffic, limits = harness.resolve(ROOT, w["name"])
        importlib.import_module(f"navbench.drivers.{traffic['driver']}")
        assert limits, f"{w['name']} has no limits file"
        for name, lim in limits.items():
            assert (lim["limit"] == lim["lower"] == 0
                    or lim["lower"] < lim["limit"] < lim["upper"]), name
    from navbench import common
    for c in bench["configs"]:
        assert _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith("navbench/")
        with open(os.path.join(ROOT, c["file"])) as f:
            spec = json.load(f)
        assert spec["name"] == c["name"]
        assert spec["source"] == c["source"]
        # what was cut: keys of the model block, listed alike in both
        # files ([] where nothing was)
        assert spec["reduced"] == c["reduced"]
        assert len(set(c["reduced"])) == len(c["reduced"]) <= 16
        assert set(c["reduced"]) <= set(spec["model"])
        # the reference and count modules it names (or the defaults)
        # import and provide what the harness calls
        ref, work = common.modules(spec)
        for name in ("Ref", "Drop"):
            assert callable(getattr(ref, name))
        assert "mode" in inspect.signature(ref.Ref).parameters
        for name in ("encode_text", "perceive", "score", "il_loss"):
            assert callable(getattr(ref.Ref, name))
        for name in ("perceive", "nav", "text", "train_step"):
            assert callable(getattr(work, name))
    for m in bench["per_layer"]:
        assert os.path.exists(os.path.join(ROOT, "navbench", "metrics",
                                           m["name"] + ".py"))


@pytest.mark.parametrize("conf", _bench()["configs"],
                         ids=lambda c: c["name"])
def test_config_file_matches_the_program(conf):
    from navbench import model_config, program
    with open(os.path.join(ROOT, conf["file"])) as f:
        spec = json.load(f)
    cfg = program.load_config(spec)      # raises on any difference
    assert spec["name"] == conf["name"]
    assert spec["model"]["task_type"] == cfg.task_type
    assert spec["model"] == model_config.model_block(cfg, spec["model"])


@pytest.mark.parametrize("name", ["r2r", "rxr"])
def test_r2r_and_rxr_use_the_default_modules(name):
    """A configuration file that names no modules (r2r's and rxr's) runs
    with `navbench/reference/model.py` and `navbench/work/model.py`
    themselves."""
    import time
    from navbench import common, harness
    from navbench.reference import model as reference
    from navbench.work import model as work
    first = next(w["name"] for w in _bench()["workloads"]
                 if w["config"] == name)
    _, cell, config, traffic, limits = harness.resolve(ROOT, first)
    assert "reference" not in config and "work" not in config
    ctx = common.Context(root=ROOT, cell=cell, config=config,
                         traffic=traffic, limits=limits, seed=1,
                         seconds=1.0, trace=False,
                         t_start=time.perf_counter())
    assert ctx.reference is reference and ctx.work is work


def test_a_module_that_does_not_import_is_a_resolve_error(tmp_path):
    """A configuration file naming a module that does not import makes
    the run exit 2, naming the module, before any driver runs."""
    import shutil
    from navbench import harness
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    for sub in ("configs", "traffic", "limits"):
        shutil.copytree(os.path.join(ROOT, "navbench", sub),
                        tmp_path / "navbench" / sub)
    path = tmp_path / "navbench" / "configs" / "r2r.json"
    spec = json.loads(path.read_text())
    spec["work"] = "navbench.work.no_such_count"
    path.write_text(json.dumps(spec))
    with pytest.raises(ValueError, match="no_such_count"):
        harness.resolve(str(tmp_path), "r2r.serve.c1")
    assert harness.main(["--workload", "r2r.serve.c1", "--seed", "1",
                         "--seconds", "1"], str(tmp_path), 0.0) == 2
