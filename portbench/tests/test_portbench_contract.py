"""``BENCHMARK.json`` against the contract's shapes, every item's files
resolving by name, and a new cell, configuration, traffic mix and metric
added as files alone."""

import json
import re
import shutil
import time

import pytest

from portbench.harness import cell, env, registry

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"^[^\n\t]{1,200}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def bench():
    return registry.benchmark()


def test_top_level_keys_and_sizes(bench):
    assert set(bench) == KEYS
    assert len(json.dumps(bench)) < 64 * 1024
    assert bench["command"] == ["python3", "portbench/run.py"]
    assert bench["paths"] == ["portbench"]
    assert all(PATH.match(p) and not p.startswith("/") and ".." not in p
               for p in bench["paths"])
    assert isinstance(bench["run_seconds"], int) and 1 <= bench["run_seconds"] <= 51
    cells = len(bench["workloads"])
    assert (2 + 14 * 24) * (bench["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert 1 <= cells <= 24 and 1 <= len(bench["configs"]) <= 24


def test_names_units_and_texts(bench):
    entries = (bench["configs"] + bench["workloads"] + bench["end_to_end"]
               + bench["per_layer"])
    for e in entries:
        assert NAME.match(e["name"]), e["name"]
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in bench[kind]]
        assert len(names) == len(set(names))
    all_metrics = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(all_metrics) == len(set(all_metrics))
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert TEXT.match(c["source"]) and TEXT.match(c["why"])
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["traffic"]) and w["chips"] in (1, 4)
        assert TEXT.match(w["why"])
    pairs = [(w["config"], w["traffic"]) for w in bench["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_metrics_shapes(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in bench["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    perf = (env.ROOT / "PERF.md").read_text()
    for m in bench["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert TEXT.match(m["layer"]) and m["moves"] in e2e
        # the layer as PERF.md's list of layers names it, letter for letter
        assert f"`{m['layer']}`" in perf, m["layer"]
        for w in m.get("workloads", []):
            reported = [x["name"] for x in registry.end_to_end(bench, w)]
            assert m["moves"] in reported, (m["name"], w)


def test_every_cell_reports_enough(bench):
    for w in bench["workloads"]:
        e2e = [m["name"] for m in registry.end_to_end(bench, w["name"])]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert registry.per_layer(bench, w["name"])
    used = {w["config"] for w in bench["workloads"]}
    assert used == {c["name"] for c in bench["configs"]}


def test_every_item_resolves_by_name(bench):
    files = [c["file"] for c in bench["configs"]]
    assert len(files) == len(set(files))
    for c in bench["configs"]:
        assert c["file"] == f"portbench/configs/{c['name']}.json"
        cfg = registry.config(c["name"])
        assert cfg["source"] == c["source"] and cfg["reduced"] == c["reduced"]
        registry.builder(c["name"])
        registry.reference(c["name"])
        registry.work(c["name"])
    for w in bench["workloads"]:
        mix = registry.traffic(w["traffic"])
        registry.driver(mix["driver"])
        assert registry.workload(w["name"])["limits"]
    for m in bench["per_layer"]:
        assert callable(registry.metric(m["name"]).read)


def test_names_are_checked_before_they_become_paths():
    for bad in ("../x", "a/b", ".hidden", "", "a b"):
        with pytest.raises(ValueError):
            registry.check_name(bad)


NEW_METRIC = '''"""Model operations per step, in GFLOP (a test metric)."""


def read(view):
    w = view.window
    return w.flops / w.units / 1e9 if w.units else None
'''


def test_a_new_cell_config_mix_and_metric_load_as_files(tmp_path, bench):
    """Copy the benchmark, add a configuration, a traffic mix, a cell and a
    per-layer metric as new files and entries, and run the new cell: no
    file that was there is edited."""
    root = tmp_path / "checkout"
    shutil.copytree(env.BENCH, root / "portbench",
                    ignore=shutil.ignore_patterns(".cache", "out",
                                                  "__pycache__"))
    b = root / "portbench"
    before = {p: p.read_bytes() for p in b.rglob("*") if p.is_file()}
    cfg = json.loads((b / "configs/lc-moe.json").read_text())
    cfg["name"] = "lc-moe-copy"
    (b / "configs/lc-moe-copy.json").write_text(json.dumps(cfg))
    for kind in ("configs", "reference", "work"):
        shutil.copy(b / kind / "lc-moe.py", b / kind / "lc-moe-copy.py")
    mix = json.loads((b / "traffic/train-b8-T2048.json").read_text())
    mix["params"].update(T=32, batch=2, cohort=8, profile_steps=1)
    (b / "traffic/train-b2-T32.json").write_text(json.dumps(mix))
    (b / "workloads/lc-copy-train-T32.json").write_text(
        (b / "workloads/lc-moe-train-T2048.json").read_text())
    (b / "metrics/work.gflop_per_step.py").write_text(NEW_METRIC)
    new = json.loads(json.dumps(bench))
    new["configs"].append({"name": "lc-moe-copy", "source": cfg["source"],
                           "file": "portbench/configs/lc-moe-copy.json",
                           "reduced": [], "why": "a copy"})
    new["workloads"].append({"name": "lc-copy-train-T32",
                             "config": "lc-moe-copy",
                             "traffic": "train-b2-T32", "chips": 1,
                             "why": "a copy"})
    new["end_to_end"][0]["workloads"].append("lc-copy-train-T32")
    new["per_layer"].append({"name": "work.gflop_per_step", "unit": "GFLOP",
                             "better": "lower", "source": "host_clock",
                             "layer": "model (models/)",
                             "moves": "train_samples_per_s",
                             "workloads": ["lc-copy-train-T32"]})
    (root / "BENCHMARK.json").write_text(json.dumps(new))
    ctx = cell.context("lc-copy-train-T32", 7, 0.2, True, "cpu",
                       time.perf_counter(), bench=new, bench_dir=b)
    result = cell.run(ctx, new)
    assert result["correct"]
    assert result["metrics"]["work.gflop_per_step"]["value"] > 0
    after = {p: p.read_bytes() for p in before}
    assert after == before
