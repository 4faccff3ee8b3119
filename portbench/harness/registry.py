"""Find every item of the benchmark by its name.

A configuration, a traffic mix, a traffic driver, a cell's limits, a
per-layer metric, a work counter and a plain reference each sit in files of
their own, found here by the name ``BENCHMARK.json`` or a traffic mix gives
them. A later change adds an item by adding its files and entries;
no file here lists items.

- ``BENCHMARK.json`` at the checkout's root: cells (each a configuration
  and a traffic mix by name), metrics, bounds.
- ``configs/<config>.json``: the configuration as it is run, with the
  module classes of the layers its spans cover; beside it
  ``configs/<config>.py``, which builds the port's model from the seed.
- ``traffic/<traffic>.json``: a traffic mix, the data its driver reads.
- ``drivers/<driver>.py``: a traffic driver (``setup``, ``measure``,
  ``check``, ``control``), named by the mix.
- ``workloads/<cell>.json``: the limits that decide the cell's
  ``correct``.
- ``metrics/<metric>.py``: a per-layer reader, ``read(view)``.
- ``work/<config>.py``: the operations one sample needs, from shapes.
- ``reference/<config>.py``: the plain PyTorch reference.
"""

from __future__ import annotations

import importlib.util
import json
import re
import sys
import zlib
from pathlib import Path
from types import ModuleType
from typing import List, Optional

from portbench.harness.env import BENCH, ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def check_name(name: str) -> str:
    """``name`` if it is a valid item name (letters, digits, ``_ . -``, at
    most 64, no leading dot or dash); raise otherwise, since a name becomes
    a file name."""
    if not isinstance(name, str) or not NAME.match(name):
        raise ValueError(f"not a valid name: {name!r}")
    return name


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def _file(kind: str, name: str, suffix: str, bench: Path) -> Path:
    path = bench / kind / f"{check_name(name)}{suffix}"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1] if kind.endswith('s') else kind}"
                                f" file for {name!r}: {path}")
    return path


def workload(name: str, bench: Path = BENCH) -> dict:
    return load_json(_file("workloads", name, ".json", bench))


def traffic(name: str, bench: Path = BENCH) -> dict:
    mix = load_json(_file("traffic", name, ".json", bench))
    mix.setdefault("name", name)
    return mix


def config(name: str, bench: Path = BENCH) -> dict:
    cfg = load_json(_file("configs", name, ".json", bench))
    cfg.setdefault("name", name)
    return cfg


def load_module(path: Path) -> ModuleType:
    """Import the file at ``path`` as a module of its own name (from its
    kind, its stem and its folder), once per process."""
    path = path.resolve()
    tag = f"{zlib.crc32(str(path.parent).encode()):08x}"
    mod_name = "portbench_item." + re.sub(
        r"[^A-Za-z0-9_]", "_", f"{path.parent.name}.{path.stem}.{tag}")
    if mod_name in sys.modules:
        return sys.modules[mod_name]
    spec = importlib.util.spec_from_file_location(mod_name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = module
    try:
        spec.loader.exec_module(module)
    except BaseException:
        del sys.modules[mod_name]
        raise
    return module


def builder(config_name: str, bench: Path = BENCH) -> ModuleType:
    return load_module(_file("configs", config_name, ".py", bench))


def reference(config_name: str, bench: Path = BENCH) -> ModuleType:
    return load_module(_file("reference", config_name, ".py", bench))


def work(config_name: str, bench: Path = BENCH) -> ModuleType:
    return load_module(_file("work", config_name, ".py", bench))


def driver(name: str, bench: Path = BENCH) -> ModuleType:
    return load_module(_file("drivers", name, ".py", bench))


def metric(name: str, bench: Path = BENCH) -> ModuleType:
    return load_module(_file("metrics", name, ".py", bench))


def cell(bench_json: dict, name: str) -> dict:
    for entry in bench_json["workloads"]:
        if entry["name"] == name:
            return entry
    raise KeyError(f"no cell {name!r} in BENCHMARK.json")


def _applies(metric_entry: dict, cell_name: str,
             reported: Optional[set] = None) -> bool:
    if "workloads" in metric_entry:
        return cell_name in metric_entry["workloads"]
    return reported is None or metric_entry.get("moves") in reported


def end_to_end(bench_json: dict, cell_name: str) -> List[dict]:
    """The end-to-end metrics the cell reports."""
    return [m for m in bench_json["end_to_end"] if _applies(m, cell_name)]


def per_layer(bench_json: dict, cell_name: str) -> List[dict]:
    """The per-layer metrics read in the cell's traced run: those listing
    it, and those with no list that move an end-to-end metric it reports."""
    reported = {m["name"] for m in end_to_end(bench_json, cell_name)}
    return [m for m in bench_json["per_layer"]
            if _applies(m, cell_name, reported)]
