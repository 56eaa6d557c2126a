"""Finds what a cell is made of, by name, from ``BENCHMARK.json``.

A cell (an entry of ``workloads``) names a configuration and a traffic mix.
The configuration's file is the one its ``configs`` entry gives; the mix is
``mixes/<traffic>.json``; the limits of the numbers that decide ``correct``
are ``limits/<cell>.json``; each metric's reader is ``metrics/<name>.py`` or,
where there is none, ``metrics/<name up to the first dot>.py``; the encoder
a configuration names is ``encoders/<encoder>.py``; the loop a mix names is
``loops/<loop>.py``. So a cell, a mix or a metric is added as files and
entries alone.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    mix: dict
    end_to_end: list          # metric entries that report in this cell
    per_layer: list
    limits: dict              # number compared -> its limit


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    spec = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; there are "
                       f"{sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in spec["configs"]}
    config = json.loads((root / configs[w["config"]]["file"]).read_text())
    mix = load_mix(w["traffic"], root)
    limits = json.loads((bench_dir(root) / "limits" / f"{name}.json")
                        .read_text())
    return Cell(name, int(w["chips"]), config, mix,
                [m for m in spec["end_to_end"] if _reports(m, name)],
                [m for m in spec["per_layer"] if _reports(m, name)],
                {k: v for k, v in limits.items() if k != "readings"})


def bench_dir(root: Path) -> Path:
    return root / HERE.name


def load_mix(traffic: str, root: Path = ROOT) -> dict:
    return json.loads((bench_dir(root) / "mixes" / f"{traffic}.json")
                      .read_text())


def _load_file(path: Path, modname: str):
    spec = importlib.util.spec_from_file_location(modname, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(metric: str, root: Path = ROOT):
    """The module whose ``read(run)`` gives ``metric``."""
    d = bench_dir(root) / "metrics"
    for stem in (metric, metric.split(".")[0]):
        path = d / f"{stem}.py"
        if path.exists():
            return _load_file(path, f"benchmark_metric_{stem.replace('.', '_')}")
    raise FileNotFoundError(f"no reader for metric {metric!r} under {d}")


def encoder(name: str):
    return importlib.import_module(f"{__package__}.encoders.{name}")


def loop(name: str):
    return importlib.import_module(f"{__package__}.loops.{name}")
