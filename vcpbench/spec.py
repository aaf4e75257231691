"""Where the benchmark finds what a cell is made of.

Everything that belongs to one configuration, one traffic mix, one cell
or one metric sits in a file of its own, found by the name that
``BENCHMARK.json`` gives it:

* a configuration: the ``file`` of its ``configs`` entry (the preset
  arguments, frame size and rate, and the guarantees the output keeps);
* a traffic mix: ``vcpbench/traffic/<traffic>.json``, the parameters of
  the one content generator (``content.py``) and of the closed loop;
* a cell's limits: ``vcpbench/limits/<workload>.json``, one limit per
  number that decides ``correct`` (``check.py``);
* a metric: ``vcpbench/metrics/<name>.py``, a reader with ``read(obs)``
  that returns the value or None when the run holds nothing to read.

A later change adds a configuration, a mix, a cell or a metric by adding
files and entries; no existing file needs an edit.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


class SpecError(ValueError):
    pass


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict          # the configuration's file, as it is run
    traffic: dict         # the traffic mix's parameters
    limits: dict          # {number: limit} of the comparison
    end_to_end: list      # BENCHMARK.json metric entries of this cell
    per_layer: list


def _load_json(path: str) -> dict:
    try:
        with open(path) as fh:
            return json.load(fh)
    except OSError as e:
        raise SpecError(f"cannot read {path}: {e}") from e


def _applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def load_cell(workload: str) -> Cell:
    """The cell named ``workload`` of ``BENCHMARK.json`` with its files."""
    bench = _load_json(os.path.join(ROOT, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SpecError(f"no workload {workload!r} in BENCHMARK.json "
                        f"(have {sorted(cells)})")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    if w["config"] not in configs:
        raise SpecError(f"workload {workload!r} names configuration "
                        f"{w['config']!r}, which BENCHMARK.json lacks")
    return Cell(
        name=workload, chips=int(w["chips"]),
        config=_load_json(os.path.join(ROOT, configs[w["config"]]["file"])),
        traffic=_load_json(os.path.join(HERE, "traffic",
                                        w["traffic"] + ".json")),
        limits=_load_json(os.path.join(HERE, "limits", workload + ".json")),
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, workload)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, workload)])


def reader(name: str):
    """The ``read`` function of ``vcpbench/metrics/<name>.py``."""
    path = os.path.join(HERE, "metrics", name + ".py")
    if not os.path.exists(path):
        raise SpecError(f"metric {name!r} has no reader at {path}")
    mod_name = "vcpbench_metric_" + "".join(
        c if c.isalnum() else "_" for c in name)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
