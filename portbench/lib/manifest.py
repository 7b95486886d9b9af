"""Find a cell's files by the names in ``BENCHMARK.json``.

A cell (an entry of ``workloads``) names a configuration and a traffic mix.
Its configuration's file is the one ``configs`` gives; its traffic is
``portbench/traffic/<traffic>.json``; its limits are
``portbench/limits/<cell>.json``; each metric it reports is read by
``portbench/metrics/<metric>.py``. A new cell, configuration, traffic mix or
metric is new files and new entries; nothing here changes.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list  # [(name, unit, reader)]
    per_layer: list


def _applies(metric: dict, cell: str, reported: set) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves", metric["name"]) in reported


def reader(root: Path, name: str):
    """The ``read`` function of ``portbench/metrics/<name>.py``."""
    path = Path(root) / "portbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name.replace('.', '_')}",
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def load_cell(root: Path, workload: str) -> Cell:
    root = Path(root)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json: {sorted(cells)}")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((root / configs[w["config"]]["file"]).read_text())
    traffic = json.loads((root / "portbench" / "traffic" / f"{w['traffic']}.json").read_text())
    limits = json.loads((root / "portbench" / "limits" / f"{workload}.json").read_text())
    e2e = [m for m in bench["end_to_end"] if "workloads" not in m or workload in m["workloads"]]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if _applies(m, workload, reported)]
    return Cell(workload, int(w["chips"]), config, traffic, limits,
                [(m["name"], m["unit"], reader(root, m["name"])) for m in e2e],
                [(m["name"], m["unit"], reader(root, m["name"])) for m in per_layer])
