"""The manifest: every cell of ``BENCHMARK.json`` resolves to its files, and
a configuration, a traffic mix and a metric dropped in as new files are
found by name with no edit to the harness."""

from __future__ import annotations

import json
import re
import time
from pathlib import Path

from portbench.lib.bench import run_cell
from portbench.lib.judge import NUMBERS
from portbench.lib.manifest import load_cell

ROOT = Path(__file__).resolve().parents[2]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")


def test_manifest_loads_every_cell():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert bench["command"] == ["python3", "portbench/run.py"] and bench["paths"] == ["portbench"]
    names = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    assert "setup_s" in names
    for w in bench["workloads"]:
        cell = load_cell(ROOT, w["name"])
        assert cell.chips == w["chips"] and cell.config["name"] == w["config"]
        assert {n for n, *_ in cell.end_to_end} >= {"setup_s", "frames_per_s"}
        assert cell.per_layer and cell.limits and set(cell.limits) <= set(NUMBERS)
    for m in bench["per_layer"]:
        assert m["moves"] in {e["name"] for e in bench["end_to_end"]}


def test_new_files_are_found_by_name(tiny_root):
    """A throwaway configuration, traffic mix and metric, as files and
    entries only, run through the unchanged harness."""
    cfg = json.loads((tiny_root / "portbench/configs/tiny.json").read_text())
    cfg["name"] = "throwaway"
    cfg["lm"]["num_layers"] = 1
    (tiny_root / "portbench/configs/throwaway.json").write_text(json.dumps(cfg))
    traffic = json.loads((tiny_root / "portbench/traffic/tiny_solo.json").read_text())
    traffic["signal_frames"] = 7
    (tiny_root / "portbench/traffic/shortloop.json").write_text(json.dumps(traffic))
    (tiny_root / "portbench/metrics/steps_counted.py").write_text(
        "def read(run):\n    return float(len(run.step_ms))\n")
    (tiny_root / "portbench/limits/throwaway.shortloop.json").write_text(
        (tiny_root / "portbench/limits/tiny.tiny_solo.json").read_text())
    bench = json.loads((tiny_root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "throwaway", "source": "test", "why": "test",
                             "file": "portbench/configs/throwaway.json", "reduced": []})
    bench["workloads"].append({"name": "throwaway.shortloop", "config": "throwaway",
                               "traffic": "shortloop", "chips": 1, "why": "test"})
    bench["end_to_end"].append({"name": "steps_counted", "unit": "steps", "better": "higher",
                                "bound": 0.01, "source": "host_clock",
                                "workloads": ["throwaway.shortloop"]})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = load_cell(tiny_root, "throwaway.shortloop")
    assert cell.config["lm"]["num_layers"] == 1 and cell.traffic["signal_frames"] == 7
    result = run_cell(cell, 5, 0.5, False, "cpu", time.perf_counter())
    assert result["metrics"]["steps_counted"]["value"] >= 1
    assert result["correct"], result["checks"]
