"""A throwaway benchmark root for the CPU tests: ``BENCHMARK.json`` and the
``portbench/`` data files of two cells over the tiny configuration, with the
repository's metric readers.

Run from the repository's root: ``python -m pytest -o addopts="" -q
portbench/tests`` (the ``cuda`` cases run where there is a card)."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import pytest
import torch

PORTBENCH = Path(__file__).resolve().parent.parent
DATA = Path(__file__).resolve().parent / "data"
CELLS = ("tiny.tiny_batch", "tiny.tiny_solo")


def make_root(root: Path) -> Path:
    for sub in ("configs", "traffic", "limits"):
        (root / "portbench" / sub).mkdir(parents=True, exist_ok=True)
    shutil.copytree(PORTBENCH / "metrics", root / "portbench" / "metrics", dirs_exist_ok=True)
    shutil.copy(DATA / "tiny.json", root / "portbench" / "configs" / "tiny.json")
    for cell in CELLS:
        traffic = cell.split(".")[1]
        shutil.copy(DATA / f"{traffic}.json", root / "portbench" / "traffic" / f"{traffic}.json")
        shutil.copy(DATA / "tiny_limits.json", root / "portbench" / "limits" / f"{cell}.json")
    bench = json.loads((PORTBENCH.parent / "BENCHMARK.json").read_text())
    bench["configs"] = [{"name": "tiny", "source": "test", "file": "portbench/configs/tiny.json",
                         "reduced": [], "why": "test"}]
    bench["workloads"] = [{"name": c, "config": "tiny", "traffic": c.split(".")[1], "chips": 1,
                           "why": "test"} for c in CELLS]
    bench["per_layer"] = [dict(m, workloads=list(CELLS)) for m in bench["per_layer"]]
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


@pytest.fixture
def tiny_root(tmp_path):
    torch.set_num_threads(2)
    return make_root(tmp_path)
