"""Training metric aggregation and logging (counterpart of
``rstnet_tpu/utils/reporter.py``, copied: the port imports nothing of the JAX
package). Typed reductions (Average, WeightedAverage), windowed log
messages, wall-clock timers (measure_time, measure_iter_time), per-epoch
observation contexts, best-epoch selection, early stopping, and a
state_dict for checkpoint resume.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from collections import defaultdict
from contextlib import contextmanager
from typing import Iterable, Optional


@dataclasses.dataclass
class Average:
    value: float

    def __float__(self):
        return float(self.value)


@dataclasses.dataclass
class WeightedAverage:
    value: float
    weight: float

    def __float__(self):
        return float(self.value)


def to_reported_value(v, weight: Optional[float] = None):
    v = float(v)
    return WeightedAverage(v, weight) if weight is not None else Average(v)


def aggregate(values: Iterable) -> float:
    values = list(values)
    if not values:
        return float("nan")
    if isinstance(values[0], WeightedAverage):
        total_w = sum(v.weight for v in values)
        return sum(v.value * v.weight for v in values) / max(total_w, 1e-12)
    return sum(float(v) for v in values) / len(values)


class SubReporter:
    """Accumulates metrics within one (epoch, key) observation."""

    def __init__(self, key: str, epoch: int, total_count: int = 0):
        self.key = key
        self.epoch = epoch
        self.start_time = time.perf_counter()
        self.stats: dict[str, list] = defaultdict(list)
        self.total_count = total_count  # cumulative steps across epochs
        self.count = 0
        self._seen_in_step: set = set()

    def get_total_count(self) -> int:
        return self.total_count

    def register(self, stats: dict, weight: Optional[float] = None) -> None:
        for k, v in stats.items():
            if v is None:
                continue
            r = to_reported_value(v, weight)
            # pad skipped steps so every series has equal length
            while len(self.stats[k]) < self.count:
                self.stats[k].append(None)
            self.stats[k].append(r)

    def next(self) -> None:
        self.count += 1
        self.total_count += 1

    @contextmanager
    def measure_time(self, name: str):
        t0 = time.perf_counter()
        yield
        self.register({name: time.perf_counter() - t0})

    def measure_iter_time(self, iterable, name: str):
        it = iter(iterable)
        while True:
            t0 = time.perf_counter()
            try:
                item = next(it)
            except StopIteration:
                break
            self.register({name: time.perf_counter() - t0})
            yield item

    def log_message(self, start: Optional[int] = None, end: Optional[int] = None) -> str:
        if start is None:
            start = 0
        if start < 0:
            start = max(0, self.count + start)
        if end is None:
            end = self.count
        parts = []
        for k, values in self.stats.items():
            window = [v for v in values[start:end] if v is not None]
            if window:
                parts.append(f"{k}={aggregate(window):.4g}")
        return f"{self.key} epoch {self.epoch} [{start}-{end}] " + ", ".join(parts)

    def finished(self) -> dict[str, float]:
        return {
            k: aggregate([v for v in vals if v is not None])
            for k, vals in self.stats.items()
        }

    def tensorboard_add_scalar(self, writer, start: Optional[int] = None) -> None:
        if start is None:
            start = 0
        for k, values in self.stats.items():
            window = [v for v in values[start:] if v is not None]
            if window:
                writer.add_scalar(f"{self.key}/{k}", aggregate(window), self.total_count)

    def wandb_log(self, start: Optional[int] = None) -> None:
        import wandb

        if start is None:
            start = 0
        log = {
            f"{self.key}/{k}": aggregate([v for v in vals[start:] if v is not None])
            for k, vals in self.stats.items()
        }
        log["iteration"] = self.total_count
        wandb.log(log)


class Reporter:
    """Cross-epoch metric store with best-epoch and early-stopping logic."""

    def __init__(self):
        self.epoch = 0
        self.stats: dict[int, dict[str, dict[str, float]]] = {}
        self._total_counts: dict[str, int] = defaultdict(int)

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def get_epoch(self) -> int:
        return self.epoch

    @contextmanager
    def observe(self, key: str, epoch: Optional[int] = None):
        epoch = epoch if epoch is not None else self.epoch
        sub = SubReporter(key, epoch, self._total_counts[key])
        try:
            yield sub
        finally:
            self._total_counts[key] = sub.total_count
            self.stats.setdefault(epoch, {})[key] = sub.finished()

    def get_value(self, key: str, metric: str, epoch: Optional[int] = None) -> float:
        epoch = epoch if epoch is not None else self.epoch
        return self.stats[epoch][key][metric]

    def has(self, key: str, metric: str, epoch: Optional[int] = None) -> bool:
        epoch = epoch if epoch is not None else self.epoch
        return metric in self.stats.get(epoch, {}).get(key, {})

    def best_epoch(self, key: str, metric: str, mode: str = "min") -> int:
        assert mode in ("min", "max")
        candidates = [
            (v[key][metric], ep) for ep, v in self.stats.items() if metric in v.get(key, {})
        ]
        if not candidates:
            return -1
        return (min if mode == "min" else max)(candidates)[1]

    def check_early_stopping(
        self, patience: int, key: str, metric: str, mode: str = "min"
    ) -> bool:
        best = self.best_epoch(key, metric, mode)
        stop = self.epoch - best > patience
        if stop:
            logging.info(
                f"early stopping: {key}/{metric} has not improved for {patience} epochs"
            )
        return stop

    def log_message(self, epoch: Optional[int] = None) -> str:
        epoch = epoch if epoch is not None else self.epoch
        parts = []
        for key, metrics in self.stats.get(epoch, {}).items():
            body = ", ".join(f"{k}={v:.4g}" for k, v in metrics.items())
            parts.append(f"[{key}] {body}")
        return f"epoch {epoch}: " + " | ".join(parts)

    def matplotlib_plot(self, output_dir: str) -> None:
        import os

        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        os.makedirs(output_dir, exist_ok=True)
        keys = {
            (key, metric)
            for v in self.stats.values()
            for key, metrics in v.items()
            for metric in metrics
        }
        for key, metric in keys:
            eps = sorted(ep for ep in self.stats if metric in self.stats[ep].get(key, {}))
            if not eps:
                continue
            plt.figure()
            plt.plot(eps, [self.stats[ep][key][metric] for ep in eps], marker="o")
            plt.xlabel("epoch")
            plt.title(f"{key}/{metric}")
            plt.grid(True)
            plt.savefig(os.path.join(output_dir, f"{key}_{metric}.png"))
            plt.close()

    def state_dict(self) -> dict:
        return {
            "epoch": self.epoch,
            "stats": self.stats,
            "total_counts": dict(self._total_counts),
        }

    def load_state_dict(self, d: dict) -> None:
        self.epoch = d["epoch"]
        self.stats = {int(k): v for k, v in d["stats"].items()}
        self._total_counts = defaultdict(int, d.get("total_counts", {}))
