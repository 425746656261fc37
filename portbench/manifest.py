"""The benchmark's manifest, ``BENCHMARK.json`` at the root of the
checkout, and the files it names. Everything that belongs to one
configuration, traffic mix, cell or metric is a file of its own, found by
its name: ``configs/<config>.json``, ``traffic/<traffic>.json``,
``checks/<cell>.json`` and ``metrics/<metric>.py``. Adding a cell adds
files and entries and edits none."""
from __future__ import annotations

import importlib
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def _load(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


class Manifest:
    """``BENCHMARK.json`` and lookups by name. `root` is the checkout (the
    directory holding ``BENCHMARK.json``), `bench` the benchmark's folder."""

    def __init__(self, root: Path = ROOT, bench: Path = HERE):
        self.data = _load(Path(root) / "BENCHMARK.json")
        self.bench = Path(bench)

    def workload(self, name: str) -> dict:
        for w in self.data["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        return _load(self.bench / "configs" / f"{name}.json")

    def traffic(self, name: str) -> dict:
        return _load(self.bench / "traffic" / f"{name}.json")

    def check(self, cell: str) -> dict:
        return _load(self.bench / "checks" / f"{cell}.json")

    def metrics(self, cell: str, traced: bool) -> list:
        """The metrics a run of `cell` reports: its end-to-end metrics with
        ``--trace 0``, its per-layer metrics with ``--trace 1``; a metric
        with a ``workloads`` key only in the cells it lists."""
        kind = "per_layer" if traced else "end_to_end"
        return [m for m in self.data[kind]
                if "workloads" not in m or cell in m["workloads"]]


def reader(metric: str):
    """The ``read(ctx)`` function of ``metrics/<metric>.py``."""
    return importlib.import_module(f"portbench.metrics.{metric}").read
