"""Where the benchmark finds its parts: everything by the name in BENCHMARK.json.

A cell (an entry of ``workloads``) names a configuration and a traffic mix.
Each part is a file of its own, so a new cell, configuration, mix or
per-layer metric is added by adding files, never by editing one:

- a configuration: the ``file`` its ``configs`` entry names;
- a traffic mix: ``portbench/traffic/<traffic>.json``;
- a cell's correctness limits: ``portbench/limits/<workload>.json``;
- a per-layer metric: ``portbench/metrics/<metric>.py``, a module with
  ``read(window) -> float | None``.

Every path is taken from the checkout root that holds ``BENCHMARK.json``.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
HOME = "portbench"


@dataclass
class Cell:
    name: str
    chips: int
    config: dict          # the configuration file's contents
    traffic: dict         # the traffic file's contents
    limits: dict          # {number: limit}
    end_to_end: list      # the BENCHMARK.json entries this cell reports
    per_layer: list


class Bench:
    def __init__(self, root: Path = ROOT):
        self.root = Path(root)
        self.spec = json.loads((self.root / "BENCHMARK.json").read_text())

    def _file(self, *parts: str) -> Path:
        return self.root.joinpath(HOME, *parts)

    def cell(self, workload: str) -> Cell:
        entries = {w["name"]: w for w in self.spec["workloads"]}
        if workload not in entries:
            raise KeyError(f"no workload {workload!r} in BENCHMARK.json; "
                           f"choices: {sorted(entries)}")
        w = entries[workload]
        configs = {c["name"]: c for c in self.spec["configs"]}
        config = json.loads((self.root / configs[w["config"]]["file"]).read_text())
        traffic = json.loads(self._file("traffic", f"{w['traffic']}.json").read_text())
        limits = json.loads(self._file("limits", f"{workload}.json").read_text())

        def mine(metrics):
            return [m for m in metrics if workload in m.get("workloads", [workload])]

        return Cell(workload, int(w["chips"]), config, traffic, limits,
                    mine(self.spec["end_to_end"]), mine(self.spec["per_layer"]))

    def reader(self, metric: str):
        """The ``read`` function of a per-layer metric's own module."""
        path = self._file("metrics", f"{metric}.py")
        spec = importlib.util.spec_from_file_location(f"portbench_metric_{metric}", path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module.read
