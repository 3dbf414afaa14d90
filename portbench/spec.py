"""Where the benchmark finds its parts: everything by the name in BENCHMARK.json.

A cell (an entry of ``workloads``) names a configuration and a traffic mix.
Each part is a file of its own, so a new cell, configuration, mix or
per-layer metric is added by adding files, never by editing one:

- a configuration: the ``file`` its ``configs`` entry names;
- its model family: the directory ``portbench/families/<model_type>/``
  named by the configuration's ``model_type``, which holds what knows the
  architecture (``Family`` below). A configuration of another
  architecture brings its family's directory beside its file;
- a traffic mix: ``portbench/traffic/<traffic>.json``;
- a cell's correctness limits: ``portbench/limits/<workload>.json``;
- a per-layer metric: ``portbench/metrics/<metric>.py``, a module with
  ``read(window) -> float | None``.

Every path is taken from the checkout root that holds ``BENCHMARK.json``.
The rest of the harness reads no key of a configuration but ``model_type``,
``vocab_size`` (the traffic's), ``compute_dtype`` (the peak ``mfu`` is read
against) and ``control_precision``; whatever else it says is its family's.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
HOME = "portbench"


def _module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class Family:
    """A model family's two modules, loaded from its directory.

    ``model`` (``model.py``) is plain: it imports torch, math, typing,
    numpy and the harness's shared arithmetic, never the program. It has
    ``context_rows(config)`` (the rows a request may fill),
    ``make_weights(config, seed, device)`` (the input both sides receive),
    ``Reference(weights, config, precision=None)`` (``.logits(ids,
    float_rows, first)``, and ``.at(precision)``: the same reference at
    another precision, sharing its weights), and the yardstick's arithmetic
    of the architecture: ``token_flops``, ``prompt_flops``,
    ``decode_attention_lane`` and ``qmm_call``.

    ``program`` (``program.py``, imported at first use) is the only place
    that knows the program's model: ``build(config, weights, traffic,
    sampling, device, on_token)`` returns the system under test, a
    ``ContinuousBatcher``, and ``model_module()`` the program module whose
    ``decode_step`` the batcher calls (where ``portbench.faults`` plants).
    """

    def __init__(self, model_type: str, home: Path):
        self.name = model_type
        self.home = home
        self.model = _module(home / "model.py", f"portbench_family_{model_type}_model")
        self._program = None

    @property
    def program(self):
        if self._program is None:
            self._program = _module(self.home / "program.py",
                                    f"portbench_family_{self.name}_program")
        return self._program


_FAMILIES: dict = {}   # (root, model_type) -> Family: each loaded once a process
_ROOT_OF: dict = {}    # model_type -> the root its family was last loaded from


def load_family(model_type: str, root: Path = ROOT) -> Family:
    """The family ``model_type`` of the checkout at ``root``."""
    root = Path(root).resolve()
    key = (root, model_type)
    if key not in _FAMILIES:
        home = root.joinpath(HOME, "families", model_type)
        if not (home / "model.py").is_file():
            raise FileNotFoundError(f"no family for model_type {model_type!r}: "
                                    f"{home / 'model.py'} does not exist")
        _FAMILIES[key] = Family(model_type, home)
    _ROOT_OF[model_type] = root
    return _FAMILIES[key]


def family(config: dict) -> Family:
    """The family of ``config``: from the root a cell of this process last
    loaded it from (``Bench.cell``), else from this harness's checkout."""
    model_type = config["model_type"]
    fam = _FAMILIES.get((_ROOT_OF.get(model_type), model_type))
    return fam if fam is not None else load_family(model_type)


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
        """The cell's parts; its configuration's family loaded from this root."""
        entries = {w["name"]: w for w in self.spec["workloads"]}
        if workload not in entries:
            raise KeyError(f"no workload {workload!r} in BENCHMARK.json; "
                           f"choices: {sorted(entries)}")
        w = entries[workload]
        configs = {c["name"]: c for c in self.spec["configs"]}
        config = json.loads((self.root / configs[w["config"]]["file"]).read_text())
        load_family(config["model_type"], self.root)
        traffic = json.loads(self._file("traffic", f"{w['traffic']}.json").read_text())
        limits = json.loads(self._file("limits", f"{workload}.json").read_text())

        def mine(metrics):
            return [m for m in metrics if workload in m.get("workloads", [workload])]

        return Cell(workload, int(w["chips"]), config, traffic, limits,
                    mine(self.spec["end_to_end"]), mine(self.spec["per_layer"]))

    def reader(self, metric: str):
        """The ``read`` function of a per-layer metric's own module."""
        return _module(self._file("metrics", f"{metric}.py"), f"portbench_metric_{metric}").read
