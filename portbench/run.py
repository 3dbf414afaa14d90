"""One run of one cell of the port's benchmark.

    python3 portbench/run.py --workload NAME --seed N --seconds S --trace 0|1

Runs from the root of a checkout, on a machine whose CUDA cards number at
least the cell's ``chips``. Prints the result as the last line of standard
output (one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics``, ``device``, with ``--trace 1`` also ``breakdown``, and last
``checks``: each compared number beside its limit) and the same checks as
the last lines of standard error. With ``--trace 0`` the metrics are the
cell's end-to-end ones; with ``--trace 1`` its per-layer ones.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "zig_gpt2_tpu")


def one_thread() -> None:
    """The host side in one thread: the program is host-bound, and idle
    OpenMP workers spinning beside its dispatch thread on a shared host make
    its speed vary from run to run. Before torch is imported."""
    for name in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[name] = "1"


def cache_dirs(root: Path) -> None:
    """Every build and kernel cache at a fixed path inside the checkout, so
    that only a checkout's first run builds."""
    base = root / ".portbench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(base / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(base / "triton")


def forbidden_modules(modules=None) -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    names = {m.split(".")[0] for m in (sys.modules if modules is None else modules)}
    return sorted(names.intersection(FORBIDDEN))


def run(workload: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
        root: Path = ROOT, t_start: float = T_START, control: bool = False,
        keep_readings: bool = False) -> dict:
    """The result of one run (``keep_readings``: also every reading under
    ``readings``; ``control``: the control's readings among them, and the
    control judged by the cell's limits under ``control_correct`` and
    ``control_checks``)."""
    import torch

    from portbench import check
    from portbench.serve import serve
    from portbench.spec import Bench, family
    from portbench.trace import Tracer, breakdown
    from portbench.traffic import Traffic

    bench = Bench(root)
    cell = bench.cell(workload)
    config = cell.config
    traffic = Traffic(cell.traffic, seed, config["vocab_size"])
    if traffic.longest() > family(config).model.context_rows(config) - 24:
        raise ValueError(f"{workload}: a request can need {traffic.longest()} rows")
    tracer = Tracer(seconds) if trace else None
    out = serve(config, traffic, seed, seconds, device, t_start, tracer)

    picked = check.sample(out.done, traffic.check, seed)
    readings = check.gaps(config, seed, picked, torch.device(device),
                          config["control_precision"] if control else None)
    rows = check.judge(readings, cell.limits)
    metrics = {}
    if trace:
        for m in cell.per_layer:
            value = bench.reader(m["name"])(out.window)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": out.end_to_end[m["name"]], "unit": m["unit"]}
    correct = all(r["ok"] for r in rows) and all(
        math.isfinite(m["value"]) for m in metrics.values())
    dev = {"platform": "gpu" if device == "cuda" else device,
           "kind": torch.cuda.get_device_name(0) if device == "cuda" else device,
           "count": cell.chips, "memory_peak_bytes": out.memory_peak_bytes}
    result = {"correct": correct, "attempted": out.attempted, "failed": 0,
              "metrics": metrics, "device": dev}
    if trace:
        dev["busy_s"] = sum(s.busy_s for s in out.window.steps)
        dev["window_s"] = sum(s.span_s for s in out.window.steps)
        result["breakdown"] = breakdown(out.window.steps)
    if control or keep_readings:
        result["readings"] = readings
    if control:
        controls = check.judge_control(readings, cell.limits)
        result["control_correct"] = all(r["ok"] for r in controls)
        result["control_checks"] = {r["name"]: {"value": r["value"], "limit": r["limit"]}
                                    for r in controls}
    result["checks"] = {r["name"]: {"value": r["value"], "limit": r["limit"]} for r in rows}
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    cache_dirs(ROOT)
    one_thread()
    import torch

    torch.set_num_threads(1)

    from portbench.spec import Bench

    chips = Bench(ROOT).cell(args.workload).chips
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: {args.workload} needs {chips} CUDA card(s), found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = run(args.workload, args.seed, args.seconds, bool(args.trace))
    found = forbidden_modules()
    if found:
        print(f"portbench: the run loaded {found}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} = {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
