"""The control of the correctness check, and the planted faults, on the chip
at a cell's own size.

    python3 portbench/control.py --workload NAME --seeds 1,2,3 --seconds S \
        [--modes control,stale,half,token]

For each mode and seed, one run of the cell as ``run.py`` makes it (set-up,
closed loop, window of S seconds, the reference over the sampled requests).

- ``control``: the program as it is, and the same positions read by the
  control: the reference one precision step below the configuration's
  (``control_precision``) in the program's place. The control's numbers
  are judged by the cell's limits as the program's are
  (``control_correct``, which has to be false).
- a fault of ``portbench.faults`` (``stale``, ``half``, ``token``): the
  program with that fault planted; ``correct`` has to be false.

Prints one JSON line per run: the mode, ``correct``, the compared numbers
beside their limits, and every reading (``portbench.check.gaps``). A cell's
limit lies between the largest program reading over a dozen seeds and the
smallest control reading. The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def one(workload: str, seed: int, seconds: float, mode: str, root: Path = ROOT,
        device: str = "cuda") -> dict:
    """One run of ``mode`` on ``workload``: its line, as a dict."""
    from portbench import faults, run
    from portbench.spec import Bench, family

    if mode == "control":
        plant = contextlib.nullcontext()
    else:
        plant = faults.plant(mode, family(Bench(root).cell(workload).config))
    with plant:
        r = run.run(workload, seed, seconds, False, device=device, root=root,
                    t_start=time.perf_counter(), control=mode == "control",
                    keep_readings=True)
    line = {"workload": workload, "seed": seed, "mode": mode, "correct": r["correct"],
            "checks": r["checks"]}
    if mode == "control":
        line["control_correct"] = r["control_correct"]
        line["control_checks"] = r["control_checks"]
    line.update(r["readings"])
    line["metrics"] = {k: v["value"] for k, v in r["metrics"].items()}
    return line


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--modes", default="control")
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from portbench import run

    run.cache_dirs(ROOT)
    run.one_thread()
    for mode in args.modes.split(","):
        for seed in (int(s) for s in args.seeds.split(",")):
            print(json.dumps(one(args.workload, seed, args.seconds, mode)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
