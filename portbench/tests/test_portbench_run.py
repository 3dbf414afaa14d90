"""Whole runs of throwaway nano cells on the CPU (``run.run`` with the card
check skipped), made from new files alone."""

import json
import subprocess
import sys
import time
from pathlib import Path

import pytest

from portbench import run

ROOT = Path(__file__).resolve().parents[2]
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("cell", ["nano-tiny", "nanoq-tiny", "nanoq-prefix"])
def test_untraced_run(nano_root, cell):
    r = run.run(cell, 2 ** 31 + 99, 1.5, False, device="cpu", root=nano_root,
                t_start=time.perf_counter())
    assert list(r) == KEYS + ["checks"]
    assert r["correct"] is True, r["checks"]
    assert r["failed"] == 0 and r["attempted"] > 0
    assert set(r["metrics"]) == {"tokens_per_s", "ttft_ms_p95", "itl_ms_p95", "itl_ms_p10",
                                 "setup_s"}
    assert all(m["value"] > 0 for m in r["metrics"].values())
    assert set(r["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert r["checks"]["logit_gap"]["value"] <= r["checks"]["logit_gap"]["limit"]
    json.dumps(r)


def test_traced_run_reads_the_host_metrics(nano_root, monkeypatch):
    import torch

    from portbench import trace

    # No card: the profiler records the host only, the markers are no-ops.
    monkeypatch.setattr(trace, "ACTIVITIES", ("CPU",))
    monkeypatch.setattr(torch.cuda, "_sleep", lambda cycles: None)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    r = run.run("nanoq-prefix", 3, 1.5, True, device="cpu", root=nano_root,
                t_start=time.perf_counter())
    assert list(r) == KEYS + ["breakdown", "checks"]
    assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
    got = set(r["metrics"])
    assert {"slot_utilization", "admission_share", "prefix_token_share",
            "decode_step_ms_p50", "mfu", "ttft_ms_p95.host"} <= got
    assert 60.0 < r["metrics"]["prefix_token_share"]["value"] < 95.0  # 20 of ~27 rows
    assert r["metrics"]["slot_utilization"]["value"] == pytest.approx(100.0)


def test_main_refuses_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    proc = subprocess.run([sys.executable, str(ROOT / "portbench" / "run.py"), "--workload",
                           "xl-int4-chat", "--seed", "1", "--seconds", "1", "--trace", "0"],
                          capture_output=True, text=True, cwd=ROOT, timeout=300)
    assert proc.returncode != 0 and proc.stdout == ""


def test_main_refuses_without_the_program(tmp_path):
    import shutil

    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    proc = subprocess.run([sys.executable, "portbench/run.py", "--workload", "xl-int4-chat",
                           "--seed", "1", "--seconds", "1", "--trace", "0"],
                          capture_output=True, text=True, cwd=tmp_path, timeout=300)
    assert proc.returncode != 0 and proc.stdout == ""
