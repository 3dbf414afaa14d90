"""On a card: a traced nano run reads every device metric from the profiler
(markers found, device time below the window's). Skips without a card.

    python -m pytest portbench/tests/test_portbench_card.py -q
"""

import time

import pytest

from portbench import run


@pytest.mark.cuda
def test_traced_run_on_the_card(card, nano_root):
    r = run.run("nanoq-tiny", 77, 3.0, True, device="cuda", root=nano_root,
                t_start=time.perf_counter())
    assert r["correct"] is True, r["checks"]
    m = {k: v["value"] for k, v in r["metrics"].items()}
    assert 0.0 < r["device"]["busy_s"] < r["device"]["window_s"]
    assert 0.0 <= m["device_idle"] < 100.0
    assert m["kernels_per_step"] > 0
    assert 0.0 < m["qmm_roofline"] <= 100.0 and 0.0 < m["attention_roofline"] <= 100.0
    assert r["breakdown"]["device_ops"] and r["breakdown"]["idle_gaps"]
