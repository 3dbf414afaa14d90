"""The check sees a broken timed path: each fault a serving cell can have,
planted in the program under a whole nano run on the CPU, makes ``correct``
false; and the control, judged by the cell's limits as the program is,
comes out not correct. Both go through ``control.one``, the path the
chip runs take."""

import pytest

from portbench import control

# The float32 nano cell: its sound runs read 0, far below its limit; the
# bf16 nano cell's readings lie too near its limit for a fault to stand out
# at two layers (the XL cells' faults are read on the card, PERF.md).
CELLS = ["nano-tiny"]


@pytest.fixture(params=CELLS)
def cell(request):
    return request.param


def _run(root, cell, mode):
    return control.one(cell, 41, 1.5, mode, root=root, device="cpu")


def test_sound(nano_root, cell):
    assert _run(nano_root, cell, "control")["correct"] is True


def test_state_unchanged(nano_root, cell):
    r = _run(nano_root, cell, "stale")
    assert r["correct"] is False
    assert r["checks"]["logit_gap"]["value"] > r["checks"]["logit_gap"]["limit"]


def test_half_the_batch_left_out(nano_root, cell):
    assert _run(nano_root, cell, "half")["correct"] is False


def test_token_altered(nano_root, cell):
    assert _run(nano_root, cell, "token")["correct"] is False


def test_control_is_judged_by_the_limits(nano_root):
    """A control run judges the control's numbers by the cell's own limits,
    as it judges the program's. At two layers the control does not separate
    from the program (nano-q over 32 seeds on the CPU: its widest gap over
    3e-2 on one), so that it comes out false is read on the card at each
    cell's own size (``control.py``, PERF.md)."""
    from portbench import check

    r = control.one("nanoq-tiny", 43, 1.5, "control", root=nano_root, device="cpu")
    assert r["correct"] is True
    for name, c in r["control_checks"].items():
        key = "tokens_compared" if name == "tokens_compared" else "control_" + name
        assert c["value"] == r[key] and c["limit"] == r["checks"][name]["limit"]
    rows = check.judge_control(r, {"logit_gap": 3e-2, "tokens_compared_min": 10})
    assert r["control_correct"] is all(x["ok"] for x in rows)


def test_control_over_its_limit_is_not_correct():
    from portbench import check

    readings = {"tokens_compared": 3000, "logit_gap_mean": 2e-4, "control_logit_gap_mean": 2e-3,
                "control_logit_gap": 0.2, "control_flipped_share": 0.05}
    limits = {"logit_gap_mean": 1.4e-3, "tokens_compared_min": 100}
    assert all(x["ok"] for x in check.judge(readings, limits))
    rows = check.judge_control(readings, limits)
    assert [(x["name"], x["value"], x["ok"]) for x in rows] == [
        ("logit_gap_mean", 2e-3, False), ("tokens_compared", 3000, True)]


def test_faults_are_lifted_after_the_run(nano_root, cell):
    from zig_gpt2_tpu_torch.models import gpt2
    from zig_gpt2_tpu_torch.runtime import batcher

    before = (gpt2.decode_step, batcher.sample)
    for mode in ("stale", "token"):
        _run(nano_root, cell, mode)
    assert (gpt2.decode_step, batcher.sample) == before
