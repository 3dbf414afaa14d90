"""The yardstick's arithmetic against hand-computed shapes."""

import json
from pathlib import Path

import pytest

from portbench import roofline
from portbench.spec import load_family

HOME = Path(__file__).resolve().parents[1]
GPT2 = load_family("gpt2", HOME.parent).model
XL = json.loads((HOME / "configs" / "gpt2-xl-int4-kv8.json").read_text())
SMALL = json.loads((HOME / "configs" / "gpt2-124m-fp32.json").read_text())


def test_qmm_int4_one_row_is_bound_by_bytes():
    # 1600 x 1600 INT4, groups of 32: 1,280,000 weight bytes, 50 x 1600 f32
    # scales, one bf16 row in, one f32 row out.
    nbytes = 1600 * 1600 / 2 + 4 * 50 * 1600 + 2 * 1600 + 4 * 1600
    assert roofline.qmm_call(XL, "int4", 1600, 1600, 1) == pytest.approx(nbytes / 3.35e12)


def test_qmm_int4_256_rows_is_bound_by_operations():
    ops = 2.0 * 256 * 1600 * 1600  # 1.32 us at bf16, against 1.21 us of bytes
    assert roofline.qmm_call(XL, "int4", 1600, 1600, 256) == pytest.approx(ops / 989e12)


def test_qmm_int8_lm_head():
    nbytes = 1600 * 50257 + 4 * 50257 + 2 * 1600 * 16 + 4 * 50257 * 16
    assert roofline.qmm_call(XL, "int8", 1600, 50257, 16) == pytest.approx(nbytes / 3.35e12)


def test_kv_row_bytes():
    # XL: 25 heads x 64 int8 for K and V, 13 pair scales each.
    assert GPT2.kv_row_bytes(XL) == 2 * (1600 + 4 * 13)
    assert GPT2.kv_row_bytes(SMALL) == 2 * 768 * 4


def test_decode_attention_lane():
    nbytes = 12 * (501 * 2 * 768 * 4 + 2 * 768 * 4)
    assert roofline.decode_attention_lane(SMALL, 500) == pytest.approx(nbytes / 3.35e12)


def test_token_flops_and_prompt_flops():
    L, E, V = 12, 768, 50257
    base = 2.0 * (12 * L * E * E + V * E)
    assert roofline.token_flops(SMALL, 10) == pytest.approx(base + 4.0 * L * E * 10)
    # positions 3, 4, 5 attend 4, 5, 6 rows
    want = sum(roofline.token_flops(SMALL, p + 1) for p in range(3, 6))
    assert roofline.prompt_flops(SMALL, 3, 6) == pytest.approx(want)


def test_peaks():
    assert roofline.peak_flops(XL) == 989e12
    assert roofline.peak_flops(SMALL) == 67e12


def test_phantom_head_is_not_counted():
    # The packed layout pads 1.5B's 25 heads to 26: Q/K/V are 1600 x 1664.
    assert roofline.qmm_call(XL, "int4", 1600, 1664, 128) == roofline.qmm_call(
        XL, "int4", 1600, 1600, 128)
    assert roofline.qmm_call(XL, "int4", 1664, 1600, 1) == roofline.qmm_call(
        XL, "int4", 1600, 1600, 1)
    assert GPT2.model_width(SMALL, 768) == 768
