"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: without a card every test skips. This file imports
neither JAX nor the JAX package, so it runs on a machine that has only
PyTorch, without the repo's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

Tolerances: attention, float or INT8 cache, prefix or ring, f32 atol/rtol
2e-5 (the same f32 online softmax in another order), bf16 one bf16 ulp
(rtol 8e-3, atol 1e-4: kernel and plain version each round one f32 result
to bf16 once); the ring kernel over caches rotated by start against the
prefix kernel over the linear caches, bit for bit (one logical row order);
qmm atol/rtol 2e-5 for f32 and bf16 activations alike (f32 sums in another
order; a bf16 x times a bf16 or int8 weight is exact in f32); the w8a8 body
of qmm bit for bit (int32 sums are exact, and kernel and plain version
quantize x and take the f32 tail in one order), and ``w8a8_matmul`` through
``torch._int_mm`` equal to its f64 product; wmm atol/rtol 1e-4 (f32 sums of
up to 8192 products in another order than the plain version's matmul), two
calls bit-identical (the splits are added in split order);
sampler ids identical, its return_max z* within 2 ulp of the plain
version's (equal bits expected).
"""

import dataclasses

import numpy as np
import pytest
import torch

from zig_gpt2_tpu_torch import config as tconfig
from zig_gpt2_tpu_torch.config import SamplingConfig
from zig_gpt2_tpu_torch.models import gpt2
from zig_gpt2_tpu_torch.ops import attention as att
from zig_gpt2_tpu_torch.ops import layers as ops
from zig_gpt2_tpu_torch.ops import sampling_kernel as sk
from zig_gpt2_tpu_torch.ops import tallies
from zig_gpt2_tpu_torch.quant import kernels as qk
from zig_gpt2_tpu_torch.quant import quantize as quant
from zig_gpt2_tpu_torch.runtime.batcher import ContinuousBatcher
from zig_gpt2_tpu_torch.runtime.engine import InferenceEngine
from zig_gpt2_tpu_torch.weights import tree_map

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.parametrize("D", [32, 64, 96, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_kernel_matches_plain(dev, D, dtype):
    g = torch.Generator(device=dev).manual_seed(D)
    L, B, H, S = 3, 3, 5, 200
    kc, vc = (torch.randn(L, B, H, S, D, device=dev, generator=g).to(dtype) for _ in range(2))
    q, kn, vn = (torch.randn(B, H, D, device=dev, generator=g).to(dtype) for _ in range(3))
    length = torch.tensor([0, 65, 200], dtype=torch.int32, device=dev)
    got = att.decode_attention_deferred(q, kn, vn, kc, vc, length, layer=2)
    want = att.decode_attention_deferred_plain(q, kn, vn, kc, vc, length, layer=2)
    atol, rtol = (2e-5, 2e-5) if dtype == torch.float32 else (1e-4, 8e-3)
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)
    assert got.dtype == dtype


def test_attention_kernel_never_reads_past_length(dev):
    L, B, H, S, D = 1, 2, 2, 64, 64
    kc, vc = (torch.randn(L, B, H, S, D, device=dev) for _ in range(2))
    q, kn, vn = (torch.randn(B, H, D, device=dev) for _ in range(3))
    length = torch.tensor([10, 0], dtype=torch.int32, device=dev)
    clean = att.decode_attention_deferred(q, kn, vn, kc, vc, length, layer=0)
    kc[0, 0, :, 10:] = float("nan")
    vc[0, :, :, 10:] = float("nan")
    kc[0, 1] = float("nan")
    assert torch.equal(att.decode_attention_deferred(q, kn, vn, kc, vc, length, layer=0),
                       clean)
    torch.testing.assert_close(clean[1], vn[1])


def test_attention_wrapper_validates(dev):
    kc = torch.zeros(1, 1, 2, 8, 64, device=dev)
    q = torch.zeros(1, 2, 64, device=dev)
    length = torch.ones(1, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):
        att.decode_attention_deferred(q, q, q, kc, kc, length, layer=1)
    with pytest.raises(ValueError):
        att.decode_attention_deferred(q.transpose(0, 1), q, q, kc, kc, length, layer=0)
    with pytest.raises(ValueError):
        att.decode_attention_deferred(q, q, q, kc, kc, length.long(), layer=0)
    with pytest.raises(ValueError):
        att.decode_attention_deferred(q, q, q, kc, kc, length.cpu(), layer=0)


def _quant_attention_inputs(dev, g, L, B, H, S, D, dtype):
    kc, vc = (torch.randint(-127, 128, (L, B, H, S, D), device=dev, generator=g,
                            dtype=torch.int8) for _ in range(2))
    ks, vs = (torch.rand(L, B, H, S, device=dev, generator=g) * 0.02 + 1e-3
              for _ in range(2))
    (kn, ksn), (vn, vsn) = (ops.quantize_kv(torch.randn(B, H, D, device=dev, generator=g))
                            for _ in range(2))
    q = torch.randn(B, H, D, device=dev, generator=g).to(dtype)
    return [q, kn, ksn, vn, vsn, kc, ks, vc, vs]


@pytest.mark.parametrize("D", [32, 64, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quant_attention_kernel_matches_plain(dev, D, dtype):
    g = torch.Generator(device=dev).manual_seed(D + 1)
    args = _quant_attention_inputs(dev, g, 3, 3, 5, 200, D, dtype)
    length = torch.tensor([0, 65, 200], dtype=torch.int32, device=dev)
    before = att.decode_attention_quant_deferred.launches
    got = att.decode_attention_quant_deferred(*args, length, layer=2)
    want = att.decode_attention_quant_deferred_plain(*args, length, layer=2)
    assert att.decode_attention_quant_deferred.launches == before + 1
    atol, rtol = (2e-5, 2e-5) if dtype == torch.float32 else (1e-4, 8e-3)
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)
    assert got.dtype == dtype


def test_quant_attention_kernel_never_reads_past_length(dev):
    g = torch.Generator(device=dev).manual_seed(0)
    args = _quant_attention_inputs(dev, g, 1, 2, 2, 64, 64, torch.float32)
    length = torch.tensor([10, 0], dtype=torch.int32, device=dev)
    clean = att.decode_attention_quant_deferred(*args, length, layer=0)
    ks, vs = args[6], args[8]
    ks[0, 0, :, 10:] = float("nan")
    vs[0, :, :, 10:] = float("nan")
    ks[0, 1] = float("nan")
    assert torch.equal(att.decode_attention_quant_deferred(*args, length, layer=0), clean)
    torch.testing.assert_close(clean[1], args[3][1].float() * args[4][1][:, None])


@pytest.mark.parametrize("rows", [1, 5, 40, 256])
@pytest.mark.parametrize("mode,k,n,group", [
    ("int8", 256, 150, None),   # per-channel, ragged N
    ("int8", 320, 96, 64),      # grouped INT8, K not a power of two
    ("int4", 1600, 200, None),  # G = 32, K/2 = 800 (1.5B's K)
    ("int4", 640, 1000, 64),    # K/2 = 320 is not a multiple of G = 64
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_qmm_kernel_matches_plain(dev, rows, mode, k, n, group, dtype):
    g = torch.Generator(device=dev).manual_seed(rows + k)
    w = torch.randn(k, n, device=dev, generator=g) * 0.05
    p = quant.quantize_linear({"w": w}, mode, group)
    qw = p["qw4"] if mode == "int4" else p["qw"]
    x = torch.randn(rows, k, device=dev, generator=g).to(dtype)
    before = qk.qmm.launches
    got = qk.qmm(x, qw, p["scale"], int4=mode == "int4")
    want = qk.qmm_plain(x, qw, p["scale"], int4=mode == "int4")
    assert qk.qmm.launches == before + 1
    assert got.dtype == torch.float32 and got.shape == (rows, n)
    torch.testing.assert_close(got, want, atol=2e-5, rtol=2e-5)


def test_qmm_wrapper_validates(dev):
    x = torch.zeros(2, 64, device=dev)
    qw = torch.zeros(64, 8, dtype=torch.int8, device=dev)
    s = torch.ones(1, 8, device=dev)
    with pytest.raises(ValueError):
        qk.qmm(torch.zeros(257, 64, device=dev), qw, s)
    with pytest.raises(ValueError):
        qk.qmm(x, qw, s, int4=True)
    with pytest.raises(ValueError):
        qk.qmm(x, qw, s.double())
    with pytest.raises(ValueError):
        qk.qmm(x, qw.t().contiguous().t(), s)
    with pytest.raises(ValueError):
        qk.qmm(x, qw.cpu(), s)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k,n", [(64, 200), (100, 150), (1000, 256), (2600, 150),
                                 (1600, 1664), (6400, 1600)])
@pytest.mark.parametrize("rows", [1, 2, 15, 16, 17, 33, 64])
def test_qmm_w8a8_kernel_bit_equal_to_plain(dev, rows, k, n, dtype):
    """The w8a8 body at 1.5B's K and N (1664: Q/K/V with the phantom head),
    K not a multiple of 32 (100, 1000, 2600) and a ragged N (150, 200), one
    split (64), splits added in a cluster (100, 1000, 1600) and by ticket
    (2600, 6400), rows that fill 16-row tiles partly (2, 15, 17, 33), rows
    with an all-zero row and exact .5 steps: bit for bit."""
    g = torch.Generator(device=dev).manual_seed(rows + k)
    p = quant.quantize_linear({"w": torch.randn(k, n, device=dev, generator=g) * 0.05},
                              "int8")
    x = torch.randn(rows, k, device=dev, generator=g) * 3
    if rows > 1:
        x[1] = 0.0
        x[0, :4] = torch.tensor([127.0, 0.5, 2.5, -126.5], device=dev)
        x[0, 4:] = x[0, 4:].clamp(-100, 100)
    x = x.to(dtype)
    before = (qk.qmm.launches, qk.qmm.w8a8_launches)
    got = qk.qmm(x, p["qw"], p["scale"], w8a8=True)
    assert (qk.qmm.launches, qk.qmm.w8a8_launches) == (before[0], before[1] + 1)
    want = qk.qmm_plain(x, p["qw"], p["scale"], w8a8=True)
    assert got.dtype == torch.float32 and got.shape == (rows, n)
    assert torch.equal(got, want), (got - want).abs().max().item()


@pytest.mark.parametrize("rows", [65, 128])
def test_w8a8_matmul_int_mm_equals_exact_product(dev, rows):
    """More than 64 rows take ``w8a8_matmul``: ``torch._int_mm`` on the card
    (K, N multiples of 8) gives the same bits as the exact f64 product."""
    g = torch.Generator(device=dev).manual_seed(rows)
    p = quant.quantize_linear({"w": torch.randn(1600, 1664, device=dev, generator=g)},
                              "int8")
    x = torch.randn(rows, 1600, device=dev, generator=g).to(torch.bfloat16)
    got = quant.w8a8_matmul(x, p["qw"], p["scale"])
    assert torch.equal(got, qk.qmm_plain(x, p["qw"], p["scale"], w8a8=True))


def test_qmm_w8a8_wrapper_validates(dev):
    p = quant.quantize_linear({"w": torch.randn(64, 8, device=dev)}, "int8")
    with pytest.raises(ValueError, match="1 to 64 rows"):
        qk.qmm(torch.zeros(65, 64, device=dev), p["qw"], p["scale"], w8a8=True)
    with pytest.raises(ValueError):
        qk.qmm(torch.zeros(2, 64, device=dev, dtype=torch.float16), p["qw"], p["scale"],
               w8a8=True)
    with pytest.raises(ValueError):
        qk.qmm(torch.zeros(2, 64, device=dev), p["qw"].cpu(), p["scale"], w8a8=True)
    with pytest.raises(ValueError):
        qk.qmm(torch.zeros(2, 64, device=dev), p["qw"].t().contiguous().t(), p["scale"],
               w8a8=True)
    with pytest.raises(ValueError):
        qk.qmm(torch.zeros(2, 64, device=dev), p["qw"], p["scale"][:, :4], w8a8=True)
    # A grouped INT8 weight ignores w8a8 (the TPU kernel's gate) and takes
    # the weight-only body, up to 256 rows.
    pg = quant.quantize_linear({"w": torch.randn(64, 8, device=dev)}, "int8", 32)
    before = (qk.qmm.launches, qk.qmm.w8a8_launches)
    qk.qmm(torch.zeros(100, 64, device=dev), pg["qw"], pg["scale"], w8a8=True)
    assert (qk.qmm.launches, qk.qmm.w8a8_launches) == (before[0] + 1, before[1])


WMM_DTYPES = [(torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
              (torch.bfloat16, torch.float32), (torch.float32, torch.bfloat16)]
WMM_ROWS = [1, 2, 7, 8, 15, 16, 17, 63, 64, 65, 255, 256]


@pytest.mark.parametrize("xdtype,wdtype", WMM_DTYPES)
@pytest.mark.parametrize("n", [768, 3072, 150, 770])
@pytest.mark.parametrize("k", [768, 3072, 100])
@pytest.mark.parametrize("rows", WMM_ROWS)
def test_wmm_kernel_matches_plain(dev, rows, k, n, xdtype, wdtype):
    """Every body (CUDA cores at one row and for f32 x, in row tiles of 4;
    tensor cores for 2+ bf16 rows, 16- and 64-row tiles, partly padded),
    every combine (one split, a cluster, the ticket), rows of f32 and bf16
    weights that start off 16 bytes (N = 150, 770) and a K that is not a
    multiple of the 32-row tile: one launch per call, within 1e-4 of the
    plain version, and two calls bit-identical."""
    g = torch.Generator(device=dev).manual_seed(rows * 7 + k + n)
    w = (torch.randn(k, n, device=dev, generator=g) * 0.05).to(wdtype)
    x = torch.randn(rows, k, device=dev, generator=g).to(xdtype)
    before = qk.wmm.launches
    got = qk.wmm(x, w)
    assert qk.wmm.launches == before + 1
    assert got.dtype == torch.float32 and got.shape == (rows, n)
    torch.testing.assert_close(got, qk.wmm_plain(x, w), atol=1e-4, rtol=1e-4)
    assert torch.equal(qk.wmm(x, w), got)


@pytest.mark.parametrize("wdtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("n", [768, 770])
@pytest.mark.parametrize("rows", [17, 64, 65, 256])
def test_wmm_ticket_combine_matches_plain(dev, rows, n, wdtype):
    """A K beyond one cluster's 16 ranges of the 64-row tensor-core body's
    x budget (8192 rows: 18 ranges of 480) takes the ticket: the last block
    of each output tile adds the partial sums in split order. One launch,
    within 1e-4 of the plain version, two calls bit-identical."""
    k = 8192
    geo = qk.wmm_geometry(rows, k, n, torch.bfloat16, wdtype)
    assert geo.splits > 16 and not geo.cluster
    g = torch.Generator(device=dev).manual_seed(rows + n)
    w = (torch.randn(k, n, device=dev, generator=g) * 0.05).to(wdtype)
    x = torch.randn(rows, k, device=dev, generator=g).to(torch.bfloat16)
    before = qk.wmm.launches
    got = qk.wmm(x, w)
    assert qk.wmm.launches == before + 1
    torch.testing.assert_close(got, qk.wmm_plain(x, w), atol=1e-4, rtol=1e-4)
    assert torch.equal(qk.wmm(x, w), got)


@pytest.mark.parametrize("xdtype,wdtype", WMM_DTYPES)
def test_wmm_is_one_kernel_per_call(dev, xdtype, wdtype):
    """Counted on the device by torch.profiler, not by the wrapper: a call
    at the GPT-2 124M shapes, 1, 8 and 256 rows, is one kernel of wmm.cu and
    nothing else. Each call sits behind a marker kernel (torch.cuda._sleep),
    and two unmarked calls pad the window's start, which can lose the first
    kernels launched into it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    g = torch.Generator(device=dev).manual_seed(8)
    calls = [(torch.randn(rows, k, device=dev, generator=g).to(xdtype),
              (torch.randn(k, n, device=dev, generator=g) * 0.05).to(wdtype))
             for rows in (1, 8, 256) for k, n in ((768, 768), (768, 3072), (3072, 768))]
    for x, w in calls:  # built, tickets allocated
        qk.wmm(x, w)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for x, w in calls[:2]:
            qk.wmm(x, w)
        for x, w in calls:
            torch.cuda._sleep(1000)
            qk.wmm(x, w)
        torch.cuda.synchronize()
    events = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA),
                    key=lambda e: (e.id, e.time_range.start))
    segments = []
    for e in events:
        if "spin_kernel" in e.name:
            segments.append([])
        elif segments:
            segments[-1].append(e.name)
    assert len(segments) >= len(calls) - 2
    assert all(len(names) == 1 and "wmm_" in names[0] for names in segments), segments


def test_wmm_wrapper_validates(dev):
    x, w = torch.zeros(2, 64, device=dev), torch.zeros(64, 8, device=dev)
    with pytest.raises(ValueError, match="1 to 256 rows"):
        qk.wmm(torch.zeros(257, 64, device=dev), w)
    with pytest.raises(ValueError):
        qk.wmm(x, torch.zeros(32, 8, device=dev))
    with pytest.raises(ValueError):
        qk.wmm(x, w.double())
    with pytest.raises(ValueError):
        qk.wmm(x, w.t().contiguous().t())
    with pytest.raises(ValueError):
        qk.wmm(x, w.cpu())
    with pytest.raises(ValueError):
        qk.wmm(x.half(), w)


def test_engine_cuda_w8a8_and_wmm_greedy_match_cpu(dev, monkeypatch):
    """w8a8 (INT8 weights, act_quant) and ZG2_WMM=1 (f32 weights) on the
    nano engine: the card's greedy tokens equal the CPU run's, and the
    kernels launch once per linear and pass: w8a8 for every linear of the
    decode steps and the 8-row prefill, wmm for the float decode linears
    only."""
    import dataclasses

    cfg = tconfig.GPT2_NANO
    params = gpt2.init_params(cfg, torch.Generator().manual_seed(7))
    kw = dict(max_seq=48, prompt_buckets=(8,))
    aq = dataclasses.replace(cfg, act_quant=True)
    w8 = quant.quantize_params(params, "int8")
    before = (qk.qmm.launches, qk.qmm.w8a8_launches)
    want = InferenceEngine(aq, w8, device="cpu", **kw).generate([1, 2, 3, 4], 16,
                                                                SamplingConfig(temperature=0.0))
    got = InferenceEngine(aq, w8, device="cuda", **kw).generate([1, 2, 3, 4], 16,
                                                                SamplingConfig(temperature=0.0))
    assert got == want
    per_pass = 6 * cfg.n_layers + 1
    assert (qk.qmm.launches, qk.qmm.w8a8_launches) == (before[0],
                                                       before[1] + per_pass * (16 + 1))
    monkeypatch.setenv("ZG2_WMM", "1")
    before = qk.wmm.launches
    want = InferenceEngine(cfg, params, device="cpu", **kw).generate(
        [1, 2, 3, 4], 16, SamplingConfig(temperature=0.0))
    got = InferenceEngine(cfg, params, device="cuda", **kw).generate(
        [1, 2, 3, 4], 16, SamplingConfig(temperature=0.0))
    assert got == want
    assert qk.wmm.launches == before + 6 * cfg.n_layers * 16


@pytest.mark.parametrize("B", [1, 4, 5, 16, 17])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("V", [7, 1000, 50257])
def test_sampler_kernel_matches_plain(dev, dtype, V, B):
    """Every row count of the vocab split (one block per row at V = 7, up
    to 197 at B=1, V=50257; rows b >= 1 of an odd V start off 16 bytes):
    identical ids, one launch per call."""
    g = torch.Generator(device=dev).manual_seed(V + B)
    logits = (torch.randn(B, V, device=dev, generator=g) * 2).to(dtype)
    thresh = logits.float().topk(min(3, V), -1).values[:, -1].contiguous()
    for _ in range(3):
        seeds = torch.randint(0, 2**31 - 1, (B,), device=dev, dtype=torch.int32, generator=g)
        for th in (None, thresh):
            assert torch.equal(sk.sample_categorical(logits, seeds, 0.7, th),
                               sk.sample_categorical_plain(logits, seeds, 0.7, th))


def test_sampler_kernel_ties_and_counter(dev):
    logits = torch.full((2, 100), -5.0, device=dev)
    logits[:, 40] = logits[:, 70] = float("inf")
    seeds = torch.tensor([3, 4], dtype=torch.int32, device=dev)
    before = sk.sample_categorical.launches
    assert sk.sample_categorical(logits, seeds, 1.0).tolist() == [40, 40]
    assert sk.sample_categorical.launches == before + 1
    # Ties in different splits of a split row: the smallest id wins
    # whichever block arrives last.
    V = 50257
    splits, chunk = sk.sampler_geometry(3, V)
    assert splits > 2
    logits = torch.full((3, V), -5.0, device=dev)
    ties = [(chunk + 7, 2 * chunk + 1), (40, V - 1), (chunk - 1, chunk)]
    for b, (i, j) in enumerate(ties):
        logits[b, i] = logits[b, j] = float("inf")
    seeds = torch.tensor([3, 4, 5], dtype=torch.int32, device=dev)
    for _ in range(5):
        ids, zmax = sk.sample_categorical(logits, seeds, 1.0, return_max=True)
        assert ids.tolist() == [i for i, _ in ties] and torch.isinf(zmax).all()
    assert sk.sample_categorical.launches == before + 6


@pytest.mark.parametrize("thresh", [False, True], ids=["all", "top-k"])
@pytest.mark.parametrize("B,V", [(1, 50257), (16, 50257), (17, 1000), (4, 7)])
def test_sampler_kernel_return_max(dev, B, V, thresh):
    """return_max: the kernel's ids equal its ids without the flag and the
    plain version's; z* is the plain version's within 2 ulp (the card's
    logf in the kernel against torch.log: no fast math on either side, so
    equal bits are expected, and the bound is what the test allows)."""
    g = torch.Generator(device=dev).manual_seed(B * V)
    logits = (torch.randn(B, V, device=dev, generator=g) * 2).to(torch.bfloat16)
    th = logits.float().topk(min(40, V), -1).values[:, -1].contiguous() if thresh else None
    seeds = torch.randint(0, 2**31 - 1, (B,), device=dev, dtype=torch.int32, generator=g)
    ids, zmax = sk.sample_categorical(logits, seeds, 0.8, th, return_max=True)
    want_ids, want_z = sk.sample_categorical_plain(logits, seeds, 0.8, th, return_max=True)
    assert torch.equal(ids, sk.sample_categorical(logits, seeds, 0.8, th))
    assert torch.equal(ids, want_ids)
    torch.testing.assert_close(zmax, want_z, rtol=2.0 ** -22, atol=0.0)


def test_engine_cuda_greedy_matches_cpu(dev):
    cfg = tconfig.GPT2_NANO
    params = gpt2.init_params(cfg, torch.Generator().manual_seed(7))
    cpu = InferenceEngine(cfg, params, max_seq=48, prompt_buckets=(8,), device="cpu")
    gpu = InferenceEngine(cfg, params, max_seq=48, prompt_buckets=(8,), device="cuda")
    before = att.decode_attention_deferred.launches
    want = cpu.generate([1, 2, 3, 4], 16, SamplingConfig(temperature=0.0))
    got = gpu.generate([1, 2, 3, 4], 16, SamplingConfig(temperature=0.0))
    assert got == want
    assert att.decode_attention_deferred.launches - before == cfg.n_layers * 16
    s = SamplingConfig(temperature=0.9, top_k=50, seed=5)
    assert gpu.generate([9, 8], 12, s) == gpu.generate([9, 8], 12, s)
    np.testing.assert_array_equal(
        gpu.generate_scan(np.array([[1, 2, 3, 0]]), [3], 5, SamplingConfig(temperature=0.0)),
        cpu.generate_scan(np.array([[1, 2, 3, 0]]), [3], 5, SamplingConfig(temperature=0.0)))


def test_engine_cuda_int4_int8kv_greedy_matches_cpu(dev):
    cfg = tconfig.GPT2_NANO
    params = quant.quantize_params(gpt2.init_params(cfg, torch.Generator().manual_seed(7)),
                                   "int4")
    kw = dict(max_seq=48, prompt_buckets=(8,), kv_quant="int8")
    cpu = InferenceEngine(cfg, params, device="cpu", **kw)
    gpu = InferenceEngine(cfg, params, device="cuda", **kw)
    before = (qk.qmm.launches, att.decode_attention_quant_deferred.launches,
              att.decode_attention_deferred.launches)
    want = cpu.generate([1, 2, 3, 4], 16, SamplingConfig(temperature=0.0))
    got = gpu.generate([1, 2, 3, 4], 16, SamplingConfig(temperature=0.0))
    assert got == want
    after = (qk.qmm.launches, att.decode_attention_quant_deferred.launches,
             att.decode_attention_deferred.launches)
    per_pass = 6 * cfg.n_layers + 1  # block linears + the lm_head
    assert after[0] - before[0] == per_pass * (16 + 1)
    assert after[1] - before[1] == cfg.n_layers * 16
    assert after[2] == before[2]


def _ring_grid(S, dev):
    """Starts 0, mid, S-1 and one more against lengths 0, 1, S-1 and S in
    every rotation: intervals that wrap, and one that fills the ring."""
    starts = torch.tensor([0, S // 2, S - 1, 7], dtype=torch.int32, device=dev)
    lengths = [0, 1, S - 1, S]
    return [(starts, torch.tensor(lengths[r:] + lengths[:r], dtype=torch.int32, device=dev))
            for r in range(4)]


def _rotate(c, starts):
    """Lane b (axis 1) of a stacked cache rolled by starts[b] on its S axis
    (axis 3): linear row i lands at ring row (starts[b] + i) mod S."""
    return torch.stack([torch.roll(c[:, b], int(st), dims=2)
                        for b, st in enumerate(starts.tolist())], dim=1).contiguous()


@pytest.mark.parametrize("D", [32, 64, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ring_attention_kernel_matches_plain(dev, D, dtype):
    g = torch.Generator(device=dev).manual_seed(D + 2)
    L, B, H, S = 3, 4, 5, 201
    kc, vc = (torch.randn(L, B, H, S, D, device=dev, generator=g).to(dtype) for _ in range(2))
    q, kn, vn = (torch.randn(B, H, D, device=dev, generator=g).to(dtype) for _ in range(3))
    atol, rtol = (2e-5, 2e-5) if dtype == torch.float32 else (1e-4, 8e-3)
    for start, length in _ring_grid(S, dev):
        before = (att.decode_attention_deferred.launches,
                  att.decode_attention_deferred.ring_launches)
        got = att.decode_attention_deferred(q, kn, vn, kc, vc, length, layer=1, start=start)
        want = att.decode_attention_deferred_plain(q, kn, vn, kc, vc, length, layer=1,
                                                   start=start)
        assert (att.decode_attention_deferred.launches,
                att.decode_attention_deferred.ring_launches) == (before[0], before[1] + 1)
        torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)


@pytest.mark.parametrize("D", [32, 64, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ring_quant_attention_kernel_matches_plain(dev, D, dtype):
    g = torch.Generator(device=dev).manual_seed(D + 3)
    S = 201
    args = _quant_attention_inputs(dev, g, 3, 4, 5, S, D, dtype)
    atol, rtol = (2e-5, 2e-5) if dtype == torch.float32 else (1e-4, 8e-3)
    for start, length in _ring_grid(S, dev):
        before = att.decode_attention_quant_deferred.ring_launches
        got = att.decode_attention_quant_deferred(*args, length, layer=2, start=start)
        want = att.decode_attention_quant_deferred_plain(*args, length, layer=2, start=start)
        assert att.decode_attention_quant_deferred.ring_launches == before + 1
        torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)


@pytest.mark.parametrize("quant", [False, True], ids=["float", "int8"])
def test_ring_kernel_equals_prefix_kernel_on_rotated_cache(dev, quant):
    """Bit equality, and NaN in every row outside the intervals (the
    stale rows of a ring) reaches neither the output nor its scales."""
    g = torch.Generator(device=dev).manual_seed(11)
    S, D = 64, 64
    if quant:
        args = _quant_attention_inputs(dev, g, 2, 4, 3, S, D, torch.float32)
        fn, caches = att.decode_attention_quant_deferred, (5, 6, 7, 8)
    else:
        args = [torch.randn(4, 3, D, device=dev, generator=g) for _ in range(3)]
        args += [torch.randn(2, 4, 3, S, D, device=dev, generator=g) for _ in range(2)]
        fn, caches = att.decode_attention_deferred, (3, 4)
    for start, length in _ring_grid(S, dev):
        want = fn(*args, length, layer=1)
        ring = list(args)
        rel = (torch.arange(S, device=dev)[None, :] - start[:, None]) % S
        outside = rel >= length[:, None]  # (B, S)
        for i in caches:
            ring[i] = _rotate(args[i], start)
            if ring[i].is_floating_point():
                mask = outside[None, :, None, :]
                ring[i] = ring[i].masked_fill(mask[..., None] if ring[i].dim() == 5 else mask,
                                              float("nan"))
        assert torch.equal(fn(*ring, length, layer=1, start=start), want)


def test_batcher_cuda_greedy_matches_cpu(dev):
    """The nano batcher on the card, ring and INT8 cache, gives the CPU
    run's greedy tokens and launches the ring kernel once per layer and
    step, the prefix kernel never."""
    cfg = tconfig.GPT2_NANO
    params = gpt2.init_params(cfg, torch.Generator().manual_seed(7))
    prompts = [[1, 2, 3], [9, 8, 7, 6, 5], [4], [11, 12, 13, 14]]
    out = {}
    for device in ("cpu", "cuda"):
        b = ContinuousBatcher(cfg, params, batch_size=2, max_seq=32, prompt_buckets=(8,),
                              sampling=SamplingConfig(temperature=0.0), kv_quant="int8",
                              device=device)
        before = (att.decode_attention_quant_deferred.launches,
                  att.decode_attention_quant_deferred.ring_launches)
        rids = [b.submit(p, 10) for p in prompts]
        by_rid = {r.rid: r.generated for r in b.run()}
        out[device] = [by_rid[r] for r in rids]
        if device == "cuda":
            assert att.decode_attention_quant_deferred.launches == before[0]
            assert (att.decode_attention_quant_deferred.ring_launches - before[1]
                    == cfg.n_layers * b.metrics.steps)
    assert out["cuda"] == out["cpu"]


# --- head-pair-packed and appended forms -------------------------------------

PACKED = {(False, True): (att.decode_attention_deferred, att.decode_attention_deferred_plain),
          (True, True): (att.decode_attention_quant_deferred,
                         att.decode_attention_quant_deferred_plain),
          (False, False): (att.decode_attention, att.decode_attention_plain),
          (True, False): (att.decode_attention_quant, att.decode_attention_quant_plain)}


def _packed_inputs(dev, g, L, B, HP, S, dtype, quant, deferred):
    """q and the operands after it, packed (rows of 128: two heads of 64),
    with per-pair scales for INT8; the self-term rows only when deferred.
    Returns (args, indices of the cache operands)."""
    if quant:
        args = _quant_attention_inputs(dev, g, L, B, HP, S, 128, dtype)
        return (args, (5, 6, 7, 8)) if deferred else ([args[0]] + args[5:], (1, 2, 3, 4))
    q, kn, vn = (torch.randn(B, HP, 128, device=dev, generator=g).to(dtype) for _ in range(3))
    kc, vc = (torch.randn(L, B, HP, S, 128, device=dev, generator=g).to(dtype)
              for _ in range(2))
    return ([q, kn, vn, kc, vc], (3, 4)) if deferred else ([q, kc, vc], (1, 2))


def _counts(fn):
    return tuple(getattr(fn, n) for n in ("launches", "ring_launches", "packed_launches",
                                           "packed_ring_launches"))


@pytest.mark.parametrize("deferred", [True, False], ids=["deferred", "appended"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("quant", [False, True], ids=["float", "int8"])
def test_packed_attention_kernel_matches_plain(dev, quant, dtype, deferred):
    """Prefix and ring, wrapping intervals and a full ring; the appended
    form at lengths of at least 1. Each launch counts as its variant."""
    g = torch.Generator(device=dev).manual_seed(21)
    S = 201
    args, _ = _packed_inputs(dev, g, 3, 4, 3, S, dtype, quant, deferred)
    fn, plain = PACKED[quant, deferred]
    atol, rtol = (2e-5, 2e-5) if dtype == torch.float32 else (1e-4, 8e-3)
    for start, length in _ring_grid(S, dev):
        if not deferred:
            length = length.clamp(min=1)
        for ring in (None, start):
            before = _counts(fn)
            got = fn(*args, length, layer=2, start=ring, packed=True)
            want = plain(*args, length, layer=2, start=ring, packed=True)
            slot = 3 if ring is not None else 2
            assert _counts(fn) == tuple(c + (i == slot) for i, c in enumerate(before))
            assert got.shape == args[0].shape and got.dtype == dtype
            torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)


@pytest.mark.parametrize("deferred", [True, False], ids=["deferred", "appended"])
@pytest.mark.parametrize("quant", [False, True], ids=["float", "int8"])
def test_packed_ring_kernel_equals_packed_prefix_kernel_on_rotated_cache(dev, quant,
                                                                         deferred):
    """Bit equality, and NaN in every row outside the intervals reaches
    neither the output nor its scales."""
    g = torch.Generator(device=dev).manual_seed(12)
    S = 64
    args, caches = _packed_inputs(dev, g, 2, 4, 3, S, torch.float32, quant, deferred)
    fn = PACKED[quant, deferred][0]
    for start, length in _ring_grid(S, dev):
        if not deferred:
            length = length.clamp(min=1)
        want = fn(*args, length, layer=1, packed=True)
        ring = list(args)
        outside = (torch.arange(S, device=dev)[None, :] - start[:, None]) % S >= length[:, None]
        for i in caches:
            ring[i] = _rotate(args[i], start)
            if ring[i].is_floating_point():
                mask = outside[None, :, None, :]
                ring[i] = ring[i].masked_fill(mask[..., None] if ring[i].dim() == 5 else mask,
                                              float("nan"))
        assert torch.equal(fn(*ring, length, layer=1, start=start, packed=True), want)


@pytest.mark.parametrize("deferred", [True, False], ids=["deferred", "appended"])
def test_packed_kernel_equals_unpacked_kernel(dev, deferred):
    """The float kernel over packed rows and over the same rows unpacked:
    f32 roundoff (the lanes sum a head's products in another order)."""
    g = torch.Generator(device=dev).manual_seed(13)
    args, _ = _packed_inputs(dev, g, 2, 3, 4, 150, torch.float32, False, deferred)
    fn = PACKED[False, deferred][0]
    length = torch.tensor([1, 77, 150], dtype=torch.int32, device=dev)
    got = fn(*args, length, layer=1, packed=True)
    unpacked = [(att.unpack_heads_rows(t) if t.dim() == 3 else att.unpack_heads_seq(t))
                .contiguous() for t in args]
    want = fn(*unpacked, length, layer=1)
    torch.testing.assert_close(att.unpack_heads_rows(got), want, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("packed", [False, True], ids=["unpacked", "packed"])
@pytest.mark.parametrize("quant", [False, True], ids=["float", "int8"])
def test_appended_kernel_equals_deferred_kernel_after_the_append(dev, quant, packed):
    """Append (k_new, v_new) at row length, then the appended kernel over
    length + 1 rows: the deferred kernel's value over length rows, to f32
    roundoff (the current row is summed by another warp)."""
    g = torch.Generator(device=dev).manual_seed(14)
    W, S = (128, 96) if packed else (64, 96)
    if quant:
        args = _quant_attention_inputs(dev, g, 2, 3, 4, S, W, torch.float32)
    else:
        args = [torch.randn(3, 4, W, device=dev, generator=g) for _ in range(3)]
        args += [torch.randn(2, 3, 4, S, W, device=dev, generator=g) for _ in range(2)]
    length = torch.tensor([0, 40, S - 1], dtype=torch.int32, device=dev)
    lanes = torch.arange(3, device=dev)
    if quant:
        q, kn, ksn, vn, vsn, kc, ks, vc, vs = args
        want = att.decode_attention_quant_deferred(*args, length, layer=1, packed=packed)
        for stack, row in ((kc, kn), (ks, ksn), (vc, vn), (vs, vsn)):
            stack[1, lanes, :, length.long()] = row
        got = att.decode_attention_quant(q, kc, ks, vc, vs, length + 1, layer=1,
                                         packed=packed)
    else:
        q, kn, vn, kc, vc = args
        want = att.decode_attention_deferred(*args, length, layer=1, packed=packed)
        for stack, row in ((kc, kn), (vc, vn)):
            stack[1, lanes, :, length.long()] = row
        got = att.decode_attention(q, kc, vc, length + 1, layer=1, packed=packed)
    torch.testing.assert_close(got, want, atol=2e-5, rtol=2e-5)


def test_packed_wrapper_validates(dev):
    length = torch.ones(1, dtype=torch.int32, device=dev)
    q = torch.zeros(1, 2, 64, device=dev)  # 64-wide rows: head_dim 32 packed
    kc = torch.zeros(1, 1, 2, 8, 64, device=dev)
    with pytest.raises(ValueError, match="head_dim 64"):
        att.decode_attention_deferred(q, q, q, kc, kc, length, layer=0, packed=True)
    q = torch.zeros(1, 2, 128, device=dev)
    flat = torch.zeros(2 * 8 * 128 + 1, device=dev)
    kc = flat[1:].view(1, 1, 2, 8, 128)  # contiguous, 4 bytes off a 16-byte boundary
    with pytest.raises(ValueError, match="aligned"):
        att.decode_attention(q, kc, kc, length, layer=0, packed=True)


PACKED_CFG = tconfig.GPTConfig(vocab_size=256, context_size=64, n_layers=2, n_heads=3,
                               n_embed=192)


@pytest.mark.parametrize("kv_quant", [None, "int8"], ids=["float", "int8"])
def test_packed_engine_and_batcher_cuda_greedy_match_cpu(dev, monkeypatch, kv_quant):
    """Three heads of 64 (a phantom head): the card picks the packed layout
    by itself; the CPU is told to (ZG2_KV_PACKED=1 would also do on the
    card). Greedy tokens agree; the packed kernels launch once per layer and
    step, the unpacked ones never."""
    params = gpt2.init_params(PACKED_CFG, torch.Generator().manual_seed(3))
    params = {**params, "wte": params["wte"] * 3}
    fn = att.decode_attention_quant_deferred if kv_quant else att.decode_attention_deferred
    out = {}
    for device in ("cpu", "cuda"):
        monkeypatch.setenv("ZG2_KV_PACKED", "1" if device == "cpu" else "auto")
        eng = InferenceEngine(PACKED_CFG, params, max_seq=48, prompt_buckets=(8,),
                              kv_quant=kv_quant, device=device)
        b = ContinuousBatcher(PACKED_CFG, params, batch_size=2, max_seq=32,
                              prompt_buckets=(8,), sampling=SamplingConfig(temperature=0.0),
                              kv_quant=kv_quant, device=device)
        assert eng.config.kv_packed and b.config.kv_packed
        before = _counts(fn)
        toks = eng.generate([1, 2, 3, 4], 16, SamplingConfig(temperature=0.0))
        rids = [b.submit(p, 10) for p in ([1, 2, 3], [9, 8, 7, 6, 5], [4], [11, 12, 13])]
        by_rid = {r.rid: r.generated for r in b.run()}
        out[device] = (toks, [by_rid[r] for r in rids])
        if device == "cuda":
            L = PACKED_CFG.n_layers
            assert _counts(fn) == (before[0], before[1], before[2] + L * 16,
                                   before[3] + L * b.metrics.steps)
    assert out["cuda"] == out["cpu"]


# --- split-S attention and the one-launch qmm -----------------------------------

def _stale_nan(args, caches, length):
    """Copies of ``args`` whose float cache rows (and INT8 scale rows) at
    or past each lane's length hold NaN, as a ring's stale rows may."""
    out = list(args)
    S = args[caches[0]].shape[3]
    stale = torch.arange(S, device=length.device)[None, :] >= length[:, None]  # (B, S)
    for i in caches:
        if out[i].is_floating_point():
            mask = stale[None, :, None, :]
            out[i] = out[i].masked_fill(mask[..., None] if out[i].dim() == 5 else mask,
                                        float("nan"))
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("ring", [False, True], ids=["prefix", "ring"])
@pytest.mark.parametrize("packed", [False, True], ids=["unpacked", "packed"])
@pytest.mark.parametrize("deferred", [True, False], ids=["deferred", "appended"])
@pytest.mark.parametrize("quant", [False, True], ids=["float", "int8"])
def test_split_attention_matches_plain(dev, quant, deferred, packed, ring, dtype):
    """S = 1024 (the ring R = 1025), where the kernel splits the rows:
    lengths 0 (deferred) or 1, 1, a split boundary -1, +0 and +1, and S,
    with NaN in every stale row. Each variant against its plain version,
    two identical calls bit-equal, one launch per call, and the ring over
    caches rotated by start (intervals across a split boundary and the
    wrap) bit-equal to the prefix kernel over the linear caches."""
    S, HP = (1025 if ring else 1024), 2
    splits, chunk = att.attention_splits(6, HP, S)
    assert splits > 1
    length = torch.tensor([0 if deferred else 1, 1, chunk - 1, chunk, chunk + 1, S],
                          dtype=torch.int32, device=dev)
    B = length.numel()
    g = torch.Generator(device=dev).manual_seed(31 + 2 * quant + deferred)
    if packed:
        args, caches = _packed_inputs(dev, g, 2, B, HP, S, dtype, quant, deferred)
    elif quant:
        full = _quant_attention_inputs(dev, g, 2, B, HP, S, 64, dtype)
        args, caches = (full, (5, 6, 7, 8)) if deferred else ([full[0]] + full[5:],
                                                               (1, 2, 3, 4))
    else:
        args = [torch.randn(B, HP, 64, device=dev, generator=g).to(dtype)
                for _ in range(3 if deferred else 1)]
        args += [torch.randn(2, B, HP, S, 64, device=dev, generator=g).to(dtype)
                 for _ in range(2)]
        caches = (3, 4) if deferred else (1, 2)
    fn, plain = PACKED[quant, deferred]
    args = _stale_nan(args, caches, length)
    atol, rtol = (2e-5, 2e-5) if dtype == torch.float32 else (1e-4, 8e-3)
    before = _counts(fn)
    got = fn(*args, length, layer=1, packed=packed)
    assert _counts(fn) == tuple(c + (i == (2 if packed else 0)) for i, c in enumerate(before))
    torch.testing.assert_close(got.float(), plain(*args, length, layer=1, packed=packed).float(),
                               atol=atol, rtol=rtol)
    assert torch.equal(fn(*args, length, layer=1, packed=packed), got)
    if ring:
        start = torch.tensor([(S - 3 - 397 * b) % S for b in range(B)], dtype=torch.int32,
                             device=dev)
        rotated = [_rotate(a, start) if i in caches else a for i, a in enumerate(args)]
        before = _counts(fn)
        got_ring = fn(*rotated, length, layer=1, start=start, packed=packed)
        assert _counts(fn) == tuple(c + (i == (3 if packed else 1))
                                    for i, c in enumerate(before))
        torch.testing.assert_close(
            got_ring.float(),
            plain(*rotated, length, layer=1, start=start, packed=packed).float(),
            atol=atol, rtol=rtol)
        assert torch.equal(got_ring, got)


@pytest.mark.parametrize("packed", [False, True], ids=["unpacked", "packed"])
@pytest.mark.parametrize("quant", [False, True], ids=["float", "int8"])
def test_split_attention_does_not_depend_on_the_cache_rows(dev, quant, packed):
    """The same rows in a cache of S = 1024 (16 splits) and of S = 300 (5
    splits of the same chunk) give the same bits: the splits past a lane's
    rows add exact zeros. (An engine's cache and a shorter replay of the
    same request agree.)"""
    g = torch.Generator(device=dev).manual_seed(41)
    B, HP = 2, 1
    if packed:
        args, caches = _packed_inputs(dev, g, 1, B, HP, 1024, torch.bfloat16, quant, True)
    elif quant:
        args = _quant_attention_inputs(dev, g, 1, B, HP, 1024, 64, torch.bfloat16)
        caches = (5, 6, 7, 8)
    else:
        args = [torch.randn(B, HP, 64, device=dev, generator=g).to(torch.bfloat16)
                for _ in range(3)]
        args += [torch.randn(1, B, HP, 1024, 64, device=dev, generator=g).to(torch.bfloat16)
                 for _ in range(2)]
        caches = (3, 4)
    short = [a[:, :, :, :300].contiguous() if i in caches else a for i, a in enumerate(args)]
    assert att.attention_splits(B, HP, 1024)[1] == att.attention_splits(B, HP, 300)[1]
    assert att.attention_splits(B, HP, 1024)[0] > att.attention_splits(B, HP, 300)[0] > 1
    fn = PACKED[quant, True][0]
    length = torch.tensor([150, 300], dtype=torch.int32, device=dev)
    assert torch.equal(fn(*args, length, layer=0, packed=packed),
                       fn(*short, length, layer=0, packed=packed))


@pytest.mark.parametrize("n", [384, 150], ids=["vector-N", "ragged-N"])
@pytest.mark.parametrize("mode,k,group", [
    ("int4", 1600, None),  # G = 32 (1.5B's K)
    ("int8", 640, None),   # per-channel
    ("int8", 640, 64),     # grouped INT8
    ("int4", 96, 4),       # G < 8: scales read from L2
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows", [1, 2, 15, 16, 17, 40, 256])
def test_qmm_one_launch_matches_plain(dev, rows, dtype, mode, k, group, n):
    """Every body (CUDA cores at one row and for f32 x; tensor cores at 16-
    and 64-row tiles for bf16 x) on a 16-byte-aligned N and a ragged one,
    split over K where the geometry says so: one launch per call, results
    within the qmm tolerance, and two calls bit-equal."""
    g = torch.Generator(device=dev).manual_seed(rows * 7 + k + n)
    w = torch.randn(k, n, device=dev, generator=g) * 0.05
    p = quant.quantize_linear({"w": w}, mode, group)
    int4 = mode == "int4"
    qw = p["qw4"] if int4 else p["qw"]
    x = torch.randn(rows, k, device=dev, generator=g).to(dtype)
    before = qk.qmm.launches
    got = qk.qmm(x, qw, p["scale"], int4=int4)
    assert qk.qmm.launches == before + 1
    assert got.dtype == torch.float32 and got.shape == (rows, n)
    torch.testing.assert_close(got, qk.qmm_plain(x, qw, p["scale"], int4=int4), atol=2e-5,
                               rtol=2e-5)
    assert torch.equal(qk.qmm(x, qw, p["scale"], int4=int4), got)


@pytest.mark.parametrize("k,n", [(1600, 1664), (1664, 1600), (1600, 6400), (6400, 1600),
                                 (1600, 50257)])
def test_qmm_w8a8_one_launch_on_the_serving_shapes(dev, k, n):
    """The 1.5B w8a8 shapes at 1 and 16 rows, split over K where the
    geometry says so (the combine runs): one launch, bit-equal to the plain
    version, and two calls bit-equal."""
    g = torch.Generator(device=dev).manual_seed(k + n)
    p = quant.quantize_linear({"w": torch.randn(k, n, device=dev, generator=g) * 0.05}, "int8")
    for rows in (1, 16):
        x = (torch.randn(rows, k, device=dev, generator=g) * 3).to(torch.bfloat16)
        before = (qk.qmm.launches, qk.qmm.w8a8_launches)
        got = qk.qmm(x, p["qw"], p["scale"], w8a8=True)
        assert (qk.qmm.launches, qk.qmm.w8a8_launches) == (before[0], before[1] + 1)
        assert torch.equal(got, qk.qmm_plain(x, p["qw"], p["scale"], w8a8=True))
        assert torch.equal(qk.qmm(x, p["qw"], p["scale"], w8a8=True), got)


def test_qmm_splits_on_the_serving_shapes(dev):
    """The 1.5B INT4 block linears at B=1 and 16 split K (the combine runs)
    and still launch once per call."""
    g = torch.Generator(device=dev).manual_seed(5)
    for k, n in ((1600, 1600), (1600, 6400), (6400, 1600)):
        p = quant.quantize_linear({"w": torch.randn(k, n, device=dev, generator=g) * 0.05},
                                  "int4")
        for rows in (1, 16):
            assert qk.qmm_geometry(rows, k, n, True, torch.bfloat16).splits > 1
            x = torch.randn(rows, k, device=dev, generator=g).to(torch.bfloat16)
            before = qk.qmm.launches
            got = qk.qmm(x, p["qw4"], p["scale"], int4=True)
            assert qk.qmm.launches == before + 1
            torch.testing.assert_close(got, qk.qmm_plain(x, p["qw4"], p["scale"], int4=True),
                                       atol=2e-5, rtol=2e-5)


# --- the extend path: gpt2.extend, prefix caching, speculative decoding --------

VERIFY_ROWS = [2, 4, 5, 64]  # a draft catch-up, B x (k + 1) windows, the w8a8 cap


@pytest.mark.parametrize("rows", VERIFY_ROWS)
@pytest.mark.parametrize("k,n", [(1600, 1600), (1600, 6400), (6400, 1600), (1600, 50257)])
def test_gemv_kernels_at_the_verify_window_rows(dev, rows, k, n):
    """qmm INT4 (the 1.5B block linears) and INT8 per channel, its w8a8 body
    and wmm, f32 and bf16 x, at the row counts the extend path gives them:
    one launch each, within their tolerances (w8a8 bit for bit)."""
    g = torch.Generator(device=dev).manual_seed(rows + k + n)
    w = torch.randn(k, n, device=dev, generator=g) * 0.05
    p4 = quant.quantize_linear({"w": w}, "int4") if n != 50257 else None
    p8 = quant.quantize_linear({"w": w}, "int8")
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.randn(rows, k, device=dev, generator=g).to(dtype)
        for qw, scale, int4 in ([(p4["qw4"], p4["scale"], True)] if p4 else []) + [
                (p8["qw"], p8["scale"], False)]:
            before = qk.qmm.launches
            got = qk.qmm(x, qw, scale, int4=int4)
            assert qk.qmm.launches == before + 1
            torch.testing.assert_close(got, qk.qmm_plain(x, qw, scale, int4=int4), atol=2e-5,
                                       rtol=2e-5)
        before = qk.qmm.w8a8_launches
        got = qk.qmm(x, p8["qw"], p8["scale"], w8a8=True)
        assert qk.qmm.w8a8_launches == before + 1
        assert torch.equal(got, qk.qmm_plain(x, p8["qw"], p8["scale"], w8a8=True))
        if n != 50257:
            wd = w.to(dtype)
            before = qk.wmm.launches
            got = qk.wmm(x, wd)
            assert qk.wmm.launches == before + 1
            torch.testing.assert_close(got, qk.wmm_plain(x, wd), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("weights", ["float", "int4"])
@pytest.mark.parametrize("kv_quant", [None, "int8"], ids=["float", "int8"])
@pytest.mark.parametrize("packed", [False, True], ids=["unpacked", "packed"])
def test_extend_cuda_matches_cpu(dev, packed, kv_quant, weights):
    """gpt2.extend of a (2, 5) window with 5 and 3 valid rows after a
    prefill, on the card and on the CPU (three heads of 64, the phantom
    head padded in when packed): logits at the valid rows within 1e-4
    (float cache) or the bf16 tolerance of the INT8 op (rtol 2e-2, atol
    5e-3), the same lengths, and qmm launched once per linear at 10 rows."""
    cfg = dataclasses.replace(PACKED_CFG, kv_packed=packed)
    params = gpt2.init_params(cfg, torch.Generator().manual_seed(3))
    if weights == "int4":
        params = quant.quantize_params(params, "int4")
    if packed:
        params, cfg = gpt2.pad_phantom_head(params, cfg)
    g = torch.Generator().manual_seed(4)
    prompt = torch.randint(0, cfg.vocab_size, (2, 8), generator=g, dtype=torch.int32)
    window = torch.randint(0, cfg.vocab_size, (2, 5), generator=g, dtype=torch.int32)
    lens, valid = torch.tensor([8, 3], dtype=torch.int32), torch.tensor([5, 3], dtype=torch.int32)
    out = {}
    for device in ("cpu", "cuda"):
        p = {k: v for k, v in _to(params, device).items()}
        cache = gpt2.init_kv_cache(cfg, 2, 24, device=device, quant=kv_quant)
        cache, _ = gpt2.prefill(p, cache, prompt.to(device), lens.to(device), cfg)
        before = qk.qmm.launches
        cache, logits = gpt2.extend(p, cache, window.to(device), valid.to(device), cfg)
        if device == "cuda" and weights == "int4":
            assert qk.qmm.launches - before == 6 * cfg.n_layers + 1
        out[device] = (logits.float().cpu(), cache["length"].cpu())
    assert torch.equal(out["cuda"][1], lens + valid)
    atol, rtol = (5e-3, 2e-2) if kv_quant else (1e-4, 1e-4)
    for b in range(2):
        torch.testing.assert_close(out["cuda"][0][b, :valid[b]], out["cpu"][0][b, :valid[b]],
                                   atol=atol, rtol=rtol)


def _to(tree, device):
    return {k: _to(v, device) if isinstance(v, dict) else v.to(device) for k, v in tree.items()}


def test_prefix_hit_cuda_greedy_matches_miss(dev):
    """On the card, the engine and the ring batcher with a registered
    prefix give the greedy tokens they give without it (float cache),
    and the first token after each hit comes from the sampler path."""
    params = gpt2.init_params(PACKED_CFG, torch.Generator().manual_seed(3))
    params = {**params, "wte": params["wte"] * 3}
    prefix = [5, 17, 3, 99, 42, 7, 8, 1]
    prompts = [prefix + [11, 12], prefix[:6] + [4], prefix, [33, 2, 9]]
    kw = dict(max_seq=48, prompt_buckets=(16,), device="cuda")
    plain, cached = InferenceEngine(PACKED_CFG, params, **kw), InferenceEngine(
        PACKED_CFG, params, **kw)
    cached.register_prefix(prefix)
    greedy = SamplingConfig(temperature=0.0)
    for p in prompts:
        assert cached.generate(p, 12, greedy) == plain.generate(p, 12, greedy), p
    out = []
    for pre in ((), (prefix,)):
        b = ContinuousBatcher(PACKED_CFG, params, batch_size=2, max_seq=48, prompt_buckets=(16,),
                              sampling=greedy, device="cuda")
        for x in pre:
            b.register_prefix(x)
        rids = [b.submit(p, 10) for p in prompts]
        by_rid = {r.rid: r.generated for r in b.run()}
        out.append([by_rid[r] for r in rids])
    assert out[0] == out[1] and b.metrics.prefix_hits == 3


@pytest.mark.parametrize("draft", ["model", "ngram"])
def test_speculative_cuda_greedy_matches_engine(dev, draft):
    """SpeculativeEngine on the card (a 1-layer draft, or prompt lookup; k
    3) and the batcher's prompt-lookup serving give the plain engine's and
    batcher's greedy tokens on the card; no sampler launch in a greedy
    round."""
    from zig_gpt2_tpu_torch.runtime.speculative import SpeculativeEngine

    cfg = tconfig.GPT2_NANO
    params = gpt2.init_params(cfg, torch.Generator().manual_seed(7))
    params = {k: (v * 3 if k == "wte" else v) for k, v in params.items()}
    dcfg = tconfig.GPTConfig(vocab_size=cfg.vocab_size, context_size=cfg.context_size,
                             n_layers=1, n_heads=2, n_embed=64)
    dparams = gpt2.init_params(dcfg, torch.Generator().manual_seed(8)) if draft == "model" else None
    greedy = SamplingConfig(temperature=0.0)
    eng = InferenceEngine(cfg, params, max_seq=64, prompt_buckets=(16,), device="cuda")
    spec = SpeculativeEngine(cfg, params, dcfg if dparams else None, dparams, k=3, max_seq=64,
                             prompt_buckets=(16,), device="cuda")
    for p in ([1, 2, 3, 4], [9, 8, 7, 9, 8, 7, 9, 8]):
        before = sk.sample_categorical.launches
        assert spec.generate(p, 20, greedy) == eng.generate(p, 20, greedy), p
        assert spec.last_rounds <= 20
    if draft == "ngram":
        prompts = [[1, 2, 3], [9, 8, 7, 9, 8, 7], [4], [11, 12, 13, 14]]
        out = []
        for kw in ({}, dict(speculative="ngram", spec_k=3, spec_min_tpr=0.0)):
            b = ContinuousBatcher(cfg, params, batch_size=2, max_seq=48, prompt_buckets=(8,),
                                  sampling=greedy, device="cuda", **kw)
            before = sk.sample_categorical.launches
            rids = [b.submit(p, 10) for p in prompts]
            by_rid = {r.rid: r.generated for r in b.run()}
            out.append([by_rid[r] for r in rids])
            assert sk.sample_categorical.launches == before  # greedy: argmax, no sampler
        assert out[0] == out[1]


# --- fused QKV shapes, perplexity and training on the card (slice 10) ---------

@pytest.mark.parametrize("rows", [1, 2, 16, 64])
@pytest.mark.parametrize("n", [4800, 4992])
@pytest.mark.parametrize("mode", ["int4", "int8", "w8a8"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_qmm_at_the_fused_qkv_widths(dev, rows, n, mode, dtype):
    """The fused 1.5B QKV projection: K 1600, N 3 x 1600 (unpacked; not a
    multiple of the 128-column tile) or 3 x 1664 (phantom head padded in),
    INT4 (G 32) and INT8 per channel weight-only within 2e-5, the w8a8 body
    bit for bit; one launch per call."""
    g = torch.Generator(device=dev).manual_seed(rows + n)
    p = quant.quantize_linear({"w": torch.randn(1600, n, device=dev, generator=g) * 0.05},
                              "int4" if mode == "int4" else "int8")
    qw = p["qw4"] if mode == "int4" else p["qw"]
    x = torch.randn(rows, 1600, device=dev, generator=g).to(dtype)
    kw = dict(int4=mode == "int4", w8a8=mode == "w8a8")
    before = qk.qmm.launches + qk.qmm.w8a8_launches
    got = qk.qmm(x, qw, p["scale"], **kw)
    assert qk.qmm.launches + qk.qmm.w8a8_launches == before + 1
    want = qk.qmm_plain(x, qw, p["scale"], **kw)
    assert got.shape == (rows, n)
    if mode == "w8a8":
        assert torch.equal(got, want), (got - want).abs().max().item()
    else:
        torch.testing.assert_close(got, want, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("rows", [1, 2, 8, 16])
@pytest.mark.parametrize("xdtype,wdtype", WMM_DTYPES)
def test_wmm_at_the_fused_qkv_width(dev, rows, xdtype, wdtype):
    """The fused 124M QKV projection, 768 x 2304: within 1e-4 of the plain
    version, one launch, two calls bit-identical."""
    g = torch.Generator(device=dev).manual_seed(rows)
    w = (torch.randn(768, 2304, device=dev, generator=g) * 0.05).to(wdtype)
    x = torch.randn(rows, 768, device=dev, generator=g).to(xdtype)
    before = qk.wmm.launches
    got = qk.wmm(x, w)
    assert qk.wmm.launches == before + 1
    torch.testing.assert_close(got, qk.wmm_plain(x, w), atol=1e-4, rtol=1e-4)
    assert torch.equal(qk.wmm(x, w), got)


def test_fused_qkv_engine_cuda_greedy_matches_cpu(dev, monkeypatch):
    """ZG2_FUSE_QKV=1 on the card (INT4 weights, INT8 cache, odd heads
    packed): the CPU's fused greedy tokens; 4 qmm launches per layer and
    one for the lm_head per decode step and per prefill."""
    monkeypatch.setenv("ZG2_FUSE_QKV", "1")
    monkeypatch.setenv("ZG2_KV_PACKED", "1")
    params = gpt2.init_params(PACKED_CFG, torch.Generator().manual_seed(3))
    params = quant.quantize_params({**params, "wte": params["wte"] * 3}, "int4")
    greedy = SamplingConfig(temperature=0.0)
    out = {}
    for device in ("cpu", "cuda"):
        eng = InferenceEngine(PACKED_CFG, params, max_seq=48, prompt_buckets=(16,),
                              kv_quant="int8", device=device)
        assert "wqkv" in eng.params["blocks"]["attn"]
        before = qk.qmm.launches
        out[device] = eng.generate([5, 17, 3, 99], 12, greedy)
        if device == "cuda":
            assert qk.qmm.launches - before == (4 * PACKED_CFG.n_layers + 1) * (12 + 1)
    assert out["cuda"] == out["cpu"]


def test_perplexity_window_and_train_step_cuda_match_cpu(dev):
    """One perplexity batch (2 windows of 64, INT4: 128 rows through qmm)
    and one AdamW step at B=2, T=65 on the card against the CPU, f32
    without TF32: perplexity within 1e-5 relative (fp32) and 1e-4 (INT4),
    the loss within 1e-5, the updated weights within 1e-6 + 1e-4 relative
    where |g| > 1e-6 (sign flips of near-zero gradients move a weight by
    2 lr)."""
    from zig_gpt2_tpu_torch import train
    from zig_gpt2_tpu_torch.eval.perplexity import perplexity

    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        cfg = tconfig.GPT2_NANO
        base = gpt2.init_params(cfg, torch.Generator().manual_seed(5))
        ids = np.random.default_rng(5).integers(0, cfg.vocab_size, 128)
        for tree, rtol in ((base, 1e-5), (quant.quantize_params(base, "int4"), 1e-4)):
            ppl = [perplexity(_to(tree, d), cfg, ids, window=64, batch_size=2)
                   for d in ("cpu", "cuda")]
            assert abs(ppl[1] - ppl[0]) <= rtol * ppl[0], ppl
        toks = torch.from_numpy(np.random.default_rng(6).integers(0, cfg.vocab_size, (2, 65)))
        out = {}
        for d in ("cpu", "cuda"):
            p = tree_map(lambda t: t.detach().clone().to(d), base)  # fresh leaves each
            opt = train.make_optimizer(p)
            p, opt, loss = train.train_step(p, opt, toks.to(d), cfg)
            grads = [t.grad.cpu() for t in train._leaves(p)]
            out[d] = (loss.item(), [t.detach().cpu() for t in train._leaves(p)], grads)
        assert abs(out["cuda"][0] - out["cpu"][0]) <= 1e-5 * out["cpu"][0]
        for got, want, g in zip(out["cuda"][1], out["cpu"][1], out["cpu"][2]):
            sure = g.abs() > 1e-6
            torch.testing.assert_close(got[sure], want[sure], atol=1e-6, rtol=1e-4)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


# --- a float cache in another dtype than q's ---------------------------------------

MIXED = [(torch.float32, torch.bfloat16), (torch.bfloat16, torch.float32)]


@pytest.mark.parametrize("deferred", [True, False], ids=["deferred", "appended"])
@pytest.mark.parametrize("packed", [False, True], ids=["unpacked", "packed"])
@pytest.mark.parametrize("ring", [False, True], ids=["prefix", "ring"])
@pytest.mark.parametrize("qd,cd", MIXED, ids=["f32q-bf16cache", "bf16q-f32cache"])
def test_attention_kernel_mixed_cache_dtype_matches_plain(dev, qd, cd, ring, packed,
                                                          deferred):
    """q (and the deferred form's current rows) in one dtype, the caches in
    the other: each read in its own type, the sums in f32, as the plain
    version (and the TPU kernel) do; the output in q's dtype. Tolerance by
    q's dtype, as in the one-dtype tests."""
    g = torch.Generator(device=dev).manual_seed(17 + 2 * ring + packed)
    L, B, H, S, W = 2, 4, 3, 201, 128 if packed else 64
    q, kn, vn = (torch.randn(B, H, W, device=dev, generator=g).to(qd) for _ in range(3))
    kc, vc = (torch.randn(L, B, H, S, W, device=dev, generator=g).to(cd) for _ in range(2))
    lanes = _ring_grid(S, dev) if ring else [
        (None, torch.tensor([0, 1, 65, 201], dtype=torch.int32, device=dev))]
    fn = att.decode_attention_deferred if deferred else att.decode_attention
    plain = att.decode_attention_deferred_plain if deferred else att.decode_attention_plain
    args = (q, kn, vn, kc, vc) if deferred else (q, kc, vc)
    atol, rtol = (2e-5, 2e-5) if qd == torch.float32 else (1e-4, 8e-3)
    for start, length in lanes:
        if not deferred:
            length = length.clamp(min=1)  # the appended form needs a row on every lane
        before = fn.launches + fn.ring_launches + fn.packed_launches + fn.packed_ring_launches
        got = fn(*args, length, layer=1, start=start, packed=packed)
        want = plain(*args, length, layer=1, start=start, packed=packed)
        assert (fn.launches + fn.ring_launches + fn.packed_launches
                + fn.packed_ring_launches) == before + 1
        assert got.dtype == qd
        torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)


@pytest.mark.parametrize("packed", ["0", "1"], ids=["unpacked", "packed"])
def test_engine_and_batcher_bf16_cache_under_f32_weights_match_cpu(dev, monkeypatch,
                                                                   packed):
    """cache_dtype=torch.bfloat16 on f32 weights, the JAX engine's option:
    a bf16 cache on the card, the float kernel launched once per layer and
    step, and the CPU's greedy tokens (the same bf16 rows, f32 sums)."""
    monkeypatch.setenv("ZG2_KV_PACKED", packed)
    cfg = PACKED_CFG  # heads of 64 (a phantom head when packed)
    params = gpt2.init_params(cfg, torch.Generator().manual_seed(8))
    params = {**params, "wte": params["wte"] * 3}
    greedy = SamplingConfig(temperature=0.0)
    out = {}
    for device in ("cpu", "cuda"):
        eng = InferenceEngine(cfg, params, max_seq=48, prompt_buckets=(8,), device=device,
                              cache_dtype=torch.bfloat16)
        b = ContinuousBatcher(cfg, params, batch_size=2, max_seq=32, prompt_buckets=(8,),
                              sampling=greedy, device=device, cache_dtype=torch.bfloat16)
        assert eng.new_cache()["k"].dtype == b.cache["k"].dtype == torch.bfloat16
        assert eng.config.kv_packed == b.config.kv_packed == (packed == "1")
        before = sum(_counts(att.decode_attention_deferred))
        toks = eng.generate([1, 2, 3, 4], 16, greedy)
        rids = [b.submit(p, 10) for p in ([1, 2, 3], [9, 8, 7, 6, 5], [4])]
        by_rid = {r.rid: r.generated for r in b.run()}
        out[device] = (toks, [by_rid[r] for r in rids])
        if device == "cuda":
            assert (sum(_counts(att.decode_attention_deferred)) - before
                    == cfg.n_layers * (16 + b.metrics.steps))
    assert out["cuda"] == out["cpu"]


# --- the batcher's decode step replayed from a CUDA graph --------------------

def _cell_model(name, dev):
    """A benchmark cell's model at its published widths, two layers deep:
    GPT-2 1.5B with INT4 block linears, an INT8 lm_head and an INT8 KV
    cache in bf16, or 124M in float32 with a float cache."""
    if name == "xl-int4-kv8":
        cfg = tconfig.GPTConfig(vocab_size=50257, context_size=1024, n_layers=2, n_heads=25,
                                n_embed=1600)
        params = gpt2.init_params(cfg, torch.Generator(device=dev).manual_seed(11),
                                  dtype=torch.bfloat16)
        return cfg, quant.quantize_params(params, "int4"), "int8"
    cfg = tconfig.GPTConfig(vocab_size=50257, context_size=1024, n_layers=2, n_heads=12,
                            n_embed=768)
    return cfg, gpt2.init_params(cfg, torch.Generator(device=dev).manual_seed(12)), None


def _serve_recorded(b, seed, min_steps):
    """A closed loop over the batcher's slots until ``min_steps`` steps have
    run, then drained: prompts of 3-150 tokens, some opening with the
    registered prefix, budgets of 1-40 tokens, a stop token. Returns
    (tokens per request in submit order, every logits tensor the batcher
    drew from, cloned)."""
    rng = np.random.default_rng(seed)
    drawn, draw = [], b._sample
    b._sample = lambda logits: (drawn.append(logits.clone()), draw(logits))[1]
    prefix = [int(t) for t in rng.integers(0, 50257, 48)]
    b.register_prefix(prefix)
    rids = []

    def submit():
        n = int(rng.integers(3, 150))
        prompt = [int(t) for t in rng.integers(0, 50257, n)]
        if rng.random() < 0.4:
            prompt = prefix[:int(rng.integers(8, 49))] + prompt[:100]
        rids.append(b.submit(prompt, int(rng.integers(1, 41)), stop_tokens=(7,)))

    for _ in range(b.batch_size + 4):
        submit()
    while b.metrics.steps < min_steps:
        b.step()
        while b.pending < b.batch_size + 4:
            submit()
    by_rid = {r.rid: r.generated for r in b.run()}
    return [by_rid[r] for r in rids], drawn


@pytest.mark.parametrize("name,lanes", [("xl-int4-kv8", 32), ("124m-fp32", 64)])
def test_decode_graph_bit_identical_to_eager(dev, name, lanes):
    """One batcher run replaying the decode step's graph and one eager,
    over 220+ steps with admissions, prefix hits and retirements between:
    every logits tensor drawn from is bit-identical, so are the greedy
    tokens; one capture, a replay per plain decode step; and the launch
    tallies the run leaves equal the eager run's."""
    cfg, params, kv = _cell_model(name, dev)
    runs = {}
    for mode in ("graph", "eager"):
        b = ContinuousBatcher(cfg, params, batch_size=lanes, sampling=SamplingConfig(temperature=0.0),
                              kv_quant=kv, device="cuda")
        assert (b._graph is not None) and b.cache["k"].is_cuda
        if mode == "eager":
            b._graph = None
        before = tallies.snapshot()
        tokens, drawn = _serve_recorded(b, 5, 220)
        torch.cuda.synchronize()
        runs[mode] = (tokens, drawn, b.metrics,
                      tallies.delta(before, tallies.snapshot()))
    (gt, gd, gm, gc), (et, ed, em, ec) = runs["graph"], runs["eager"]
    assert gm.steps == em.steps >= 220 and gm.prefix_hits == em.prefix_hits > 0
    assert gt == et and len(gd) == len(ed)
    assert all(torch.equal(g, e) for g, e in zip(gd, ed))
    assert (gm.decode_graph_captures, gm.decode_graph_replays) == (1, gm.steps)
    assert (em.decode_graph_captures, em.decode_graph_replays) == (0, 0)
    assert gc == ec and gc  # the tallies count what the eager run launched
    assert gm.as_dict(lanes)["decode_graph_replays"] == gm.steps


def test_decode_graph_after_speculation_auto_off(dev):
    """Prompt-lookup serving whose auto-off fires (its threshold above the
    k + 1 tokens a round can commit, so it fires once its window fills):
    the plain decode it hands over to captures once (its rounds rebound the
    cache's length) and replays every plain step after, and its greedy
    tokens are the plain batcher's."""
    cfg = tconfig.GPT2_NANO
    params = gpt2.init_params(cfg, torch.Generator().manual_seed(7))
    params = {k: (v * 3 if k == "wte" else v) for k, v in params.items()}
    greedy = SamplingConfig(temperature=0.0)
    prompts = [[int(t) for t in np.random.default_rng(i).integers(0, 512, 5 + i % 9)]
               for i in range(40)]
    out = []
    for kw in ({}, dict(speculative="ngram", spec_k=3, spec_min_tpr=5.0)):
        b = ContinuousBatcher(cfg, params, batch_size=16, max_seq=64, prompt_buckets=(16,),
                              sampling=greedy, device="cuda", **kw)
        rids = [b.submit(p, 30) for p in prompts]
        by_rid = {r.rid: r.generated for r in b.run()}
        out.append([by_rid[r] for r in rids])
        m = b.metrics
        if kw:
            assert m.spec_auto_off_step is not None and 0 < m.spec_rounds < m.steps
            assert m.decode_graph_replays == m.steps - m.spec_rounds
        else:
            assert m.decode_graph_replays == m.steps
        assert m.decode_graph_captures == 1
    assert out[0] == out[1]


def test_decode_graph_stays_eager_where_the_step_rebinds_its_cache(dev, monkeypatch, caplog):
    """A decode step that rebinds the cache's tensors instead of updating
    them cannot be replayed: the batcher keeps its warm-up call as the
    step, serves from the cache the step returns (the same dict or a new
    one), stays eager and logs it once, with the eager run's tokens. (Large
    position embeddings, so that a stale length changes the tokens.)"""
    cfg = tconfig.GPT2_NANO
    params = gpt2.init_params(cfg, torch.Generator().manual_seed(7))
    params = {k: (v * 30 if k == "wpe" else v) for k, v in params.items()}
    real = gpt2.decode_step

    def rebinding(new_dict):
        def step(p, cache, tokens, config):
            old = cache["length"].clone()
            cache, logits = real(p, cache, tokens, config)
            length = cache["length"].clone()
            cache["length"].copy_(old)  # the dict given keeps the old lengths
            out = dict(cache) if new_dict else cache
            out["length"] = length
            return out, logits
        return step

    out = []
    for step in (real, rebinding(False), rebinding(True)):
        monkeypatch.setattr(gpt2, "decode_step", step)
        caplog.clear()
        b = ContinuousBatcher(cfg, params, batch_size=2, max_seq=32, prompt_buckets=(8,),
                              sampling=SamplingConfig(temperature=0.0), device="cuda")
        rids = [b.submit(p, 10) for p in ([1, 2, 3], [9, 8, 7, 6, 5], [4])]
        by_rid = {r.rid: r.generated for r in b.run()}
        out.append([by_rid[r] for r in rids])
        warned = [r for r in caplog.records if "runs eagerly" in r.getMessage()]
        if step is real:
            assert not b._graph.eager and b.metrics.decode_graph_captures == 1
            continue
        assert b._graph.eager and b.metrics.decode_graph_captures == 0
        assert b.metrics.decode_graph_replays == 0 and len(warned) == 1
    assert out[0] == out[1] == out[2]
