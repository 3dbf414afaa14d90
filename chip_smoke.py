#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU (built for the H100).

    python3 chip_smoke.py

Phases, each printed on its own line; any failure exits non-zero and
prints no result line:

1. device    - a CUDA card must be present; prints its name and power limit.
2. build     - builds the CUDA kernels from ``zig_gpt2_tpu_torch/ops/csrc``.
3. attention - the float decode-attention kernel against its plain PyTorch
               version at GPT-2 124M shapes (L=12, H=12, S=1024, D=64), B=1
               and B=4, lengths {0, 1, 17, 1023}, f32 and bf16 caches.
4. attention-int8 - the INT8-cache decode-attention kernel against its
               plain version at GPT-2 1.5B shapes (L=48, H=25, S=1024,
               D=64), B=1 and B=4, lengths {0, 1, 17, 1023}, f32 and bf16 q,
               layers 0 and 47.
5. attention-ring - the ring variants of both kernels (old rows
               [start, start + length) mod R) against their plain versions:
               float at 124M shapes, INT8 at 1.5B shapes, B=16, R=1025 (a
               1024-row window plus the ring row), per-lane starts including
               0 and R-1 with intervals that wrap, lengths {0, 1, 17, 1023,
               1024}, f32 and bf16 q, layers 0 and last; and the ring kernel
               over per-lane-rotated caches equals the prefix kernel over the
               linear caches bit for bit.
6. sampler   - the Gumbel-max sampler kernel (split over the vocab)
               against its plain version, B 1, 4, 16 and 17 x V 7, 1000 and
               50257, f32 and bf16, with and without a top-k/top-p threshold:
               identical ids, with and without ``return_max``, whose z* is the
               plain version's within 2 ulp; +inf ties placed in different
               splits of a row give the smaller id.
7. serve     - GPT-2 124M, fp32, at full width (random weights from a fixed
               seed, a BPE trained in-process, vocab padded to 50257 rows)
               on ``InferenceEngine(device="cuda")``: three prompts x 32 new
               tokens (greedy; T=0.8; T=0.8 with top-k 40 and top-p 0.9).
               Kernel launch counts must match the decode steps; the greedy
               run's teacher-forced logits are held against the same model
               on the CPU.
8. trace     - ``torch.profiler`` over 32 decode steps of the 124M path
               (fp32, T=0.8, one host sync per token as the engine runs
               them; two padding steps, a marker kernel per step): the
               device's busy and idle share of the traced steps, kernels
               launched per step, the top kernels.
9. serve-batcher-124M - the same 124M model on
               ``ContinuousBatcher(batch_size=8, max_seq=256)``, ring cache:
               16 greedy requests of mixed prompt lengths and budgets. The
               float ring kernel launches 12 times per decode step, the
               prefix kernel never; two requests are held to the engine's
               tokens up to a near-tie.
10. qmm      - the dequant-GEMV kernel against its plain version on the
               1.5B model's quantized weights: the six block linears at
               layers 0 and 47 (INT4, grouped) and the lm_head (INT8
               per-channel, K=1600, N=50257), rows 1, 16, 32 and 256, f32 and
               bf16 activations.
11. serve-1.5B - GPT-2 1.5B at full width and depth (48 layers, 25 heads,
               1600 wide; random bf16 weights from a fixed seed, INT4
               weights and an INT8 lm_head by ``quantize_params``) on
               ``InferenceEngine(kv_quant="int8", device="cuda")``: the same
               three requests. Launch counts: qmm 289 per decode step and
               per prefill, INT8 attention 48 per decode step, float
               attention none. The greedy request is teacher-forced through
               the same quantized weights with f32 float leaves on the card
               and on the CPU (weights dequantized to f32, plain attention),
               and the logits compared, over the first 12 of the 48 layers
               (phase 17 compares the first 24).
12. trace-1.5B - as 8, for the 1.5B INT4 + INT8-KV decode step (bf16).
13. serve-batcher-1.5B - the 1.5B model of phase 11 on
               ``ContinuousBatcher(batch_size=16, max_seq=256, decode_chunk=1,
               kv_quant="int8")``, ring cache (R=257): 64 requests, prompt
               lengths 8-120, budgets 32-96, the first half at T=0.8 with
               top-k 40 and top-p 0.9, then the greedy half, so that the
               write pointer wraps under the greedy half. Every request ends
               at its budget; launch counts match the steps and prefills;
               the greedy half served again on a linear cache (ZG2_RING=0)
               gives the same tokens; four greedy requests are the
               model's greedy tokens at the batcher's own prefill and batch
               shapes, bit for bit (teacher-forced replay), and match the
               engine's up to a near-tie (a wider gap is taken as the two
               shapes' roundoff).
14. trace-batcher-1.5B - ``torch.profiler`` over 32 batcher steps at full
               occupancy (B=16): kernels per step, the device's busy and
               idle share, the top kernels, and the host syncs per step
               (``torch.cuda.set_sync_debug_mode``), which must be 1.
15. attention-packed - the head-pair-packed bodies (two heads of 64 per
               128-wide row, per-pair INT8 scales) against their plain
               versions: float f32 and bf16 at 124M shapes (12 heads, Hp=6),
               INT8 with f32 and bf16 q at 1.5B shapes (25 heads: Hp=13 with a
               phantom head), B=1 and B=16, R=1025, lengths 0-1024, prefix
               and ring with wrapping intervals, layers 0 and last; packed
               ring over rotated caches bit-equal to packed prefix; float
               packed against unpacked over the same rows; the appended forms
               (no self-term, unpacked and packed) against their plain
               versions and against the deferred kernel after the append.
16. serve-packed-124M - phase 7's model and requests on an engine that
               chose the packed layout itself (the card's default): packed
               launches equal the steps, teacher-forced logits vs the CPU;
               then phase 9's batcher on the packed layout (the float packed
               ring kernel, 12 launches per decode step).
17. serve-packed-1.5B - phase 11 on the packed layout (per-pair INT8
               scales, the JAX package's served quantization; the phantom
               head padded into the weights once, at construction).
18. serve-batcher-packed-1.5B - phase 13 on the packed layout: packed ring
               launches equal the steps, ring vs linear greedy identity,
               engine near-tie check; then the layout A/B: 32 traced steps at
               full occupancy on the packed and on an unpacked batcher, device
               busy ms and attention kernel us per step for each.
19. w8a8     - the w8a8 (s8 x s8) body of the qmm kernel against its plain
               version on a 1.5B INT8 per-channel tree with the phantom head
               padded in: the six block linears at layers 0 and 47 (Q/K/V
               1600x1664) and the lm_head (K=1600, N=50257), rows 1, 2, 15,
               16, 17, 33 and 64, f32 and bf16 activations, bit for bit and
               one launch per call; 65 rows go to
               ``w8a8_matmul`` (``torch._int_mm``; the exact f64 product for
               the lm_head's N) and launch no kernel.
20. serve-w8a8-1.5B - GPT-2 1.5B at full width and depth, the bf16
               weights of phase 11 quantized INT8 per channel, ``act_quant``
               (``--quant w8a8``), packed layout: ``InferenceEngine`` with a
               bf16 KV cache, phase 11's three requests (w8a8 launches 289
               per decode step and per prefill of at most 64 rows, the weight-
               only qmm and wmm none), the greedy request teacher-forced
               against the CPU over the first 12 layers within max(1e-3, 3 x
               the run's CPU f32-vs-f64 floor), and a trace of 32 decode
               steps; then ``ContinuousBatcher(batch_size=16, max_seq=256,
               kv_quant="int8")``: 32 greedy requests (prompts 8-120, budgets
               32-96) on a ring and on a linear cache, identical, and the
               near-tie check against the engine; then ``torch.profiler`` over
               32 steps of that batcher at B=16 (T=0.8, top-k 40, top-p 0.9):
               kernels per step, 289 w8a8 kernels per step (one per call, no
               reduce pass), busy and idle share, top kernels, one host sync
               per step.
21. wmm      - the float GEMV kernel against its plain version at 124M
               shapes (768x768 for each of Q/K/V and c_proj, 768x3072,
               3072x768; layers 0 and 11) and at weights whose rows start
               off 16 bytes (N 150, 770), whose K (100) is not a multiple
               of the 32-row tile, or whose K (8192) takes the ticket
               combine above 16 bf16 rows: rows 1, 2, 7, 8, 15, 16, 17, 63,
               64, 65, 255 and 256, f32 and bf16 weights and activations,
               one launch per call, two calls bit-identical.
22. serve-wmm-124M - phase 7's model and requests with ``ZG2_WMM=1`` on
               ``InferenceEngine`` (wmm launches 72 per decode step, none per
               prefill; teacher-forced logits vs the CPU; greedy tokens equal
               to the engine's without wmm up to a near-tie), then phase 9's
               batcher (B=8), packed layout; a trace of 32 decode steps with
               ``ZG2_WMM=1`` and then ``=0`` (device busy, kernels and wmm
               kernels per step: no marked step above 72 wmm kernels, the
               median exactly 72, no reduce kernel); then the B=8 batcher on
               a bf16 copy of the weights with ``ZG2_WMM=1`` (wmm's
               tensor-core body): ring and linear caches identical, near-tie
               check against a bf16 engine without wmm.
23. extend   - ``gpt2.extend`` of a T=5 window (2 lanes, 5 and 3 valid
               rows) against 5 sequential decode steps on the card: 124M
               fp32 unpacked and packed within 1e-3 (no kernel launched);
               1.5B INT4 + INT8 KV packed: 289 qmm launches and nothing else,
               then f32 float leaves over the first 12 layers, the card's
               extend within max(1e-3, 3 x the CPU f32-vs-f64 floor) of the
               CPU's and within max(1e-3, 3 x floor, 3 x the CPU's own
               extend-vs-decode gap) of the card's decode steps (the INT8
               extend rounds q and p * v_scale to bf16, the JAX op's
               arithmetic; the decode kernel does not).
24. serve-prefix-1.5B - phase 17's engine with a 256-token prefix
               registered: three prompts of it plus 8-24 tokens, 32 greedy
               tokens each (289 qmm per hit's extend and per decode step),
               equal to the engine without the prefix up to a near-tie;
               prefill_ms with and without the hit, prefix_tokens_reused.
25. serve-batcher-prefix-1.5B - the B=16 ring batcher (INT4 + INT8 KV,
               packed) with a 64-token prefix registered: 32 greedy requests,
               half of them sharing the prefix, the write pointer wrapping;
               launch counts per step, prefill and prefix extend; equal to
               the batcher without the prefix up to a near-tie;
               prefix_hits and prefill_tokens_saved.
26. speculative-1.5B - ``SpeculativeEngine``, target 1.5B INT4 + INT8 KV
               (unpacked), draft 124M fp32, k=4, greedy: three prompts x 32
               tokens equal to the unpacked target engine's up to a near-tie
               (launches: 289 qmm per round and prefill, 36 draft attention
               per round, no sampler), ms per committed token against the
               engine's; ``torch.profiler`` over 4 marked rounds (289 qmm,
               36 attention, 0 sampler kernels); self-draft at 124M at >= 0.9
               x (k + 1) tokens per round; prompt lookup on a seeded looping
               1.5B stream (else 124M; fails if neither loops) above 1 token
               per round.
27. serve-batcher-spec-1.5B - ``ContinuousBatcher(speculative="ngram",
               batch_size=16, spec_k=3, spec_min_tpr=0)``, INT4 + INT8 KV: 16
               greedy requests (half a repeated 3-token pattern), every
               round one (16, 4) verify extend (289 qmm at 64 rows), equal to
               the plain unpacked batcher up to a near-tie, tokens per round;
               then the default spec_min_tpr, whether the auto-off fired.
28. npz      - the 124M fp32 weights written as a raw checkpoint and
               repacked on the host (``tools.repack --mode int4``) to an
               .npz, loaded to the card bit-equal to ``quantize_params``
               there; greedy tokens from the loaded tree identical to the
               in-process quantized tree's (3 prompts x 32; 73 qmm per pass);
               the 1.5B INT4 tree (float leaves as f32) round-tripped
               bit-equal, with its size and load time.
29. fused-qkv - ``ZG2_FUSE_QKV=1``: the 1.5B INT4 + INT8 KV packed engine
               launches 193 qmm per decode step and per prefill (289
               unfused; the fused projection is 1600 x 4992), greedy tokens
               equal to the unfused engine's up to a near-tie; the 124M
               fp32 engine with ``ZG2_WMM=1`` 48 wmm per step (72); one B=16
               ring batcher pass at 1.5B fused and unfused (193 and 289 per
               step, tokens up to a near-tie); 32 traced steps at 1.5B B=1
               fused and unfused (reported).
30. ppl      - ``tools.ppl_gate`` on the card at 124M (raw checkpoint of
               phase 28, 8192 synthetic ids in a .npy, TF32 off), modes
               int8, w8a8, int4: window 256 batch 1 (qmm per INT8/INT4
               window: 73 launches) and window 1024 batch 8 (no GEMV
               launch); at window 256 every mode against the CPU (fp32
               1e-4, quantized 1e-3 relative). Budgets printed, not gated.
31. train    - 5 AdamW steps at 124M fp32, B=8, T=1024, with and without
               remat: the loss falls at every step, the runs agree within
               1e-5, the remat peak memory is lower; one step at B=2, T=128
               against the CPU (loss 1e-5, gradients 1e-3 of each leaf's
               largest).
32. profile-debug - ``cli --profile`` writes a trace naming the port's
               kernels; ``nan_checks`` silent on clean weights, raising with
               the op's name on a NaN planted in wte; ``checked_decode_step``
               raises on a cache at max_seq.
33. times    - each kernel's device time per call at the main paths'
               shapes (CUDA-graph replay of many calls), its bound, its
               plain version's time and one PyTorch library call computing
               the same function (timed only, never used by the port):
               attention at B=1 and the ring at B=16 (with the w8a8
               engine's packed bf16 cache at 1.5B shapes), the sampler at
               B=1 and B=16, qmm at 1, 5, 16 and 64 rows and the w8a8 body
               at 1, 16 and 64 rows per 1.5B linear and per 289 calls (a
               decode step or an extend window), and wmm at rows 1, 2 and
               8, f32 and bf16, per 124M shape and per 72-call step in
               served order, every call on another layer's weight (from
               device memory, not L2); and the fused QKV shapes: qmm INT4
               and the w8a8 body at 1600 x 4992, rows 1 and 16, and wmm at
               768 x 2304, one row, f32 and bf16 (rows of their own in the
               kernels line).

34. native-bpe (run after phase 6) - the port's loader builds ``libzg2bpe``
               from the repository's ``native/bpe.cpp`` on the card's host;
               the native core's ids and bytes equal the Python core's on a
               fixed corpus, and the serving encoder runs the native core.
35. serve-tp (run after phase 32) - two ranks (spawned processes) on the
               one card over gloo (NCCL refuses two ranks on one device),
               mesh 1 x 2: GPT-2 1.5B at full width and depth, 25 heads
               padded to 26 (13 per rank: unpacked), vocab rows 50304, INT4
               weights quantized for tp=2, the INT8 lm_head and KV cache.
               ``InferenceEngine(mesh=)``: two greedy requests x 32 tokens
               and one at T=0.8 top-k 40 x 16; then
               ``ContinuousBatcher(batch_size=4, mesh=)``, ring cache: 6
               greedy and 2 sampled requests, each ending at its budget; the
               mesh paths: a 256-id prefill with and without
               ``seq_parallel`` (bit-equal), a 64-id prefix on the engine
               and the batcher, the B=4 ngram batcher (k=4, 8 x 32) against
               one card, its switch to plain decode (``spec_min_tpr`` above
               the ceiling, 4 x 88), three AdamW steps of the 124M tree
               against one card; then a 124M fp32 engine (6 heads per rank:
               packed), 16 greedy tokens. Each rank's launches per kernel (``return_max`` draws
               apart) and collectives equal what the steps imply; each kernel
               at the rank's shapes (qmm per shard linear, INT8 attention
               over 13 heads and its ring, the sampler with ``return_max``
               over 25152 ids) against its plain version; the ranks return
               the same tokens, the greedy ones the one-card engine's on the
               same weights up to a near-tie; no id >= the vocab. Rank 0
               times the kernels at its shapes (rows of their own in the
               kernels line) and the collectives (host clock).

Phases 24-27 compare two bf16 paths' greedy tokens (with and without a
prefix, speculative and plain): equal up to the first divergence, and
there a near-tie within max(1e-3, 3 x the INT8 floor, 3 x the bf16 floor:
the served engine's teacher-forced logits against the same weights' with
f32 float leaves, as phase 22 holds its bf16 batcher).

Every single-card batcher phase (9, 13, 16, 18, 20, 22, 25, 29's
batcher, and 27 after its auto-off) replays its plain decode
step from one CUDA graph (``runtime.decode_graph``): the phase also holds
the graph's replays to its plain decode steps, and counts on the device
the kernels of marked replayed steps (``replayed_kernels``): each kernel
family (attention, qmm, its w8a8 body, wmm, the sampler) as many times in
every step, and as many in all as the wrappers' launch counts rose by,
so the counts a replay adds to them are the kernels it ran.

Phases 7-14 serve the unpacked layout (``ZG2_KV_PACKED=0``), phases 16-25
the packed one, which the card picks by itself at head_dim 64; the
speculative target's cache and the speculative batcher's stay unpacked,
as the JAX package keeps them.
fp32 matmuls run in full f32: TF32 is switched off for cuBLAS and cuDNN.
The line before the last is a JSON object listing the kernels; the last
line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time

# Published H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, the f32 rate
# outside the tensor cores, used here for every 32-bit scalar op, and the
# dense tensor-core rates for bf16 and int8 products.
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12
PEAK_BF16_OPS_PER_S = 989e12
PEAK_INT8_OPS_PER_S = 1979e12
# Operations per vocab element in the sampler: Philox4x32-10 is 10 rounds
# of 2 mul-hi, 2 mul-lo, 4 xor and 2 key adds; then ~14 for the uniform,
# two logs, the scale, the add, the mask and the running argmax.
SAMPLER_OPS_PER_ELEM = 114
# return_max: the kernel's z* against the plain version's, relative: 2 ulp
# (the kernel's logf against torch.log, both without fast math on the card,
# so equal bits are expected).
SAMPLER_ZMAX_RTOL = 2.0 ** -22

# (atol, rtol). bf16: one bf16 ulp, since kernel and plain version each
# round one f32 result to bf16 once.
ATTN_TOL = {"float32": (2e-5, 2e-5), "bfloat16": (1e-4, 8e-3)}
# qmm returns f32 for both activation dtypes (a bf16 x times a bf16 or int8
# weight is exact in f32); the kernel sums up to 6400 products per output
# in another order than cuBLAS in the plain version.
QMM_TOL = (1e-4, 1e-4)
E2E_ATOL, E2E_RTOL = 1e-3, 1e-3

BLOCK_LINEARS = (("attn", "wq"), ("attn", "wk"), ("attn", "wv"), ("attn", "c_proj"),
                 ("mlp", "c_fc"), ("mlp", "c_proj"))
DEMO_TEXT = ("the quick brown fox jumps over the lazy dog. "
             "hello world, streaming tokens from a random model on the card. ") * 8


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> int:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    return 1


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, n: int, warmup: int = 3, graph: bool = True) -> float:
    """Mean device time of fn(i) over n calls, by CUDA events. With
    ``graph`` the n calls are captured once in a CUDA graph and the replay
    is timed, so that the host's cost of issuing each call (the wrappers'
    checks, allocation and launch: tens of us) does not stand in for the
    device's; without it (for code that copies from the host, which a
    graph cannot capture) the calls are issued back to back."""
    import torch

    for i in range(warmup):
        fn(i)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if graph:
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for i in range(n):
                fn(i)
        g.replay()
        torch.cuda.synchronize()
        start.record()
        g.replay()
        end.record()
    else:
        start.record()
        for i in range(n):
            fn(i)
        end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def bound_ms(nbytes: float, nops: float, peak_ops: float = PEAK_OPS_PER_S) -> tuple[float, str]:
    tb, to = nbytes / PEAK_BYTES_PER_S * 1e3, nops / peak_ops * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def max_err(got, want) -> float:
    return (got.float() - want.float()).abs().max().item()


def check_close(name: str, got, want, atol: float, rtol: float, torch) -> float:
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs()
    if (err > atol + rtol * want.float().abs()).any() or not torch.isfinite(got).all():
        raise AssertionError(f"{name}: kernel disagrees with its plain version "
                             f"(max_abs_err {err.max().item():.3e})")
    return err.max().item()


def check_attention(att, torch) -> None:
    """The float kernel against its plain version at 124M shapes, q and the
    cache in each pair of dtypes (one dtype, or f32 q over a bf16 cache and
    the reverse: the engine's ``cache_dtype``), unpacked and packed; the
    tolerance is that of q's dtype."""
    L, H, S, D = 12, 12, 1024, 64
    g = torch.Generator(device="cuda").manual_seed(1)
    f32, bf16 = torch.float32, torch.bfloat16
    for B, lengths in ((1, [17]), (1, [1023]), (4, [0, 1, 17, 1023])):
        for dtype, cache_dtype in ((f32, f32), (bf16, bf16), (f32, bf16), (bf16, f32)):
            kc = torch.randn(L, B, H, S, D, device="cuda", generator=g).to(cache_dtype)
            vc = torch.randn(L, B, H, S, D, device="cuda", generator=g).to(cache_dtype)
            q, kn, vn = (torch.randn(B, H, D, device="cuda", generator=g).to(dtype)
                         for _ in range(3))
            length = torch.tensor(lengths, dtype=torch.int32, device="cuda")
            atol, rtol = ATTN_TOL[str(dtype).split(".")[-1]]
            what = f"{dtype}" + (f" over a {cache_dtype} cache" if cache_dtype != dtype else "")
            layouts = (False, True) if cache_dtype != dtype else (False,)
            for layer in (0, L - 1):
                for packed in layouts:
                    args = (q, kn, vn, kc, vc)
                    if packed:
                        args = (*(att.pack_heads_rows(t) for t in args[:3]),
                                *(att.pack_heads_seq(t).contiguous() for t in args[3:]))
                    got = att.decode_attention_deferred(*args, length, layer=layer,
                                                        packed=packed)
                    want = att.decode_attention_deferred_plain(*args, length, layer=layer,
                                                               packed=packed)
                    label = f"attention B={B} {what}{' packed' if packed else ''} layer={layer}"
                    err = check_close(label, got, want, atol, rtol, torch)
                    log(f"{label} len={lengths}: max_abs_err={err:.3e} (atol {atol}, "
                        f"rtol {rtol})")


def int8_attention_inputs(ops, torch, g, L, B, H, S, D, dtype):
    """Random INT8 caches with scale planes of the size quantize_kv gives
    GPT-2-like rows, quantized current rows, and q in ``dtype``."""
    kc, vc = (torch.randint(-127, 128, (L, B, H, S, D), device="cuda", generator=g,
                            dtype=torch.int8) for _ in range(2))
    ks, vs = (torch.rand(L, B, H, S, device="cuda", generator=g) * 0.03 + 0.01
              for _ in range(2))
    (kn, ksn), (vn, vsn) = (ops.quantize_kv(torch.randn(B, H, D, device="cuda",
                                                        generator=g))
                            for _ in range(2))
    q = torch.randn(B, H, D, device="cuda", generator=g).to(dtype)
    return [q, kn, ksn, vn, vsn, kc, ks, vc, vs]


def check_attention_int8(att, ops, torch) -> None:
    L, H, S, D = 48, 25, 1024, 64
    g = torch.Generator(device="cuda").manual_seed(5)
    for B, lengths in ((1, [17]), (1, [1023]), (4, [0, 1, 17, 1023])):
        for dtype in (torch.float32, torch.bfloat16):
            args = int8_attention_inputs(ops, torch, g, L, B, H, S, D, dtype)
            length = torch.tensor(lengths, dtype=torch.int32, device="cuda")
            atol, rtol = ATTN_TOL[str(dtype).split(".")[-1]]
            for layer in (0, L - 1):
                got = att.decode_attention_quant_deferred(*args, length, layer=layer)
                want = att.decode_attention_quant_deferred_plain(*args, length, layer=layer)
                err = check_close(f"attention-int8 B={B} {dtype} layer={layer}", got,
                                  want, atol, rtol, torch)
                log(f"attention-int8 B={B} len={lengths} {dtype} layer={layer}: "
                    f"max_abs_err={err:.3e} (atol {atol}, rtol {rtol})")


RING_ROWS = 1025  # a 1024-row window plus the ring's write row
RING_LENGTHS = (0, 1, 17, 1023, 1024)


def ring_lanes(B: int, R: int, lengths, torch):
    """(start, length) (B,) int32 on the card: lane 0 starts at 0, lane 1
    at R-1, the others spread over the ring; lengths cycle over
    ``lengths``, so that many intervals wrap."""
    starts = ([0, R - 1] + [(b * 397) % R for b in range(2, B)])[:B]
    lens = [lengths[b % len(lengths)] for b in range(B)]
    return (torch.tensor(starts, dtype=torch.int32, device="cuda"),
            torch.tensor(lens, dtype=torch.int32, device="cuda"))


def rotate_lanes(c, starts, torch):
    """Lane b (axis 1) of a stacked (L, B, H, S[, D]) cache rolled by
    starts[b] on its S axis: linear row i lands at ring row starts[b] + i
    mod S."""
    return torch.stack([torch.roll(c[:, b], st, dims=2)
                        for b, st in enumerate(starts.tolist())], dim=1).contiguous()


def check_attention_ring(att, ops, torch) -> None:
    B, R, D = 16, RING_ROWS, 64
    start, length = ring_lanes(B, R, RING_LENGTHS, torch)
    for label, L, H, quant in (("float, 124M shapes", 12, 12, False),
                               ("int8, 1.5B shapes", 48, 25, True)):
        g = torch.Generator(device="cuda").manual_seed(9)
        for dtype in (torch.float32, torch.bfloat16):
            if quant:
                args = int8_attention_inputs(ops, torch, g, L, B, H, R, D, dtype)
                kernel, plain, caches = (att.decode_attention_quant_deferred,
                                         att.decode_attention_quant_deferred_plain, (5, 6, 7, 8))
            else:
                args = [torch.randn(B, H, D, device="cuda", generator=g).to(dtype)
                        for _ in range(3)]
                args += [torch.randn(L, B, H, R, D, device="cuda", generator=g).to(dtype)
                         for _ in range(2)]
                kernel, plain, caches = (att.decode_attention_deferred,
                                         att.decode_attention_deferred_plain, (3, 4))
            ring = [rotate_lanes(a, start, torch) if i in caches else a
                    for i, a in enumerate(args)]
            atol, rtol = ATTN_TOL[str(dtype).split(".")[-1]]
            for layer in (0, L - 1):
                got = kernel(*ring, length, layer=layer, start=start)
                want = plain(*ring, length, layer=layer, start=start)
                err = check_close(f"attention-ring {label} {dtype} layer={layer}", got, want,
                                  atol, rtol, torch)
                same = bool(torch.equal(got, kernel(*args, length, layer=layer)))
                log(f"attention-ring {label} B={B} R={R} {dtype} layer={layer}: "
                    f"max_abs_err={err:.3e} (atol {atol}, rtol {rtol}); ring over rotated "
                    f"caches == prefix over linear caches bit for bit: {same}")
                if not same:
                    raise AssertionError("the ring kernel over rotated caches differs from "
                                         "the prefix kernel over the linear caches")
            del args, ring


def packed_inputs(ops, torch, g, L, B, HP, S, dtype, quant):
    """Packed operands of the deferred wrappers: q, the self-term rows and
    the caches, rows of 128 (two heads of 64), with per-pair scales for
    INT8. Returns (args, indices of the cache operands)."""
    if quant:
        return int8_attention_inputs(ops, torch, g, L, B, HP, S, 128, dtype), (5, 6, 7, 8)
    args = [torch.randn(B, HP, 128, device="cuda", generator=g).to(dtype) for _ in range(3)]
    args += [torch.randn(L, B, HP, S, 128, device="cuda", generator=g).to(dtype)
             for _ in range(2)]
    return args, (3, 4)


def appended_args(args, quant):
    """The appended form's operands out of the deferred form's: q and the
    caches."""
    return [args[0]] + (args[5:] if quant else args[3:])


def append_rows(args, quant, layer, rows, torch):
    """The deferred operands' current rows written at cache row rows[b] of
    ``layer`` (into copies of that layer, as a 1-layer stack): the appended
    form's caches after the append."""
    lanes = torch.arange(args[0].shape[0], device="cuda")
    pairs = ((5, 1), (6, 2), (7, 3), (8, 4)) if quant else ((3, 1), (4, 2))
    out = {}
    for ci, ri in pairs:
        stack = args[ci][layer:layer + 1].clone()
        stack[0, lanes, :, rows.long()] = args[ri]
        out[ci] = stack
    return [args[0]] + [out[ci] for ci, _ in pairs]


def check_attention_packed(att, ops, torch) -> None:
    """Phase 15."""
    R = RING_ROWS
    for label, L, HP, quant in (("float, 124M shapes", 12, 6, False),
                                ("int8, 1.5B shapes", 48, 13, True)):
        deferred, plain = ((att.decode_attention_quant_deferred,
                            att.decode_attention_quant_deferred_plain) if quant else
                           (att.decode_attention_deferred, att.decode_attention_deferred_plain))
        appended, appended_plain = ((att.decode_attention_quant, att.decode_attention_quant_plain)
                                    if quant else (att.decode_attention,
                                                   att.decode_attention_plain))
        g = torch.Generator(device="cuda").manual_seed(15)
        for dtype in (torch.float32, torch.bfloat16):
            atol, rtol = ATTN_TOL[str(dtype).split(".")[-1]]
            for B in (1, 16):
                start, length = ring_lanes(B, R, RING_LENGTHS if B > 1 else (1023,), torch)
                args, caches = packed_inputs(ops, torch, g, L, B, HP, R, dtype, quant)
                ring = [rotate_lanes(a, start, torch) if i in caches else a
                        for i, a in enumerate(args)]
                errs = []
                for layer in (0, L - 1):
                    got = deferred(*args, length, layer=layer, packed=True)
                    errs.append(check_close(f"attention-packed {label} B={B} {dtype}", got,
                                            plain(*args, length, layer=layer, packed=True),
                                            atol, rtol, torch))
                    got_ring = deferred(*ring, length, layer=layer, start=start, packed=True)
                    errs.append(check_close(
                        f"attention-packed ring {label} B={B} {dtype}", got_ring,
                        plain(*ring, length, layer=layer, start=start, packed=True), atol,
                        rtol, torch))
                    if not torch.equal(got_ring, got):
                        raise AssertionError("the packed ring kernel over rotated caches "
                                             "differs from the packed prefix kernel")
                    if not quant:  # the same rows through the unpacked kernel
                        unpacked = [(att.unpack_heads_rows(a) if a.dim() == 3 else
                                     att.unpack_heads_seq(a[layer:layer + 1])).contiguous()
                                    for a in args]
                        errs.append(check_close(
                            f"attention-packed vs unpacked {label} B={B} {dtype}",
                            att.unpack_heads_rows(got),
                            deferred(*unpacked, length, layer=0), atol, rtol, torch))
                    # The appended form, prefix and ring, and after the append.
                    n = length.clamp(min=1, max=R - 1)
                    app = appended_args(args, quant)
                    app_ring = appended_args(ring, quant)
                    errs.append(check_close(
                        f"appended packed {label} B={B} {dtype}",
                        appended(*app, n, layer=layer, packed=True),
                        appended_plain(*app, n, layer=layer, packed=True), atol, rtol, torch))
                    errs.append(check_close(
                        f"appended packed ring {label} B={B} {dtype}",
                        appended(*app_ring, n, layer=layer, start=start, packed=True),
                        appended_plain(*app_ring, n, layer=layer, start=start, packed=True),
                        atol, rtol, torch))
                    m = length.clamp(max=R - 1)
                    after = append_rows(args, quant, layer, m, torch)
                    errs.append(check_close(
                        f"appended packed after the append vs deferred {label} B={B} {dtype}",
                        appended(*after, m + 1, layer=0, packed=True),
                        deferred(*args, m, layer=layer, packed=True), atol, rtol, torch))
                log(f"attention-packed {label} B={B} R={R} {dtype} layers 0 and {L - 1}: "
                    f"deferred and appended, prefix and ring, max_abs_err={max(errs):.3e} "
                    f"(atol {atol}, rtol {rtol}); packed ring over rotated caches == packed "
                    f"prefix bit for bit")
                del args, ring
        # The appended form of the unpacked layout, against its plain version
        # and against the unpacked deferred kernel after the append.
        H = 2 * HP - (1 if quant else 0)
        g = torch.Generator(device="cuda").manual_seed(16)
        if quant:
            args = int8_attention_inputs(ops, torch, g, L, 16, H, R, 64, torch.bfloat16)
        else:
            args = [torch.randn(16, H, 64, device="cuda", generator=g) for _ in range(3)]
            args += [torch.randn(L, 16, H, R, 64, device="cuda", generator=g)
                     for _ in range(2)]
        atol, rtol = ATTN_TOL["bfloat16" if quant else "float32"]
        start, length = ring_lanes(16, R, RING_LENGTHS, torch)
        n, m = length.clamp(min=1, max=R - 1), length.clamp(max=R - 1)
        app = appended_args(args, quant)
        errs = [check_close(f"appended {label}", appended(*app, n, layer=L - 1),
                            appended_plain(*app, n, layer=L - 1), atol, rtol, torch),
                check_close(f"appended ring {label}", appended(*app, n, layer=L - 1, start=start),
                            appended_plain(*app, n, layer=L - 1, start=start), atol, rtol, torch),
                check_close(f"appended after the append vs deferred {label}",
                            appended(*append_rows(args, quant, L - 1, m, torch), m + 1, layer=0),
                            deferred(*args, m, layer=L - 1), atol, rtol, torch)]
        log(f"appended unpacked {label} B=16 R={R}: prefix, ring and after the append, "
            f"max_abs_err={max(errs):.3e} (atol {atol}, rtol {rtol})")
        del args


def check_sampler(sk, sampling, torch) -> None:
    """Phase 6: ids identical to the plain version at every row count of the
    vocab split, with and without a top-k/top-p threshold; return_max's z*
    within SAMPLER_ZMAX_RTOL of the plain version's (the largest gap is
    logged); ties placed in different splits of a row."""
    g = torch.Generator(device="cuda").manual_seed(2)
    worst = 0.0
    for B in (1, 4, 16, 17):
        for V in (7, 1000, 50257):
            splits, chunk = sk.sampler_geometry(B, V)
            for dtype in (torch.float32, torch.bfloat16):
                logits = (torch.randn(B, V, device="cuda", generator=g) * 3).to(dtype)
                thresh = sampling._threshold(logits, 0.8, min(40, V - 1), 0.9)
                for trial in range(2):
                    seeds = torch.randint(0, 2**31 - 1, (B,), device="cuda",
                                          dtype=torch.int32, generator=g)
                    for th in (None, thresh):
                        got, zmax = sk.sample_categorical(logits, seeds, 0.8, th,
                                                          return_max=True)
                        want, want_z = sk.sample_categorical_plain(logits, seeds, 0.8, th,
                                                                   return_max=True)
                        if not torch.equal(got, want) or not torch.equal(
                                got, sk.sample_categorical(logits, seeds, 0.8, th)):
                            raise AssertionError(
                                f"sampler B={B} V={V} {dtype}: kernel ids differ: "
                                f"{got.tolist()} vs {want.tolist()}")
                        gap = ((zmax - want_z).abs() / want_z.abs().clamp(min=1e-30)).max().item()
                        worst = max(worst, gap)
                        if gap > SAMPLER_ZMAX_RTOL:
                            raise AssertionError(f"sampler B={B} V={V}: z* differs from the "
                                                 f"plain version's by {gap:.3e} (relative)")
                        if th is not None and (logits.float().gather(1, got.long()[:, None])[:, 0]
                                               < th).any():
                            raise AssertionError("sampler drew an id below its threshold")
            log(f"sampler B={B} V={V} ({splits} splits of {chunk}): f32/bf16 x "
                f"thresh none/top-k top-p, ids identical to the plain version")
    V = 50257
    splits, chunk = sk.sampler_geometry(3, V)
    logits = torch.full((3, V), -5.0, device="cuda")
    ties = [(chunk + 7, 2 * chunk + 1), (40, V - 1), (chunk - 1, chunk)]
    for b, (i, j) in enumerate(ties):
        logits[b, i] = logits[b, j] = float("inf")
    seeds = torch.tensor([3, 4, 5], dtype=torch.int32, device="cuda")
    for _ in range(8):
        got = sk.sample_categorical(logits, seeds, 1.0).tolist()
        if got != [i for i, _ in ties]:
            raise AssertionError(f"sampler ties across splits: {got}, expected the smaller ids")
    log(f"sampler ties across splits (chunk {chunk}) at {ties}: the smaller id, 8 of 8 calls; "
        f"return_max z* largest relative gap to the plain version {worst:.3e} "
        f"(bound {SAMPLER_ZMAX_RTOL:.3e})")


def linears(params, layer):
    """(name, qw, scale, int4) of the six block linears at ``layer`` and,
    for layer None, of the lm_head."""
    if layer is None:
        p = params["lm_head"]
        return [("lm_head", p["qw"], p["scale"], False)]
    out = []
    for mod, name in BLOCK_LINEARS:
        p = params["blocks"][mod][name]
        int4 = "qw4" in p
        out.append((f"{mod}.{name}[{layer}]", (p["qw4"] if int4 else p["qw"])[layer],
                    p["scale"][layer], int4))
    return out


def check_qmm(qk, params, torch) -> None:
    g = torch.Generator(device="cuda").manual_seed(6)
    atol, rtol = QMM_TOL
    last = params["blocks"]["attn"]["wq"]["scale"].shape[0] - 1
    for name, qw, scale, int4 in linears(params, 0) + linears(params, last) + linears(
            params, None):
        k = qw.shape[0] * (2 if int4 else 1)
        errs = []
        for rows in (1, 16, 32, 256):  # every body: CUDA cores, 16- and 64-row mma
            for dtype in (torch.float32, torch.bfloat16):
                x = torch.randn(rows, k, device="cuda", generator=g).to(dtype)
                got = qk.qmm(x, qw, scale, int4=int4)
                want = qk.qmm_plain(x, qw, scale, int4=int4)
                errs.append(check_close(f"qmm {name} rows={rows} {dtype}", got, want,
                                        atol, rtol, torch))
        log(f"qmm {name} K={k} N={qw.shape[1]} groups={scale.shape[0]} "
            f"{'int4' if int4 else 'int8'}: rows 1/16/32/256 x f32/bf16 "
            f"max_abs_err={max(errs):.3e} (atol {atol}, rtol {rtol})")


# (count key, wrapper, counter): every attention wrapper counts its prefix,
# ring, packed and packed ring launches apart.
COUNTERS = tuple((key + suffix, fn, attr)
                 for key, fn in (("attention", "decode_attention_deferred"),
                                 ("attention_int8", "decode_attention_quant_deferred"),
                                 ("appended", "decode_attention"),
                                 ("appended_int8", "decode_attention_quant"))
                 for suffix, attr in (("", "launches"), ("_ring", "ring_launches"),
                                      ("_packed", "packed_launches"),
                                      ("_packed_ring", "packed_ring_launches")))


@contextlib.contextmanager
def env_setting(name: str, value: str):
    """Environment variable ``name`` set to ``value`` inside the block, as
    runtimes are built (``ZG2_KV_PACKED`` and ``ZG2_FUSE_QKV`` are read at
    construction), and restored after it."""
    old = os.environ.get(name)
    os.environ[name] = value
    try:
        yield
    finally:
        if old is None:
            del os.environ[name]
        else:
            os.environ[name] = old


def reset_counts(att, sk, qk) -> None:
    for _, fn, attr in COUNTERS:
        setattr(getattr(att, fn), attr, 0)
        getattr(att, fn).by_dtype.clear()
    sk.sample_categorical.launches = sk.sample_categorical.max_launches = 0
    qk.qmm.launches = qk.qmm.w8a8_launches = qk.wmm.launches = 0
    qk.qmm.by_shape.clear()
    qk.wmm.by_shape.clear()


def read_counts(att, sk, qk, torch) -> dict:
    torch.cuda.synchronize()
    counts = {key: getattr(getattr(att, fn), attr) for key, fn, attr in COUNTERS}
    counts.update(sampler=sk.sample_categorical.launches,
                  sampler_max=sk.sample_categorical.max_launches, qmm=qk.qmm.launches,
                  qmm_w8a8=qk.qmm.w8a8_launches, wmm=qk.wmm.launches)
    return counts


def expect_counts(label: str, counts: dict, expected: dict) -> None:
    """Every counter equals its expected value (0 where not listed)."""
    want = {k: expected.get(k, 0) for k in counts}
    log(f"{label} launches: {counts} (expected {want})")
    if counts != want:
        raise AssertionError(f"{label}: launch counts do not match the steps: "
                             f"{counts} vs {want}")


REQUESTS = (("greedy", "the quick brown fox", dict(temperature=0.0)),
            ("T=0.8", "hello world, streaming", dict(temperature=0.8, seed=1)),
            ("T=0.8 top-k 40 top-p 0.9", "the lazy dog",
             dict(temperature=0.8, top_k=40, top_p=0.9, seed=2)))


def run_requests(engine_mod, config_mod, engine, label: str, card: str):
    """The three requests, 32 new tokens each; returns [(name, prompt,
    sampling, text, metrics)], the decode steps and the sampled steps."""
    results = []
    for name, prompt, kw in REQUESTS:
        sampling = config_mod.SamplingConfig(**kw)
        m = engine_mod.GenerationMetrics()
        text = engine.generate_text(prompt, 32, sampling, metrics=m)
        results.append((name, prompt, sampling, text, m))
    for name, prompt, _, text, m in results:
        log(f"{label} [{name}] {prompt!r} -> {text!r}")
        log(f"{label} [{name}] prefill_ms={m.prefill_ms:.3f} "
            f"ms_per_token_p50={m.ms_per_token_percentile(50):.3f} "
            f"tok_per_s={m.tokens_per_sec:.1f} generated={m.generated_tokens} ({card})")
        if m.generated_tokens != 32:
            raise AssertionError(f"{label} {name}: {m.generated_tokens} tokens, expected 32")
    decode_steps = sum(m.generated_tokens for *_, m in results)
    sampled = sum(m.generated_tokens + 1 for _, _, s, _, m in results if s.temperature > 0)
    return results, decode_steps, sampled


def teacher_forced(gpt2, params, config, ids, tokens, device, torch, kv_quant=None,
                   bucket=32, group=1, lanes=1, cache_dtype=None):
    """(len(tokens) + 1, vocab) logits: prefill of ``ids`` padded to
    ``bucket`` (the engine's prompt bucket, so that the served run's
    arithmetic is repeated exactly), then one decode step per token of
    ``tokens``. ``group`` and ``lanes`` repeat a batcher's shapes: the
    prefill runs ``group`` copies of the prompt (one admission group) and
    the decode steps ``lanes`` copies (the batch), lane 0 read. A float
    cache is in ``cache_dtype`` (default wte's dtype)."""
    cache = gpt2.init_kv_cache(config, group, bucket + len(tokens) + 1, device=device,
                               quant=kv_quant, dtype=cache_dtype or params["wte"].dtype)
    prompt = torch.zeros((group, bucket), dtype=torch.int32, device=device)
    prompt[:, :len(ids)] = torch.tensor(ids, dtype=torch.int32)
    cache, logits = gpt2.prefill(params, cache, prompt,
                                 torch.full((group,), len(ids), dtype=torch.int32,
                                            device=device), config)
    rows = [logits[0]]
    if lanes != group:  # every lane of the batch a copy of lane 0 (axis 1; 0 of length)
        cache = {name: (t[:1].expand(lanes) if name == "length" else
                        t[:, :1].expand(t.shape[0], lanes, *t.shape[2:])).contiguous()
                 for name, t in cache.items()}
    for t in tokens:
        cache, logits = gpt2.decode_step(params, cache, torch.full((lanes,), t,
                                                                   dtype=torch.int32,
                                                                   device=device), config)
        rows.append(logits[0])
    return torch.stack(rows).float().cpu()[:, :config.vocab_size]


def compare_logits(label: str, gpu, cpu, torch, atol: float = E2E_ATOL,
                   what: str = "teacher-forced fp32 logits, card vs CPU") -> None:
    """``gpu`` within atol + E2E_RTOL * |cpu| of ``cpu`` (positions, vocab),
    finite, and the same argmax wherever cpu's top two are not a near-tie."""
    err = (gpu - cpu).abs()
    top2 = cpu.topk(2, -1).values
    near_tie = (top2[:, 0] - top2[:, 1]) < 2 * (atol + E2E_RTOL * top2[:, 0].abs())
    flips = (cpu.argmax(-1) != gpu.argmax(-1)) & ~near_tie
    log(f"{label} {what} over {gpu.shape[0]} positions: "
        f"max_abs_err={err.max().item():.3e} (atol {atol:.3e}, rtol {E2E_RTOL}), "
        f"argmax flips outside near-ties={int(flips.sum())}")
    if (err > atol + E2E_RTOL * cpu.abs()).any() or flips.any():
        raise AssertionError(f"{label}: {what}: the logits disagree")
    if not torch.isfinite(gpu).all():
        raise AssertionError(f"{label}: non-finite logits")


def layout_name(config) -> str:
    return "packed KV" if config.kv_packed else "unpacked KV"


def serve(pkg, torch, encoder, card: str, label: str = "serve", params=None):
    """Phases 7 and 16: the engine on the layout that ZG2_KV_PACKED gives
    it, with new random weights or ``params``. Returns the kernels' launch
    counts, the engine and the greedy prompt's ids."""
    config_mod, gpt2, engine_mod, att, sk, qk, weights, _ = pkg
    # Full 124M width; the tokenizer knows len(vocab) ids, the other rows
    # of the 50257-row vocab are padding that the lm_head masks.
    config = dataclasses.replace(config_mod.get_config("124M"), vocab_size=len(encoder.vocab),
                                 padded_vocab_size=50257)
    if params is None:
        params = gpt2.init_params(config, torch.Generator(device="cuda").manual_seed(0),
                                  torch.float32)
    engine = engine_mod.InferenceEngine(config, params, encoder, device="cuda")
    engine.generate_text("warm up", 2, config_mod.SamplingConfig(temperature=0.8))
    torch.cuda.synchronize()

    reset_counts(att, sk, qk)
    results, decode_steps, sampled = run_requests(
        engine_mod, config_mod, engine, label,
        f"fp32, B=1, {layout_name(engine.config)}, {card}")
    counts = read_counts(att, sk, qk, torch)
    key = "attention_packed" if engine.config.kv_packed else "attention"
    expected = {key: config.n_layers * decode_steps, "sampler": sampled}
    if gpt2._use_wmm():  # ZG2_WMM=1: the float block linears of every decode step
        expected["wmm"] = 6 * config.n_layers * decode_steps
    expect_counts(label, counts, expected)

    # Teacher-forced check of the greedy request against the CPU.
    _, prompt, sampling, text, _ = results[0]
    ids = encoder.encode(prompt)
    greedy = engine.generate(ids, 32, sampling)
    if encoder.decode(greedy) != text:
        raise AssertionError("greedy rerun differs from the served text")
    gpu = teacher_forced(gpt2, engine.params, engine.config, ids, greedy[:-1], "cuda", torch)
    if gpu.argmax(-1).tolist() != greedy:
        raise AssertionError("teacher-forced argmax differs from the greedy tokens")
    seq = torch.tensor([ids + greedy[:-1]], dtype=torch.int32)
    cpu_params = weights.tree_map(lambda t: t.cpu(), engine.params)
    cpu = gpt2.forward(cpu_params, seq, config)[0, len(ids) - 1:][:, :config.vocab_size]
    compare_logits(label, gpu, cpu, torch)
    return counts, engine, ids


def dequantized(quantize, params):
    """The tree with every quantized linear replaced by its f32
    dequantized weight: the reference formulation dequantize-then-matmul."""
    out = dict(params, blocks=dict(params["blocks"]))
    for mod, name in BLOCK_LINEARS:
        sub = dict(out["blocks"][mod])
        sub[name] = quantize.dequantize_linear(sub[name])
        out["blocks"][mod] = sub
    out["lm_head"] = quantize.dequantize_linear(params["lm_head"])
    return out


def build_1p5b(config_mod, gpt2, quantize, encoder, torch, mode: str = "int4"):
    """GPT-2 1.5B at full width and depth, random bf16 weights from a
    fixed seed, INT4 (``mode``, or INT8 per-channel) block linears and the
    INT8 lm_head."""
    config = dataclasses.replace(config_mod.get_config("1558M"), vocab_size=len(encoder.vocab),
                                 padded_vocab_size=50257)
    params = gpt2.init_params(config, torch.Generator(device="cuda").manual_seed(0),
                              torch.bfloat16)
    params = quantize.quantize_params(params, mode=mode)
    torch.cuda.synchronize()
    return config, params


def gemv_counts(config, steps: int, prefills) -> dict:
    """Expected launches of the quantized GEMV: the block linears and the
    lm_head of every decode step; per prefill of k x T rows the block
    linears when k * T is within the kernel's row cap (256, or 64 for the
    w8a8 body under act_quant), and the lm_head's k rows. Counted under
    ``qmm``, or ``qmm_w8a8`` for w8a8."""
    L = config.n_layers
    key, cap = ("qmm_w8a8", 64) if config.act_quant else ("qmm", 256)
    return {key: (6 * L + 1) * steps + sum(6 * L * (k * t <= cap) + 1 for k, t in prefills)}


def serve_1p5b(pkg, torch, encoder, config, params, card: str, label: str = "serve-1.5B",
               check_layers=None):
    """Phases 11 and 17. Returns the kernels' launch counts, the engine, the
    greedy prompt's ids and the INT8 floor. With ``check_layers`` the
    teacher-forced comparisons with the CPU run the first that many layers
    (the served requests run them all)."""
    config_mod, gpt2, engine_mod, att, sk, qk, weights, quantize = pkg
    engine = engine_mod.InferenceEngine(config, params, encoder, kv_quant="int8",
                                        device="cuda")
    engine.generate_text("warm up", 2, config_mod.SamplingConfig(temperature=0.8))
    torch.cuda.synchronize()

    reset_counts(att, sk, qk)
    results, decode_steps, sampled = run_requests(
        engine_mod, config_mod, engine, label,
        f"INT4 weights, INT8 lm_head and KV cache ({layout_name(engine.config)}), bf16 "
        f"activations, B=1, {card}")
    counts = read_counts(att, sk, qk, torch)
    per_pass = 6 * config.n_layers + 1  # block linears + the lm_head
    passes = decode_steps + len(results)  # decode steps + prefills
    key = "attention_int8_packed" if engine.config.kv_packed else "attention_int8"
    expect_counts(label, counts, {"qmm": per_pass * passes, "sampler": sampled,
                                  key: config.n_layers * decode_steps})
    config = engine.config  # the layout the engine chose, for the runs below

    _, prompt, sampling, text, _ = results[0]
    ids = encoder.encode(prompt)
    greedy = engine.generate(ids, 32, sampling)
    if encoder.decode(greedy) != text:
        raise AssertionError("greedy rerun differs from the served text")
    served = teacher_forced(gpt2, engine.params, config, ids, greedy[:-1], "cuda", torch,
                            kv_quant="int8")
    if served.argmax(-1).tolist() != greedy:
        raise AssertionError("teacher-forced argmax differs from the greedy tokens")
    # The same quantized weights with f32 float leaves (the scales are f32
    # already), teacher-forced on the card and on the CPU.
    t0 = time.perf_counter()
    f32 = weights.tree_map(lambda t: t.float() if t.is_floating_point() else t, engine.params)
    if check_layers and check_layers < config.n_layers:  # views of the first blocks
        config = dataclasses.replace(config, n_layers=check_layers)
        f32 = dict(f32, blocks=weights.tree_map(lambda t: t[:check_layers], f32["blocks"]))
        log(f"{label} teacher-forced comparisons with the CPU over the first {check_layers} "
            f"of {engine.config.n_layers} layers")
    cpu_w = weights.tree_map(lambda t: t.cpu(), dequantized(quantize, f32))
    # On the CPU the weights are dequantized to f32 once (on the card, then
    # copied: float(q) * scale is one f32 product, the same bits on either
    # device): each linear is one
    # plain matmul, the same products as qmm's plain version (weight
    # float(q) * scale in f32, f32 sums) in another order, at a fraction of
    # its time (the qmm phase holds the kernel to that plain version).
    # 1. Float KV cache: the INT4/INT8 GEMVs through 48 layers.
    gpu = teacher_forced(gpt2, f32, config, ids, greedy[:-1], "cuda", torch)
    t1 = time.perf_counter()
    cpu = teacher_forced(gpt2, cpu_w, config, ids, greedy[:-1], "cpu", torch)
    log(f"{label} CPU run, float KV cache: {time.perf_counter() - t1:.1f} s")
    compare_logits(f"{label} float KV cache", gpu, cpu, torch)
    # 2. INT8 KV cache, the served configuration, against the CPU through the
    #    plain INT8 attention. An INT8 row rounds each element to a step of
    #    absmax/127, so a roundoff-sized difference before the rounding
    #    flips a few elements by a whole step and moves the logits by far
    #    more than roundoff. The floor is measured here: the same model on
    #    the CPU with f64 float leaves against the f32 run. The card is held
    #    to 1e-3 or three times that floor, whichever is larger.
    gpu = teacher_forced(gpt2, f32, config, ids, greedy[:-1], "cuda", torch, kv_quant="int8")
    t1 = time.perf_counter()
    cpu = teacher_forced(gpt2, cpu_w, config, ids, greedy[:-1], "cpu", torch, kv_quant="int8")
    log(f"{label} CPU run, INT8 KV cache: {time.perf_counter() - t1:.1f} s")
    cpu_w = weights.tree_map(lambda t: t.double() if t.is_floating_point() else t, cpu_w)
    t1 = time.perf_counter()
    f64 = teacher_forced(gpt2, cpu_w, config, ids, greedy[:-1], "cpu", torch, kv_quant="int8")
    log(f"{label} CPU run, INT8 KV cache, f64: {time.perf_counter() - t1:.1f} s")
    del cpu_w
    floor = (f64 - cpu).abs().max().item()
    log(f"{label} INT8 KV floor: the CPU run in f64 and in f32 differ by max_abs_err="
        f"{floor:.3e} over {cpu.shape[0]} positions")
    compare_logits(f"{label} INT8 KV cache", gpu, cpu, torch, atol=max(E2E_ATOL, 3 * floor))
    log(f"{label} teacher-forced runs (2 on the card, 3 on the CPU): {time.perf_counter() - t0:.1f} s")
    return counts, engine, ids, floor


W8A8_ROWS = (1, 2, 15, 16, 17, 33, 64)  # every 16-row tile count, partly padded tiles


def check_w8a8(qk, quantize, params, torch) -> None:
    """Phase 19: the w8a8 body against its plain version, bit for bit, on an
    INT8 per-channel tree; 65 rows take ``w8a8_matmul`` and no kernel."""
    g = torch.Generator(device="cuda").manual_seed(19)
    last = params["blocks"]["attn"]["wq"]["scale"].shape[0] - 1
    for name, qw, scale, _ in linears(params, 0) + linears(params, last) + linears(
            params, None):
        k, n = qw.shape
        geos = {rows: qk.w8a8_geometry(rows, k, n) for rows in W8A8_ROWS}
        for rows in W8A8_ROWS:
            for dtype in (torch.float32, torch.bfloat16):
                x = (torch.randn(rows, k, device="cuda", generator=g) * 3).to(dtype)
                if rows > 1:  # an all-zero row (the 1e-12 floor)
                    x[1] = 0
                before = (qk.qmm.launches, qk.qmm.w8a8_launches)
                got = qk.qmm(x, qw, scale, w8a8=True)
                want = qk.qmm_plain(x, qw, scale, w8a8=True)
                torch.cuda.synchronize()
                if (qk.qmm.launches, qk.qmm.w8a8_launches) != (before[0], before[1] + 1):
                    raise AssertionError(f"w8a8 {name}: not one launch of the w8a8 body")
                if not torch.equal(got, want):
                    raise AssertionError(f"w8a8 {name} rows={rows} {dtype}: kernel differs from "
                                         f"its plain version (max_abs_err "
                                         f"{max_err(got, want):.3e})")
        x = torch.randn(65, k, device="cuda", generator=g).to(torch.bfloat16)
        before = (qk.qmm.launches, qk.qmm.w8a8_launches)
        y = quantize.quantized_linear({"qw": qw, "scale": scale}, x, act_quant=True)
        torch.cuda.synchronize()
        if (qk.qmm.launches, qk.qmm.w8a8_launches) != before:
            raise AssertionError(f"w8a8 {name}: 65 rows launched a GEMV kernel")
        same = torch.equal(quantize.w8a8_matmul(x, qw, scale),
                           qk.qmm_plain(x, qw, scale, w8a8=True))
        if not same or y.shape != (65, n):
            raise AssertionError(f"w8a8 {name}: w8a8_matmul differs from the exact product")
        log(f"w8a8 {name} K={k} N={n}: rows {W8A8_ROWS} x f32/bf16 bit-equal to the plain "
            f"version, one launch each (splits {[geos[r].splits for r in W8A8_ROWS]}); "
            f"65 rows through w8a8_matmul "
            f"({'torch._int_mm' if quantize._int_mm_takes(x, qw) else 'f64 product'}) "
            f"equal to the exact product, no kernel launched")


def serve_w8a8_1p5b(pkg, torch, encoder, config, params, card: str, check_layers: int = 12):
    """Phase 20's engine: w8a8 with a bf16 KV cache. Returns the launch
    counts, the engine, the greedy prompt's ids and the run's floor."""
    config_mod, gpt2, engine_mod, att, sk, qk, weights, _ = pkg
    label = "serve-w8a8-1.5B"
    engine = engine_mod.InferenceEngine(config, params, encoder, device="cuda")
    engine.generate_text("warm up", 2, config_mod.SamplingConfig(temperature=0.8))
    torch.cuda.synchronize()

    reset_counts(att, sk, qk)
    results, decode_steps, sampled = run_requests(
        engine_mod, config_mod, engine, label,
        f"{weights_name(config)}, bf16 KV cache ({layout_name(engine.config)}), bf16 "
        f"activations, B=1, {card}")
    counts = read_counts(att, sk, qk, torch)
    prefills = [(1, engine_mod._bucket(len(encoder.encode(prompt)), engine.prompt_buckets))
                for _, prompt, *_ in results]
    key = "attention_packed" if engine.config.kv_packed else "attention"
    expect_counts(label, counts, {key: config.n_layers * decode_steps, "sampler": sampled,
                                  **gemv_counts(config, decode_steps, prefills)})

    _, prompt, sampling, text, _ = results[0]
    ids = encoder.encode(prompt)
    greedy = engine.generate(ids, 32, sampling)
    if encoder.decode(greedy) != text:
        raise AssertionError("greedy rerun differs from the served text")
    served = teacher_forced(gpt2, engine.params, engine.config, ids, greedy[:-1], "cuda", torch)
    if served.argmax(-1).tolist() != greedy:
        raise AssertionError("teacher-forced argmax differs from the greedy tokens")
    # The same quantized weights with f32 float leaves, the first layers,
    # teacher-forced on the card and on the CPU (the w8a8 plain versions),
    # and on the CPU with f64 float leaves for the floor: x is quantized per
    # row, so a roundoff-sized difference upstream can move one int8 value by
    # a whole step, as in the INT8 KV cache.
    t0 = time.perf_counter()
    check_layers = min(check_layers, config.n_layers)
    cfg = dataclasses.replace(engine.config, n_layers=check_layers)
    f32 = weights.tree_map(lambda t: t.float() if t.is_floating_point() else t, engine.params)
    f32 = dict(f32, blocks=weights.tree_map(lambda t: t[:check_layers], f32["blocks"]))
    gpu = teacher_forced(gpt2, f32, cfg, ids, greedy[:-1], "cuda", torch)
    cpu_w = weights.tree_map(lambda t: t.cpu(), f32)
    t1 = time.perf_counter()
    cpu = teacher_forced(gpt2, cpu_w, cfg, ids, greedy[:-1], "cpu", torch)
    log(f"{label} CPU run: {time.perf_counter() - t1:.1f} s")
    cpu_w = weights.tree_map(lambda t: t.double() if t.is_floating_point() else t, cpu_w)
    t1 = time.perf_counter()
    f64 = teacher_forced(gpt2, cpu_w, cfg, ids, greedy[:-1], "cpu", torch)
    log(f"{label} CPU run, f64: {time.perf_counter() - t1:.1f} s")
    del cpu_w
    floor = (f64 - cpu).abs().max().item()
    log(f"{label} floor: the CPU run in f64 and in f32 differ by max_abs_err={floor:.3e} over "
        f"{cpu.shape[0]} positions ({check_layers} of {config.n_layers} layers)")
    compare_logits(label, gpu, cpu, torch, atol=max(E2E_ATOL, 3 * floor))
    log(f"{label} teacher-forced runs: {time.perf_counter() - t0:.1f} s")
    return counts, engine, ids, floor


WMM_ROWS = (1, 2, 7, 8, 15, 16, 17, 63, 64, 65, 255, 256)


def check_wmm(qk, params, torch) -> None:
    """Phase 21: the float GEMV against its plain version at the 124M
    linears (layers 0 and last) and at weights whose rows start off 16
    bytes (N = 150, 770) or whose K is not a multiple of the kernel's
    32-row tile (K = 100), or so long (K = 8192) that more than 16 rows of
    bf16 x add their splits by ticket: every row count of WMM_ROWS (each
    body, partly padded tiles), f32 and bf16 weights and activations,
    within QMM_TOL, one launch per call, and a second call bit-identical."""
    g = torch.Generator(device="cuda").manual_seed(21)
    atol, rtol = QMM_TOL
    last = params["blocks"]["attn"]["wq"]["w"].shape[0] - 1
    cases = [(f"{mod}.{name}[{layer}]", params["blocks"][mod][name]["w"][layer])
             for layer in (0, last) for mod, name in BLOCK_LINEARS]
    cases += [(f"random {k}x{n}", torch.randn(k, n, device="cuda", generator=g) * 0.05)
              for k, n in ((768, 150), (3072, 770), (100, 768), (8192, 770))]
    for label, w32 in cases:
        errs = []
        for wdtype in (torch.float32, torch.bfloat16):
            w = w32.to(wdtype)
            for rows in WMM_ROWS:
                for xdtype in (torch.float32, torch.bfloat16):
                    x = torch.randn(rows, w.shape[0], device="cuda", generator=g).to(xdtype)
                    before = qk.wmm.launches
                    got = qk.wmm(x, w)
                    if qk.wmm.launches != before + 1:
                        raise AssertionError(f"wmm {label}: not one launch")
                    errs.append(check_close(f"wmm {label} rows={rows} x {xdtype} w {wdtype}",
                                            got, qk.wmm_plain(x, w), atol, rtol, torch))
                    if not torch.equal(qk.wmm(x, w), got):
                        raise AssertionError(f"wmm {label} rows={rows} x {xdtype} w {wdtype}: "
                                             "two calls differ")
        log(f"wmm {label} K={w32.shape[0]} N={w32.shape[1]}: rows {WMM_ROWS} x f32/bf16 x and "
            f"w, max_abs_err={max(errs):.3e} (atol {atol}, rtol {rtol}), two calls bit-identical")


def batch_requests(seed: int, n: int, vocab: int, prompt_lens, budgets):
    """n (prompt ids, budget) pairs from numpy's generator: prompt lengths
    and budgets drawn from the inclusive ranges given."""
    import numpy as np

    rng = np.random.default_rng(seed)
    lens = rng.integers(prompt_lens[0], prompt_lens[1] + 1, n)
    budgets = rng.integers(budgets[0], budgets[1] + 1, n)
    return [(rng.integers(0, vocab, m).tolist(), int(b)) for m, b in zip(lens, budgets)]


def serve_batch(batcher, requests, label: str):
    """Submit, run to the end; every request must end at its budget (no
    stop tokens, and max_seq leaves room). Returns the tokens per request."""
    rids = [batcher.submit(ids, budget) for ids, budget in requests]
    by_rid = {r.rid: r.generated for r in batcher.run()}
    out = [by_rid.get(r) for r in rids]
    short = [i for i, (toks, (_, budget)) in enumerate(zip(out, requests))
             if toks is None or len(toks) != budget]
    if short:
        raise AssertionError(f"{label}: requests {short} did not end at their budgets")
    return out


def near_tie_check(label: str, gpt2, engine, requests, served, tol: float, torch,
                   shapes=None, lanes: int = 1, wants=None) -> None:
    """Each request's batcher tokens equal the engine's greedy tokens up to
    the first divergence, if any; there the engine's logits for its token
    and for the batcher's differ by at most ``tol`` (a near-tie that the
    two paths' different prefill shapes may break either way).

    With ``shapes`` (a prompt's admission prefill shape (k, T)) each
    request is also replayed at the batcher's own shapes: the model
    teacher-forced with the batcher's tokens after a k x T prefill, then at
    a decode batch of ``lanes``, must pick every one of them as its argmax
    (the batcher computed the model's greedy tokens, bit for bit, at its
    shapes). A divergence from the engine wider than ``tol`` then passes
    as the roundoff of the two paths' shapes. ``wants``: the engine's
    greedy tokens per request, when already generated."""
    import numpy as np

    from zig_gpt2_tpu_torch.config import SamplingConfig
    from zig_gpt2_tpu_torch.runtime.engine import _bucket

    for i, ((ids, budget), got) in enumerate(zip(requests, served)):
        replay = None
        if shapes is not None:
            group, bucket = shapes[tuple(ids)]
            replay = teacher_forced(gpt2, engine.params, engine.config, ids, got[:-1], "cuda",
                                    torch, kv_quant=engine.kv_quant, bucket=bucket,
                                    group=group, lanes=lanes)
            picked = replay.argmax(-1).tolist()
            log(f"{label} replay at the batcher's shapes (prefill {group} x {bucket}, decode "
                f"batch {lanes}): prompt of {len(ids)}, {budget} tokens: the model picks the "
                f"batcher's tokens: {picked == got}")
            if picked != got:
                raise AssertionError(f"{label}: the batcher's tokens are not the model's greedy "
                                     f"tokens at its own shapes (first at "
                                     f"{next(i for i, (a, b) in enumerate(zip(picked, got)) if a != b)})")
        want = (wants[i] if wants is not None else
                engine.generate(ids, budget, SamplingConfig(temperature=0.0)))
        n = next((i for i, (a, b) in enumerate(zip(want, got)) if a != b), None)
        if n is None:
            log(f"{label} near-tie check: prompt of {len(ids)}, {budget} tokens: identical "
                f"to the engine")
            continue
        logits = teacher_forced(gpt2, engine.params, engine.config, ids, want[:n], "cuda",
                                torch, kv_quant=engine.kv_quant,
                                bucket=_bucket(len(ids), engine.prompt_buckets))[-1]
        if int(np.argmax(logits.numpy())) != want[n]:
            raise AssertionError(f"{label}: the teacher-forced run does not repeat the "
                                 "engine's token")
        gap = float(logits[want[n]] - logits[got[n]])
        log(f"{label} near-tie check: prompt of {len(ids)}, {budget} tokens: first "
            f"divergence at token {n}, engine logit gap {gap:.3e} (tolerance {tol:.3e})")
        if gap > tol and replay is None:
            raise AssertionError(f"{label}: the batcher left the engine's tokens at "
                                 f"token {n}, not at a near-tie (gap {gap:.3e})")
        if gap > tol:
            log(f"{label} near-tie check: a wider gap, taken as the shapes' roundoff: at the "
                f"batcher's shapes the model's logit gap for the batcher's token is "
                f"{float(replay[n, got[n]] - replay[n, want[n]]):.3e}")


def serve_batcher_124m(pkg, batcher_mod, torch, engine, card: str,
                       label: str = "serve-batcher-124M") -> dict:
    """Phases 9 and 16: the batcher on the engine's model and layout.
    Returns the kernels' launch counts."""
    config_mod, gpt2, _, att, sk, qk, _, _ = pkg
    greedy = config_mod.SamplingConfig(temperature=0.0)
    b = batcher_mod.ContinuousBatcher(engine.config, engine.params, batch_size=8,
                                      max_seq=256, sampling=greedy, device="cuda")
    serve_batch(b, [([1, 2, 3], 4), ([4, 5], 4)], f"{label} warm-up")
    b.metrics = batcher_mod.BatcherMetrics()
    requests = batch_requests(21, 16, engine.config.vocab_size, (4, 100), (16, 64))
    reset_counts(att, sk, qk)
    served = serve_batch(b, requests, label)
    counts = read_counts(att, sk, qk, torch)
    steps = b.metrics.steps
    key = "attention_packed_ring" if b.config.kv_packed else "attention_ring"
    expected = {key: engine.config.n_layers * steps}
    if gpt2._use_wmm():
        expected["wmm"] = 6 * engine.config.n_layers * steps
    expect_counts(label, counts, expected)
    expect_replays(label, b)
    log(f"{label} metrics {json.dumps(b.metrics.as_dict(8))} "
        f"(fp32, B=8, ring, {layout_name(b.config)}, greedy, {card})")
    replayed_kernels(label, b, att, sk, qk, torch)
    near_tie_check(label, gpt2, engine, requests[:2], served[:2], E2E_ATOL, torch)
    return counts


def serve_batcher_wmm_bf16(pkg, batcher_mod, torch, engine, card: str) -> dict:
    """Phase 22's bf16 batcher: the engine's 124M weights cast to bf16 on
    ``ContinuousBatcher(batch_size=8, max_seq=256)`` with ``ZG2_WMM=1``, so
    that the decode linears take wmm's tensor-core body (8 bf16 rows in one
    padded 16-row tile). 16 greedy requests on a ring cache equal those on a
    linear one (``ZG2_RING=0``), and two of them the tokens of a bf16 engine
    with ``ZG2_WMM=0`` up to a near-tie within max(1e-3, 3 x the bf16
    floor): the largest gap between that engine's teacher-forced logits and
    the same weights' in f32, on the card. Returns the launch counts."""
    from zig_gpt2_tpu_torch.runtime.engine import _bucket

    config_mod, gpt2, engine_mod, att, sk, qk, weights, _ = pkg
    label = "serve-batcher-wmm-bf16-124M"
    bf16 = weights.tree_map(lambda t: t.to(torch.bfloat16) if t.is_floating_point() else t,
                            engine.params)
    ref = engine_mod.InferenceEngine(engine.config, bf16, device="cuda")
    greedy = config_mod.SamplingConfig(temperature=0.0)
    kw = dict(batch_size=8, max_seq=256, sampling=greedy, device="cuda")
    requests = batch_requests(22, 16, ref.config.vocab_size, (4, 100), (16, 64))
    os.environ["ZG2_WMM"] = "1"
    try:
        b = batcher_mod.ContinuousBatcher(ref.config, ref.params, **kw)
        serve_batch(b, [([1, 2, 3], 4), ([4, 5], 4)], f"{label} warm-up")
        b.metrics = batcher_mod.BatcherMetrics()
        reset_counts(att, sk, qk)
        served = serve_batch(b, requests, label)
        counts = read_counts(att, sk, qk, torch)
        steps, L = b.metrics.steps, ref.config.n_layers
        key = "attention_packed_ring" if b.config.kv_packed else "attention_ring"
        expect_counts(label, counts, {key: L * steps, "wmm": 6 * L * steps})
        expect_replays(label, b)
        log(f"{label} metrics {json.dumps(b.metrics.as_dict(8))} (bf16, B=8, ring, "
            f"{layout_name(b.config)}, greedy, wmm, {card})")
        replayed_kernels(label, b, att, sk, qk, torch)
        os.environ["ZG2_RING"] = "0"
        try:
            linear = batcher_mod.ContinuousBatcher(ref.config, ref.params, **kw)
        finally:
            del os.environ["ZG2_RING"]
        linear_served = serve_batch(linear, requests, f"{label} linear")
    finally:
        os.environ["ZG2_WMM"] = "0"
    same = sum(a == c for a, c in zip(served, linear_served))
    log(f"{label} ring vs linear cache: {same} of {len(served)} greedy requests identical")
    if same != len(served):
        raise AssertionError("the bf16 wmm ring batcher's greedy tokens differ from the "
                             "linear one's")
    ids, budget = requests[0]
    tokens = ref.generate(ids, budget, greedy)
    bucket = _bucket(len(ids), ref.prompt_buckets)
    got = teacher_forced(gpt2, ref.params, ref.config, ids, tokens[:-1], "cuda", torch,
                         bucket=bucket)
    f32 = weights.tree_map(lambda t: t.float() if t.is_floating_point() else t, ref.params)
    want = teacher_forced(gpt2, f32, ref.config, ids, tokens[:-1], "cuda", torch, bucket=bucket)
    floor = (got - want).abs().max().item()
    log(f"{label} bf16 floor: the bf16 engine's teacher-forced logits and the same weights' "
        f"in f32 differ by max_abs_err={floor:.3e} over {got.shape[0]} positions")
    near_tie_check(f"{label} against the bf16 engine with ZG2_WMM=0", gpt2, ref, requests[:2],
                   served[:2], max(E2E_ATOL, 3 * floor), torch)
    return counts


def weights_name(config) -> str:
    return ("w8a8: INT8 weights and activations" if config.act_quant else
            "INT4 weights, INT8 lm_head")


def serve_batcher_1p5b(pkg, batcher_mod, torch, config, params, floor: float, card: str,
                       label: str = "serve-batcher-1.5B", sampled_half: bool = True):
    """Phases 13, 18 and 20: 64 requests, the first half sampled, sized so
    that the write pointer wraps; or with ``sampled_half=False`` 32 greedy
    requests. Returns the kernels' launch counts and the ring batcher."""
    import os

    config_mod, gpt2, engine_mod, att, sk, qk, _, _ = pkg
    sampled = config_mod.SamplingConfig(temperature=0.8, top_k=40, top_p=0.9, seed=4)
    greedy = config_mod.SamplingConfig(temperature=0.0)
    kw = dict(batch_size=16, max_seq=256, decode_chunk=1, kv_quant="int8", device="cuda")
    b = batcher_mod.ContinuousBatcher(config, params, sampling=sampled, **kw)
    rows = b.cache["k"].shape[-2]
    serve_batch(b, [([1, 2, 3], 4), ([4, 5], 4)], f"{label} warm-up")
    b.metrics = batcher_mod.BatcherMetrics()
    requests = (batch_requests(31, 64, config.vocab_size, (8, 120), (32, 96)) if sampled_half
                else batch_requests(51, 32, config.vocab_size, (8, 120), (32, 96)))
    half = len(requests) // 2 if sampled_half else 0

    # Each admission's prefill (tokens, lengths): its (k, T) for the qmm
    # count, its prompts' shapes for the replay.
    with recording(gpt2, {"prefill": [], "extend": []}) as calls:
        reset_counts(att, sk, qk)
        if half:
            serve_batch(b, requests[:half], f"{label} sampled half")
        sampled_steps, sampled_prefills = b.metrics.steps, len(calls["prefill"])
        b.sampling = greedy
        served = serve_batch(b, requests[half:], f"{label} greedy half" if half else label)
        counts = read_counts(att, sk, qk, torch)
    admitted, prefills = calls["prefill"], window_shapes(calls["prefill"])
    steps = b.metrics.steps
    key = "attention_int8_packed_ring" if b.config.kv_packed else "attention_int8_ring"
    expect_counts(label, counts, {key: config.n_layers * steps,
                                  **gemv_counts(config, steps, prefills),
                                  "sampler": sampled_steps + sampled_prefills})
    log(f"{label}: {steps} decode steps ({sampled_steps} sampled), "
        f"{len(prefills)} admission prefills {sorted(set(prefills))}, ring rows {rows}, "
        f"wptr now {int(b.cache['wptr'])}")
    if sampled_half and steps + 2 < rows:  # the warm-up took 2 steps
        raise AssertionError("the write pointer did not wrap")
    expect_replays(label, b)
    log(f"{label} metrics {json.dumps(b.metrics.as_dict(16))} ({weights_name(config)}, INT8 "
        f"KV cache, {layout_name(b.config)}, bf16 activations, B=16, ring, {card})")
    replayed_kernels(label, b, att, sk, qk, torch)

    os.environ["ZG2_RING"] = "0"
    try:
        linear = batcher_mod.ContinuousBatcher(config, params, sampling=greedy, **kw)
    finally:
        del os.environ["ZG2_RING"]
    linear_served = serve_batch(linear, requests[half:], f"{label} linear")
    same = sum(a == c for a, c in zip(served, linear_served))
    log(f"{label} ring vs linear cache: {same} of {len(served)} greedy requests "
        f"identical")
    if same != len(served):
        raise AssertionError("the ring batcher's greedy tokens differ from the linear one's")
    del linear

    shapes = {tuple(row[:n]): tuple(toks.shape) for toks, lens in admitted
              for row, n in zip(toks.tolist(), lens.tolist())}
    engine = engine_mod.InferenceEngine(config, params, kv_quant="int8", device="cuda")
    greedy_half = sorted(zip(requests[half:], served), key=lambda rs: rs[0][1])[:4]
    near_tie_check(label, gpt2, engine, [r for r, _ in greedy_half],
                   [t for _, t in greedy_half], max(E2E_ATOL, 3 * floor), torch,
                   shapes=shapes, lanes=b.batch_size)
    return counts, b


def marked_steps(prof) -> list:
    """The kernels of each marked step of a profiler window, [(name, device
    us)] per step, a ``torch.cuda._sleep`` marker kernel opening each, in
    launch order (a device event's correlation id: by start time a marker
    once fell 2954 kernels into the next step). Read from the raw kineto
    events: building the profiler's FunctionEvent list took 17.97 s for a
    1.5B B=1 window of 152896 kernels (NVIDIA H100 80GB HBM3, 700.00 W),
    the raw events 1.75 s: the same kernels in the same order with the same
    durations."""
    from torch.autograd import DeviceType

    events = sorted((e.correlation_id(), e.start_ns(), e.name(), e.duration_ns())
                    for e in prof.profiler.kineto_results.events()
                    if e.device_type() == DeviceType.CUDA)
    steps = []
    for _, _, name, ns in events:
        if "spin_kernel" in name:
            steps.append([])
        elif steps:
            steps[-1].append((name, ns / 1e3))
    return steps


# Device kernel names by family, the first substring that matches, beside
# the read_counts keys whose launches the family's kernels are.
KERNEL_FAMILIES = (("decode_attention_kernel", tuple(key for key, _, _ in COUNTERS)),
                   ("qmm_w8a8", ("qmm_w8a8",)), ("qmm_", ("qmm",)), ("wmm_", ("wmm",)),
                   ("sample_categorical_kernel", ("sampler",)))


def expect_replays(label: str, b) -> None:
    """A single-card batcher replays its decode graph once per plain
    decode sub-step (its speculative rounds apart) and captures it at most
    once in a window."""
    m = b.metrics
    plain = m.steps - m.spec_rounds
    log(f"{label} decode graph: {m.decode_graph_captures} captures, "
        f"{m.decode_graph_replays} replays, {plain} plain decode steps")
    if b._graph is None or m.decode_graph_replays != plain or m.decode_graph_captures > 1:
        raise AssertionError(f"{label}: {m.decode_graph_replays} graph replays and "
                             f"{m.decode_graph_captures} captures for {plain} plain decode "
                             "steps, expected one replay a step")


def replayed_kernels(label: str, batcher, att, sk, qk, torch, steps: int = 4,
                     pad: int = 2) -> dict:
    """The kernels of a batcher's replayed decode steps, counted on the
    device. Every slot gets a request that outlasts the window, admitted
    by one step; then one profiler window of ``pad`` untraced steps (a
    window loses its first kernels) and ``steps`` steps each opened by a
    marker kernel (``marked_steps``). Each marked step must replay the
    graph ``decode_chunk`` times and capture nothing; each kernel family
    must run as many times in every marked step, and as many in all as the
    wrappers' launch counts (``read_counts``) rose by over those steps;
    the attention kernel must run. The requests are then served to their
    ends. Returns the family counts of one step."""
    from torch.profiler import ProfilerActivity, profile

    m = batcher.metrics
    budget = 8 + (pad + steps + 1) * batcher.decode_chunk
    for ids, _ in batch_requests(43, batcher.batch_size, batcher.config.vocab_size, (4, 32),
                                 (budget, budget)):
        batcher.submit(ids, budget)
    batcher.step()  # admits every slot: the marked steps admit and retire nothing
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(pad):
            batcher.step()
        before = read_counts(att, sk, qk, torch)
        graph0 = (m.decode_graph_captures, m.decode_graph_replays)
        for _ in range(steps):
            torch.cuda._sleep(1000)  # the step's marker
            batcher.step()
        after = read_counts(att, sk, qk, torch)
    active = sum(r is not None for r in batcher.slots)
    replays = m.decode_graph_replays - graph0[1]
    batcher.run()
    per_step = []
    for step in marked_steps(prof):
        seen = collections.Counter()
        for name, _ in step:
            seen[next((f for f, _ in KERNEL_FAMILIES if f in name), "other")] += 1
        per_step.append(seen)
    tallied = {f: sum(after[k] - before[k] for k in keys) for f, keys in KERNEL_FAMILIES}
    one = {f: per_step[0][f] for f, _ in KERNEL_FAMILIES} if per_step else {}
    log(f"{label} replayed steps on the device: kernels per step {one}, the launch counts "
        f"rose by {tallied} over {len(per_step)} marked steps, {replays} replays, "
        f"{active} of {batcher.batch_size} slots")
    if len(per_step) != steps or active != batcher.batch_size:
        raise AssertionError(f"{label}: {len(per_step)} marked steps of {steps}, {active} of "
                             f"{batcher.batch_size} slots busy")
    if m.decode_graph_captures != graph0[0] or replays != steps * batcher.decode_chunk:
        raise AssertionError(f"{label}: {replays} replays and "
                             f"{m.decode_graph_captures - graph0[0]} captures in {steps} "
                             f"marked steps of {batcher.decode_chunk} sub-steps")
    for f, _ in KERNEL_FAMILIES:
        counts = [seen[f] for seen in per_step]
        if len(set(counts)) != 1 or sum(counts) != tallied[f]:
            raise AssertionError(f"{label}: {f} kernels per replayed step {counts} on the "
                                 f"device, the launch counts rose by {tallied[f]}")
    if not one["decode_attention_kernel"]:
        raise AssertionError(f"{label}: no attention kernel in a replayed step")
    return one


def trace_batcher(batcher, config_mod, torch, card: str, label: str = "trace-batcher",
                  weights: str = "INT4 (lm_head INT8), bf16 activations",
                  w8a8_per_step: int = 0) -> dict:
    """Phases 14, 18 and 20: 32 steps at full occupancy, T=0.8 top-k 40
    top-p 0.9, in one profiler window. The window loses the first kernels
    launched into it (on an H100, from none to more than a step's worth,
    more as the process ages), so two untraced steps pad its start and a
    marker kernel opens each traced step. The check is per step: no step
    records more than ``w8a8_per_step`` w8a8 GEMV kernels, at least one
    records exactly that many (one per call), and no qmm reduce pass
    appears. Returns the trace's row."""
    import warnings
    from collections import defaultdict

    from torch.profiler import ProfilerActivity, profile

    steps, pad = 32, 2
    batcher.sampling = config_mod.SamplingConfig(temperature=0.8, top_k=40, top_p=0.9,
                                                 seed=5)
    for ids, _ in batch_requests(41, batcher.batch_size, batcher.config.vocab_size,
                                 (8, 120), (64, 64)):
        batcher.submit(ids, 64)
    batcher.step()  # admits every slot: the traced steps admit and retire nothing
    torch.cuda.synchronize()
    wall_us = 0.0
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(pad):
            batcher.step()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            for _ in range(steps):
                torch.cuda._sleep(1000)  # the step's marker
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    t0 = time.perf_counter()
                    batcher.step()
                    wall_us += (time.perf_counter() - t0) * 1e6
                finally:
                    torch.cuda.set_sync_debug_mode(0)
    by_step = marked_steps(prof)
    kernels = [k for step in by_step for k in step]
    per_step = [(len(step), sum("qmm_w8a8" in name for name, _ in step)) for step in by_step]
    syncs = sum("called a synchronizing CUDA operation" in str(w.message) for w in caught)
    active = sum(r is not None for r in batcher.slots)
    row = {"model": "1558M", "weights": weights,
           "kv_cache": f"int8 ring, {layout_name(batcher.config)}",
           "batch": batcher.batch_size, "active_slots": active,
           "temperature": 0.8, "traced_batcher_steps": steps,
           "traced_wall_ms": wall_us / 1e3, "host_syncs_per_step": syncs / steps,
           "card": card}
    if kernels:
        n = len(by_step)
        busy = sum(us for _, us in kernels) / n  # per step, as the wall time below
        wall = wall_us / steps
        by_name = defaultdict(float)
        for name, us in kernels:
            by_name[name[:80]] += us
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
        attn = sum(us for name, us in kernels if "decode_attention_kernel" in name)
        w8a8 = [us for name, us in kernels if "qmm_w8a8" in name]
        row.update({"w8a8_kernels_per_step": len(w8a8) / n,
                    "w8a8_kernel_ms_per_step": sum(w8a8) / 1e3 / n})
        if any("reduce" in name for name, _ in kernels if "qmm" in name):
            raise AssertionError(f"{label}: a qmm reduce pass is in the trace")
        row.update({"steps_in_trace": n,
                    "kernels_by_step": sorted({k for k, _ in per_step}),
                    "w8a8_kernels_by_step": sorted({w for _, w in per_step})})
        row.update({"device_busy_ms_per_step": busy / 1e3,
                    "device_busy_share": busy / wall,
                    "device_idle_share": 1.0 - busy / wall,
                    "kernels_per_decode_step": len(kernels) / n,
                    "attention_kernel_us_per_step": attn / n,
                    "top_kernels_ms_per_step": {k: v / 1e3 / n for k, v in top}})
    else:
        row["device_busy_share"] = "not measured (no device events in the trace)"
    log(f"{label} {json.dumps(row)}")
    if any(w > w8a8_per_step for _, w in per_step) or (
            w8a8_per_step and w8a8_per_step not in {w for _, w in per_step}):
        raise AssertionError(f"{label}: w8a8 kernels per step {[w for _, w in per_step]}, "
                             f"expected {w8a8_per_step} (one per call)")
    if active != batcher.batch_size:
        raise AssertionError(f"the traced steps ran {active} of {batcher.batch_size} slots")
    if syncs != steps:
        raise AssertionError(f"{syncs} host syncs in {steps} batcher steps, expected one "
                             "per step")
    return row


def layout_ab(batcher_mod, config_mod, torch, config, params, packed_batcher, card: str):
    """Phase 18's layout A/B: 32 traced steps at full occupancy on the packed
    batcher, then on an unpacked one built alike (ZG2_KV_PACKED=0), the
    same requests and sampling."""
    kw = dict(batch_size=16, max_seq=256, decode_chunk=1, kv_quant="int8", device="cuda")
    with env_setting("ZG2_KV_PACKED", "0"):
        unpacked = batcher_mod.ContinuousBatcher(config, params, **kw)
    if unpacked.config.kv_packed or not packed_batcher.config.kv_packed:
        raise AssertionError("the layout A/B did not get one batcher of each layout")
    rows = {}
    for name, b in (("packed", packed_batcher), ("unpacked", unpacked)):
        rows[name] = trace_batcher(b, config_mod, torch, card, f"layout-ab {name}")
    keys = ("device_busy_ms_per_step", "attention_kernel_us_per_step", "device_idle_share",
            "kernels_per_decode_step", "traced_wall_ms")
    log(f"layout-ab {json.dumps({k: {n: r.get(k) for n, r in rows.items()} for k in keys})} "
        f"(1.5B INT4 + INT8 KV ring, B=16, 32 steps each, {card})")


def trace_decode(gpt2, sampling, engine, ids, torch, label: dict, card: str,
                 wmm_per_step=None) -> dict:
    """Trace 32 decode steps after a prefill, as the engine's per-token
    loop runs them (decode, sample, one host sync), in one profiler window:
    two steps pad its start (the window can lose the first kernels launched
    into it) and a marker kernel opens each traced step, as in
    ``trace_batcher``. With ``wmm_per_step`` the wmm kernels of every marked
    step are held to it: none above, and the median step exactly it (one
    kernel per call), with no reduce kernel. Returns the trace's row."""
    import statistics
    from collections import defaultdict

    from torch.profiler import ProfilerActivity, profile

    steps, pad = 32, 2
    n = len(ids)
    tokens = torch.zeros((1, 32), dtype=torch.int32, device=engine.device)
    tokens[0, :n] = torch.tensor(ids, dtype=torch.int32)
    cache, logits = gpt2.prefill(engine.params, engine.new_cache(), tokens,
                                 torch.tensor([n], dtype=torch.int32, device=engine.device),
                                 engine.config)
    generator = torch.Generator(device=engine.device).manual_seed(3)
    token = sampling.sample(logits, generator, 0.8)
    torch.cuda.synchronize()
    wall_us = 0.0
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(pad + steps):
            if i >= pad:
                torch.cuda._sleep(1000)  # the step's marker
            t0 = time.perf_counter()
            cache, logits = gpt2.decode_step(engine.params, cache, token, engine.config)
            token = sampling.sample(logits, generator, 0.8)
            int(token[0])
            if i >= pad:
                wall_us += (time.perf_counter() - t0) * 1e6
    by_step = marked_steps(prof)
    kernels = [k for step in by_step for k in step]
    wmm_by_step = [sum("wmm_" in name for name, _ in step) for step in by_step]
    row = {**label, "batch": 1, "temperature": 0.8, "traced_decode_steps": steps,
           "traced_wall_ms": wall_us / 1e3, "card": card}
    if kernels:
        m = len(by_step)
        busy = sum(us for _, us in kernels) / m
        wall = wall_us / steps
        by_name = defaultdict(float)
        for name, us in kernels:
            by_name[name[:80]] += us
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
        row.update({"steps_in_trace": m,
                    "device_busy_ms_per_step": busy / 1e3,
                    "device_busy_share": busy / wall,
                    "device_idle_share": 1.0 - busy / wall,
                    "kernels_per_decode_step": len(kernels) / m,
                    "kernels_by_step": sorted({len(step) for step in by_step}),
                    "w8a8_kernels_per_step": sum("qmm_w8a8" in k for k, _ in kernels) / m,
                    "wmm_kernels_per_step": sum(wmm_by_step) / m,
                    "wmm_kernels_by_step": sorted(set(wmm_by_step)),
                    "wmm_kernel_ms_per_step": sum(us for k, us in kernels if "wmm_" in k) / 1e3 / m,
                    "top_kernels_ms_per_step": {k: v / 1e3 / m for k, v in top}})
        if any("reduce" in name for name, _ in kernels if "qmm" in name or "wmm" in name):
            raise AssertionError("a qmm or wmm reduce pass is in the decode trace")
    else:
        row["device_busy_share"] = "not measured (no device events in the trace)"
    log(f"trace {json.dumps(row)}")
    if wmm_per_step is not None and (
            not wmm_by_step or max(wmm_by_step) > wmm_per_step
            or statistics.median(wmm_by_step) != wmm_per_step):
        raise AssertionError(f"wmm kernels per traced step {wmm_by_step}, expected "
                             f"{wmm_per_step} (one per call)")
    return row


# --- the extend path: gpt2.extend, prefix caching, speculative decoding -------

EXTEND_T = 5
QMM_PER_PASS_1P5B = 6 * 48 + 1  # the block linears and the lm_head of one 1.5B pass


def extend_and_decode(gpt2, params, config, kv_quant, device: str, torch, counted=None):
    """A prefill of two prompts (24 and 17 tokens, padded to 32), then
    ``gpt2.extend`` of a T=5 window with 5 and 3 valid rows, and 5
    sequential ``decode_step``s over the same window from a copy of the
    prefilled cache. Returns (extend logits, decode logits) at the valid
    rows, (8, vocab) f32 on the CPU, the extend's host time in ms and, with
    ``counted`` (read_counts' arguments), the extend's launch counts."""
    g = torch.Generator().manual_seed(29)
    B, T, bucket, vocab = 2, EXTEND_T, 32, config.vocab_size
    lens = torch.tensor([24, 17], dtype=torch.int32, device=device)
    valid = torch.tensor([T, 3], dtype=torch.int32, device=device)
    prompt = torch.randint(0, vocab, (B, bucket), generator=g, dtype=torch.int32).to(device)
    window = torch.randint(0, vocab, (B, T), generator=g, dtype=torch.int32).to(device)
    cache = gpt2.init_kv_cache(config, B, bucket + 2 * T, dtype=params["wte"].dtype,
                               device=device, quant=kv_quant)
    cache, _ = gpt2.prefill(params, cache, prompt, lens, config)
    seq = {name: t.clone() for name, t in cache.items()}
    if counted:
        reset_counts(*counted[:3])
    t0 = time.perf_counter()
    cache, ext = gpt2.extend(params, cache, window, valid, config)
    if device == "cuda":
        torch.cuda.synchronize()
    ext_ms = (time.perf_counter() - t0) * 1e3
    counts = read_counts(*counted) if counted else None
    rows = []
    for t in range(T):
        seq, logits = gpt2.decode_step(params, seq, window[:, t], config)
        rows.append(logits)
    if cache["length"].tolist() != (lens + valid).tolist():
        raise AssertionError(f"extend's lengths {cache['length'].tolist()}")
    dec = torch.stack(rows, 1)

    def valid_rows(x):
        return torch.cat([x[b, :int(valid[b])] for b in range(B)]).float().cpu()[:, :vocab]

    return valid_rows(ext), valid_rows(dec), ext_ms, counts


def run_extend_phase(pkg, torch, config_124m, params_124m, config_1p5b, params_1p5b,
                     card: str, check_layers: int = 12) -> dict:
    """Phase extend. 124M fp32, unpacked and packed: extend on the card
    against 5 decode steps on the card within the E2E gate (1e-3); the
    extend launches no kernel (float linears, plain attention).

    1.5B INT4 + INT8 KV, packed (the phantom head padded in), served in
    bf16: the extend launches qmm once per linear (289) and nothing else.
    Then, as phase 11 does, the same weights with f32 float leaves over the
    first ``check_layers`` layers, on the card and on the CPU (weights
    dequantized to f32; and in f64 for the floor): the card's extend within
    max(1e-3, 3 x floor) of the CPU's, and within max(1e-3, 3 x floor, 3 x
    the CPU's own extend-vs-decode gap) of the card's decode steps. (The
    INT8 extend rounds q and p * v_scale to bf16, the JAX op's arithmetic;
    the decode kernel does not, so the two differ by more than roundoff.)
    Returns the launch counts of the three extends of the served weights."""
    _, gpt2, _, att, sk, qk, weights, quantize = pkg
    counted = (att, sk, qk, torch)
    total = {}
    for packed in (False, True):
        cfg = dataclasses.replace(config_124m, kv_packed=packed)
        label = f"extend-124M fp32 {layout_name(cfg)}"
        ext, dec, ms, counts = extend_and_decode(gpt2, params_124m, cfg, None, "cuda", torch,
                                                 counted)
        compare_logits(label, ext, dec, torch,
                       what=f"extend (T={EXTEND_T}, valid 5 and 3) vs {EXTEND_T} decode steps "
                            f"on the card")
        log(f"{label}: extend {ms:.2f} ms host clock ({card})")
        expect_counts(label, counts, {})
        total = {k: total.get(k, 0) + v for k, v in counts.items()}
    params, cfg = gpt2.pad_phantom_head(params_1p5b,
                                        dataclasses.replace(config_1p5b, kv_packed=True))
    label = "extend-1.5B INT4 + INT8 KV, packed KV"
    ext, dec, ms, counts = extend_and_decode(gpt2, params, cfg, "int8", "cuda", torch, counted)
    log(f"{label}, bf16 activations, {cfg.n_layers} layers: extend {ms:.2f} ms host clock; "
        f"extend vs {EXTEND_T} decode steps max_abs_err {(ext - dec).abs().max().item():.3e} "
        f"(logged: bf16 activations round the two arithmetics apart) ({card})")
    expect_counts(label, counts, {"qmm": QMM_PER_PASS_1P5B})
    total = {k: total[k] + v for k, v in counts.items()}

    t0 = time.perf_counter()
    cfg = dataclasses.replace(cfg, n_layers=check_layers)
    f32 = weights.tree_map(lambda t: t.float() if t.is_floating_point() else t, params)
    f32 = dict(f32, blocks=weights.tree_map(lambda t: t[:check_layers], f32["blocks"]))
    ext_gpu, dec_gpu, _, _ = extend_and_decode(gpt2, f32, cfg, "int8", "cuda", torch)
    cpu_w = dequantized(quantize, weights.tree_map(lambda t: t.cpu(), f32))
    ext_cpu, dec_cpu, _, _ = extend_and_decode(gpt2, cpu_w, cfg, "int8", "cpu", torch)
    cpu_w = weights.tree_map(lambda t: t.double() if t.is_floating_point() else t, cpu_w)
    ext_f64, _, _, _ = extend_and_decode(gpt2, cpu_w, cfg, "int8", "cpu", torch)
    del cpu_w
    floor = (ext_f64 - ext_cpu).abs().max().item()
    gap = (ext_cpu - dec_cpu).abs().max().item()
    log(f"{label}, f32 activations, the first {check_layers} of 48 layers: CPU extend f64 vs "
        f"f32 (floor) {floor:.3e}; CPU extend vs CPU decode steps (the bf16-rounding gap) "
        f"{gap:.3e}; card and CPU runs {time.perf_counter() - t0:.1f} s")
    compare_logits(label, ext_gpu, ext_cpu, torch, atol=max(E2E_ATOL, 3 * floor),
                   what="extend, card vs CPU")
    compare_logits(label, ext_gpu, dec_gpu, torch, atol=max(E2E_ATOL, 3 * floor, 3 * gap),
                   what=f"extend vs {EXTEND_T} decode steps on the card")
    return total


def near_tie_pair(label: str, gpt2, engine, requests, a_served, b_served, tol: float,
                  torch) -> None:
    """Two greedy paths' tokens per request: equal up to the first
    divergence, if any, and there a near-tie: the engine's teacher-forced
    logits (at its own prompt bucket) for the two tokens within ``tol``."""
    from zig_gpt2_tpu_torch.runtime.engine import _bucket

    same = 0
    for (ids, _), a, b in zip(requests, a_served, b_served):
        n = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if n is None and len(a) == len(b):
            same += 1
            continue
        if n is None:
            raise AssertionError(f"{label}: a request ended at another length")
        logits = teacher_forced(gpt2, engine.params, engine.config, ids, a[:n], "cuda", torch,
                                kv_quant=engine.kv_quant,
                                bucket=_bucket(len(ids), engine.prompt_buckets),
                                cache_dtype=engine.cache_dtype)[-1]
        gap = abs(float(logits[a[n]] - logits[b[n]]))
        log(f"{label} near-tie check: prompt of {len(ids)}: first divergence at token {n}, "
            f"logit gap {gap:.3e} (tolerance {tol:.3e})")
        if gap > tol:
            raise AssertionError(f"{label}: the two paths part at token {n}, not at a "
                                 f"near-tie (gap {gap:.3e})")
    log(f"{label}: {same} of {len(requests)} requests identical, the others part at a "
        f"near-tie")


def bf16_floor(gpt2, weights, engine, ids, tokens, torch, label: str) -> float:
    """The served bf16 path's own roundoff at 1.5B: the engine's
    teacher-forced logits (bf16 weights and activations, its cache) against
    the same weights' with f32 float leaves, on the card (as phase 22
    measures the bf16 wmm batcher's). Two bf16 paths that part at a
    near-tie are held to max(1e-3, 3 x this, 3 x the INT8 floor)."""
    from zig_gpt2_tpu_torch.runtime.engine import _bucket

    bucket = _bucket(len(ids), engine.prompt_buckets)
    got = teacher_forced(gpt2, engine.params, engine.config, ids, tokens, "cuda", torch,
                         kv_quant=engine.kv_quant, bucket=bucket)
    f32 = weights.tree_map(lambda t: t.float() if t.is_floating_point() else t, engine.params)
    want = teacher_forced(gpt2, f32, engine.config, ids, tokens, "cuda", torch,
                          kv_quant=engine.kv_quant, bucket=bucket)
    floor = (got - want).abs().max().item()
    log(f"{label} bf16 floor: the engine's teacher-forced logits and the same weights' in f32 "
        f"differ by max_abs_err={floor:.3e} over {got.shape[0]} positions")
    return floor


def serve_prefix_1p5b(pkg, torch, encoder, config, params, floor: float, card: str):
    """Phase serve-prefix-1.5B: the INT4 + INT8 KV engine (packed, the
    card's default) with a 256-token prefix registered; three prompts of it
    plus 8, 16 and 24 tokens, 32 greedy tokens each, against the same
    engine without the prefix up to a near-tie. Every hit is one (1, 32)
    extend (289 qmm); decode as in phase 17. Returns the launch counts and
    the engine without the prefix."""
    import numpy as np

    config_mod, gpt2, engine_mod, att, sk, qk, _, _ = pkg
    label = "serve-prefix-1.5B"
    greedy = config_mod.SamplingConfig(temperature=0.0)
    rng = np.random.default_rng(61)
    prefix = rng.integers(0, config.vocab_size, 256).tolist()
    prompts = [prefix + rng.integers(0, config.vocab_size, n).tolist() for n in (8, 16, 24)]
    kw = dict(kv_quant="int8", device="cuda")
    plain = engine_mod.InferenceEngine(config, params, encoder, **kw)
    cached = engine_mod.InferenceEngine(config, params, encoder, **kw)
    t0 = time.perf_counter()
    cached.register_prefix(prefix)
    torch.cuda.synchronize()
    log(f"{label}: register_prefix of {len(prefix)} tokens {1e3 * (time.perf_counter() - t0):.1f}"
        f" ms ({layout_name(cached.config)})")
    for eng in (cached, plain):  # warm-up: the hit's and the miss's shapes
        eng.generate(prompts[0], 2, greedy)
    reset_counts(att, sk, qk)
    hits = []
    for p in prompts:
        m = engine_mod.GenerationMetrics()
        hits.append((cached.generate(p, 32, greedy, metrics=m), m))
    counts = read_counts(att, sk, qk, torch)
    steps = sum(m.generated_tokens for _, m in hits)
    key = "attention_int8_packed" if cached.config.kv_packed else "attention_int8"
    expect_counts(label, counts, {"qmm": QMM_PER_PASS_1P5B * (steps + len(prompts)),
                                  key: config.n_layers * steps})
    misses = []
    for p in prompts:
        m = engine_mod.GenerationMetrics()
        misses.append((plain.generate(p, 32, greedy, metrics=m), m))
    for p, (_, mh), (_, mm) in zip(prompts, hits, misses):
        log(f"{label} prompt of {len(p)}: prefill_ms with the hit {mh.prefill_ms:.3f}, without "
            f"{mm.prefill_ms:.3f}; prefix_tokens_reused {mh.prefix_tokens_reused}; "
            f"ms_per_token_p50 {mh.ms_per_token_percentile(50):.3f} / "
            f"{mm.ms_per_token_percentile(50):.3f} (INT4 + INT8 KV, B=1, {card})")
        if mh.prefix_tokens_reused != len(prefix) or mm.prefix_tokens_reused:
            raise AssertionError(f"{label}: the prompt of {len(p)} was not served from the prefix")
    floor_bf16 = bf16_floor(gpt2, pkg[6], plain, prompts[0], misses[0][0], torch, label)
    near_tie_check(label, gpt2, plain, [(p, 32) for p in prompts], [t for t, _ in hits],
                   max(E2E_ATOL, 3 * floor, 3 * floor_bf16), torch,
                   wants=[t for t, _ in misses])
    return counts, plain


@contextlib.contextmanager
def recording(gpt2, calls: dict):
    """gpt2.prefill and gpt2.extend record each call's (tokens, lengths or
    valid) into calls["prefill"] and calls["extend"] while the context is
    open."""
    plain_prefill, plain_extend = gpt2.prefill, gpt2.extend

    def prefill(params, cache, tokens, lengths, config):
        calls["prefill"].append((tokens, lengths))
        return plain_prefill(params, cache, tokens, lengths, config)

    def extend(params, cache, tokens, valid, config):
        calls["extend"].append((tokens, valid))
        return plain_extend(params, cache, tokens, valid, config)

    gpt2.prefill, gpt2.extend = prefill, extend
    try:
        yield calls
    finally:
        gpt2.prefill, gpt2.extend = plain_prefill, plain_extend


def window_shapes(calls) -> list:
    """The (k, T) window shape of each recorded call."""
    return [tuple(tokens.shape) for tokens, _ in calls]


def window_qmm(config, calls: dict) -> int:
    """qmm launches of the recorded admissions: a prefill's block linears
    within the row cap and its lm_head (``gemv_counts``), an extend's 289
    (its lm_head runs on every window row) within the cap, else none."""
    return (gemv_counts(config, 0, window_shapes(calls["prefill"]))["qmm"]
            + sum(QMM_PER_PASS_1P5B for k, t in window_shapes(calls["extend"]) if k * t <= 256))


def serve_batcher_prefix_1p5b(pkg, batcher_mod, torch, config, params, engine, floor: float,
                              card: str) -> dict:
    """Phase serve-batcher-prefix-1.5B: the ring batcher, B=16, INT4 + INT8
    KV, packed, with a 64-token prefix registered: 32 greedy requests, the
    even ones the prefix plus 8-32 tokens, the odd ones 8-96 fresh tokens,
    budgets 88-136 (the write pointer wraps); against the same batcher
    without the prefix, up to a near-tie. Returns the launch counts."""
    import numpy as np

    config_mod, gpt2, _, att, sk, qk, _, _ = pkg
    label = "serve-batcher-prefix-1.5B"
    greedy = config_mod.SamplingConfig(temperature=0.0)
    rng = np.random.default_rng(62)
    vocab = config.vocab_size
    prefix = rng.integers(0, vocab, 64).tolist()
    requests = []
    for i in range(32):
        ids = (prefix + rng.integers(0, vocab, int(rng.integers(8, 33))).tolist() if i % 2 == 0
               else rng.integers(0, vocab, int(rng.integers(8, 97))).tolist())
        requests.append((ids, int(rng.integers(88, 137))))
    kw = dict(batch_size=16, max_seq=240, decode_chunk=1, kv_quant="int8", sampling=greedy,
              device="cuda")
    served, counts = {}, None
    for name, prefixes in (("prefix", [prefix]), ("plain", [])):
        b = batcher_mod.ContinuousBatcher(config, params, **kw)
        serve_batch(b, [([1, 2, 3], 4), ([4, 5], 4)], f"{label} warm-up")
        for pre in prefixes:
            b.register_prefix(pre)
        b.metrics = batcher_mod.BatcherMetrics()
        reset_counts(att, sk, qk)
        with recording(gpt2, {"prefill": [], "extend": []}) as calls:
            served[name] = serve_batch(b, requests, f"{label} {name}")
        run_counts = read_counts(att, sk, qk, torch)
        steps, rows = b.metrics.steps, b.cache["k"].shape[-2]
        key = "attention_int8_packed_ring" if b.config.kv_packed else "attention_int8_ring"
        expect_counts(f"{label} {name}", run_counts,
                      {key: config.n_layers * steps,
                       "qmm": QMM_PER_PASS_1P5B * steps + window_qmm(config, calls)})
        log(f"{label} {name}: {steps} decode steps, prefills "
            f"{sorted(set(window_shapes(calls['prefill'])))}, prefix extends "
            f"{sorted(set(window_shapes(calls['extend'])))}, ring rows {rows}, wptr now "
            f"{int(b.cache['wptr'])}; metrics {json.dumps(b.metrics.as_dict(16))} (INT4 + INT8 "
            f"KV, {layout_name(b.config)}, B=16, ring, greedy, {card})")
        if steps + 2 < rows:  # the warm-up took 2 steps
            raise AssertionError(f"{label} {name}: the write pointer did not wrap")
        expect_replays(f"{label} {name}", b)
        if name == "prefix":
            counts = run_counts
            d = b.metrics.as_dict(16)
            if d.get("prefix_hits") != 16 or d.get("prefill_tokens_saved", 0) < 16 * 63:
                raise AssertionError(f"{label}: prefix hits {d.get('prefix_hits')}, expected 16")
        replayed_kernels(f"{label} {name}", b, att, sk, qk, torch)
    ids, _ = requests[0]
    floor_bf16 = bf16_floor(gpt2, pkg[6], engine, ids, served["plain"][0][:32], torch, label)
    near_tie_pair(label, gpt2, engine, requests, served["prefix"], served["plain"],
                  max(E2E_ATOL, 3 * floor, 3 * floor_bf16), torch)
    return counts


def looping_prompt(engine, vocab: int, greedy, seeds=range(8)):
    """A prompt of 3 seeded tokens repeated 5 times whose greedy stream of 24
    tokens ends in a loop of period 3 or less (as the JAX package's batcher
    test searches), with the stream; or None."""
    import numpy as np

    for seed in seeds:
        prompt = np.random.default_rng(seed).integers(0, vocab, 3).tolist() * 5
        stream = engine.generate(prompt, 24, greedy)
        if stream[-3:] == stream[-6:-3] == stream[-9:-6]:
            return prompt, stream
    return None


def trace_spec_rounds(spec, ids, torch, card: str, label: str) -> dict:
    """``torch.profiler`` over greedy speculative rounds of ``spec`` after a
    prefill: two untraced-padding rounds, then 4 rounds each opened by a
    marker kernel (``trace_batcher``'s scheme). Per marked round: the
    target's verify launches one qmm per linear (289; none above, at least
    one round exactly), the draft's k - 1 decode steps 12 x (k - 1)
    attention kernels, and no round a sampler kernel. Returns the row."""
    from torch.profiler import ProfilerActivity, profile

    from zig_gpt2_tpu_torch.config import SamplingConfig

    greedy = SamplingConfig(temperature=0.0)
    n = len(ids)
    tokens = torch.zeros((1, 32), dtype=torch.int32, device="cuda")
    tokens[0, :n] = torch.tensor(ids, dtype=torch.int32)
    state = spec._prefill_and_sample(tokens, torch.tensor([n], dtype=torch.int32, device="cuda"),
                                     greedy)
    torch.cuda.synchronize()
    pad, rounds, wall_us = 2, 4, 0.0
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(pad + rounds):
            if i >= pad:
                torch.cuda._sleep(1000)  # the round's marker
            t0 = time.perf_counter()
            _, count = spec._round(state, greedy)
            int(count[0])  # the round's host read, as generate_iter makes it
            if i >= pad:
                wall_us += (time.perf_counter() - t0) * 1e6
    by_round = marked_steps(prof)

    def per_round(key):
        return [sum(key in name for name, _ in r) for r in by_round]

    qmm = [q - w for q, w in zip(per_round("qmm_"), per_round("qmm_w8a8"))]
    attn, sampler = per_round("decode_attention_kernel"), per_round("sample_categorical_kernel")
    k = spec.k
    row = {"target": "1558M INT4 + INT8 KV, unpacked", "draft": "124M fp32", "k": k,
           "traced_rounds": rounds, "rounds_in_trace": len(by_round),
           "qmm_kernels_by_round": qmm, "attention_kernels_by_round": attn,
           "sampler_kernels_by_round": sampler, "traced_wall_ms": wall_us / 1e3, "card": card}
    if by_round:
        busy = sum(us for r in by_round for _, us in r) / len(by_round)
        row.update({"device_busy_ms_per_round": busy / 1e3,
                    "device_idle_share": 1.0 - busy / (wall_us / rounds),
                    "kernels_per_round": sum(len(r) for r in by_round) / len(by_round)})
    log(f"{label} {json.dumps(row)}")
    if (not by_round or max(qmm) > QMM_PER_PASS_1P5B or QMM_PER_PASS_1P5B not in qmm
            or max(attn) > 12 * (k - 1) or 12 * (k - 1) not in attn or any(sampler)):
        raise AssertionError(f"{label}: per round qmm {qmm}, attention {attn}, sampler "
                             f"{sampler}; expected {QMM_PER_PASS_1P5B}, {12 * (k - 1)}, 0")
    return row


def speculative_1p5b(pkg, torch, encoder, config_1p5b, params_1p5b, config_124m, params_124m,
                     floor: float, card: str):
    """Phase speculative-1.5B. Returns the launch counts of the draft-model
    run and the unpacked 1.5B engine (the target's layout)."""
    import numpy as np

    from zig_gpt2_tpu_torch.runtime.speculative import SpeculativeEngine

    config_mod, gpt2, engine_mod, att, sk, qk, weights, _ = pkg
    label, k = "speculative-1.5B", 4
    greedy = config_mod.SamplingConfig(temperature=0.0)
    # the target's layout: extend-only caches stay unpacked
    with env_setting("ZG2_KV_PACKED", "0"):
        ref = engine_mod.InferenceEngine(config_1p5b, params_1p5b, encoder, kv_quant="int8",
                                         device="cuda")
    spec = SpeculativeEngine(config_1p5b, params_1p5b, config_124m, params_124m, k=k,
                             kv_quant="int8", device="cuda")
    prompts = [encoder.encode(prompt) for _, prompt, _ in REQUESTS]
    spec.generate(prompts[0], 6, greedy)  # warm-up
    ref.generate(prompts[0], 6, greedy)
    reset_counts(att, sk, qk)
    runs, rounds = [], 0
    for ids in prompts:
        m = engine_mod.GenerationMetrics()
        runs.append((spec.generate(ids, 32, greedy, metrics=m), m))
        rounds += spec.last_rounds
    counts = read_counts(att, sk, qk, torch)
    expect_counts(label, counts, {"qmm": QMM_PER_PASS_1P5B * (rounds + len(prompts)),
                                  "attention": config_124m.n_layers * (k - 1) * rounds})
    wants = []
    for ids, (toks, m) in zip(prompts, runs):
        mr = engine_mod.GenerationMetrics()
        wants.append(ref.generate(ids, 32, greedy, metrics=mr))
        log(f"{label} prompt of {len(ids)}: {m.generated_tokens} tokens, ms per committed token "
            f"{m.ms_per_token:.3f} (speculative, draft 124M fp32, k={k}) against "
            f"{mr.ms_per_token:.3f} (the plain engine), prefill_ms {m.prefill_ms:.3f} / "
            f"{mr.prefill_ms:.3f} (INT4 + INT8 KV, unpacked, B=1, {card})")
    log(f"{label}: {rounds} rounds for {sum(m.generated_tokens - 1 for _, m in runs)} tokens "
        f"after the first")
    tol = max(E2E_ATOL, 3 * floor,
              3 * bf16_floor(gpt2, weights, ref, prompts[0], wants[0], torch, label))
    near_tie_check(label, gpt2, ref, [(ids, 32) for ids in prompts], [t for t, _ in runs], tol,
                   torch, wants=wants)
    trace_spec_rounds(spec, prompts[0], torch, card, "trace-speculative-1.5B")
    del spec

    # Self-draft at 124M: every proposal accepted up to near-ties.
    self_draft = SpeculativeEngine(config_124m, params_124m, config_124m, params_124m, k=k,
                                   device="cuda")
    n_steps = 100
    ids = prompts[0]
    out = self_draft.generate_scan(np.asarray([ids], np.int32), [len(ids)], n_steps, greedy)
    tpr = n_steps / self_draft.last_rounds
    log(f"{label} self-draft 124M fp32, k={k}: {self_draft.last_rounds} rounds for {n_steps} "
        f"tokens, {tpr:.3f} tokens per round (ceiling {k + 1}, gate {0.9 * (k + 1)})")
    if tpr < 0.9 * (k + 1) or out.shape != (1, n_steps):
        raise AssertionError(f"{label}: the self-draft committed {tpr:.3f} tokens per round")

    # Prompt lookup on a looping greedy stream: 1.5B, else 124M.
    found = looping_prompt(ref, config_1p5b.vocab_size, greedy)
    model = "1.5B INT4 + INT8 KV"
    if found is not None:
        ng = SpeculativeEngine(config_1p5b, params_1p5b, k=k, kv_quant="int8", device="cuda")
        ng_ref = ref
    else:
        log(f"{label}: no seeded 1.5B prompt loops; searching at 124M")
        ng_ref = engine_mod.InferenceEngine(config_124m, params_124m, encoder, device="cuda")
        found = looping_prompt(ng_ref, config_124m.vocab_size, greedy)
        if found is None:
            raise AssertionError(f"{label}: neither 1.5B nor 124M gives a looping greedy stream "
                                 "from the seeded prompts: the n-gram gate would be vacuous")
        ng = SpeculativeEngine(config_124m, params_124m, k=k, device="cuda")
        model = "124M fp32"
    prompt, stream = found
    toks = ng.generate(prompt, 24, greedy)
    tpr = (len(toks) - 1) / ng.last_rounds
    if ng_ref is not ref:  # 124M fp32: the float E2E gate
        tol = E2E_ATOL
    log(f"{label} n-gram on a looping {model} stream (prompt {prompt[:3]} x 5): {ng.last_rounds} "
        f"rounds for {len(toks) - 1} tokens after the first, {tpr:.3f} tokens per round")
    near_tie_check(f"{label} n-gram", gpt2, ng_ref, [(prompt, 24)], [toks], tol, torch,
                   wants=[stream])
    if tpr <= 1.0:
        raise AssertionError(f"{label}: prompt lookup accepted nothing on a looping stream")
    return counts, ref


def serve_batcher_spec_1p5b(pkg, batcher_mod, torch, config, params, engine, floor: float,
                            card: str) -> dict:
    """Phase serve-batcher-spec-1.5B: ``speculative="ngram"``, B=16,
    spec_k=3 (64 verify rows, the w8a8 cap), spec_min_tpr=0, INT4 + INT8 KV
    (linear, unpacked): 16 greedy requests, half of them a 3-token pattern
    repeated (where lookup accepts), against the plain unpacked batcher up
    to a near-tie; then the default spec_min_tpr, reporting whether the
    auto-off fired. Returns the launch counts of the first run."""
    import numpy as np

    config_mod, gpt2, _, att, sk, qk, _, _ = pkg
    label = "serve-batcher-spec-1.5B"
    greedy = config_mod.SamplingConfig(temperature=0.0)
    rng = np.random.default_rng(63)
    vocab = config.vocab_size
    requests = []
    for i in range(16):
        ids = (rng.integers(0, vocab, 3).tolist() * 6 if i % 2 == 0
               else rng.integers(0, vocab, int(rng.integers(8, 121))).tolist())
        requests.append((ids, int(rng.integers(32, 65))))
    kw = dict(batch_size=16, max_seq=256, kv_quant="int8", sampling=greedy, device="cuda")
    spec_kw = dict(speculative="ngram", spec_k=3)
    b = batcher_mod.ContinuousBatcher(config, params, spec_min_tpr=0.0, **spec_kw, **kw)
    serve_batch(b, [([1, 2, 3], 4), ([4, 5], 4)], f"{label} warm-up")
    b.metrics = batcher_mod.BatcherMetrics()
    reset_counts(att, sk, qk)
    with recording(gpt2, {"prefill": [], "extend": []}) as calls:
        served = serve_batch(b, requests, label)
    counts = read_counts(att, sk, qk, torch)
    rounds = b.metrics.spec_rounds
    if window_shapes(calls["extend"]) != [(16, 4)] * rounds:
        raise AssertionError(f"{label}: verify windows "
                             f"{sorted(set(window_shapes(calls['extend'])))}, expected {rounds} "
                             f"of (16, 4)")
    expect_counts(label, counts, {"qmm": window_qmm(config, calls)})
    log(f"{label}: tokens_per_round {b.metrics.tokens_per_round:.4f}, metrics "
        f"{json.dumps(b.metrics.as_dict(16))} (INT4 + INT8 KV, linear unpacked, B=16, spec_k=3, "
        f"greedy, {card})")
    with env_setting("ZG2_KV_PACKED", "0"):
        plain = batcher_mod.ContinuousBatcher(config, params, **kw)
    serve_batch(plain, [([1, 2, 3], 4), ([4, 5], 4)], f"{label} plain warm-up")
    plain.metrics = batcher_mod.BatcherMetrics()
    plain_served = serve_batch(plain, requests, f"{label} plain")
    log(f"{label} plain batcher metrics {json.dumps(plain.metrics.as_dict(16))} (INT4 + INT8 KV, "
        f"ring unpacked, B=16, greedy, {card})")
    ids, _ = requests[1]
    tol = max(E2E_ATOL, 3 * floor,
              3 * bf16_floor(gpt2, pkg[6], engine, ids, plain_served[1][:32], torch, label))
    near_tie_pair(label, gpt2, engine, requests, served, plain_served, tol, torch)
    auto = batcher_mod.ContinuousBatcher(config, params, **spec_kw, **kw)
    auto_served = serve_batch(auto, requests, f"{label} default spec_min_tpr")
    off = auto.metrics.spec_auto_off_step
    log(f"{label} with the default spec_min_tpr: auto-off "
        f"{'did not fire' if off is None else f'fired at step {off}'}; "
        f"metrics {json.dumps(auto.metrics.as_dict(16))} ({card})")
    expect_replays(f"{label} default spec_min_tpr", auto)
    if off is not None:
        replayed_kernels(f"{label} default spec_min_tpr", auto, att, sk, qk, torch)
    near_tie_pair(f"{label} default spec_min_tpr", gpt2, engine, requests, auto_served,
                  plain_served, tol, torch)
    return counts


# --- slice 10: .npz checkpoints, fused QKV, perplexity, training, hooks -------

def leaf_paths(tree, prefix=""):
    """{'/'-joined path: tensor} of a parameter tree."""
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        out.update(leaf_paths(v, key) if isinstance(v, dict) else {key: v})
    return out


def check_bit_equal(label: str, got, want, torch) -> int:
    """Every leaf of ``got`` equals ``want``'s in path, dtype, shape and
    bits. Returns the number of leaves."""
    got, want = leaf_paths(got), leaf_paths(want)
    if sorted(got) != sorted(want):
        raise AssertionError(f"{label}: leaf paths differ: {sorted(set(got) ^ set(want))}")
    for key, w in want.items():
        g = got[key]
        if g.dtype != w.dtype or g.shape != w.shape or not torch.equal(g, w.to(g.device)):
            raise AssertionError(f"{label}: leaf {key} differs ({g.dtype} {tuple(g.shape)} vs "
                                 f"{w.dtype} {tuple(w.shape)})")
    return len(want)


def npz_phase(pkg, torch, encoder, config, params, params_1p5b, tmp: str, card: str):
    """Phase npz: the 124M fp32 weights written as a raw checkpoint, the
    repacker (``tools.repack --mode int4``, on the host) to an INT4 .npz,
    loaded to the card bit-equal to ``quantize_params`` there; greedy tokens
    from the loaded tree and from the in-process quantized tree, 3 prompts
    x 32, identical; the 1.5B INT4 tree round-tripped through the .npz
    (its bf16 float leaves as f32: the format holds no bfloat16) bit-equal.
    Returns the launch counts of the loaded tree's requests and the raw
    checkpoint's directory."""
    from zig_gpt2_tpu_torch.tools import repack
    from zig_gpt2_tpu_torch.utils import io as zio

    config_mod, gpt2, engine_mod, att, sk, qk, weights, quantize = pkg
    raw = os.path.join(tmp, "raw-124M")
    t0 = time.perf_counter()
    zio.save_gpt2_raw(params, raw, config)
    out = os.path.join(tmp, "124M-int4.npz")
    t1 = time.perf_counter()
    repack.main(["--raw", raw, "--model", "124M", "--mode", "int4", "--out", out])
    t2 = time.perf_counter()
    loaded, meta = zio.load_pytree_npz(out, device="cuda", with_meta=True)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    want = quantize.quantize_params(params, "int4")
    n = check_bit_equal("npz 124M INT4", loaded, want, torch)
    if meta != {"model": "124M", "mode": "int4"}:
        raise AssertionError(f"npz meta {meta}")
    log(f"npz 124M: raw write {t1 - t0:.1f} s, repack (host) {t2 - t1:.1f} s, "
        f"{os.path.getsize(out) / 1e6:.1f} MB, load to the card {t3 - t2:.2f} s; {n} leaves "
        f"bit-equal to quantize_params(params, 'int4') on the card; meta {meta}")
    greedy = config_mod.SamplingConfig(temperature=0.0)
    prompts = [encoder.encode(p) for _, p, _ in REQUESTS]
    served = {}
    for name, tree in (("in-process", want), ("loaded", loaded)):
        engine = engine_mod.InferenceEngine(config, tree, encoder, device="cuda")
        engine.generate(prompts[0], 2, greedy)
        reset_counts(att, sk, qk)
        served[name] = [engine.generate(ids, 32, greedy) for ids in prompts]
        counts = read_counts(att, sk, qk, torch)
        key = "attention_packed" if engine.config.kv_packed else "attention"
        expect_counts(f"npz 124M INT4 {name} engine", counts,
                      {key: config.n_layers * 32 * len(prompts),
                       "qmm": (6 * config.n_layers + 1) * (32 + 1) * len(prompts)})
        del engine
    if served["loaded"] != served["in-process"]:
        raise AssertionError("npz: the loaded tree's greedy tokens differ from the in-process "
                             "quantized tree's")
    log(f"npz 124M INT4: greedy tokens of the loaded tree identical to the in-process tree's "
        f"(3 prompts x 32, {layout_name(dataclasses.replace(config, kv_packed=True))}, {card})")
    del loaded, want
    # 1.5B INT4: float leaves as f32 (bf16 values held exactly).
    f32 = weights.tree_map(lambda t: t.float() if t.is_floating_point() else t, params_1p5b)
    big = os.path.join(tmp, "1558M-int4.npz")
    t0 = time.perf_counter()
    zio.save_pytree_npz(f32, big, meta={"model": "1558M", "mode": "int4"})
    t1 = time.perf_counter()
    back = zio.load_pytree_npz(big, device="cuda")
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    n = check_bit_equal("npz 1.5B INT4", back, f32, torch)
    back = leaf_paths(back)
    for key, t in leaf_paths(params_1p5b).items():
        if t.dtype == torch.bfloat16 and not torch.equal(back[key].to(torch.bfloat16), t):
            raise AssertionError(f"npz 1.5B: bf16 leaf {key} does not survive the round trip")
    log(f"npz 1.5B INT4: {os.path.getsize(big) / 1e6:.1f} MB, save {t1 - t0:.1f} s, load to "
        f"the card {t2 - t1:.2f} s (host clock, {card}); {n} leaves bit-equal")
    os.remove(big)
    return counts, raw


def fused_qkv_phase(pkg, batcher_mod, sampling, torch, encoder, config_1p5b, params_1p5b,
                    config_124m, params_124m, floor: float, card: str, shapes: dict):
    """Phase fused-qkv: ``ZG2_FUSE_QKV=1``. The 1.5B INT4 + INT8 KV packed
    engine (one 1600 x 4992 projection per layer: the phantom head padded
    in first): 193 qmm launches per decode step and per prefill, against
    289 unfused; greedy tokens (3 prompts x 32) equal to the unfused
    engine's up to a near-tie within max(1e-3, 3 x the INT8 floor, 3 x the
    bf16 floor). The 124M fp32 engine with ``ZG2_WMM=1``: 48 wmm launches
    per decode step against 72, the same tokens up to a near-tie within
    1e-3. One B=16 ring batcher pass at 1.5B, fused and unfused: 193 and
    289 qmm per decode step, tokens up to a near-tie. Then 32 traced decode
    steps at 1.5B B=1, fused and unfused (reported, not gated). Returns the
    fused runs' launch counts and the traces' rows; ``shapes`` (a Counter)
    receives the counted runs' qmm and wmm launches per shape, as the
    wrappers tally them (``qmm.by_shape``, ``wmm.by_shape``)."""
    config_mod, gpt2, engine_mod, att, sk, qk, weights, _ = pkg
    greedy = config_mod.SamplingConfig(temperature=0.0)
    prompts = [encoder.encode(p) for _, p, _ in REQUESTS]
    L = config_1p5b.n_layers
    t0 = time.perf_counter()
    total = {}
    engines, served = {}, {}
    for fused in ("1", "0"):
        with env_setting("ZG2_FUSE_QKV", fused):
            engine = engine_mod.InferenceEngine(config_1p5b, params_1p5b, encoder,
                                                kv_quant="int8", device="cuda")
        attn = engine.params["blocks"]["attn"]
        if (fused == "1") != ("wqkv" in attn):
            raise AssertionError(f"fused-qkv: ZG2_FUSE_QKV={fused} gave {sorted(attn)}")
        engine.generate(prompts[0], 2, greedy)
        reset_counts(att, sk, qk)
        served[fused] = [engine.generate(ids, 32, greedy) for ids in prompts]
        counts = read_counts(att, sk, qk, torch)
        shapes.update(qk.qmm.by_shape)
        per_pass = (4 if fused == "1" else 6) * L + 1
        expect_counts(f"fused-qkv 1.5B engine ZG2_FUSE_QKV={fused}", counts,
                      {"qmm": per_pass * 33 * len(prompts),
                       "attention_int8_packed": L * 32 * len(prompts)})
        log(f"fused-qkv 1.5B engine ZG2_FUSE_QKV={fused}: {per_pass} qmm per decode step "
            f"(packed, INT4 + INT8 KV, bf16 activations, {card})")
        if fused == "1":
            n = attn["wqkv"]["qw4"].shape[-1]
            if n != 3 * engine.config.attn_heads * engine.config.head_dim or n != 4992:
                raise AssertionError(f"fused-qkv: wqkv is {n} wide, expected 4992")
            total = counts
        engines[fused] = engine
    plain = engines["0"]
    bf16 = bf16_floor(gpt2, weights, plain, prompts[0], served["0"][0][:-1], torch, "fused-qkv")
    tol = max(E2E_ATOL, 3 * floor, 3 * bf16)
    requests = [(ids, 32) for ids in prompts]
    near_tie_pair("fused-qkv 1.5B engine vs unfused", gpt2, plain, requests, served["1"],
                  served["0"], tol, torch)
    log(f"fused-qkv 1.5B engines and their near-tie check: {time.perf_counter() - t0:.1f} s")
    traces = {}
    for fused in ("1", "0"):
        ids = prompts[0]
        traces[f"ZG2_FUSE_QKV={fused}"] = trace_decode(
            gpt2, sampling, engines[fused], ids, torch,
            {"model": "1558M", "weights": f"INT4 (lm_head INT8), fused QKV {fused}",
             "kv_cache": "int8, packed"}, card)
    keys = ("device_busy_ms_per_step", "kernels_per_decode_step", "device_idle_share",
            "traced_wall_ms")
    rows = {k: {n: r.get(k) for n, r in traces.items()} for k in keys}
    log(f"trace-fused-qkv {json.dumps(rows)} (1.5B INT4 + INT8 KV packed, B=1, 32 steps each, "
        f"{card})")
    del engines["1"]
    log(f"fused-qkv traces: {time.perf_counter() - t0:.1f} s")

    # 124M fp32 with wmm: 48 launches per step fused, 72 unfused.
    with env_setting("ZG2_WMM", "1"):  # read at every decode step
        tokens = {}
        for fused in ("1", "0"):
            with env_setting("ZG2_FUSE_QKV", fused):
                engine = engine_mod.InferenceEngine(config_124m, params_124m, encoder,
                                                    device="cuda")
            engine.generate(prompts[0], 2, greedy)
            reset_counts(att, sk, qk)
            tokens[fused] = [engine.generate(ids, 32, greedy) for ids in prompts]
            counts = read_counts(att, sk, qk, torch)
            shapes.update(qk.wmm.by_shape)
            per_step = (4 if fused == "1" else 6) * engine.config.n_layers
            expect_counts(f"fused-qkv 124M ZG2_WMM=1 ZG2_FUSE_QKV={fused}", counts,
                          {"wmm": per_step * 32 * len(prompts),
                           "attention_packed": engine.config.n_layers * 32 * len(prompts)})
            log(f"fused-qkv 124M fp32 ZG2_WMM=1 ZG2_FUSE_QKV={fused}: {per_step} wmm per decode "
                f"step ({card})")
            if fused == "1":
                total = {k: total[k] + counts[k] for k in total}
            else:
                near_tie_pair("fused-qkv 124M wmm vs unfused", gpt2, engine, requests,
                              tokens["1"], tokens["0"], E2E_ATOL, torch)
            del engine
    log(f"fused-qkv 124M wmm engines: {time.perf_counter() - t0:.1f} s")
    # One B=16 ring batcher pass at 1.5B, fused and unfused.
    kw = dict(batch_size=16, max_seq=256, kv_quant="int8", sampling=greedy, device="cuda")
    reqs = batch_requests(71, 16, config_1p5b.vocab_size, (8, 60), (16, 32))
    out = {}
    for fused in ("1", "0"):
        with env_setting("ZG2_FUSE_QKV", fused):
            b = batcher_mod.ContinuousBatcher(config_1p5b, params_1p5b, **kw)
        serve_batch(b, [([1, 2, 3], 4), ([4, 5], 4)], "fused-qkv batcher warm-up")
        b.metrics = batcher_mod.BatcherMetrics()
        with recording(gpt2, {"prefill": [], "extend": []}) as calls:
            reset_counts(att, sk, qk)
            out[fused] = serve_batch(b, reqs, f"fused-qkv batcher ZG2_FUSE_QKV={fused}")
            counts = read_counts(att, sk, qk, torch)
            shapes.update(qk.qmm.by_shape)
        steps = b.metrics.steps
        per_pass = (4 if fused == "1" else 6) * L
        prefill = sum(per_pass * (k * t <= 256) + 1 for k, t in window_shapes(calls["prefill"]))
        expect_counts(f"fused-qkv 1.5B batcher ZG2_FUSE_QKV={fused}", counts,
                      {"qmm": (per_pass + 1) * steps + prefill,
                       "attention_int8_packed_ring": L * steps})
        log(f"fused-qkv 1.5B batcher ZG2_FUSE_QKV={fused}: {steps} steps, {per_pass + 1} qmm "
            f"per decode step, metrics {json.dumps(b.metrics.as_dict(16))} (B=16, ring, "
            f"packed, INT4 + INT8 KV, {card})")
        expect_replays(f"fused-qkv 1.5B batcher ZG2_FUSE_QKV={fused}", b)
        replayed_kernels(f"fused-qkv 1.5B batcher ZG2_FUSE_QKV={fused}", b, att, sk, qk,
                         torch)
        if fused == "1":
            total = {k: total[k] + counts[k] for k in total}
        del b
    near_tie_pair("fused-qkv 1.5B batcher vs unfused", gpt2, plain, reqs, out["1"], out["0"],
                  tol, torch)
    return total, traces


def cache_dtype_phase(pkg, torch, encoder, config, params, card: str) -> dict:
    """Phase cache-dtype: ``InferenceEngine(cache_dtype=torch.bfloat16)`` on
    the 124M fp32 weights (the JAX engine's option: a bf16 KV cache under
    f32 activations), in the layout the card picks (packed). The float
    decode-attention kernel reads f32 q and the current row over bf16 rows:
    one launch per layer and decode step (3 prompts x 32 greedy tokens).
    The greedy prompt's teacher-forced logits over a bf16 cache, card
    against CPU, within max(1e-3, 3 x the CPU's f64-vs-f32 floor); every
    prompt's greedy tokens equal to the CPU engine's (the same cache dtype
    and layout) up to a near-tie within the same tolerance. Returns the launch counts and the launches with
    f32 q over a bf16 cache, as the wrapper tallied them."""
    config_mod, gpt2, engine_mod, att, sk, qk, weights, _ = pkg
    from zig_gpt2_tpu_torch.runtime.engine import _bucket

    bf16 = torch.bfloat16
    greedy = config_mod.SamplingConfig(temperature=0.0)
    prompts = [encoder.encode(p) for _, p, _ in REQUESTS]
    engine = engine_mod.InferenceEngine(config, params, encoder, device="cuda",
                                        cache_dtype=bf16)
    if engine.new_cache()["k"].dtype != bf16:
        raise AssertionError(f"cache-dtype: the engine's cache is {engine.new_cache()['k'].dtype}")
    engine.generate(prompts[0], 2, greedy)
    reset_counts(att, sk, qk)
    served = [engine.generate(ids, 32, greedy) for ids in prompts]
    counts = read_counts(att, sk, qk, torch)
    key = "attention_packed" if engine.config.kv_packed else "attention"
    expect_counts("cache-dtype 124M fp32, bf16 KV cache", counts,
                  {key: config.n_layers * 32 * len(prompts)})
    variant = "packed_launches" if engine.config.kv_packed else "launches"
    mixed = att.decode_attention_deferred.by_dtype[(variant, "float32", "bfloat16")]
    if mixed != counts[key]:
        raise AssertionError(f"cache-dtype: {mixed} of {counts[key]} launches read f32 q over "
                             f"the bf16 cache")
    with env_setting("ZG2_KV_PACKED", "1" if engine.config.kv_packed else "0"):
        cpu = engine_mod.InferenceEngine(config, weights.tree_map(lambda t: t.cpu(), params),
                                         encoder, device="cpu", cache_dtype=bf16)
    if cpu.config.kv_packed != engine.config.kv_packed:
        raise AssertionError("cache-dtype: the CPU engine took another layout")
    ids, tokens = prompts[0], served[0][:-1]
    bucket = _bucket(len(ids), engine.prompt_buckets)
    f64 = weights.tree_map(lambda t: t.double() if t.is_floating_point() else t, cpu.params)
    got, want, exact = (teacher_forced(gpt2, p, cpu.config, ids, tokens, dev, torch,
                                       bucket=bucket, cache_dtype=bf16)
                        for p, dev in ((engine.params, "cuda"), (cpu.params, "cpu"),
                                       (f64, "cpu")))
    # A K or V element within roundoff of a bf16 rounding boundary may land
    # one bf16 step apart on two devices: the CPU's own f64-vs-f32 gap is
    # the floor, as for the INT8 cache.
    floor = (exact - want).abs().max().item()
    log(f"cache-dtype 124M floor: the CPU run in f64 and in f32, both over a bf16 cache, differ "
        f"by max_abs_err={floor:.3e} over {want.shape[0]} positions")
    tol = max(E2E_ATOL, 3 * floor)
    compare_logits("cache-dtype 124M fp32, bf16 KV cache", got, want, torch, atol=tol)
    near_tie_pair("cache-dtype 124M fp32, bf16 KV cache, card vs CPU", gpt2, engine,
                  [(ids, 32) for ids in prompts], served,
                  [cpu.generate(ids, 32, greedy) for ids in prompts], tol, torch)
    log(f"cache-dtype 124M: bf16 KV cache under f32 activations served on the card "
        f"({layout_name(engine.config)}, {card})")
    return counts, mixed


PPL_MODES = ("int8", "w8a8", "int4")
# Card vs CPU perplexity over PPL_CPU_IDS ids, relative, from the readings
# (the same in every run: fp32 0, INT8 and INT4 1.197e-07, w8a8 6.582e-06;
# NVIDIA H100 80GB HBM3, 700.00 W): about 8 x the weight-only modes' gap,
# 3 x w8a8's (its rows are quantized, so a roundoff-sized difference
# flips int8 values). Each lies below its mode's distance from fp32
# (INT8 4.6e-4, w8a8 3.2e-4, INT4 1.1e-5), which the phase checks.
PPL_RTOL = {"fp32": 1e-6, "int8": 1e-6, "int4": 1e-6, "w8a8": 2e-5}
PPL_CPU_IDS = 2048


def ppl_phase(pkg, torch, raw: str, tmp: str, card: str) -> dict:
    """Phase ppl: GPT-2 124M at full width (the raw checkpoint of phase npz,
    its 50257-id vocab), a synthetic corpus of 8192 ids from a seed, TF32
    off.
    ``tools.ppl_gate`` on the card against the raw directory and a .npy
    corpus, modes int8, w8a8 and int4, at window 256 and batch 1 (each
    INT8/INT4 window through qmm: 73 launches per window; w8a8's 256 rows
    take ``w8a8_matmul``) and at window 1024 and batch 8 (8192 rows:
    dequantize-then-matmul, no GEMV launch). Each mode's perplexity at
    window 256 over the first PPL_CPU_IDS ids on the card is held to the
    same computation on the CPU within its mode's PPL_RTOL, and each
    quantized mode's limit must lie below its distance from fp32 on the
    card, so that a path in the wrong precision would fail it. (With wte
    times 3 the perplexity moves away from V, but w8a8's card-vs-CPU gap
    grows to 4.3e-4 against a distance of 9.8e-4 from fp32: no limit
    separates the two; PERF.md.) The gate's budgets are
    printed, not gated: on random weights a budget of 0.1 or 0.5 says
    nothing about quantization. Returns the launch counts of the window-256
    run."""
    import io

    import numpy as np

    from zig_gpt2_tpu_torch.eval.perplexity import perplexity
    from zig_gpt2_tpu_torch.tools import ppl_gate
    from zig_gpt2_tpu_torch.utils import io as zio

    config_mod, gpt2, _, att, sk, qk, weights, quantize = pkg
    config = config_mod.get_config("124M")
    ids = np.random.default_rng(10).integers(0, config.vocab_size, 8192).astype(np.int32)
    corpus = os.path.join(tmp, "corpus.npy")
    np.save(corpus, ids)
    result = None
    for window, batch in ((256, 1), (1024, 8)):
        reset_counts(att, sk, qk)
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = ppl_gate.main(["--model", "124M", "--weights", raw, "--corpus", corpus,
                                "--modes", ",".join(PPL_MODES), "--window", str(window),
                                "--batch", str(batch), "--device", "cuda"])
        secs = time.perf_counter() - t0
        counts = read_counts(att, sk, qk, torch)
        out = buf.getvalue().strip().splitlines()
        for line in out[:-1]:
            log(f"ppl window={window} batch={batch} | {line}")
        verdict = json.loads(out[-1])
        log(f"ppl window={window} batch={batch}: {json.dumps(verdict)} (exit code {rc}, budgets "
            f"not gated; {secs:.1f} s, 124M, 8192 ids, {card})")
        if [r["mode"] for r in verdict["rows"]] != ["fp32", *PPL_MODES]:
            raise AssertionError(f"ppl: rows {verdict['rows']}")
        if not all(np.isfinite(r["ppl"]) and r["ppl"] > 1 for r in verdict["rows"]):
            raise AssertionError("ppl: a perplexity is not finite")
        windows = -(-ids.size // window)
        want = {"qmm": 2 * (6 * config.n_layers + 1) * windows} if window * batch <= 256 else {}
        expect_counts(f"ppl window={window} batch={batch}", counts, want)
        if window == 256:
            result = counts
    # The card against the CPU, each mode, window 256 and batch 1 (the GEMV
    # path) over the corpus's first PPL_CPU_IDS ids (the H100 machine's host
    # CPU takes ~7 s per mode for 2048 ids at 124M, so ~1 minute for the
    # whole corpus); the CPU's weight-only modes as their f32 dequantized
    # weights (the plain version's products, dequantized once, not per window).
    card_w = zio.load_gpt2_raw(raw, config, device="cuda")
    cpu = zio.load_gpt2_raw(raw, config, device="cpu")
    part = ids[:PPL_CPU_IDS]
    t0 = time.perf_counter()
    card_ppl = {}
    for mode in ("fp32", *PPL_MODES):
        trees, cfg = [card_w, cpu], config
        if mode != "fp32":
            trees = [quantize.quantize_params(t, "int8" if mode == "w8a8" else mode)
                     for t in trees]
            cfg = dataclasses.replace(config, act_quant=mode == "w8a8")
        if mode in ("int8", "int4"):
            trees[1] = dequantized(quantize, trees[1])
        got, want = (perplexity(t, cfg, part, window=256, batch_size=1) for t in trees)
        card_ppl[mode] = got
        rel = abs(got - want) / want
        tol = PPL_RTOL[mode]
        dist = abs(got - card_ppl["fp32"]) / card_ppl["fp32"]
        log(f"ppl {mode} window=256 over the first {part.size} ids: card {got:.6f}, CPU "
            f"{want:.6f}, relative gap {rel:.3e} (tolerance {tol:.0e})"
            + ("" if mode == "fp32" else f"; distance from fp32 on the card {dist:.3e}"))
        if not rel <= tol:
            raise AssertionError(f"ppl {mode}: the card's perplexity is not the CPU's")
        if mode != "fp32" and not tol < dist:
            raise AssertionError(f"ppl {mode}: the tolerance {tol:.3e} does not tell the mode "
                                 f"from fp32 ({dist:.3e})")
    log(f"ppl card vs CPU: {time.perf_counter() - t0:.1f} s")
    return result


TRAIN_LR = 3e-5


def train_phase(pkg, torch, encoder, card: str) -> None:
    """Phase train: GPT-2 124M fp32 at full width and depth, random weights
    from a seed, TF32 off. Five AdamW steps on one fixed batch (B=8,
    T=1024: the demo text encoded by the in-process BPE, repeated, each row
    from another offset) with and without ``remat``: the loss falls at
    every step, the two runs' losses agree within 1e-5 relative, and the
    peak memory with recompute is below the peak without it. Then one step
    at B=2, T=128 on the card against the CPU: the loss within 1e-5
    relative, each leaf's gradient within 1e-3 of the CPU's in L2 norm, or
    within 3 x the CPU's own f32-vs-f64 gap. The gated runs take TRAIN_LR;
    five steps at optax's default 3e-4 (no warmup) are run first and
    reported: there the loss falls, then overshoots, and the JAX package's
    train_step overshoots alike (tests/adamw_overshoot_witness.py: JAX and
    the port on the CPU at 124M width and 6 layers, the same curve)."""
    from zig_gpt2_tpu_torch import train

    config_mod, gpt2, _, att, sk, qk, weights, _ = pkg
    config = config_mod.get_config("124M")
    g = torch.Generator(device="cuda").manual_seed(11)
    base = gpt2.init_params(config, g, torch.float32)
    tokens = train_tokens(encoder, torch, "cuda", 8, 1024)
    params = weights.tree_map(lambda t: t.clone(), base)
    opt = train.make_optimizer(params)
    step = train.make_train_step(config)
    losses = [step(params, opt, tokens)[2].item() for _ in range(5)]
    log(f"train at optax's default lr 3e-4, no warmup (reported, not gated): losses {losses}")
    del params, opt
    runs = {}
    for remat in (False, True):
        params = weights.tree_map(lambda t: t.clone(), base)
        opt = train.make_optimizer(params, learning_rate=TRAIN_LR)
        step = train.make_train_step(config, remat=remat)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        losses = []
        for _ in range(5):
            params, opt, loss = step(params, opt, tokens)
            losses.append(loss.item())
        secs = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        runs[remat] = (losses, peak)
        log(f"train remat={remat}: losses {losses}, peak memory {peak / 2**30:.3f} GiB, "
            f"{5 * 8 * 1024 / secs:.1f} tokens/s over 5 steps ({secs:.2f} s; 124M fp32, B=8, "
            f"T=1024, AdamW lr {TRAIN_LR}, {card})")
        if not all(a > b for a, b in zip(losses, losses[1:])):
            raise AssertionError(f"train remat={remat}: the loss does not fall at every step")
        del params, opt
    for a, b in zip(runs[False][0], runs[True][0]):
        if abs(a - b) > 1e-5 * abs(a):
            raise AssertionError(f"train: remat losses {runs[True][0]} differ from "
                                 f"{runs[False][0]}")
    if not runs[True][1] < runs[False][1]:
        raise AssertionError("train: the peak memory with remat is not below the peak without")
    torch.cuda.empty_cache()
    small = tokens[:2, :129]
    out = []
    for device, dtype in (("cuda", torch.float32), ("cpu", torch.float32),
                          ("cpu", torch.float64)):
        params = weights.tree_map(lambda t: t.detach().clone().to(device, dtype), base)
        train.make_optimizer(params)
        loss = train.loss_fn(params, small.to(device), config)
        loss.backward()
        out.append((loss.item(), {k: t.grad.cpu().double()
                                  for k, t in leaf_paths(params).items()}))
    (loss_card, g_card), (loss_cpu, g_cpu), (_, g64) = out
    rel = abs(loss_card - loss_cpu) / loss_cpu
    # Per leaf, in L2: the card's gap to the CPU within 1e-3 of the CPU
    # gradient's norm, or within 3 x the CPU's own f32-vs-f64 gap (leaves
    # whose true gradient is zero, as the K bias's under softmax, hold only
    # roundoff).
    ratios = {}
    for k, g in g_cpu.items():
        tol = max(1e-3 * g.norm().item(), 3 * (g64[k] - g).norm().item())
        ratios[k] = (g_card[k] - g).norm().item() / tol
    worst = max(ratios, key=ratios.get)
    log(f"train one step B=2 T=128, card vs CPU: loss {loss_card:.6f} vs {loss_cpu:.6f} "
        f"(relative {rel:.3e}, tolerance 1e-5); gradients per leaf (L2): the largest gap over "
        f"its tolerance max(1e-3 x the gradient, 3 x the CPU f32-vs-f64 gap) is "
        f"{ratios[worst]:.3e}, at {worst}")
    if rel > 1e-5 or ratios[worst] > 1:
        raise AssertionError("train: the card's step is not the CPU's")


PORT_KERNELS = ("decode_attention_kernel", "qmm_simt_kernel", "qmm_mma_kernel",
                "qmm_w8a8_kernel", "wmm_simt_kernel", "wmm_mma_kernel",
                "sample_categorical_kernel")


def profile_debug_phase(pkg, torch, config, params, tmp: str, card: str) -> dict:
    """Phase profile-debug: ``cli.main(--demo --model 124M --profile DIR)``
    on the card writes a torch.profiler trace that names the port's own
    kernels; ``nan_checks`` stays silent over the 124M forward on clean
    weights and raises, naming the op, on a NaN planted in wte;
    ``checked_decode_step`` raises on a cache at max_seq. Returns the CLI
    run's launch counts."""
    from zig_gpt2_tpu_torch import cli
    from zig_gpt2_tpu_torch.utils import debug

    config_mod, gpt2, _, att, sk, qk, weights, _ = pkg
    trace_dir = os.path.join(tmp, "profile")
    reset_counts(att, sk, qk)
    cli.main(["--demo", "--model", "124M", "--dtype", "fp32", "--device", "cuda", "--temp",
              "0.8", "--max-tokens", "8", "--profile", trace_dir, "the quick brown fox"])
    counts = read_counts(att, sk, qk, torch)
    path = os.path.join(trace_dir, "trace.json")
    events = json.load(open(path))["traceEvents"]
    kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
    ours = sorted({k for k in PORT_KERNELS if any(k in name for name in kernels)})
    log(f"profile-debug: cli --profile wrote {path} ({os.path.getsize(path) / 1e6:.1f} MB, "
        f"{len(kernels)} kernel events); the port's kernels named in it: {ours}; launches "
        f"{counts}")
    if not ours:
        raise AssertionError("profile-debug: the trace names none of the port's kernels")
    toks = torch.tensor([[5, 17, 3, 99, 42, 7]], device="cuda")
    with torch.no_grad(), debug.nan_checks():
        gpt2.forward(params, toks, config)
    bad = dict(params, wte=params["wte"].clone())
    bad["wte"][17, 3] = float("nan")
    try:
        with torch.no_grad(), debug.nan_checks():
            gpt2.forward(bad, toks, config)
    except FloatingPointError as e:
        log(f"profile-debug: nan_checks on a NaN planted in wte: {e}")
        if "aten." not in str(e):
            raise AssertionError("profile-debug: nan_checks did not name the op") from e
    else:
        raise AssertionError("profile-debug: nan_checks missed a planted NaN")
    del bad
    step = debug.checked_decode_step(config)
    cache = gpt2.init_kv_cache(config, 1, 64, device="cuda")
    cache, _ = step(params, cache, torch.tensor([5], device="cuda"))  # length 0: fine
    cache["length"].fill_(64)
    try:
        step(params, cache, torch.tensor([5], device="cuda"))
    except ValueError as e:
        log(f"profile-debug: checked_decode_step on a cache at max_seq: {e}")
    else:
        raise AssertionError("profile-debug: checked_decode_step missed a full cache")
    return counts


def time_fused_qkv(qk, quantize, gpt2, config_1p5b, params_1p5b, params_w8, params_124m, torch,
                   shapes: dict, card: str):
    """The fused QKV projections' rows of the kernels line: qmm INT4 and
    the w8a8 body at 1600 x 4992 (the packed 1.5B trees, phantom head
    padded in), rows 1 and 16, bf16 activations, and wmm at 768 x 2304 (the
    124M tree), one row, f32 and bf16; each call on another layer's weight
    (from device memory), against its bound (bytes), its plain version and
    torch.matmul on the weight dequantized ahead of time (bf16; for wmm the
    weight itself). ``launches``: the fused-qkv phase's launches of that
    kernel at that shape, as its wrapper tallied them (``shapes``)."""
    g = torch.Generator(device="cuda").manual_seed(31)
    padded, _ = gpt2.pad_phantom_head(params_1p5b, config_1p5b)
    int4 = gpt2.fuse_qkv_params(padded)["blocks"]["attn"]["wqkv"]
    w8 = gpt2.fuse_qkv_params(params_w8)["blocks"]["attn"]["wqkv"]
    del padded
    entries = []
    for name, p, key, w8a8, peak in (("qmm", int4, "qw4", False, PEAK_BF16_OPS_PER_S),
                                     ("qmm_w8a8", w8, "qw", True, PEAK_INT8_OPS_PER_S)):
        qws, scales = p[key], p["scale"]
        L, k = qws.shape[0], qws.shape[1] * (2 if key == "qw4" else 1)
        n = qws.shape[-1]
        dq = [quantize.dequantize_linear({key: qws[i], "scale": scales[i]},
                                         torch.bfloat16)["w"] for i in range(L)]
        kw = dict(int4=key == "qw4", w8a8=w8a8)
        for rows in (1, 16):
            x = torch.randn(rows, k, device="cuda", generator=g).to(torch.bfloat16)
            err = max_err(qk.qmm(x, qws[0], scales[0], **kw), qk.qmm_plain(x, qws[0], scales[0],
                                                                           **kw))
            ms = time_ms(lambda i: qk.qmm(x, qws[i % L], scales[i % L], **kw), 4 * L)
            plain_ms = time_ms(lambda i: qk.qmm_plain(x, qws[i % L], scales[i % L], **kw), L)
            lib_ms = time_ms(lambda i: torch.matmul(x, dq[i % L]), 4 * L)
            nbytes, nops = qmm_work(qws[0], scales[0], key == "qw4", rows, 2)
            bms, by = bound_ms(nbytes, nops, PEAK_OPS_PER_S if rows == 1 and not w8a8 else peak)
            label = f"{name} fused QKV {'INT4' if key == 'qw4' else 'w8a8'} {k}x{n} rows={rows}"
            log(f"time {label} bf16: kernel {ms * 1e3:.2f} us, bound {bms * 1e3:.2f} us ({by}), "
                f"plain {plain_ms * 1e3:.2f} us, torch.matmul on a pre-dequantized bf16 weight "
                f"{lib_ms * 1e3:.2f} us, max_abs_err={err:.3e} ({card})")
            entries.append({"name": label, "route": "cuda",
                            "source": "zig_gpt2_tpu_torch/ops/csrc/qmm.cu",
                            "replaces": ("zig_gpt2_tpu/quant/kernels.py:77" if w8a8 else
                                         "zig_gpt2_tpu/quant/kernels.py:256"),
                            "launches": shapes[("w8a8" if w8a8 else "int4", k, n, rows)],
                            "max_abs_err": err,
                            "ms": ms, "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
                            "library_ms": lib_ms})
        del dq
    fused = gpt2.fuse_qkv_params(params_124m)["blocks"]["attn"]["wqkv"]["w"]
    for dtype in (torch.float32, torch.bfloat16):
        ws = [w.to(dtype) for w in fused]
        L, (k, n) = len(ws), ws[0].shape
        size = 4 if dtype == torch.float32 else 2
        x = torch.randn(1, k, device="cuda", generator=g).to(dtype)
        err = max_err(qk.wmm(x, ws[0]), qk.wmm_plain(x, ws[0]))
        t = {key: time_ms(lambda i: fn(x, ws[i % L]), 8 * L) for key, fn in
             (("ms", qk.wmm), ("plain_ms", qk.wmm_plain), ("library_ms", torch.matmul))}
        bms, by = bound_ms(k * n * size + k * size + n * 4, 2 * k * n,
                           PEAK_OPS_PER_S if dtype == torch.float32 else PEAK_BF16_OPS_PER_S)
        label = f"wmm fused QKV {k}x{n} rows=1 {str(dtype).replace('torch.', '')}"
        log(f"time {label}: kernel {t['ms'] * 1e3:.2f} us, bound {bms * 1e3:.2f} us ({by}), plain "
            f"{t['plain_ms'] * 1e3:.2f} us, torch.matmul {t['library_ms'] * 1e3:.2f} us, "
            f"max_abs_err={err:.3e} ({card})")
        entries.append({"name": label, "route": "cuda",
                        "source": "zig_gpt2_tpu_torch/ops/csrc/wmm.cu",
                        "replaces": "zig_gpt2_tpu/quant/kernels.py:162",
                        "launches": shapes[(str(dtype).removeprefix("torch."), k, n, 1)],
                        "max_abs_err": err, **t, "bound_ms": bms, "bound_by": by})
    return entries


def time_sampler(sk, torch, counts, card: str):
    """The sampler at B=1 (the engines) and B=16 (the sampled batchers) over
    the 50257-id vocab, f32 logits, plain temperature. The JSON entry is
    B=1's."""
    V, T = 50257, 0.8
    g = torch.Generator(device="cuda").manual_seed(4)
    entries = {}
    for B in (1, 16):
        logits = torch.randn(B, V, device="cuda", generator=g)
        seeds = torch.randint(0, 2**31 - 1, (B,), device="cuda", dtype=torch.int32,
                              generator=g)
        err = float((sk.sample_categorical(logits, seeds, T).long()
                     - sk.sample_categorical_plain(logits, seeds, T).long()).abs().max().item())
        ms = time_ms(lambda i: sk.sample_categorical(logits, seeds, T), 400)
        plain_ms = time_ms(lambda i: sk.sample_categorical_plain(logits, seeds, T), 40,
                           graph=False)  # it copies 1/T from the host
        u = torch.rand(B, V, device="cuda", generator=g)
        lib_ms = time_ms(lambda i: torch.argmax(logits / T - torch.log(-torch.log(u)), -1), 400)
        bms, by = bound_ms(V * 4 * B + 8 * B, SAMPLER_OPS_PER_ELEM * V * B)
        log(f"time sampler f32 B={B} V={V} ({sk.sampler_geometry(B, V)[0]} splits): kernel "
            f"{ms * 1e3:.2f} us, bound {bms * 1e3:.2f} us ({by}), plain {plain_ms * 1e3:.2f} us, "
            f"argmax-gumbel {lib_ms * 1e3:.2f} us, max_abs_err={err} ({card})")
        entries[B] = {"name": "sample_categorical", "route": "cuda",
                      "source": "zig_gpt2_tpu_torch/ops/csrc/sampling.cu",
                      "replaces": "zig_gpt2_tpu/ops/sampling_kernel.py:37",
                      "launches": counts["sampler"], "max_abs_err": err, "ms": ms,
                      "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
                      "library_ms": lib_ms}
    return [entries[1]]


def time_attention(name, replaces, launches, kernel, plain, args, L, lib, nbytes, nops,
                   what, card, **kw):
    """One attention kernel's entry: device time per call by CUDA-graph
    replay rotating over the L layers, its plain version's, the library
    call's (``lib(layer)``), the bound and the error against the plain
    version at layer 0. ``args`` end with the lengths."""
    err = max_err(kernel(*args, layer=0, **kw), plain(*args, layer=0, **kw))
    ms = time_ms(lambda i: kernel(*args, layer=i % L, **kw), 10 * L)
    plain_ms = time_ms(lambda i: plain(*args, layer=i % L, **kw), L)
    lib_ms = time_ms(lambda i: lib(i % L), 10 * L)
    bms, by = bound_ms(nbytes, nops)
    log(f"time {name} {what}: kernel {ms * 1e3:.2f} us, bound {bms * 1e3:.2f} us ({by}), "
        f"plain {plain_ms * 1e3:.2f} us, library {lib_ms * 1e3:.2f} us, "
        f"max_abs_err={err:.3e} ({card})")
    return {"name": name, "route": "cuda",
            "source": "zig_gpt2_tpu_torch/ops/csrc/decode_attention.cu",
            "replaces": f"zig_gpt2_tpu/ops/attention.py{replaces}", "launches": launches,
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bms,
            "bound_by": by, "library_ms": lib_ms}


def attention_work(args, n: int, S: int, L: int, quant: bool):
    """(bytes, operations) of one attention call: the n rows read of one
    layer of each cache and scale plane, every other input once and the
    output (like q) once; a multiply and an add per K and per V element
    read, and two multiplies per scale read."""
    nbytes = args[0].numel() * args[0].element_size()  # the output
    elems = planes = 0
    for a in args:
        size = a.numel() * a.element_size()
        if a.dim() >= 4:  # a stacked cache or plane: one layer, n of S rows
            read = a.numel() // L // S * n
            size = read * a.element_size()
            if a.dim() == 5:
                elems += read
            else:
                planes += read
        nbytes += size
    return nbytes, 2 * elems + (2 * planes if quant else 0)


# Attention kernels timed at the main paths' shapes: (JSON name, or None to
# log only; TPU kernel line; INT8 cache; q dtype; B; ring; deferred; packed;
# model shapes: float caches at 124M unless "1.5B", INT8 caches at 1.5B;
# a float cache's dtype when it is not q's).
ATTENTION_TIMES = (
    ("decode_attention_deferred", ":913", False, "float32", 1, False, True, False),
    (None, ":913", False, "bfloat16", 1, False, True, False),
    ("decode_attention_quant_deferred", ":928", True, "bfloat16", 1, False, True, False),
    (None, ":928", True, "float32", 1, False, True, False),
    ("decode_attention_deferred_ring", ":913", False, "float32", 16, True, True, False),
    ("decode_attention_quant_deferred_ring", ":928", True, "bfloat16", 16, True, True, False),
    ("decode_attention_deferred_packed", ":913", False, "float32", 1, False, True, True),
    ("decode_attention_quant_deferred_packed", ":928", True, "bfloat16", 1, False, True, True),
    ("decode_attention_deferred_packed_ring", ":913", False, "float32", 16, True, True, True),
    ("decode_attention_quant_deferred_packed_ring", ":928", True, "bfloat16", 16, True, True,
     True),
    ("decode_attention", ":875", False, "float32", 1, False, False, False),
    ("decode_attention_packed", ":875", False, "float32", 1, False, False, True),
    ("decode_attention_quant", ":898", True, "bfloat16", 1, False, False, False),
    ("decode_attention_quant_packed", ":898", True, "bfloat16", 1, False, False, True),
    # the w8a8 engine's bf16 cache: float, packed, 1.5B shapes (Hp=13)
    ("decode_attention_deferred_packed_bf16_1p5b", ":913", False, "bfloat16", 1, False, True,
     True, "1.5B"),
    # the cache-dtype engine: f32 q over a bf16 cache, packed, 124M shapes
    ("decode_attention_deferred_packed_bf16_cache", ":913", False, "float32", 1, False, True,
     True, "124M", "bfloat16"))


def time_attention_kernels(att, ops, torch, counts, card: str, launches: dict):
    """Every attention kernel of ``ATTENTION_TIMES``, rotating over the
    layers so that the caches come from HBM: float at 124M shapes (12
    heads, Hp=6) and the w8a8 engine's packed bf16 cache at 1.5B shapes,
    INT8 at 1.5B shapes (25 heads, Hp=13 with the phantom head); B=1 over
    1023 old rows (1024 rows for the appended form), and the ring at B=16,
    R=1025, 1023 old rows per lane, starts spread over the ring (most
    intervals wrap). The library yardstick is SDPA over the
    unpacked view of the same rows (copied ahead of time; for INT8
    dequantized ahead of time to q's dtype, 2 or 4 times the bytes), with a
    boolean mask over all R rows for the ring (the interval plus the next
    row, standing for the current one); a float cache in another dtype than
    q's is converted to q's ahead of time. ``launches``: an entry's count
    by name, where the variant's counter in ``counts`` also holds other
    dtypes' launches."""
    import torch.nn.functional as F

    entries = []
    for name, replaces, quant, dtype, B, ring, deferred, packed, *model in ATTENTION_TIMES:
        L, H = (48, 25) if quant or model[:1] == ["1.5B"] else (12, 12)
        dtype = getattr(torch, dtype)
        cache_dtype = getattr(torch, model[1]) if len(model) > 1 else dtype
        rows, W = ((H + 1) // 2, 128) if packed else (H, 64)
        S = RING_ROWS if ring else 1024
        n = 1023 if deferred else 1024  # old rows, or every row of the appended form
        g = torch.Generator(device="cuda").manual_seed(17)
        if quant:
            args = int8_attention_inputs(ops, torch, g, L, B, rows, S, W, dtype)
            kd = (args[5].float() * args[6][..., None]).to(dtype)
            vd = (args[7].float() * args[8][..., None]).to(dtype)
        else:
            args = [torch.randn(B, rows, W, device="cuda", generator=g).to(dtype)
                    for _ in range(3)]
            args += [torch.randn(L, B, rows, S, W, device="cuda", generator=g).to(cache_dtype)
                     for _ in range(2)]
            kd, vd = args[3].to(dtype), args[4].to(dtype)
        q4 = args[0]
        if packed:
            kd, vd, q4 = att.unpack_heads_seq(kd), att.unpack_heads_seq(vd), \
                att.unpack_heads_rows(q4)
        q4 = q4[:, :, None, :]
        if not deferred:
            args = appended_args(args, quant)
        kw = {"packed": packed}
        if ring:
            start, length = ring_lanes(B, S, (n,), torch)
            kw["start"] = start
            mask = ops.decode_valid_mask(S, length + 1, start)[:, :, None, :]

            def lib(layer):
                return F.scaled_dot_product_attention(q4, kd[layer], vd[layer], attn_mask=mask)
        else:
            length = torch.full((B,), n, dtype=torch.int32, device="cuda")
            rows_lib = n + (1 if deferred else 0)  # the current row stands in as one more
            kd, vd = kd[..., :rows_lib, :], vd[..., :rows_lib, :]

            def lib(layer):
                return F.scaled_dot_product_attention(q4, kd[layer], vd[layer])
        key = (("attention" if deferred else "appended") + ("_int8" if quant else "")
               + ("_packed" if packed else "") + ("_ring" if ring else ""))
        base = ("decode_attention" + ("_quant" if quant else "")
                + ("_deferred" if deferred else ""))
        nbytes, nops = attention_work([*args, length] + ([kw["start"]] if ring else []), n, S,
                                      L, quant)
        what = (f"{'INT8, ' if quant else ''}{dtype}"
                f"{f' over a {cache_dtype} cache' if cache_dtype != dtype else ''}, B={B}, "
                f"{'Hp=' + str(rows) if packed else 'H=' + str(H)}, {'R' if ring else 'S'}={S}, "
                f"{n} {'old ' if deferred else ''}rows{', ring' if ring else ''}; library: SDPA "
                f"over the unpacked rows{', dequantized ahead of time' if quant else ''}"
                f"{f', converted to {dtype} ahead of time' if cache_dtype != dtype else ''}")
        entry = time_attention(name or base, replaces, launches.get(name, counts[key]),
                               getattr(att, base),
                               getattr(att, base + "_plain"), [*args, length], L, lib, nbytes,
                               nops, what, card, **kw)
        if name:
            entries.append(entry)
        del args, kd, vd
    return entries


def qmm_work(qw, scale, int4: bool, rows: int, x_bytes: int):
    """(bytes, operations) of one qmm call: the weight, its scales, x and
    the f32 output once each; 2 operations per weight per row (multiply,
    add) and, for grouped scales, 1 more per weight (the dequant multiply)."""
    kp, n = qw.shape
    k = kp * (2 if int4 else 1)
    nbytes = qw.numel() + scale.numel() * 4 + rows * k * x_bytes + rows * n * 4
    nops = 2 * rows * k * n + (k * n if scale.shape[0] > 1 else 0)
    return nbytes, nops


def time_qmm(qk, quantize, params, torch, counts, card: str):
    """qmm at B=1 (rows 1), at the batcher's 16 rows and at the extend
    path's 5 (the smoke test's T=5 window at B=1) and 64 (B=16 verify
    windows of 4), bf16 activations as served, per linear shape, rotating
    over the 48 layers so that the weights come from HBM (the lm_head alone
    is 80 MB). The yardstick is torch.matmul on the same weights dequantized
    ahead of time to bf16: it reads 4x the INT4 bytes. The JSON entry is the B=1 step."""
    g = torch.Generator(device="cuda").manual_seed(8)
    L = params["blocks"]["attn"]["wq"]["scale"].shape[0]
    shapes = [("attn.wq/wk/wv/c_proj", [linears(params, i)[0][1:] for i in range(L)]),
              ("mlp.c_fc", [linears(params, i)[4][1:] for i in range(L)]),
              ("mlp.c_proj", [linears(params, i)[5][1:] for i in range(L)]),
              ("lm_head", [linears(params, None)[0][1:]])]
    steps = {rows: {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bytes": 0.0, "ops": 0.0}
             for rows in (1, 5, 16, 64)}
    errs = []
    for label, layers in shapes:
        qw, scale, int4 = layers[0]
        k = qw.shape[0] * (2 if int4 else 1)
        dq = [quantize.dequantize_linear({"qw4" if i4 else "qw": w, "scale": s},
                                         torch.bfloat16)["w"] for w, s, i4 in layers]
        nl = len(layers)
        calls = 4 * L if label.startswith("attn") else (L if label.startswith("mlp") else 1)
        for rows, step in steps.items():
            x = torch.randn(rows, k, device="cuda", generator=g).to(torch.bfloat16)
            errs.append(max_err(qk.qmm(x, qw, scale, int4=int4),
                                qk.qmm_plain(x, qw, scale, int4=int4)))
            ms = time_ms(lambda i: qk.qmm(x, *layers[i % nl][:2], int4=int4), max(8 * nl, 64))
            plain_ms = time_ms(lambda i: qk.qmm_plain(x, *layers[i % nl][:2], int4=int4),
                               max(2 * nl, 8))
            lib_ms = time_ms(lambda i: torch.matmul(x, dq[i % nl]), max(8 * nl, 64))
            nbytes, nops = qmm_work(qw, scale, int4, rows, x.element_size())
            bms, by = bound_ms(nbytes, nops, PEAK_OPS_PER_S if rows == 1 else PEAK_BF16_OPS_PER_S)
            geo = qk.qmm_geometry(rows, k, qw.shape[1], int4, x.dtype)
            log(f"time qmm {label} K={k} N={qw.shape[1]} {'int4' if int4 else 'int8'} "
                f"groups={scale.shape[0]} rows={rows} bf16 ({geo}): kernel "
                f"{ms * 1e3:.2f} us, bound {bms * 1e3:.2f} us ({by}), plain "
                f"{plain_ms * 1e3:.2f} us, torch.matmul on a pre-dequantized bf16 weight "
                f"{lib_ms * 1e3:.2f} us, max_abs_err={errs[-1]:.3e} ({card})")
            step["ms"] += calls * ms
            step["plain_ms"] += calls * plain_ms
            step["library_ms"] += calls * lib_ms
            step["bytes"] += calls * nbytes
            step["ops"] += calls * nops
        del dq
    for rows, step in steps.items():
        bms, by = bound_ms(step["bytes"], step["ops"],
                           PEAK_OPS_PER_S if rows == 1 else PEAK_BF16_OPS_PER_S)
        step["bound_ms"], step["bound_by"] = bms, by
        what = "decode step" if rows in (1, 16) else "extend window"
        log(f"time qmm per {what} (289 calls, rows={rows}, bf16): kernel "
            f"{step['ms']:.4f} ms, bound {bms:.4f} ms ({by}), plain {step['plain_ms']:.4f} ms, "
            f"torch.matmul on pre-dequantized bf16 weights {step['library_ms']:.4f} ms "
            f"({card})")
    step = steps[1]
    return [{"name": "qmm", "route": "cuda", "source": "zig_gpt2_tpu_torch/ops/csrc/qmm.cu",
             "replaces": "zig_gpt2_tpu/quant/kernels.py:256", "launches": counts["qmm"],
             "max_abs_err": max(errs), "ms": step["ms"], "plain_ms": step["plain_ms"],
             "bound_ms": step["bound_ms"], "bound_by": step["bound_by"],
             "library_ms": step["library_ms"]}]


def time_w8a8(qk, quantize, params, torch, counts, card: str):
    """The w8a8 body at rows 1, 16 and 64 (a B=16 verify window of 4, the
    body's cap), bf16 activations as served, per
    linear shape of the phantom-padded 1.5B tree and per 289-call decode
    step, rotating over the 48 layers so that the weights come from HBM.
    The yardstick is torch.matmul on the same weights dequantized ahead of
    time to bf16 (twice the int8 bytes); ``torch._int_mm``, which needs more
    than 16 rows, is timed at 32 rows and logged only. The JSON entry is
    the B=1 step."""
    g = torch.Generator(device="cuda").manual_seed(23)
    L = params["blocks"]["attn"]["wq"]["scale"].shape[0]
    shapes = [("attn.wq/wk/wv", [linears(params, i)[0][1:3] for i in range(L)], 3 * L),
              ("attn.c_proj", [linears(params, i)[3][1:3] for i in range(L)], L),
              ("mlp.c_fc", [linears(params, i)[4][1:3] for i in range(L)], L),
              ("mlp.c_proj", [linears(params, i)[5][1:3] for i in range(L)], L),
              ("lm_head", [linears(params, None)[0][1:3]], 1)]
    steps = {rows: {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bytes": 0.0, "ops": 0.0}
             for rows in (1, 16, 64)}
    errs = []
    for label, layers, calls in shapes:
        qw, scale = layers[0]
        k, n = qw.shape
        nl = len(layers)
        dq = [quantize.dequantize_linear({"qw": w, "scale": s}, torch.bfloat16)["w"]
              for w, s in layers]
        for rows, step in steps.items():
            x = torch.randn(rows, k, device="cuda", generator=g).to(torch.bfloat16)
            errs.append(max_err(qk.qmm(x, qw, scale, w8a8=True),
                                qk.qmm_plain(x, qw, scale, w8a8=True)))
            ms = time_ms(lambda i: qk.qmm(x, *layers[i % nl], w8a8=True), max(8 * nl, 64))
            plain_ms = time_ms(lambda i: qk.qmm_plain(x, *layers[i % nl], w8a8=True),
                               max(2 * nl, 8))
            lib_ms = time_ms(lambda i: torch.matmul(x, dq[i % nl]), max(8 * nl, 64))
            nbytes = qw.numel() + scale.numel() * 4 + rows * k * 2 + rows * n * 4
            nops = 2 * rows * k * n
            bms, by = bound_ms(nbytes, nops, PEAK_INT8_OPS_PER_S)
            log(f"time qmm w8a8 {label} K={k} N={n} rows={rows} bf16 "
                f"({qk.w8a8_geometry(rows, k, n)}): kernel {ms * 1e3:.2f} us, "
                f"bound {bms * 1e3:.2f} us ({by}), plain {plain_ms * 1e3:.2f} us, torch.matmul "
                f"on a pre-dequantized bf16 weight {lib_ms * 1e3:.2f} us, "
                f"max_abs_err={errs[-1]:.3e} ({card})")
            step["ms"] += calls * ms
            step["plain_ms"] += calls * plain_ms
            step["library_ms"] += calls * lib_ms
            step["bytes"] += calls * nbytes
            step["ops"] += calls * nops
        x32 = torch.randint(-127, 128, (32, k), device="cuda", generator=g, dtype=torch.int8)
        if quantize._int_mm_takes(x32, qw):
            int_ms = time_ms(lambda i: torch._int_mm(x32, layers[i % nl][0]), max(8 * nl, 64))
            log(f"time torch._int_mm {label} K={k} N={n} rows=32 (int8 x int8 -> int32, "
                f"library yardstick only): {int_ms * 1e3:.2f} us ({card})")
        del dq
    for rows, step in steps.items():
        bms, by = bound_ms(step["bytes"], step["ops"], PEAK_INT8_OPS_PER_S)
        step["bound_ms"], step["bound_by"] = bms, by
        what = "decode step" if rows < 64 else "extend window"
        log(f"time qmm w8a8 per {what} (289 calls, rows={rows}, bf16): kernel "
            f"{step['ms']:.4f} ms, bound {bms:.4f} ms ({by}), plain {step['plain_ms']:.4f} ms, "
            f"torch.matmul on pre-dequantized bf16 weights {step['library_ms']:.4f} ms ({card})")
    step = steps[1]
    return [{"name": "qmm_w8a8", "route": "cuda",
             "source": "zig_gpt2_tpu_torch/ops/csrc/qmm.cu",
             "replaces": "zig_gpt2_tpu/quant/kernels.py:77", "launches": counts["qmm_w8a8"],
             "max_abs_err": max(errs), "ms": step["ms"], "plain_ms": step["plain_ms"],
             "bound_ms": step["bound_ms"], "bound_by": step["bound_by"],
             "library_ms": step["library_ms"]}]


def time_wmm(qk, params, torch, counts, card: str):
    """wmm at rows 1, 2 (the draft's catch-up window) and 8, f32 and bf16
    (weights and x alike, as served), per 124M linear shape, each call on
    another layer's weight of that shape (48 for 768x768, 12 for c_fc and
    for MLP c_proj: 113 MB per shape in f32, 57 MB in bf16), and per decode
    step: the 72 calls in served order
    (wq, wk, wv, attn c_proj, c_fc, MLP c_proj per layer; 340 MB in f32),
    timed as one sequence. The weights come from device memory, not from
    the 50 MB L2. The yardstick is torch.matmul on the same inputs (cuBLAS;
    f32 without TF32). The JSON entry is the f32 B=1 step's."""
    g = torch.Generator(device="cuda").manual_seed(24)
    blocks = params["blocks"]
    L = blocks["attn"]["wq"]["w"].shape[0]
    attn = [blocks["attn"][name]["w"][layer] for layer in range(L)
            for name in ("wq", "wk", "wv", "c_proj")]
    shapes = {"attn.wq/wk/wv/c_proj": attn,
              "mlp.c_fc": [blocks["mlp"]["c_fc"]["w"][layer] for layer in range(L)],
              "mlp.c_proj": [blocks["mlp"]["c_proj"]["w"][layer] for layer in range(L)]}
    fns = {"ms": qk.wmm, "plain_ms": qk.wmm_plain, "library_ms": torch.matmul}
    steps = {}
    errs = []
    for dtype in (torch.float32, torch.bfloat16):
        peak = PEAK_OPS_PER_S if dtype == torch.float32 else PEAK_BF16_OPS_PER_S
        ws = {label: [w.to(dtype) for w in stack] for label, stack in shapes.items()}
        size = 4 if dtype == torch.float32 else 2
        for rows in (1, 2, 8):
            xs = {k: torch.randn(rows, k, device="cuda", generator=g).to(dtype)
                  for k in (768, 3072)}
            for label, stack in ws.items():
                k, n = stack[0].shape
                x = xs[k]
                errs.append(max_err(qk.wmm(x, stack[0]), qk.wmm_plain(x, stack[0])))
                t = {key: time_ms(lambda i: fn(x, stack[i % len(stack)]), max(2 * len(stack), 96))
                     for key, fn in fns.items()}
                bms, by = bound_ms(k * n * size + rows * k * size + rows * n * 4,
                                   2 * rows * k * n, peak)
                log(f"time wmm {label} K={k} N={n} rows={rows} {dtype} "
                    f"({qk.wmm_geometry(rows, k, n, dtype, dtype)}): kernel "
                    f"{t['ms'] * 1e3:.2f} us, bound {bms * 1e3:.2f} us ({by}), plain "
                    f"{t['plain_ms'] * 1e3:.2f} us, torch.matmul {t['library_ms'] * 1e3:.2f} us, "
                    f"max_abs_err={errs[-1]:.3e} ({card})")
            seq = []  # one decode step's calls in served order
            for layer in range(L):
                seq += [(xs[768], w) for w in ws["attn.wq/wk/wv/c_proj"][4 * layer:4 * layer + 4]]
                seq += [(xs[768], ws["mlp.c_fc"][layer]), (xs[3072], ws["mlp.c_proj"][layer])]
            step = {key: time_ms(lambda i: fn(*seq[i % len(seq)]), 4 * len(seq)) * len(seq)
                    for key, fn in fns.items()}
            nbytes = sum(w.numel() * size + x.numel() * size + rows * w.shape[1] * 4
                         for x, w in seq)
            step["bound_ms"], step["bound_by"] = bound_ms(
                nbytes, sum(2 * x.numel() * w.shape[1] for x, w in seq), peak)
            steps[(dtype, rows)] = step
            log(f"time wmm per decode step ({len(seq)} calls in served order, rows={rows}, "
                f"{dtype}): kernel {step['ms']:.4f} ms, bound {step['bound_ms']:.4f} ms "
                f"({step['bound_by']}), plain {step['plain_ms']:.4f} ms, torch.matmul "
                f"{step['library_ms']:.4f} ms ({card})")
        del ws
    step = steps[(torch.float32, 1)]
    return [{"name": "wmm", "route": "cuda", "source": "zig_gpt2_tpu_torch/ops/csrc/wmm.cu",
             "replaces": "zig_gpt2_tpu/quant/kernels.py:162", "launches": counts["wmm"],
             "max_abs_err": max(errs), "ms": step["ms"], "plain_ms": step["plain_ms"],
             "bound_ms": step["bound_ms"], "bound_by": step["bound_by"],
             "library_ms": step["library_ms"]}]


# --- native-bpe and serve-tp ------------------------------------------------

NATIVE_CORPUS = (DEMO_TEXT + "numbers 12345, punctuation?!... unicode: héllo wörld — naïve "
                 "café 日本語 🎉 contractions: don't we'll i'm ")


def native_bpe_phase(tok, vocab, merges) -> None:
    """The port's loader builds ``libzg2bpe`` from the repository's
    ``native/bpe.cpp`` on this host; the native core's ids and bytes equal
    the Python core's on a fixed corpus; the serving encoder's core is the
    native one (no quiet fallback here)."""
    from zig_gpt2_tpu_torch import native

    t0 = time.perf_counter()
    lib = native.load_bpe()
    if lib is None:
        raise AssertionError(f"native BPE library unavailable: {native.load_error()}")
    log(f"native-bpe: {native.library_path().name} loaded in {time.perf_counter() - t0:.2f} s "
        f"(compiler {native.toolchain()})")
    nat, py = tok.Encoder(vocab, merges), tok.Encoder(vocab, merges, native=False)
    if not nat.native_active or py.native_active:
        raise AssertionError("the serving encoder does not run the native core")
    for text in (NATIVE_CORPUS, DEMO_TEXT[::-1], " ", ""):
        ids = nat.encode(text)
        if ids != py.encode(text) or nat.decode_bytes(ids) != py.decode_bytes(ids):
            raise AssertionError(f"native ids differ from the Python core's on {text[:30]!r}")
    t0 = time.perf_counter()
    for _ in range(20):
        nat._native_ids.clear()
        nat.encode(NATIVE_CORPUS)
    t_nat = (time.perf_counter() - t0) / 20
    t0 = time.perf_counter()
    for _ in range(20):
        py._bpe_cache.clear()
        py.encode(NATIVE_CORPUS)
    t_py = (time.perf_counter() - t0) / 20
    log(f"native-bpe: ids identical to the Python core on {len(NATIVE_CORPUS)} chars "
        f"({len(py.encode(NATIVE_CORPUS))} ids); encode with cold caches {t_nat * 1e3:.3f} ms "
        f"native, {t_py * 1e3:.3f} ms Python (host CPU)")


TP = 2
TP_DEVICE = "cuda:0"
# The serve-tp engine's requests: (name, prompt, sampling, new tokens).
TP_REQUESTS = (("greedy", "the quick brown fox", dict(temperature=0.0), 32),
               ("greedy", "hello world, streaming", dict(temperature=0.0), 32),
               ("T=0.8 top-k 40", "the lazy dog", dict(temperature=0.8, top_k=40, seed=2), 16))
TP_BATCH = 4
# The short packed run: GPT-2 124M fp32 (12 heads, 6 per rank: even, so
# the head-pair-packed layout, Hp=3 per rank), random weights drawn on the
# CPU from this seed by the parent and by each rank alike.
TP_124M_SEED, TP_124M_PROMPT, TP_124M_TOKENS = 3, "the quick brown fox", 16
# qmm rows checked per rank: decode, the B=4 batcher, the speculative
# verify window (B x (k + 1)) and the sequence-parallel prefill's 256.
TP_SPEC_K = 4
TP_QMM_ROWS = (1, 4, TP_BATCH * (TP_SPEC_K + 1), 256)
# The mesh paths beyond plain decode: sequence-parallel prefill of one
# prompt, a 64-id prefix on the engine and the batcher, prompt-lookup
# speculation at B=4, and three AdamW steps of the 124M float tree.
TP_SP_PROMPT = 256
TP_PREFIX, TP_PREFIX_TOKENS = 64, 8
TP_SPEC_REQUESTS, TP_SPEC_TOKENS = 8, 32
# Speculation's auto-off: the first TP_BATCH speculative prompts at a budget
# past the 16 rounds of 5 tokens that fill the switch's window (8 syncs of
# 2 rounds over 4 live slots), so that plain decode follows.
TP_AUTO_OFF_TOKENS = 88
TP_TRAIN_B, TP_TRAIN_T, TP_TRAIN_STEPS = 4, 256, 3


def build_tp_124m(config_mod, gpt2, vocab_size: int, torch):
    config = dataclasses.replace(config_mod.get_config("124M"), vocab_size=vocab_size,
                                 padded_vocab_size=50257)
    return config, gpt2.init_params(config, torch.Generator().manual_seed(TP_124M_SEED),
                                    torch.float32)


def build_tp_tree(config_mod, gpt2, quantize, encoder, torch, tp: int = TP):
    """GPT-2 1.5B at full width and depth, bf16 weights from phase 11's seed,
    padded for tp (25 heads to 26, vocab rows 50257 to 50304) and quantized
    for it: INT4 block linears with the c_proj groups aligned for tp, the
    INT8 lm_head."""
    from zig_gpt2_tpu_torch.parallel.sharding import pad_for_tp

    config = dataclasses.replace(config_mod.get_config("1558M"), vocab_size=len(encoder.vocab),
                                 padded_vocab_size=50257)
    params = gpt2.init_params(config, torch.Generator(device="cuda").manual_seed(0),
                              torch.bfloat16)
    params, config = pad_for_tp(params, config, tp)
    params = quantize.quantize_params(params, mode="int4", tp=tp)
    torch.cuda.synchronize()
    return config, params


def tp_collective_counts(config, passes: int, draws: int, thresholded: int) -> dict:
    """A rank's model-group collectives for ``passes`` forwards (each: the
    embedding's all-reduce, one per row-parallel linear, and the INT4
    all-gather of x per row-parallel linear) and ``draws`` draws (two
    all-gathers each, one more per thresholded draw)."""
    L = config.n_layers
    return {"all_reduce": passes * (1 + 2 * L),
            "all_gather": passes * 2 * L + 2 * draws + thresholded}


def tp_check_kernels(rank: int, engine, att, sk, qk, quantize, torch, card: str) -> list:
    """This rank's kernels against their plain versions at its per-shard
    shapes, a few calls each: qmm on its layer-0 and last-layer linears
    (rows 1 and 4, the speculative verify window's B x (k + 1) = 20 and
    the sequence-parallel prefill's 256; the INT4 c_proj fed its two
    half-split feature ranges), the INT8 decode attention over its heads
    (B=1 and B=4 linear: the engine after a prefix hit and the speculative
    batcher after auto-off; the ring at B=4), the float packed attention of
    the 124M run (Hp=3), the sampler with return_max over its vocab slice.
    Returns the qmm shapes (label, qw, scale, int4, calls per step) for the
    timings."""
    from zig_gpt2_tpu_torch.ops import layers as ops
    from zig_gpt2_tpu_torch.parallel.shard_kernels import int4_row_shard_slices

    g = torch.Generator(device="cuda").manual_seed(100 + rank)
    p = engine.params
    blocks = p["blocks"]
    L = engine.config.n_layers
    shapes = []
    for name, calls in (("attn.wq", 3), ("attn.c_proj", 1), ("mlp.c_fc", 1), ("mlp.c_proj", 1)):
        mod, lin = name.split(".")
        leaf = blocks[mod][lin]
        int4 = "qw4" in leaf
        qw = leaf["qw4"] if int4 else leaf["qw"]
        shapes.append((name, [(qw[i], leaf["scale"][i]) for i in range(L)], int4, calls * L))
    shapes.append(("lm_head", [(p["lm_head"]["qw"], p["lm_head"]["scale"])], False, 1))
    worst = 0.0
    for name, layers, int4, _ in shapes:
        for qw, scale in (layers[0], layers[-1]):
            k = qw.shape[0] * (2 if int4 else 1)
            for rows in TP_QMM_ROWS:
                x = (torch.randn(rows, k, device="cuda", generator=g)).to(torch.bfloat16)
                sc = scale
                if int4 and name.endswith("c_proj"):  # the rank's two feature ranges
                    full = torch.randn(rows, TP * k, device="cuda", generator=g).to(torch.bfloat16)
                    x, sc = int4_row_shard_slices(full, scale, TP, engine.mesh.model_index)
                worst = max(worst, check_close(
                    f"serve-tp rank {rank} qmm {name} K={k} N={qw.shape[1]} rows={rows}",
                    qk.qmm(x, qw, sc, int4=int4), qk.qmm_plain(x, qw, sc, int4=int4),
                    *QMM_TOL, torch))
    log(f"serve-tp rank {rank}: qmm at {[(n, l[0][0].shape[0] * (2 if i4 else 1), l[0][0].shape[1]) for n, l, i4, _ in shapes]} "
        f"(K, N per shard) rows {TP_QMM_ROWS}, layers 0 and {L - 1}: max_abs_err={worst:.3e} "
        f"vs plain")
    H = engine.config.attn_heads
    S = engine.new_cache()["k"].shape[-2]
    for B, ring in ((1, False), (TP_BATCH, False), (TP_BATCH, True)):
        R = 257 if ring else S
        args = int8_attention_inputs(ops, torch, g, L, B, H, R, 64, torch.bfloat16)
        kw = {}
        if ring:
            start, length = ring_lanes(B, R, (0, 1, 17, 255), torch)
            kw["start"] = start
        else:
            length = torch.full((B,), 17, dtype=torch.int32, device="cuda")
        for layer in (0, L - 1):
            err = check_close(f"serve-tp rank {rank} attention-int8 B={B}",
                              att.decode_attention_quant_deferred(*args, length, layer=layer, **kw),
                              att.decode_attention_quant_deferred_plain(*args, length,
                                                                        layer=layer, **kw),
                              *ATTN_TOL["bfloat16"], torch)
        log(f"serve-tp rank {rank}: INT8 decode attention{' ring' if ring else ''} H={H} B={B} "
            f"{'R' if ring else 'S'}={R}: max_abs_err={err:.3e} vs plain")
    from zig_gpt2_tpu_torch.ops import layers as ops_layers

    args, _ = packed_inputs(ops_layers, torch, g, 12, 1, 3, 1024, torch.float32, False)
    length = torch.tensor([1023], dtype=torch.int32, device="cuda")
    for layer in (0, 11):
        err = check_close(f"serve-tp rank {rank} attention packed float Hp=3",
                          att.decode_attention_deferred(*args, length, layer=layer, packed=True),
                          att.decode_attention_deferred_plain(*args, length, layer=layer,
                                                              packed=True),
                          *ATTN_TOL["float32"], torch)
    log(f"serve-tp rank {rank}: float packed decode attention (124M rank shape) Hp=3 B=1 S=1024: "
        f"max_abs_err={err:.3e} vs plain")
    V = p["lm_head"]["qw"].shape[1]
    for B in (1, TP_BATCH):
        logits = (torch.randn(B, V, device="cuda", generator=g) * 3).float()
        seeds = torch.randint(0, 2**31 - 1, (B,), device="cuda", dtype=torch.int32, generator=g)
        got, z = sk.sample_categorical(logits, seeds, 0.8, return_max=True)
        want, want_z = sk.sample_categorical_plain(logits, seeds, 0.8, return_max=True)
        gap = ((z - want_z).abs() / want_z.abs().clamp(min=1e-30)).max().item()
        if not torch.equal(got, want) or gap > SAMPLER_ZMAX_RTOL:
            raise AssertionError(f"serve-tp rank {rank}: sampler return_max at V={V} B={B} "
                                 f"differs from its plain version (z* gap {gap:.3e})")
        log(f"serve-tp rank {rank}: sampler return_max V={V} B={B}: ids identical, z* gap "
            f"{gap:.3e} (bound {SAMPLER_ZMAX_RTOL:.3e})")
    return shapes


def tp_time_qmm_step(shapes, rows: int, qk, quantize, torch, g, label: str, card: str):
    """qmm per rank-step at ``rows`` bf16 rows (289 calls, each on another
    layer's weight; rank 0's INT4 c_proj scales cut to its two feature
    ranges): kernel, plain, torch.matmul on the weights dequantized ahead of
    time, and the bound. Returns the step's entry (launches set later)."""
    step = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bytes": 0.0, "ops": 0.0}
    errs = []
    for name, layers, int4, calls in shapes:
        qw, scale = layers[0]
        k = qw.shape[0] * (2 if int4 else 1)
        if int4 and scale.shape[0] != 1 and name.endswith("c_proj"):
            layers = [(w, torch.cat([s[:s.shape[0] // (2 * TP)],
                                     s[s.shape[0] // 2:s.shape[0] // 2 + s.shape[0] // (2 * TP)]]))
                      for w, s in layers]  # rank 0's two feature ranges of the scales
            scale = layers[0][1]
        x = torch.randn(rows, k, device="cuda", generator=g).to(torch.bfloat16)
        dq = [quantize.dequantize_linear({"qw4" if int4 else "qw": w, "scale": s},
                                         torch.bfloat16)["w"] for w, s in layers]
        nl = len(layers)
        errs.append(max_err(qk.qmm(x, qw, scale, int4=int4), qk.qmm_plain(x, qw, scale,
                                                                          int4=int4)))
        ms = time_ms(lambda i: qk.qmm(x, *layers[i % nl], int4=int4), max(4 * nl, 64))
        plain_ms = time_ms(lambda i: qk.qmm_plain(x, *layers[i % nl], int4=int4), max(nl, 8))
        lib_ms = time_ms(lambda i: torch.matmul(x, dq[i % nl]), max(4 * nl, 64))
        nbytes, nops = qmm_work(qw, scale, int4, rows, 2)
        bms, by = bound_ms(nbytes, nops, PEAK_OPS_PER_S if rows == 1 else PEAK_BF16_OPS_PER_S)
        log(f"time serve-tp qmm {name} per shard K={k} N={qw.shape[1]} "
            f"{'int4' if int4 else 'int8'} groups={scale.shape[0]} rows={rows} bf16: kernel "
            f"{ms * 1e3:.2f} us, bound {bms * 1e3:.2f} us ({by}), plain {plain_ms * 1e3:.2f} us, "
            f"torch.matmul on a pre-dequantized bf16 weight {lib_ms * 1e3:.2f} us ({card})")
        for key, val in (("ms", ms), ("plain_ms", plain_ms), ("library_ms", lib_ms),
                         ("bytes", nbytes), ("ops", nops)):
            step[key] += calls * val
        del dq
    bms, by = bound_ms(step["bytes"], step["ops"],
                       PEAK_OPS_PER_S if rows == 1 else PEAK_BF16_OPS_PER_S)
    log(f"time serve-tp qmm per rank-step (289 calls, rows={rows}, bf16, tp={TP}): kernel "
        f"{step['ms']:.4f} ms, bound {bms:.4f} ms ({by}), plain {step['plain_ms']:.4f} ms, "
        f"torch.matmul {step['library_ms']:.4f} ms ({card})")
    return {"name": label, "route": "cuda", "source": "zig_gpt2_tpu_torch/ops/csrc/qmm.cu",
            "replaces": "zig_gpt2_tpu/quant/kernels.py:256", "launches": None,
            "max_abs_err": max(errs), "ms": step["ms"], "plain_ms": step["plain_ms"],
            "bound_ms": bms, "bound_by": by, "library_ms": step["library_ms"]}


def tp_time_kernels(engine, shapes, att, sk, qk, quantize, torch, card: str):
    """Rank 0's kernels at its per-shard shapes, by CUDA-graph replay, with
    their plain versions, bounds and library calls, as phase ``times``
    does: qmm per rank-step at rows 1 and at the speculative verify
    window's 20, the INT8 attention over 13 heads at B=1 (1023 old rows of
    a 1024-row cache) and its ring at B=4 (R=257), the float packed
    attention of the 124M run at its rank shape (Hp=3, B=1, 1023 old rows),
    the sampler with return_max over the 25152-id slice at B=1. The other
    rank waits. Each entry's ``launches`` key names its counter in the
    ranks' counts (the parent sums both ranks'; ``qmm_verify_rows``: the
    qmm launches at the verify window's rows, by ``qmm.by_shape``)."""
    import torch.nn.functional as F

    from zig_gpt2_tpu_torch.ops import layers as ops

    g = torch.Generator(device="cuda").manual_seed(7)
    L = engine.config.n_layers
    entries = [dict(tp_time_qmm_step(shapes, 1, qk, quantize, torch, g,
                                     f"qmm_tp{TP}_rank_step", card), launches="qmm"),
               dict(tp_time_qmm_step(shapes, TP_BATCH * (TP_SPEC_K + 1), qk, quantize, torch, g,
                                     f"qmm_tp{TP}_verify_rank_step", card),
                    launches="qmm_verify_rows")]
    H = engine.config.attn_heads
    for name, B, ring in ((f"decode_attention_quant_deferred_tp{TP}", 1, False),
                          (f"decode_attention_quant_deferred_ring_tp{TP}", TP_BATCH, True)):
        S = 257 if ring else 1024
        n = 255 if ring else 1023
        args = int8_attention_inputs(ops, torch, g, L, B, H, S, 64, torch.bfloat16)
        kd = (args[5].float() * args[6][..., None]).to(torch.bfloat16)
        vd = (args[7].float() * args[8][..., None]).to(torch.bfloat16)
        q4 = args[0][:, :, None, :]
        kw = {"packed": False}
        if ring:
            start, length = ring_lanes(B, S, (n,), torch)
            kw["start"] = start
            mask = ops.decode_valid_mask(S, length + 1, start)[:, :, None, :]

            def lib(layer, kd=kd, vd=vd, mask=mask):
                return F.scaled_dot_product_attention(q4, kd[layer], vd[layer], attn_mask=mask)
        else:
            length = torch.full((B,), n, dtype=torch.int32, device="cuda")
            kd, vd = kd[..., :n + 1, :], vd[..., :n + 1, :]

            def lib(layer, kd=kd, vd=vd):
                return F.scaled_dot_product_attention(q4, kd[layer], vd[layer])
        nbytes, nops = attention_work([*args, length] + ([kw["start"]] if ring else []), n, S,
                                      L, True)
        entries.append(dict(time_attention(
            name, ":928", None,
            att.decode_attention_quant_deferred, att.decode_attention_quant_deferred_plain,
            [*args, length], L, lib, nbytes, nops,
            f"serve-tp rank 0 shard: INT8, bf16 q, B={B}, H={H}, {'R' if ring else 'S'}={S}, "
            f"{n} old rows{', ring' if ring else ''}; library: SDPA over the rows dequantized "
            f"ahead of time", card, **kw), launches="attention_int8_ring" if ring
            else "attention_int8"))
    # Row 1c at the 124M run's rank shape: f32, 6 heads per rank packed (Hp=3).
    args, _ = packed_inputs(ops, torch, g, 12, 1, 3, 1024, torch.float32, False)
    n = 1023
    length = torch.full((1,), n, dtype=torch.int32, device="cuda")
    kd = att.unpack_heads_seq(args[3])[..., :n + 1, :]
    vd = att.unpack_heads_seq(args[4])[..., :n + 1, :]
    q4 = att.unpack_heads_rows(args[0])[:, :, None, :]

    def lib_packed(layer):
        return F.scaled_dot_product_attention(q4, kd[layer], vd[layer])

    nbytes, nops = attention_work([*args, length], n, 1024, 12, False)
    entries.append(dict(time_attention(
        f"decode_attention_deferred_packed_tp{TP}", ":913", None,
        att.decode_attention_deferred, att.decode_attention_deferred_plain, [*args, length], 12,
        lib_packed, nbytes, nops,
        "serve-tp rank 0 shard of the 124M run: f32, B=1, Hp=3 (6 heads), S=1024, 1023 old "
        "rows; library: SDPA over the unpacked rows", card, packed=True),
        launches="attention_packed"))
    V = engine.params["lm_head"]["qw"].shape[1]
    logits = torch.randn(1, V, device="cuda", generator=g)
    seeds = torch.randint(0, 2**31 - 1, (1,), device="cuda", dtype=torch.int32, generator=g)
    ms = time_ms(lambda i: sk.sample_categorical(logits, seeds, 0.8, return_max=True), 400)
    plain_ms = time_ms(lambda i: sk.sample_categorical_plain(logits, seeds, 0.8, return_max=True),
                       40, graph=False)
    u = torch.rand(1, V, device="cuda", generator=g)
    lib_ms = time_ms(lambda i: torch.max(logits / 0.8 - torch.log(-torch.log(u)), -1), 400)
    bms, by = bound_ms(V * 4 + 8 + 4, SAMPLER_OPS_PER_ELEM * V)
    err = float((sk.sample_categorical(logits, seeds, 0.8, return_max=True)[1]
                 - sk.sample_categorical_plain(logits, seeds, 0.8, return_max=True)[1]).abs().item())
    log(f"time serve-tp sampler return_max f32 B=1 V={V} ({sk.sampler_geometry(1, V)[0]} "
        f"splits): kernel {ms * 1e3:.2f} us, bound {bms * 1e3:.2f} us ({by}), plain "
        f"{plain_ms * 1e3:.2f} us, max of gumbel-perturbed logits {lib_ms * 1e3:.2f} us, "
        f"z* max_abs_err={err:.3e} ({card})")
    entries.append({"name": f"sample_categorical_return_max_tp{TP}", "route": "cuda",
                    "source": "zig_gpt2_tpu_torch/ops/csrc/sampling.cu",
                    "replaces": "zig_gpt2_tpu/ops/sampling_kernel.py:37",
                    "launches": "sampler_max", "max_abs_err": err, "ms": ms,
                    "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by, "library_ms": lib_ms})
    return entries


def tp_inputs(vocab: int) -> dict:
    """The mesh paths' inputs, drawn alike in the parent and in each rank:
    the 256-id prompt of the sequence-parallel prefill; the 64-id prefix
    with the engine's prompt (the prefix plus 8 ids) and the batcher's four
    requests (two hits, two fresh prompts); the speculative requests (a
    3-id pattern six times each)."""
    import numpy as np

    rng = np.random.default_rng(64)

    def ids(n):
        return rng.integers(0, vocab, n).tolist()

    prefix = ids(TP_PREFIX)
    return {"sp_prompt": ids(TP_SP_PROMPT), "prefix": prefix,
            "engine_prompts": [prefix + ids(8)],
            "batch": [(prefix + ids(8), TP_PREFIX_TOKENS), (ids(12), TP_PREFIX_TOKENS),
                      (prefix + ids(16), TP_PREFIX_TOKENS), (ids(20), TP_PREFIX_TOKENS)],
            "spec": [(ids(3) * 6, TP_SPEC_TOKENS) for _ in range(TP_SPEC_REQUESTS)]}


def train_tokens(encoder, torch, device, B: int = TP_TRAIN_B, T: int = TP_TRAIN_T):
    """(B, T + 1) ids: the demo text encoded and repeated, each row from
    another offset (phases train and serve-tp)."""
    text = encoder.encode(DEMO_TEXT)
    stream = text * (-(-(B * 37 + T + 1) // len(text)))
    return torch.tensor([stream[37 * r:37 * r + T + 1] for r in range(B)], device=device)


def model_collectives(mesh, before: dict) -> dict:
    """The model group's collectives since ``before`` (a counts copy)."""
    return {op: n - before.get(op, 0) for op, n in mesh.model.counts.items()
            if n != before.get(op, 0)}


def expect_collectives(label: str, got: dict, want: dict) -> None:
    log(f"{label} collectives {got} (expected {want})")
    if got != want:
        raise AssertionError(f"{label}: collectives {got} vs {want}")


def tp_seq_parallel(rank: int, engine, mesh, gpt2, att, sk, qk, torch, prompt, card) -> dict:
    """The 1.5B prefill of one 256-id prompt on this rank's engine, with and
    without ``seq_parallel``: logits and every cache leaf bit-equal; one
    reduce-scatter for the embedding and two per layer where the plain
    prefill all-reduces, and one all-gather before each column-parallel
    stage and the lm_head; qmm at 256 rows. Returns the host-clock ms of
    each and the collectives."""
    L = engine.config.n_layers
    toks = torch.tensor([prompt], dtype=torch.int32, device=TP_DEVICE)
    lens = torch.tensor([len(prompt)], dtype=torch.int32, device=TP_DEVICE)
    runs = {}
    reset_counts(att, sk, qk)
    for name, conf in (("plain", engine.config),
                       ("seq_parallel", dataclasses.replace(engine.config, seq_parallel=True))):
        before = dict(mesh.model.counts)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cache, logits = gpt2.prefill(engine.params, engine.new_cache(), toks, lens, conf)
        torch.cuda.synchronize()
        runs[name] = (cache, logits, model_collectives(mesh, before),
                      (time.perf_counter() - t0) * 1e3)
    expect_counts(f"serve-tp rank {rank} prefill", read_counts(att, sk, qk, torch),
                  {"qmm": 2 * QMM_PER_PASS_1P5B})
    (c0, l0, n0, ms0), (c1, l1, n1, ms1) = runs["plain"], runs["seq_parallel"]
    equal = {k: torch.equal(c0[k], c1[k]) for k in c0}
    equal["logits"] = torch.equal(l0, l1)
    staged = mesh.model.host_staged.get("reduce_scatter")
    log(f"serve-tp rank {rank} prefill of {len(prompt)} ids, plain {ms0:.1f} ms, sequence-parallel "
        f"{ms1:.1f} ms (host clock, {card}); bit-equal {equal}; reduce-scatters "
        f"{n1.get('reduce_scatter')} ({'host-staged' if staged else 'direct'})")
    if not all(equal.values()):
        raise AssertionError(f"serve-tp rank {rank}: the sequence-parallel prefill differs from "
                             f"the plain one: {equal}")
    expect_collectives(f"serve-tp rank {rank} plain prefill", n0,
                       {"all_reduce": 1 + 2 * L, "all_gather": 2 * L})
    expect_collectives(f"serve-tp rank {rank} sequence-parallel prefill", n1,
                       {"reduce_scatter": 1 + 2 * L, "all_gather": 2 * L + 1 + 2 * L})
    return {"ms": (ms0, ms1), "collectives": (n0, n1)}


def tp_prefix(rank: int, engine, config, params, encoder, mesh, plain_batcher, mods, torch,
              inputs, card) -> dict:
    """A 64-id prefix on a mesh engine (B=1) and a B=4 ring batcher: the
    engine's prompt, 8 greedy tokens, and the batcher's four
    requests, against ``engine`` and ``plain_batcher`` (the same mesh
    without the prefix; the parent judges any divergence). Launch counts and
    collectives per pass and draw are gated; every hit reuses the whole
    prefix."""
    engine_mod, batcher_mod, config_mod, gpt2, att, sk, qk = mods
    L = config.n_layers
    greedy = config_mod.SamplingConfig(temperature=0.0)
    cached = engine_mod.InferenceEngine(config, params, encoder, kv_quant="int8",
                                        device=TP_DEVICE, mesh=mesh)
    cached.register_prefix(inputs["prefix"])
    before = dict(mesh.model.counts)
    reset_counts(att, sk, qk)
    hits = []
    for ids in inputs["engine_prompts"]:
        m = engine_mod.GenerationMetrics()
        hits.append((cached.generate(ids, TP_PREFIX_TOKENS, greedy, metrics=m), m))
    counts = engine_counts = read_counts(att, sk, qk, torch)
    n = len(hits)
    steps = sum(m.generated_tokens for _, m in hits)
    expect_counts(f"serve-tp rank {rank} prefix engine", counts,
                  {"qmm": QMM_PER_PASS_1P5B * (steps + n), "attention_int8": L * steps})
    expect_collectives(f"serve-tp rank {rank} prefix engine", model_collectives(mesh, before),
                       tp_collective_counts(config, steps + n, steps + n, 0))
    if any(m.prefix_tokens_reused != TP_PREFIX for _, m in hits):
        raise AssertionError(f"serve-tp rank {rank}: a prompt was not served from the prefix")
    plain = [engine.generate(ids, TP_PREFIX_TOKENS, greedy) for ids in inputs["engine_prompts"]]
    for (toks, m), ids in zip(hits, inputs["engine_prompts"]):
        log(f"serve-tp rank {rank} prefix engine: prompt of {len(ids)}, prefill_ms "
            f"{m.prefill_ms:.3f} (a hit: one extend of the suffix), prefix_tokens_reused "
            f"{m.prefix_tokens_reused} ({card})")
    del cached
    b = batcher_mod.ContinuousBatcher(config, params, batch_size=TP_BATCH, max_seq=256,
                                      kv_quant="int8", device=TP_DEVICE, mesh=mesh,
                                      sampling=greedy)
    b.register_prefix(inputs["prefix"])
    before = dict(mesh.model.counts)
    with recording(gpt2, {"prefill": [], "extend": []}) as calls:
        reset_counts(att, sk, qk)
        served = serve_batch(b, inputs["batch"], f"serve-tp rank {rank} prefix batcher")
        counts = read_counts(att, sk, qk, torch)
    steps, admissions = b.metrics.steps, len(calls["prefill"]) + len(calls["extend"])
    expect_counts(f"serve-tp rank {rank} prefix batcher", counts,
                  {"attention_int8_ring": L * steps,
                   "qmm": QMM_PER_PASS_1P5B * steps + window_qmm(config, calls)})
    expect_collectives(f"serve-tp rank {rank} prefix batcher", model_collectives(mesh, before),
                       tp_collective_counts(config, steps + admissions, steps + admissions, 0))
    d = b.metrics.as_dict(TP_BATCH)
    log(f"serve-tp rank {rank} prefix batcher metrics {json.dumps(d)} (INT4, INT8 KV ring, "
        f"B={TP_BATCH}, tp={TP}, {card})")
    if d.get("prefix_hits") != 2 or d.get("prefill_tokens_saved") != 2 * TP_PREFIX:
        raise AssertionError(f"serve-tp rank {rank}: prefix hits {d.get('prefix_hits')}, "
                             f"saved {d.get('prefill_tokens_saved')}")
    plain_batcher.sampling = greedy
    plain_served = serve_batch(plain_batcher, inputs["batch"],
                               f"serve-tp rank {rank} batcher without the prefix")
    return {"engine": ([t for t, _ in hits], plain), "batcher": (served, plain_served),
            "prefix_hits": d["prefix_hits"],
            "counts": {k: engine_counts[k] + counts[k] for k in counts}}


def tp_spec(rank: int, config, params, mesh, mods, torch, inputs, card) -> dict:
    """Prompt-lookup speculation on the mesh: a B=4 batcher,
    ``speculative="ngram"``, k=4, spec_min_tpr 0 (speculation held on),
    INT4 + INT8 KV (linear, unpacked), the eight repetitive requests, 32
    greedy tokens each. Every verify window is (4, 5), one qmm per linear
    per round at 20 rows; per round one pass's collectives and the
    all-gather of the verify logits. Returns the tokens and metrics."""
    _, batcher_mod, config_mod, gpt2, att, sk, qk = mods
    L = config.n_layers
    b = batcher_mod.ContinuousBatcher(config, params, batch_size=TP_BATCH, max_seq=256,
                                      kv_quant="int8", device=TP_DEVICE, mesh=mesh,
                                      sampling=config_mod.SamplingConfig(temperature=0.0),
                                      speculative="ngram", spec_k=TP_SPEC_K, spec_min_tpr=0.0)
    before = dict(mesh.model.counts)
    t0 = time.perf_counter()
    with recording(gpt2, {"prefill": [], "extend": []}) as calls:
        reset_counts(att, sk, qk)
        served = serve_batch(b, inputs["spec"], f"serve-tp rank {rank} speculative batcher")
        counts = read_counts(att, sk, qk, torch)
    secs = time.perf_counter() - t0
    rounds, prefills = b.metrics.spec_rounds, len(calls["prefill"])
    if window_shapes(calls["extend"]) != [(TP_BATCH, TP_SPEC_K + 1)] * rounds:
        raise AssertionError(f"serve-tp rank {rank}: verify windows "
                             f"{sorted(set(window_shapes(calls['extend'])))}")
    expect_counts(f"serve-tp rank {rank} speculative batcher", counts,
                  {"qmm": window_qmm(config, calls)})
    verify_rows = TP_BATCH * (TP_SPEC_K + 1)
    verify = sum(n for (_, _, _, rows), n in qk.qmm.by_shape.items() if rows == verify_rows)
    if verify != QMM_PER_PASS_1P5B * rounds:
        raise AssertionError(f"serve-tp rank {rank}: {verify} qmm launches at the verify "
                             f"window's {verify_rows} rows for {rounds} rounds")
    want = tp_collective_counts(config, rounds + prefills, prefills, 0)
    want["all_gather"] += rounds  # the verify logits, gathered for the acceptance
    expect_collectives(f"serve-tp rank {rank} speculative batcher",
                       model_collectives(mesh, before), want)
    tokens = sum(len(t) for t in served)
    log(f"serve-tp rank {rank} speculative batcher: {rounds} rounds, tokens_per_round "
        f"{b.metrics.tokens_per_round:.4f}, {1e3 * secs / tokens:.3f} ms per committed token "
        f"({tokens} tokens in {secs:.1f} s, host clock); metrics "
        f"{json.dumps(b.metrics.as_dict(TP_BATCH))} (INT4 + INT8 KV, B={TP_BATCH}, "
        f"k={TP_SPEC_K}, tp={TP}, {card})")
    return {"served": served, "tokens_per_round": b.metrics.tokens_per_round,
            "ms_per_token": 1e3 * secs / tokens, "counts": counts, "verify_launches": verify}


def tp_spec_auto_off(rank: int, config, params, mesh, mods, torch, inputs, card) -> dict:
    """Speculation's switch to plain decode on the mesh: the B=4 ngram
    batcher with ``spec_min_tpr`` above the k + 1 ceiling and two rounds per
    sync, so that it switches once its window is full (16 rounds), on the
    first four speculative prompts at TP_AUTO_OFF_TOKENS each. The rounds
    launch qmm at the verify window's rows; the plain steps after the
    switch launch the INT8 decode attention (linear, B=4) and qmm at 4
    rows. Returns the tokens, the switch's step and the counts."""
    _, batcher_mod, config_mod, gpt2, att, sk, qk = mods
    L = config.n_layers
    b = batcher_mod.ContinuousBatcher(config, params, batch_size=TP_BATCH, max_seq=256,
                                      kv_quant="int8", device=TP_DEVICE, mesh=mesh,
                                      sampling=config_mod.SamplingConfig(temperature=0.0),
                                      speculative="ngram", spec_k=TP_SPEC_K,
                                      spec_min_tpr=TP_SPEC_K + 2.0, spec_chunk=2)
    requests = [(ids, TP_AUTO_OFF_TOKENS) for ids, _ in inputs["spec"][:TP_BATCH]]
    before = dict(mesh.model.counts)
    t0 = time.perf_counter()
    with recording(gpt2, {"prefill": [], "extend": []}) as calls:
        reset_counts(att, sk, qk)
        served = serve_batch(b, requests, f"serve-tp rank {rank} speculative auto-off")
        counts = read_counts(att, sk, qk, torch)
    secs = time.perf_counter() - t0
    m = b.metrics
    rounds, prefills = m.spec_rounds, len(calls["prefill"])
    plain = m.steps - rounds
    if m.spec_auto_off_step is None or plain < 1:
        raise AssertionError(f"serve-tp rank {rank}: speculation did not switch off "
                             f"({rounds} rounds, {plain} plain steps)")
    expect_counts(f"serve-tp rank {rank} speculative auto-off", counts,
                  {"qmm": window_qmm(config, calls) + QMM_PER_PASS_1P5B * plain,
                   "attention_int8": L * plain})
    want = tp_collective_counts(config, rounds + prefills + plain, prefills + plain, 0)
    want["all_gather"] += rounds
    expect_collectives(f"serve-tp rank {rank} speculative auto-off",
                       model_collectives(mesh, before), want)
    log(f"serve-tp rank {rank} speculative auto-off: switched at step {m.spec_auto_off_step} "
        f"after {rounds} rounds (tokens_per_round {m.tokens_per_round:.4f}), then {plain} plain "
        f"decode steps; {secs:.1f} s (host clock; INT4 + INT8 KV, B={TP_BATCH}, "
        f"k={TP_SPEC_K}, tp={TP}, {card})")
    return {"served": served, "requests": requests, "switched_at": m.spec_auto_off_step,
            "plain_steps": plain, "counts": counts}


def tp_train(rank: int, encoder, mesh, mods, torch, card) -> dict:
    """Three AdamW steps (lr TRAIN_LR) of the 124M fp32 tree over the mesh
    (the tree padded for tp=2 and sliced: 6 heads and 25152 vocab rows per
    rank), B=4, T=256: the losses (the parent holds them to one card's),
    tokens/s and the peak memory of this rank's process. No kernel of the
    port runs; per step 4L + 2 all-reduces (forward: the embedding and the
    row-parallel outputs; backward: each column-parallel input and the
    lm_head's) and one all-gather of the logits."""
    from zig_gpt2_tpu_torch import train
    from zig_gpt2_tpu_torch.parallel.mesh import local_config, prepare_params

    _, _, config_mod, gpt2, att, sk, qk = mods
    small_cfg, small = build_tp_124m(config_mod, gpt2, len(encoder.vocab), torch)
    params, padded = prepare_params(small, small_cfg, mesh, TP_DEVICE)
    conf = local_config(padded, mesh)
    opt = train.make_optimizer(params, learning_rate=TRAIN_LR)
    step = train.make_train_step(conf, mesh=mesh)
    tokens = train_tokens(encoder, torch, TP_DEVICE)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    before = dict(mesh.model.counts)
    reset_counts(att, sk, qk)
    t0 = time.perf_counter()
    losses = []
    for _ in range(TP_TRAIN_STEPS):
        params, opt, loss = step(params, opt, tokens)
        losses.append(loss.item())
    secs = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    expect_counts(f"serve-tp rank {rank} train", read_counts(att, sk, qk, torch), {})
    L = small_cfg.n_layers
    expect_collectives(f"serve-tp rank {rank} train", model_collectives(mesh, before),
                       {"all_reduce": TP_TRAIN_STEPS * (4 * L + 2),
                        "all_gather": TP_TRAIN_STEPS})
    rate = TP_TRAIN_STEPS * TP_TRAIN_B * TP_TRAIN_T / secs
    log(f"serve-tp rank {rank} train: losses {losses}, {rate:.1f} tokens/s ({secs:.2f} s for "
        f"{TP_TRAIN_STEPS} steps), peak memory {peak / 2**30:.3f} GiB ({base / 2**30:.3f} GiB "
        f"allocated before) (124M fp32, B={TP_TRAIN_B}, T={TP_TRAIN_T}, tp={TP}, AdamW lr "
        f"{TRAIN_LR}, host clock, {card})")
    return {"losses": losses, "tokens_per_s": rate, "peak_gib": peak / 2**30}


def tp_rank(rank: int, init: str, tree_path: str, cfg_fields: dict, vocab, merges,
            out_path: str, card: str) -> None:
    """One rank of serve-tp (a spawned process on the one card): join the
    gloo group; over the 1 x 2 mesh serve the engine's requests, prefill one
    prompt with and without sequence parallelism, serve a prefix on the
    engine, the batcher's requests, a prefix on the batcher, prompt-lookup
    speculation in the batcher, the packed 124M engine, and train the 124M
    tree three steps; hold each kernel against its plain version at the
    shard's shapes, and count every launch and collective. Rank 0 also
    times the kernels (rank 1 waits) and the collectives (both take part);
    each rank writes its results for the parent."""
    import torch
    import torch.distributed as dist

    torch.cuda.set_device(TP_DEVICE)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from zig_gpt2_tpu_torch import config as config_mod
    from zig_gpt2_tpu_torch import tokenizer as tok
    from zig_gpt2_tpu_torch.models import gpt2
    from zig_gpt2_tpu_torch.ops import attention as att
    from zig_gpt2_tpu_torch.ops import sampling_kernel as sk
    from zig_gpt2_tpu_torch.parallel import distributed as pdist
    from zig_gpt2_tpu_torch.parallel.mesh import make_mesh
    from zig_gpt2_tpu_torch.quant import kernels as qk
    from zig_gpt2_tpu_torch.quant import quantize
    from zig_gpt2_tpu_torch.runtime import batcher as batcher_mod
    from zig_gpt2_tpu_torch.runtime import engine as engine_mod

    pdist.initialize(init, TP, rank, init_timeout_s=300, backend="gloo")
    try:
        mesh = make_mesh(1, TP, TP_DEVICE)
        log(f"serve-tp rank {rank}: gloo took CUDA tensors directly for "
            f"{[op for op, d in mesh.model.direct.items() if d]}, through the host for "
            f"{[op for op, d in mesh.model.direct.items() if not d]}")
        t0 = time.perf_counter()
        params = torch.load(tree_path, map_location="cpu", weights_only=False)
        config = config_mod.GPTConfig(**cfg_fields)
        encoder = tok.Encoder(vocab, merges)
        if not encoder.native_active:
            raise AssertionError("serve-tp: the encoder does not run the native core")
        engine = engine_mod.InferenceEngine(config, params, encoder, kv_quant="int8",
                                            device=TP_DEVICE, mesh=mesh)
        L = config.n_layers
        log(f"serve-tp rank {rank}: tree loaded and sliced in {time.perf_counter() - t0:.1f} s; "
            f"{engine.config.attn_heads} heads, {engine.params['wte'].shape[0]} vocab rows, "
            f"{'packed' if engine.config.kv_packed else 'unpacked'} INT8 KV")
        engine.generate_text("warm up", 2, config_mod.SamplingConfig(temperature=0.8, top_k=40))
        before = dict(mesh.model.counts)
        reset_counts(att, sk, qk)
        out = {"engine": []}
        for name, prompt, kw, n in TP_REQUESTS:
            sampling = config_mod.SamplingConfig(**kw)
            m = engine_mod.GenerationMetrics()
            ids = encoder.encode(prompt)
            toks = engine.generate(ids, n, sampling, metrics=m)
            out["engine"].append((name, ids, toks, m.ms_per_token_percentile(50),
                                  m.tokens_per_sec))
            log(f"serve-tp rank {rank} [{name}] {prompt!r} -> {encoder.decode(toks)!r} "
                f"ms_per_token_p50={m.ms_per_token_percentile(50):.3f} "
                f"tok_per_s={m.tokens_per_sec:.1f} ({card})")
            if len(toks) != n or max(toks) >= config.vocab_size:
                raise AssertionError(f"serve-tp [{name}]: {len(toks)} tokens, max id {max(toks)}")
        counts = read_counts(att, sk, qk, torch)
        steps = sum(n for *_, n in TP_REQUESTS)
        sampled = sum(n + 1 for _, _, kw, n in TP_REQUESTS if kw["temperature"] > 0)
        expect_counts(f"serve-tp rank {rank} engine", counts,
                      {"qmm": (6 * L + 1) * (steps + len(TP_REQUESTS)), "attention_int8": L * steps,
                       "sampler": sampled, "sampler_max": sampled})
        expect_collectives(f"serve-tp rank {rank} engine", model_collectives(mesh, before),
                           tp_collective_counts(config, steps + len(TP_REQUESTS),
                                                steps + len(TP_REQUESTS), sampled))
        log(f"serve-tp rank {rank} host-staged so far {dict(mesh.model.host_staged)}")
        total = dict(counts)
        inputs = tp_inputs(config.vocab_size)
        mods = (engine_mod, batcher_mod, config_mod, gpt2, att, sk, qk)
        t_part = time.perf_counter()

        def part_done(name: str) -> None:
            nonlocal t_part
            if rank == 0:
                log(f"serve-tp rank 0 {name}: {time.perf_counter() - t_part:.1f} s")
            t_part = time.perf_counter()

        out["seq_parallel"] = tp_seq_parallel(rank, engine, mesh, gpt2, att, sk, qk, torch,
                                              inputs["sp_prompt"], card)
        total["qmm"] += 2 * QMM_PER_PASS_1P5B
        part_done("sequence-parallel prefill")

        greedy = config_mod.SamplingConfig(temperature=0.0)
        b = batcher_mod.ContinuousBatcher(config, params, batch_size=TP_BATCH, max_seq=256,
                                          kv_quant="int8", device=TP_DEVICE, mesh=mesh,
                                          sampling=greedy)
        serve_batch(b, [([1, 2, 3], 4), ([4, 5], 4)], f"serve-tp rank {rank} batcher warm-up")
        b.metrics = batcher_mod.BatcherMetrics()
        requests = batch_requests(61, 6, config.vocab_size, (8, 40), (8, 16))
        sampled_requests = batch_requests(62, 2, config.vocab_size, (8, 40), (8, 12))
        with recording(gpt2, {"prefill": [], "extend": []}) as calls:
            reset_counts(att, sk, qk)
            served = serve_batch(b, requests, f"serve-tp rank {rank} batcher greedy")
            greedy_steps, greedy_prefills = b.metrics.steps, len(calls["prefill"])
            b.sampling = config_mod.SamplingConfig(temperature=0.8, top_k=40, seed=9)
            drawn = serve_batch(b, sampled_requests, f"serve-tp rank {rank} batcher T=0.8")
            counts = read_counts(att, sk, qk, torch)
        steps = b.metrics.steps
        n_sampled = steps - greedy_steps + len(calls["prefill"]) - greedy_prefills
        expect_counts(f"serve-tp rank {rank} batcher", counts,
                      {"attention_int8_ring": L * steps,
                       **gemv_counts(engine.config, steps, window_shapes(calls["prefill"])),
                       "sampler": n_sampled, "sampler_max": n_sampled})
        if max(t for toks in drawn + served for t in toks) >= config.vocab_size:
            raise AssertionError("serve-tp batcher emitted a phantom id")
        log(f"serve-tp rank {rank} batcher metrics {json.dumps(b.metrics.as_dict(TP_BATCH))} "
            f"(INT4, INT8 KV ring, B={TP_BATCH}, tp={TP}, {card})")
        out["batcher"] = (requests, served)
        total = {k: total[k] + counts[k] for k in total}
        part_done("batcher")
        out["prefix"] = tp_prefix(rank, engine, config, params, encoder, mesh, b, mods, torch,
                                  inputs, card)
        del b
        part_done("prefix engine and batcher")
        out["spec"] = tp_spec(rank, config, params, mesh, mods, torch, inputs, card)
        part_done("speculative batcher")
        out["auto_off"] = tp_spec_auto_off(rank, config, params, mesh, mods, torch, inputs,
                                           card)
        part_done("speculative auto-off")
        del params
        for part in ("prefix", "spec", "auto_off"):
            total = {k: total[k] + out[part]["counts"][k] for k in total}

        small_cfg, small = build_tp_124m(config_mod, gpt2, config.vocab_size, torch)
        small = engine_mod.InferenceEngine(small_cfg, small, encoder, device=TP_DEVICE,
                                           mesh=mesh)  # the card's default layout: packed
        reset_counts(att, sk, qk)
        ids = encoder.encode(TP_124M_PROMPT)
        out["packed_124m"] = small.generate(ids, TP_124M_TOKENS, greedy)
        counts = read_counts(att, sk, qk, torch)
        expect_counts(f"serve-tp rank {rank} packed 124M", counts,
                      {"attention_packed": small_cfg.n_layers * TP_124M_TOKENS})
        log(f"serve-tp rank {rank} packed 124M fp32 ({small.config.attn_heads} heads per rank, "
            f"{small.new_cache()['k'].shape[2]} packed rows): "
            f"{encoder.decode(out['packed_124m'])!r}")
        total = {k: total[k] + counts[k] for k in total}
        del small
        torch.cuda.empty_cache()
        part_done("packed 124M")
        out["train"] = tp_train(rank, encoder, mesh, mods, torch, card)
        part_done("train")

        shapes = tp_check_kernels(rank, engine, att, sk, qk, quantize, torch, card)
        part_done("kernel checks")
        dist.barrier()
        x = torch.randn(1, config.n_embed, device=TP_DEVICE)
        idx = torch.zeros(1, dtype=torch.int32, device=TP_DEVICE)
        xs = torch.randn(1, TP_SP_PROMPT, config.n_embed, device=TP_DEVICE)
        for label, fn in (("all_reduce (1, 1600) f32", lambda: mesh.model.all_reduce(x)),
                          ("all_gather (1,) int32", lambda: mesh.model.all_gather(idx)),
                          ("reduce_scatter (1, 256, 1600) f32 over T",
                           lambda: mesh.model.reduce_scatter(xs, 1))):
            for _ in range(10):  # both ranks take part in every call
                fn()
            t0 = time.perf_counter()
            for _ in range(200):
                fn()
            torch.cuda.synchronize()
            if rank == 0:
                op = label.split()[0]
                how = "direct" if mesh.model.direct[op] else "host-staged"
                log(f"time serve-tp collective {label} on cuda over gloo ({how}): "
                    f"{(time.perf_counter() - t0) / 200 * 1e3:.3f} ms per call, host clock, "
                    f"two ranks on one card ({card})")
        part_done("collective timings")
        if rank == 0:
            out["entries"] = tp_time_kernels(engine, shapes, att, sk, qk, quantize, torch, card)
        part_done("kernel timings")
        dist.barrier()
        out["counts"] = dict(total, qmm_verify_rows=out["spec"]["verify_launches"])
        out["collectives"] = dict(mesh.model.counts)
        out["host_staged"] = dict(mesh.model.host_staged)
        out["direct"] = dict(mesh.model.direct)
        torch.save(out, f"{out_path}.{rank}")
    finally:
        pdist.shutdown()


def serve_tp_phase(pkg, torch, encoder, vocab, merges, floor: float, tmp: str, card: str):
    """serve-tp: two ranks on the one card over gloo (NCCL refuses two ranks
    on one device), mesh 1 x 2, GPT-2 1.5B at full width and depth (26 heads
    padded from 25, 50304 vocab rows), INT4 weights quantized for tp=2, the
    INT8 lm_head, an INT8 KV cache (13 heads per rank: odd, so unpacked).
    The parent builds the tree once, serves the greedy requests on one
    device (unpacked, the same weights) for the near-tie checks, runs the
    one-card references of the mesh paths (the speculative batcher on the
    same weights, the 124M training steps on the same padded tree), and
    starts the ranks (``tp_rank``). Afterwards: the ranks' tokens agree; the
    tp=2 engine, the prefix runs against the same mesh without the prefix,
    and the speculative batcher against one card, equal up to a near-tie;
    the training losses within 1e-5 relative of one card's. Returns (each
    rank's launch counts summed, kernel entries)."""
    import torch.multiprocessing as mp

    from zig_gpt2_tpu_torch import train
    from zig_gpt2_tpu_torch.parallel.sharding import pad_for_tp
    from zig_gpt2_tpu_torch.runtime import batcher as batcher_mod

    config_mod, gpt2, engine_mod, att, sk, qk, weights, quantize = pkg
    t0 = time.perf_counter()
    config, params = build_tp_tree(config_mod, gpt2, quantize, encoder, torch)
    if (config.attn_heads, config.vocab_rows) != (26, 50304):
        raise AssertionError(f"serve-tp: padded to {config.attn_heads} heads, "
                             f"{config.vocab_rows} vocab rows")
    tree_path = os.path.join(tmp, "tp_tree.pt")
    torch.save(weights.tree_map(lambda t: t.cpu(), params), tree_path)
    log(f"serve-tp: 1.5B INT4 tree padded and quantized for tp={TP} and written in "
        f"{time.perf_counter() - t0:.1f} s ({os.path.getsize(tree_path) / 1e6:.0f} MB)")
    out_path = os.path.join(tmp, "tp_out")
    greedy = config_mod.SamplingConfig(temperature=0.0)
    with env_setting("ZG2_KV_PACKED", "0"):  # 13 heads per rank: the ranks serve unpacked
        single = engine_mod.InferenceEngine(config, params, encoder, kv_quant="int8",
                                            device="cuda")
    wants, rates = [], []
    for name, prompt, kw, n in TP_REQUESTS:
        if kw["temperature"] == 0.0:
            m = engine_mod.GenerationMetrics()
            wants.append(single.generate(encoder.encode(prompt), n, greedy, metrics=m))
            rates.append(m.tokens_per_sec)
    inputs = tp_inputs(config.vocab_size)
    t0 = time.perf_counter()
    one_card = batcher_mod.ContinuousBatcher(config, params, batch_size=TP_BATCH, max_seq=256,
                                             kv_quant="int8", device="cuda", sampling=greedy,
                                             speculative="ngram", spec_k=TP_SPEC_K,
                                             spec_min_tpr=0.0)
    spec_want = serve_batch(one_card, inputs["spec"], "serve-tp one-card speculative batcher")
    log(f"serve-tp one-card speculative batcher: tokens_per_round "
        f"{one_card.metrics.tokens_per_round:.4f}, "
        f"{1e3 * (time.perf_counter() - t0) / sum(map(len, spec_want)):.3f} ms per committed "
        f"token (host clock, with its warm-up; {card})")
    del one_card, params
    small_cfg, small = build_tp_124m(config_mod, gpt2, config.vocab_size, torch)
    small, small_cfg = pad_for_tp(small, small_cfg, TP)
    small = weights.tree_map(lambda t: t.to("cuda"), small)
    opt = train.make_optimizer(small, learning_rate=TRAIN_LR)
    step = train.make_train_step(small_cfg)
    tokens = train_tokens(encoder, torch, "cuda")
    train_want = [step(small, opt, tokens)[2].item() for _ in range(TP_TRAIN_STEPS)]
    log(f"serve-tp one-card train on the padded 124M tree: losses {train_want}")
    del small, opt
    torch.cuda.empty_cache()
    fields = {f.name: getattr(config, f.name) for f in dataclasses.fields(config_mod.GPTConfig)}
    t0 = time.perf_counter()
    mp.start_processes(tp_rank, args=(f"file://{tmp}/tp_rendezvous", tree_path, fields, vocab,
                                      merges, out_path, card),
                       nprocs=TP, join=True, start_method="spawn")
    log(f"serve-tp: the ranks ran {time.perf_counter() - t0:.1f} s")
    ranks = [torch.load(f"{out_path}.{r}", weights_only=False) for r in range(TP)]
    for r in ranks[1:]:
        if ([e[2] for e in r["engine"]] != [e[2] for e in ranks[0]["engine"]]
                or r["batcher"][1] != ranks[0]["batcher"][1]
                or r["packed_124m"] != ranks[0]["packed_124m"]
                or r["prefix"]["engine"] != ranks[0]["prefix"]["engine"]
                or r["prefix"]["batcher"] != ranks[0]["prefix"]["batcher"]
                or r["spec"]["served"] != ranks[0]["spec"]["served"]
                or r["auto_off"]["served"] != ranks[0]["auto_off"]["served"]
                or r["train"]["losses"] != ranks[0]["train"]["losses"]):
            raise AssertionError("serve-tp: the ranks returned different tokens or losses")
    engine_runs = [(ids, toks) for name, ids, toks, _, _ in ranks[0]["engine"]
                   if name == "greedy"]
    tp_rate = [tps for name, _, _, _, tps in ranks[0]["engine"] if name == "greedy"]
    log(f"serve-tp: greedy tokens/s tp={TP} (rank 0) {[round(x, 1) for x in tp_rate]} against "
        f"one device on the same weights {[round(x, 1) for x in rates]} ({card})")
    near_tie_check("serve-tp against one device", gpt2, single,
                   [(ids, len(t)) for ids, t in engine_runs], [t for _, t in engine_runs],
                   max(E2E_ATOL, 3 * floor), torch, wants=wants)
    ids, toks = engine_runs[0]
    tol = max(E2E_ATOL, 3 * floor,
              3 * bf16_floor(gpt2, weights, single, ids, toks[:16], torch, "serve-tp"))
    hits, plain = ranks[0]["prefix"]["engine"]
    near_tie_pair("serve-tp prefix engine against the mesh without the prefix", gpt2, single,
                  [(p, TP_PREFIX_TOKENS) for p in inputs["engine_prompts"]], hits, plain, tol,
                  torch)
    with_prefix, without = ranks[0]["prefix"]["batcher"]
    near_tie_pair("serve-tp prefix batcher against the mesh without the prefix", gpt2, single,
                  inputs["batch"], with_prefix, without, tol, torch)
    near_tie_pair("serve-tp speculative batcher against one card", gpt2, single, inputs["spec"],
                  ranks[0]["spec"]["served"], spec_want, tol, torch)
    auto_off = ranks[0]["auto_off"]
    near_tie_pair("serve-tp speculative auto-off against the speculative batcher", gpt2,
                  single, inputs["spec"][:TP_BATCH], [t[:TP_SPEC_TOKENS] for t in
                                                      auto_off["served"]],
                  ranks[0]["spec"]["served"][:TP_BATCH], tol, torch)
    near_tie_check("serve-tp speculative auto-off against one device", gpt2, single,
                   auto_off["requests"][:1], auto_off["served"][:1], tol, torch)
    got = ranks[0]["train"]["losses"]
    gap = max(abs(a - b) / abs(b) for a, b in zip(got, train_want))
    log(f"serve-tp train tp={TP}: losses {got} against one card's {train_want}: largest "
        f"relative gap {gap:.3e} (tolerance 1e-5); tokens/s per rank "
        f"{[round(r['train']['tokens_per_s'], 1) for r in ranks]}, peak memory per rank "
        f"{[round(r['train']['peak_gib'], 3) for r in ranks]} GiB ({card})")
    if gap > 1e-5:
        raise AssertionError("serve-tp: the mesh's training losses are not one card's")
    del single
    small_cfg, small = build_tp_124m(config_mod, gpt2, config.vocab_size, torch)
    small = engine_mod.InferenceEngine(small_cfg, small, encoder, device="cuda")
    if not small.config.kv_packed:
        raise AssertionError("serve-tp: the one-card 124M engine is not packed")
    near_tie_check("serve-tp packed 124M against one device", gpt2, small,
                   [(encoder.encode(TP_124M_PROMPT), TP_124M_TOKENS)],
                   [ranks[0]["packed_124m"]], E2E_ATOL, torch)
    del small
    log(f"serve-tp collectives per rank {[r['collectives'] for r in ranks]}, host-staged "
        f"{[r['host_staged'] for r in ranks]}, gloo direct on cuda {ranks[0]['direct']}")
    counts = {k: sum(r["counts"][k] for r in ranks) for k in ranks[0]["counts"]}
    entries = ranks[0]["entries"]
    for entry in entries:
        entry["launches"] = counts[entry["launches"]]  # both ranks' launches
    return counts, entries


def main() -> int:
    t_start = time.perf_counter()
    try:
        import torch
    except ImportError as e:
        return fail(f"torch is not importable: {e}")
    if not torch.cuda.is_available():
        return fail("no CUDA device: this smoke test runs only on the card")
    try:
        from zig_gpt2_tpu_torch import config as config_mod
        from zig_gpt2_tpu_torch import tokenizer as tok
        from zig_gpt2_tpu_torch import weights
        from zig_gpt2_tpu_torch.models import gpt2
        from zig_gpt2_tpu_torch.ops import _build
        from zig_gpt2_tpu_torch.ops import attention as att
        from zig_gpt2_tpu_torch.ops import layers as ops
        from zig_gpt2_tpu_torch.ops import sampling_kernel as sk
        from zig_gpt2_tpu_torch.quant import kernels as qk
        from zig_gpt2_tpu_torch.quant import quantize
        from zig_gpt2_tpu_torch.runtime import batcher as batcher_mod
        from zig_gpt2_tpu_torch.runtime import engine as engine_mod
        from zig_gpt2_tpu_torch.runtime import sampling
        from zig_gpt2_tpu_torch.tools.kernel_ab import register_report
    except ImportError as e:
        return fail(f"the zig_gpt2_tpu_torch package is not importable: {e}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    pkg = (config_mod, gpt2, engine_mod, att, sk, qk, weights, quantize)

    card = card_line()
    log(f"phase device: {torch.cuda.get_device_name(0)}; card: {card}; "
        f"torch {torch.__version__} cuda {torch.version.cuda}")
    t_phase = time.perf_counter()

    def phase(name: str) -> None:
        nonlocal t_phase
        now = time.perf_counter()
        log(f"phase {name} (previous phase {now - t_phase:.1f} s)")
        t_phase = now

    os.environ["ZG2_KV_PACKED"] = "0"  # phases 7-14 serve the unpacked layout
    try:
        lib, secs, build_log = _build.build()
        log(f"phase build: {secs:.1f} s -> {lib.name}")
        for name, used in register_report(build_log):
            log(f"  ptxas: {name}: {used}")
        phase("attention: float kernel vs plain at 124M shapes")
        check_attention(att, torch)
        phase("attention-int8: INT8-cache kernel vs plain at 1.5B shapes")
        check_attention_int8(att, ops, torch)
        phase("attention-ring: ring kernels vs plain, B=16 R=1025")
        check_attention_ring(att, ops, torch)
        phase("sampler: kernel vs plain, B 1/4/16/17 x V 7/1000/50257, return_max, ties")
        check_sampler(sk, sampling, torch)
        vocab, merges = tok.train_bpe(DEMO_TEXT, vocab_size=512)
        phase("native-bpe: the port's loader builds libzg2bpe; native ids vs the Python core")
        native_bpe_phase(tok, vocab, merges)
        encoder = tok.Encoder(vocab, merges)
        phase("serve: GPT-2 124M full width on InferenceEngine(device='cuda')")
        counts_124m, engine, ids = serve(pkg, torch, encoder, card)
        config_124m = engine.config  # unpacked: ZG2_KV_PACKED=0 here
        phase("trace: torch.profiler over 32 decode steps of the 124M path")
        trace_decode(gpt2, sampling, engine, ids, torch,
                     {"model": "124M", "weights": "float32", "kv_cache": "float32"}, card)
        phase("serve-batcher-124M: ContinuousBatcher(batch_size=8), ring cache")
        counts_b124 = serve_batcher_124m(pkg, batcher_mod, torch, engine, card)
        params_124m = engine.params
        del engine
        phase("qmm: dequant-GEMV kernel vs plain on the 1.5B INT4 weights")
        config_1p5b, params_1p5b = build_1p5b(config_mod, gpt2, quantize, encoder, torch)
        check_qmm(qk, params_1p5b, torch)
        phase("serve-1.5B: GPT-2 1.5B INT4 + INT8 KV on "
              "InferenceEngine(kv_quant='int8', device='cuda')")
        counts_1p5b, engine, ids, floor = serve_1p5b(pkg, torch, encoder, config_1p5b,
                                                     params_1p5b, card, check_layers=12)
        floor_unpacked = floor
        phase("trace-1.5B: torch.profiler over 32 decode steps of the 1.5B path")
        trace_decode(gpt2, sampling, engine, ids, torch,
                     {"model": "1558M", "weights": "INT4 (lm_head INT8), bf16 activations",
                      "kv_cache": "int8"}, card)
        del engine
        phase("serve-batcher-1.5B: ContinuousBatcher(batch_size=16, kv_quant='int8'), "
              "ring cache")
        counts_b1p5b, batcher = serve_batcher_1p5b(pkg, batcher_mod, torch, config_1p5b,
                                                   params_1p5b, floor, card)
        phase("trace-batcher-1.5B: torch.profiler over 32 batcher steps at B=16")
        trace_batcher(batcher, config_mod, torch, card)
        del batcher
        phase("attention-packed: packed and appended kernels vs plain, B=1 and B=16")
        check_attention_packed(att, ops, torch)
        os.environ["ZG2_KV_PACKED"] = "auto"  # phases 16-18: the card's default layout
        phase("serve-packed-124M: GPT-2 124M on InferenceEngine(device='cuda') and "
              "ContinuousBatcher(batch_size=8), packed KV")
        counts_p124, engine, _ = serve(pkg, torch, encoder, card, "serve-packed-124M",
                                       params_124m)
        counts_pb124 = serve_batcher_124m(pkg, batcher_mod, torch, engine, card,
                                          "serve-batcher-packed-124M")
        del engine
        phase("serve-packed-1.5B: GPT-2 1.5B INT4 + INT8 KV on InferenceEngine, packed KV")
        counts_p1p5b, engine, _, floor = serve_1p5b(pkg, torch, encoder, config_1p5b,
                                                    params_1p5b, card, "serve-packed-1.5B")
        del engine
        phase("serve-batcher-packed-1.5B: ContinuousBatcher(batch_size=16, kv_quant='int8'), "
              "ring cache, packed KV; then the layout A/B")
        counts_pb1p5b, batcher = serve_batcher_1p5b(pkg, batcher_mod, torch, config_1p5b,
                                                    params_1p5b, floor, card,
                                                    "serve-batcher-packed-1.5B")
        layout_ab(batcher_mod, config_mod, torch, config_1p5b, params_1p5b, batcher, card)
        del batcher
        phase("w8a8: the s8 x s8 body of qmm vs plain on the 1.5B INT8 weights")
        config_w8, params_w8 = build_1p5b(config_mod, gpt2, quantize, encoder, torch, "int8")
        params_w8, config_w8 = gpt2.pad_phantom_head(params_w8, config_w8)
        config_w8 = dataclasses.replace(config_w8, act_quant=True)
        check_w8a8(qk, quantize, params_w8, torch)
        phase("serve-w8a8-1.5B: GPT-2 1.5B w8a8 on InferenceEngine (bf16 KV) and "
              "ContinuousBatcher(batch_size=16, kv_quant='int8'), packed KV")
        counts_w1p5b, engine, ids, floor_w8 = serve_w8a8_1p5b(pkg, torch, encoder, config_w8,
                                                              params_w8, card)
        trace_decode(gpt2, sampling, engine, ids, torch,
                     {"model": "1558M", "weights": "w8a8 (INT8 weights and activations), "
                      "bf16 activations", "kv_cache": "bf16, packed"}, card)
        del engine
        counts_wb1p5b, batcher = serve_batcher_1p5b(
            pkg, batcher_mod, torch, config_w8, params_w8, max(floor, floor_w8), card,
            "serve-batcher-w8a8-1.5B", sampled_half=False)
        trace_batcher(batcher, config_mod, torch, card, "trace-batcher-w8a8-1.5B",
                      "w8a8 (INT8 weights and activations), bf16 activations",
                      w8a8_per_step=gemv_counts(config_w8, 1, [])["qmm_w8a8"])
        del batcher
        phase("wmm: float GEMV kernel vs plain at 124M shapes")
        check_wmm(qk, params_124m, torch)
        phase("serve-wmm-124M: GPT-2 124M with ZG2_WMM=1 on InferenceEngine and "
              "ContinuousBatcher(batch_size=8), packed KV")
        os.environ["ZG2_WMM"] = "1"
        label = {"model": "124M", "weights": "float32", "kv_cache": "float32, packed"}
        try:
            counts_m124, engine, ids = serve(pkg, torch, encoder, card, "serve-wmm-124M",
                                             params_124m)
            greedy = config_mod.SamplingConfig(temperature=0.0)
            wmm_tokens = engine.generate(ids, 32, greedy)
            counts_mb124 = serve_batcher_124m(pkg, batcher_mod, torch, engine, card,
                                              "serve-batcher-wmm-124M")
            traces = {"ZG2_WMM=1": trace_decode(gpt2, sampling, engine, ids, torch, label, card,
                                                wmm_per_step=6 * engine.config.n_layers)}
        finally:
            os.environ["ZG2_WMM"] = "0"
        traces["ZG2_WMM=0"] = trace_decode(gpt2, sampling, engine, ids, torch, label, card,
                                           wmm_per_step=0)
        keys = ("device_busy_ms_per_step", "kernels_per_decode_step", "wmm_kernels_per_step",
                "wmm_kernel_ms_per_step", "device_idle_share", "traced_wall_ms")
        log(f"trace-wmm {json.dumps({k: {n: r.get(k) for n, r in traces.items()} for k in keys})} "
            f"(124M fp32, B=1, 32 steps each, {card})")
        near_tie_check("serve-wmm-124M against the engine with ZG2_WMM=0", gpt2, engine,
                       [(ids, 32)], [wmm_tokens], E2E_ATOL, torch)
        counts_mbf16 = serve_batcher_wmm_bf16(pkg, batcher_mod, torch, engine, card)
        del engine
        phase("extend: gpt2.extend vs sequential decode steps, 124M fp32 unpacked and packed, "
              "1.5B INT4 + INT8 KV packed")
        counts_x = run_extend_phase(pkg, torch, config_124m, params_124m, config_1p5b,
                                    params_1p5b, card)
        phase("serve-prefix-1.5B: InferenceEngine (INT4 + INT8 KV, packed) with a 256-token "
              "prefix registered")
        counts_x1p5b, engine = serve_prefix_1p5b(pkg, torch, encoder, config_1p5b, params_1p5b,
                                                 floor, card)
        phase("serve-batcher-prefix-1.5B: ContinuousBatcher(batch_size=16, kv_quant='int8'), "
              "ring cache, packed KV, a prefix registered")
        counts_xb1p5b = serve_batcher_prefix_1p5b(pkg, batcher_mod, torch, config_1p5b,
                                                  params_1p5b, engine, floor, card)
        del engine
        phase("speculative-1.5B: SpeculativeEngine, target 1.5B INT4 + INT8 KV, draft 124M "
              "fp32, k=4, greedy; self-draft and n-gram")
        spec_floor = max(floor, floor_unpacked)  # the target's cache is unpacked
        counts_s1p5b, engine = speculative_1p5b(pkg, torch, encoder, config_1p5b, params_1p5b,
                                                config_124m, params_124m, spec_floor, card)
        phase("serve-batcher-spec-1.5B: ContinuousBatcher(speculative='ngram', batch_size=16, "
              "spec_k=3, kv_quant='int8')")
        counts_sb1p5b = serve_batcher_spec_1p5b(pkg, batcher_mod, torch, config_1p5b,
                                                params_1p5b, engine, spec_floor, card)
        del engine
        fused_shapes = collections.Counter()
        with tempfile.TemporaryDirectory(prefix="zg2_smoke_") as tmp:
            phase("npz: the 124M raw checkpoint repacked to INT4 .npz, loaded to the card and "
                  "served; the 1.5B INT4 tree round-tripped")
            counts_npz, raw = npz_phase(pkg, torch, encoder, config_124m, params_124m,
                                        params_1p5b, tmp, card)
            phase("fused-qkv: ZG2_FUSE_QKV=1 on the 1.5B INT4 + INT8 KV engine and B=16 "
                  "batcher, and the 124M wmm engine")
            counts_f, _ = fused_qkv_phase(pkg, batcher_mod, sampling, torch, encoder,
                                          config_1p5b, params_1p5b, config_124m, params_124m,
                                          floor, card, fused_shapes)
            phase("cache-dtype: InferenceEngine(cache_dtype=torch.bfloat16) on the 124M fp32 "
                  "weights, against the CPU")
            counts_cd, mixed = cache_dtype_phase(pkg, torch, encoder, config_124m, params_124m,
                                                 card)
            phase("ppl: tools.ppl_gate on the card at 124M, 8192 synthetic ids, windows 256 "
                  "and 1024, against the CPU")
            counts_ppl = ppl_phase(pkg, torch, raw, tmp, card)
            phase("train: 5 AdamW steps at 124M fp32, B=8 T=1024, with and without remat; "
                  "one step against the CPU")
            train_phase(pkg, torch, encoder, card)
            phase("profile-debug: cli --profile, nan_checks, checked_decode_step")
            counts_prof = profile_debug_phase(pkg, torch, config_124m, params_124m, tmp, card)
            phase(f"serve-tp: two ranks on the card over gloo, mesh 1x{TP}, GPT-2 1.5B INT4 + "
                  f"INT8 KV, 48 layers, InferenceEngine and ContinuousBatcher(batch_size="
                  f"{TP_BATCH})")
            counts_tp, tp_entries = serve_tp_phase(pkg, torch, encoder, vocab, merges,
                                                   floor_unpacked, tmp, card)
        phase("times")
        paths = (counts_124m, counts_b124, counts_1p5b, counts_b1p5b, counts_p124,
                 counts_pb124, counts_p1p5b, counts_pb1p5b, counts_w1p5b, counts_wb1p5b,
                 counts_m124, counts_mb124, counts_mbf16, counts_x, counts_x1p5b,
                 counts_xb1p5b, counts_s1p5b, counts_sb1p5b, counts_npz, counts_f,
                 counts_cd, counts_ppl, counts_prof, counts_tp)
        counts = {k: sum(c[k] for c in paths) for k in counts_124m}
        log(f"launches on the main paths (the serve and serve-batcher phases, unpacked and "
            f"packed, INT4, w8a8 and wmm, the extend path's phases, and the npz, fused-qkv, "
            f"cache-dtype, ppl, profile-debug and serve-tp phases): {counts}")
        entries = time_attention_kernels(att, ops, torch, counts, card,
                                         {"decode_attention_deferred_packed_bf16_cache": mixed})
        entries += time_sampler(sk, torch, counts, card)
        entries += time_qmm(qk, quantize, params_1p5b, torch, counts, card)
        entries += time_fused_qkv(qk, quantize, gpt2, config_1p5b, params_1p5b, params_w8,
                                  params_124m, torch, fused_shapes, card)
        del params_1p5b
        entries += time_w8a8(qk, quantize, params_w8, torch, counts, card)
        entries += time_wmm(qk, params_124m, torch, counts, card)
        entries += tp_entries
        phase("done")
    except Exception as e:  # a failed phase ends the run with its traceback
        import traceback

        traceback.print_exc()
        return fail(f"{type(e).__name__}: {e}")
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(card)
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                            "kind": torch.cuda.get_device_name(0),
                                            "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
