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
6. sampler   - the Gumbel-max sampler kernel against its plain version,
               B=4, V=50257, with and without a top-k/top-p threshold:
               identical ids.
7. serve     - GPT-2 124M, fp32, at full width (random weights from a fixed
               seed, a BPE trained in-process, vocab padded to 50257 rows)
               on ``InferenceEngine(device="cuda")``: three prompts x 32 new
               tokens (greedy; T=0.8; T=0.8 with top-k 40 and top-p 0.9).
               Kernel launch counts must match the decode steps; the greedy
               run's teacher-forced logits are held against the same model
               on the CPU.
8. trace     - ``torch.profiler`` over 32 decode steps of the 124M path
               (fp32, T=0.8, one host sync per token as the engine runs
               them): the device's busy and idle share of the traced
               window, kernels launched per step, the top kernels.
9. serve-batcher-124M - the same 124M model on
               ``ContinuousBatcher(batch_size=8, max_seq=256)``, ring cache:
               16 greedy requests of mixed prompt lengths and budgets. The
               float ring kernel launches 12 times per decode step, the
               prefix kernel never; two requests are held to the engine's
               tokens up to a near-tie.
10. qmm      - the dequant-GEMV kernel against its plain version on the
               1.5B model's quantized weights: the six block linears at
               layers 0 and 47 (INT4, grouped) and the lm_head (INT8
               per-channel, K=1600, N=50257), rows 1, 32 and 256, f32 and
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
               and the logits compared.
12. trace-1.5B - as 8, for the 1.5B INT4 + INT8-KV decode step (bf16).
13. serve-batcher-1.5B - the 1.5B model of phase 11 on
               ``ContinuousBatcher(batch_size=16, max_seq=256, decode_chunk=1,
               kv_quant="int8")``, ring cache (R=257): 64 requests, prompt
               lengths 8-120, budgets 32-96, the first half at T=0.8 with
               top-k 40 and top-p 0.9, then the greedy half, so that the
               write pointer wraps under the greedy half. Every request ends
               at its budget; launch counts match the steps and prefills;
               the greedy half served again on a linear cache (ZG2_RING=0)
               gives the same tokens; four greedy requests match the
               engine's up to a near-tie.
14. trace-batcher-1.5B - ``torch.profiler`` over 32 batcher steps at full
               occupancy (B=16): kernels per step, the device's busy and
               idle share, the top kernels, and the host syncs per step
               (``torch.cuda.set_sync_debug_mode``), which must be 1.
15. times    - each kernel's device time per call at the main paths'
               shapes (CUDA-graph replay of many calls), its bound, its
               plain version's time and one PyTorch library call computing
               the same function (timed only, never used by the port).

fp32 matmuls run in full f32: TF32 is switched off for cuBLAS and cuDNN.
The line before the last is a JSON object listing the kernels; the last
line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time

# Published H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, and the f32
# rate outside the tensor cores, used here for every 32-bit scalar op.
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12
# Operations per vocab element in the sampler: Philox4x32-10 is 10 rounds
# of 2 mul-hi, 2 mul-lo, 4 xor and 2 key adds; then ~14 for the uniform,
# two logs, the scale, the add, the mask and the running argmax.
SAMPLER_OPS_PER_ELEM = 114

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


def bound_ms(nbytes: float, nops: float) -> tuple[float, str]:
    tb, to = nbytes / PEAK_BYTES_PER_S * 1e3, nops / PEAK_OPS_PER_S * 1e3
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
    L, H, S, D = 12, 12, 1024, 64
    g = torch.Generator(device="cuda").manual_seed(1)
    for B, lengths in ((1, [17]), (1, [1023]), (4, [0, 1, 17, 1023])):
        for dtype in (torch.float32, torch.bfloat16):
            kc = torch.randn(L, B, H, S, D, device="cuda", generator=g).to(dtype)
            vc = torch.randn(L, B, H, S, D, device="cuda", generator=g).to(dtype)
            q, kn, vn = (torch.randn(B, H, D, device="cuda", generator=g).to(dtype)
                         for _ in range(3))
            length = torch.tensor(lengths, dtype=torch.int32, device="cuda")
            atol, rtol = ATTN_TOL[str(dtype).split(".")[-1]]
            for layer in (0, L - 1):
                got = att.decode_attention_deferred(q, kn, vn, kc, vc, length, layer=layer)
                want = att.decode_attention_deferred_plain(q, kn, vn, kc, vc, length,
                                                           layer=layer)
                err = check_close(f"attention B={B} {dtype} layer={layer}", got, want,
                                  atol, rtol, torch)
                log(f"attention B={B} len={lengths} {dtype} layer={layer}: "
                    f"max_abs_err={err:.3e} (atol {atol}, rtol {rtol})")


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
    starts = [0, R - 1] + [(b * 397) % R for b in range(2, B)]
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


def check_sampler(sk, sampling, torch) -> None:
    B, V = 4, 50257
    g = torch.Generator(device="cuda").manual_seed(2)
    for dtype in (torch.float32, torch.bfloat16):
        logits = (torch.randn(B, V, device="cuda", generator=g) * 3).to(dtype)
        thresh = sampling._threshold(logits, 0.8, 40, 0.9)
        for trial in range(4):
            seeds = torch.randint(0, 2**31 - 1, (B,), device="cuda", dtype=torch.int32,
                                  generator=g)
            for th in (None, thresh):
                got = sk.sample_categorical(logits, seeds, 0.8, th)
                want = sk.sample_categorical_plain(logits, seeds, 0.8, th)
                same = bool(torch.equal(got, want))
                log(f"sampler {dtype} trial={trial} thresh={th is not None}: "
                    f"ids={got.tolist()} identical={same}")
                if not same:
                    raise AssertionError(f"sampler kernel ids differ: {got.tolist()} vs "
                                         f"{want.tolist()}")
                if th is not None and (logits.float().gather(1, got.long()[:, None])[:, 0]
                                       < th).any():
                    raise AssertionError("sampler drew an id below its threshold")


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
        for rows in (1, 32, 256):
            for dtype in (torch.float32, torch.bfloat16):
                x = torch.randn(rows, k, device="cuda", generator=g).to(dtype)
                got = qk.qmm(x, qw, scale, int4=int4)
                want = qk.qmm_plain(x, qw, scale, int4=int4)
                errs.append(check_close(f"qmm {name} rows={rows} {dtype}", got, want,
                                        atol, rtol, torch))
        log(f"qmm {name} K={k} N={qw.shape[1]} groups={scale.shape[0]} "
            f"{'int4' if int4 else 'int8'}: rows 1/32/256 x f32/bf16 "
            f"max_abs_err={max(errs):.3e} (atol {atol}, rtol {rtol})")


COUNTERS = (("attention", "decode_attention_deferred", "launches"),
            ("attention_ring", "decode_attention_deferred", "ring_launches"),
            ("attention_int8", "decode_attention_quant_deferred", "launches"),
            ("attention_int8_ring", "decode_attention_quant_deferred", "ring_launches"))


def reset_counts(att, sk, qk) -> None:
    for _, fn, attr in COUNTERS:
        setattr(getattr(att, fn), attr, 0)
    sk.sample_categorical.launches = 0
    qk.qmm.launches = 0


def read_counts(att, sk, qk, torch) -> dict:
    torch.cuda.synchronize()
    counts = {key: getattr(getattr(att, fn), attr) for key, fn, attr in COUNTERS}
    counts.update(sampler=sk.sample_categorical.launches, qmm=qk.qmm.launches)
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
                   bucket=32):
    """(len(tokens) + 1, vocab) logits: prefill of ``ids`` padded to
    ``bucket`` (the engine's prompt bucket, so that the served run's
    arithmetic is repeated exactly), then one decode step per token of
    ``tokens``."""
    cache = gpt2.init_kv_cache(config, 1, bucket + len(tokens) + 1, device=device,
                               quant=kv_quant, dtype=params["wte"].dtype)
    prompt = torch.zeros((1, bucket), dtype=torch.int32, device=device)
    prompt[0, :len(ids)] = torch.tensor(ids, dtype=torch.int32)
    cache, logits = gpt2.prefill(params, cache, prompt,
                                 torch.tensor([len(ids)], dtype=torch.int32, device=device),
                                 config)
    rows = [logits[0]]
    for t in tokens:
        cache, logits = gpt2.decode_step(params, cache, torch.tensor([t], dtype=torch.int32,
                                                                     device=device), config)
        rows.append(logits[0])
    return torch.stack(rows).float().cpu()[:, :config.vocab_size]


def compare_logits(label: str, gpu, cpu, torch, atol: float = E2E_ATOL) -> None:
    err = (gpu - cpu).abs()
    top2 = cpu.topk(2, -1).values
    near_tie = (top2[:, 0] - top2[:, 1]) < 2 * (atol + E2E_RTOL * top2[:, 0].abs())
    flips = (cpu.argmax(-1) != gpu.argmax(-1)) & ~near_tie
    log(f"{label} teacher-forced fp32 logits, card vs CPU over {gpu.shape[0]} positions: "
        f"max_abs_err={err.max().item():.3e} (atol {atol:.3e}, rtol {E2E_RTOL}), "
        f"argmax flips outside near-ties={int(flips.sum())}")
    if (err > atol + E2E_RTOL * cpu.abs()).any() or flips.any():
        raise AssertionError(f"{label}: card logits disagree with the CPU run")
    if not torch.isfinite(gpu).all():
        raise AssertionError(f"{label}: non-finite logits")


def serve(pkg, torch, encoder, card: str):
    """Phase 6. Returns the kernels' launch counts and the engine."""
    config_mod, gpt2, engine_mod, att, sk, qk, weights, _ = pkg
    # Full 124M width; the tokenizer knows len(vocab) ids, the other rows
    # of the 50257-row vocab are padding that the lm_head masks.
    config = dataclasses.replace(config_mod.get_config("124M"), vocab_size=len(encoder.vocab),
                                 padded_vocab_size=50257)
    params = gpt2.init_params(config, torch.Generator(device="cuda").manual_seed(0),
                              torch.float32)
    engine = engine_mod.InferenceEngine(config, params, encoder, device="cuda")
    engine.generate_text("warm up", 2, config_mod.SamplingConfig(temperature=0.8))
    torch.cuda.synchronize()

    reset_counts(att, sk, qk)
    results, decode_steps, sampled = run_requests(engine_mod, config_mod, engine, "serve",
                                                  f"fp32, B=1, {card}")
    counts = read_counts(att, sk, qk, torch)
    expect_counts("serve", counts, {"attention": config.n_layers * decode_steps,
                                    "sampler": sampled})

    # Teacher-forced check of the greedy request against the CPU.
    _, prompt, sampling, text, _ = results[0]
    ids = encoder.encode(prompt)
    greedy = engine.generate(ids, 32, sampling)
    if encoder.decode(greedy) != text:
        raise AssertionError("greedy rerun differs from the served text")
    gpu = teacher_forced(gpt2, engine.params, config, ids, greedy[:-1], "cuda", torch)
    if gpu.argmax(-1).tolist() != greedy:
        raise AssertionError("teacher-forced argmax differs from the greedy tokens")
    seq = torch.tensor([ids + greedy[:-1]], dtype=torch.int32)
    cpu_params = weights.tree_map(lambda t: t.cpu(), engine.params)
    cpu = gpt2.forward(cpu_params, seq, config)[0, len(ids) - 1:][:, :config.vocab_size]
    compare_logits("serve", gpu, cpu, torch)
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


def build_1p5b(config_mod, gpt2, quantize, encoder, torch):
    """GPT-2 1.5B at full width and depth, random bf16 weights from a
    fixed seed, INT4 block linears and the INT8 lm_head."""
    config = dataclasses.replace(config_mod.get_config("1558M"), vocab_size=len(encoder.vocab),
                                 padded_vocab_size=50257)
    params = gpt2.init_params(config, torch.Generator(device="cuda").manual_seed(0),
                              torch.bfloat16)
    params = quantize.quantize_params(params, mode="int4")
    torch.cuda.synchronize()
    return config, params


def serve_1p5b(pkg, torch, encoder, config, params, card: str):
    """Phase 9. Returns the kernels' launch counts and the engine."""
    config_mod, gpt2, engine_mod, att, sk, qk, weights, quantize = pkg
    engine = engine_mod.InferenceEngine(config, params, encoder, kv_quant="int8",
                                        device="cuda")
    engine.generate_text("warm up", 2, config_mod.SamplingConfig(temperature=0.8))
    torch.cuda.synchronize()

    reset_counts(att, sk, qk)
    results, decode_steps, sampled = run_requests(
        engine_mod, config_mod, engine, "serve-1.5B",
        f"INT4 weights, INT8 lm_head and KV cache, bf16 activations, B=1, {card}")
    counts = read_counts(att, sk, qk, torch)
    per_pass = 6 * config.n_layers + 1  # block linears + the lm_head
    passes = decode_steps + len(results)  # decode steps + prefills
    expect_counts("serve-1.5B", counts, {"qmm": per_pass * passes, "sampler": sampled,
                                         "attention_int8": config.n_layers * decode_steps})

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
    cpu_w = dequantized(quantize, weights.tree_map(lambda t: t.cpu(), f32))
    # On the CPU the weights are dequantized to f32 once: each linear is one
    # plain matmul, the same products as qmm's plain version (weight
    # float(q) * scale in f32, f32 sums) in another order, at a fraction of
    # its time (the qmm phase holds the kernel to that plain version).
    # 1. Float KV cache: the INT4/INT8 GEMVs through 48 layers.
    gpu = teacher_forced(gpt2, f32, config, ids, greedy[:-1], "cuda", torch)
    t1 = time.perf_counter()
    cpu = teacher_forced(gpt2, cpu_w, config, ids, greedy[:-1], "cpu", torch)
    log(f"serve-1.5B CPU run, float KV cache: {time.perf_counter() - t1:.1f} s")
    compare_logits("serve-1.5B float KV cache", gpu, cpu, torch)
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
    log(f"serve-1.5B CPU run, INT8 KV cache: {time.perf_counter() - t1:.1f} s")
    cpu_w = weights.tree_map(lambda t: t.double() if t.is_floating_point() else t, cpu_w)
    t1 = time.perf_counter()
    f64 = teacher_forced(gpt2, cpu_w, config, ids, greedy[:-1], "cpu", torch, kv_quant="int8")
    log(f"serve-1.5B CPU run, INT8 KV cache, f64: {time.perf_counter() - t1:.1f} s")
    del cpu_w
    floor = (f64 - cpu).abs().max().item()
    log(f"serve-1.5B INT8 KV floor: the CPU run in f64 and in f32 differ by max_abs_err="
        f"{floor:.3e} over {cpu.shape[0]} positions")
    compare_logits("serve-1.5B INT8 KV cache", gpu, cpu, torch, atol=max(E2E_ATOL, 3 * floor))
    log(f"serve-1.5B teacher-forced runs (2 on the card, 3 on the CPU): {time.perf_counter() - t0:.1f} s")
    return counts, engine, ids, floor


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


def near_tie_check(label: str, gpt2, engine, requests, served, tol: float, torch) -> None:
    """Each request's batcher tokens equal the engine's greedy tokens up to
    the first divergence, if any; there the engine's logits for its token
    and for the batcher's differ by at most ``tol`` (a near-tie that the
    two paths' different prefill shapes may break either way)."""
    import numpy as np

    from zig_gpt2_tpu_torch.config import SamplingConfig
    from zig_gpt2_tpu_torch.runtime.engine import _bucket

    for (ids, budget), got in zip(requests, served):
        want = engine.generate(ids, budget, SamplingConfig(temperature=0.0))
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
        if gap > tol:
            raise AssertionError(f"{label}: the batcher left the engine's tokens at "
                                 f"token {n}, not at a near-tie (gap {gap:.3e})")


def serve_batcher_124m(pkg, batcher_mod, torch, engine, card: str) -> dict:
    """Phase 9. Returns the kernels' launch counts."""
    config_mod, gpt2, _, att, sk, qk, _, _ = pkg
    greedy = config_mod.SamplingConfig(temperature=0.0)
    b = batcher_mod.ContinuousBatcher(engine.config, engine.params, batch_size=8,
                                      max_seq=256, sampling=greedy, device="cuda")
    serve_batch(b, [([1, 2, 3], 4), ([4, 5], 4)], "serve-batcher-124M warm-up")
    b.metrics = batcher_mod.BatcherMetrics()
    requests = batch_requests(21, 16, engine.config.vocab_size, (4, 100), (16, 64))
    reset_counts(att, sk, qk)
    served = serve_batch(b, requests, "serve-batcher-124M")
    counts = read_counts(att, sk, qk, torch)
    steps = b.metrics.steps
    expect_counts("serve-batcher-124M", counts,
                  {"attention_ring": engine.config.n_layers * steps})
    log(f"serve-batcher-124M metrics {json.dumps(b.metrics.as_dict(8))} "
        f"(fp32, B=8, ring, greedy, {card})")
    near_tie_check("serve-batcher-124M", gpt2, engine, requests[:2], served[:2],
                   E2E_ATOL, torch)
    return counts


def serve_batcher_1p5b(pkg, batcher_mod, torch, config, params, floor: float, card: str):
    """Phase 13. Returns the kernels' launch counts and the ring batcher."""
    import os

    config_mod, gpt2, engine_mod, att, sk, qk, _, _ = pkg
    sampled = config_mod.SamplingConfig(temperature=0.8, top_k=40, top_p=0.9, seed=4)
    greedy = config_mod.SamplingConfig(temperature=0.0)
    kw = dict(batch_size=16, max_seq=256, decode_chunk=1, kv_quant="int8", device="cuda")
    b = batcher_mod.ContinuousBatcher(config, params, sampling=sampled, **kw)
    rows = b.cache["k"].shape[-2]
    serve_batch(b, [([1, 2, 3], 4), ([4, 5], 4)], "serve-batcher-1.5B warm-up")
    b.metrics = batcher_mod.BatcherMetrics()
    requests = batch_requests(31, 64, config.vocab_size, (8, 120), (32, 96))
    half = len(requests) // 2

    prefills = []  # (k, T) of each admission's prefill, for the qmm count
    plain_prefill = gpt2.prefill

    def recording_prefill(params, cache, tokens, lengths, config):
        prefills.append(tuple(tokens.shape))
        return plain_prefill(params, cache, tokens, lengths, config)

    gpt2.prefill = recording_prefill
    try:
        reset_counts(att, sk, qk)
        serve_batch(b, requests[:half], "serve-batcher-1.5B sampled half")
        sampled_steps, sampled_prefills = b.metrics.steps, len(prefills)
        b.sampling = greedy
        served = serve_batch(b, requests[half:], "serve-batcher-1.5B greedy half")
        counts = read_counts(att, sk, qk, torch)
    finally:
        gpt2.prefill = plain_prefill
    steps = b.metrics.steps
    per_pass = 6 * config.n_layers + 1  # block linears + the lm_head
    qmm = per_pass * steps + sum(6 * config.n_layers * (k * t <= 256) + 1
                                 for k, t in prefills)
    expect_counts("serve-batcher-1.5B", counts, {
        "attention_int8_ring": config.n_layers * steps, "qmm": qmm,
        "sampler": sampled_steps + sampled_prefills})
    log(f"serve-batcher-1.5B: {steps} decode steps ({sampled_steps} sampled), "
        f"{len(prefills)} admission prefills {sorted(set(prefills))}, ring rows {rows}, "
        f"wptr now {int(b.cache['wptr'])}")
    if steps + 2 < rows:  # the warm-up took 2 steps
        raise AssertionError("the write pointer did not wrap")
    log(f"serve-batcher-1.5B metrics {json.dumps(b.metrics.as_dict(16))} (INT4 weights, "
        f"INT8 lm_head and KV cache, bf16 activations, B=16, ring, {card})")

    os.environ["ZG2_RING"] = "0"
    try:
        linear = batcher_mod.ContinuousBatcher(config, params, sampling=greedy, **kw)
    finally:
        del os.environ["ZG2_RING"]
    linear_served = serve_batch(linear, requests[half:], "serve-batcher-1.5B linear")
    same = sum(a == c for a, c in zip(served, linear_served))
    log(f"serve-batcher-1.5B ring vs linear cache: {same} of {len(served)} greedy requests "
        f"identical")
    if same != len(served):
        raise AssertionError("the ring batcher's greedy tokens differ from the linear one's")
    del linear

    engine = engine_mod.InferenceEngine(config, params, kv_quant="int8", device="cuda")
    greedy_half = sorted(zip(requests[half:], served), key=lambda rs: rs[0][1])[:4]
    near_tie_check("serve-batcher-1.5B", gpt2, engine, [r for r, _ in greedy_half],
                   [t for _, t in greedy_half], max(E2E_ATOL, 3 * floor), torch)
    return counts, b


def trace_batcher(batcher, config_mod, torch, card: str) -> None:
    """Phase 14: 32 steps at full occupancy, T=0.8 top-k 40 top-p 0.9."""
    import warnings
    from collections import defaultdict

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    steps = 32
    batcher.sampling = config_mod.SamplingConfig(temperature=0.8, top_k=40, top_p=0.9,
                                                 seed=5)
    for ids, _ in batch_requests(41, batcher.batch_size, batcher.config.vocab_size,
                                 (8, 120), (64, 64)):
        batcher.submit(ids, 64)
    batcher.step()  # admits every slot: the traced steps admit and retire nothing
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                for _ in range(steps):
                    batcher.step()
            finally:
                torch.cuda.set_sync_debug_mode(0)
        wall_us = (time.perf_counter() - t0) * 1e6
    syncs = sum("called a synchronizing CUDA operation" in str(w.message) for w in caught)
    active = sum(r is not None for r in batcher.slots)
    kernels = [(e.name, e.time_range.end - e.time_range.start) for e in prof.events()
               if e.device_type == DeviceType.CUDA]
    row = {"model": "1558M", "weights": "INT4 (lm_head INT8), bf16 activations",
           "kv_cache": "int8 ring", "batch": batcher.batch_size, "active_slots": active,
           "temperature": 0.8, "traced_batcher_steps": steps,
           "traced_wall_ms": wall_us / 1e3, "host_syncs_per_step": syncs / steps,
           "card": card}
    if kernels:
        busy = sum(us for _, us in kernels)
        by_name = defaultdict(float)
        for name, us in kernels:
            by_name[name[:80]] += us
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
        row.update({"device_busy_ms_per_step": busy / 1e3 / steps,
                    "device_busy_share": busy / wall_us,
                    "device_idle_share": 1.0 - busy / wall_us,
                    "kernels_per_decode_step": len(kernels) / steps,
                    "top_kernels_ms_per_step": {k: v / 1e3 / steps for k, v in top}})
    else:
        row["device_busy_share"] = "not measured (no device events in the trace)"
    log(f"trace-batcher {json.dumps(row)}")
    if active != batcher.batch_size:
        raise AssertionError(f"the traced steps ran {active} of {batcher.batch_size} slots")
    if syncs != steps:
        raise AssertionError(f"{syncs} host syncs in {steps} batcher steps, expected one "
                             "per step")


def trace_decode(gpt2, sampling, engine, ids, torch, label: dict, card: str) -> None:
    """Trace 32 decode steps after a prefill, as the engine's per-token
    loop runs them (decode, sample, one host sync)."""
    from collections import defaultdict

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    steps = 32
    n = len(ids)
    tokens = torch.zeros((1, 32), dtype=torch.int32, device=engine.device)
    tokens[0, :n] = torch.tensor(ids, dtype=torch.int32)
    cache, logits = gpt2.prefill(engine.params, engine.new_cache(), tokens,
                                 torch.tensor([n], dtype=torch.int32, device=engine.device),
                                 engine.config)
    generator = torch.Generator(device=engine.device).manual_seed(3)
    token = sampling.sample(logits, generator, 0.8)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            cache, logits = gpt2.decode_step(engine.params, cache, token, engine.config)
            token = sampling.sample(logits, generator, 0.8)
            int(token[0])
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [(e.name, e.time_range.end - e.time_range.start) for e in prof.events()
               if e.device_type == DeviceType.CUDA]
    row = {**label, "batch": 1, "temperature": 0.8, "traced_decode_steps": steps,
           "traced_wall_ms": wall_us / 1e3, "card": card}
    if kernels:
        busy = sum(us for _, us in kernels)
        by_name = defaultdict(float)
        for name, us in kernels:
            by_name[name[:80]] += us
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
        row.update({"device_busy_ms_per_step": busy / 1e3 / steps,
                    "device_busy_share": busy / wall_us,
                    "device_idle_share": 1.0 - busy / wall_us,
                    "kernels_per_decode_step": len(kernels) / steps,
                    "top_kernels_ms_per_step": {k: v / 1e3 / steps for k, v in top}})
    else:
        row["device_busy_share"] = "not measured (no device events in the trace)"
    log(f"trace {json.dumps(row)}")


def time_float_kernels(att, sk, torch, counts, card: str):
    import torch.nn.functional as F

    entries = []
    # Attention: B=1, the full 124M window (len 1023 old rows), f32 cache.
    # The layer rotates over all 12, so the 75 MB working set exceeds L2.
    L, B, H, S, D, n = 12, 1, 12, 1024, 64, 1023
    for dtype in (torch.float32, torch.bfloat16):
        g = torch.Generator(device="cuda").manual_seed(3)
        kc = torch.randn(L, B, H, S, D, device="cuda", generator=g).to(dtype)
        vc = torch.randn(L, B, H, S, D, device="cuda", generator=g).to(dtype)
        q, kn, vn = (torch.randn(B, H, D, device="cuda", generator=g).to(dtype)
                     for _ in range(3))
        length = torch.full((B,), n, dtype=torch.int32, device="cuda")
        err = max_err(att.decode_attention_deferred(q, kn, vn, kc, vc, length, layer=0),
                      att.decode_attention_deferred_plain(q, kn, vn, kc, vc, length,
                                                          layer=0))
        ms = time_ms(lambda i: att.decode_attention_deferred(q, kn, vn, kc, vc, length,
                                                             layer=i % L), 240)
        plain_ms = time_ms(lambda i: att.decode_attention_deferred_plain(
            q, kn, vn, kc, vc, length, layer=i % L), 48)
        q4 = q[:, :, None, :]
        lib_ms = time_ms(lambda i: F.scaled_dot_product_attention(
            q4, kc[i % L, :, :, :n + 1], vc[i % L, :, :, :n + 1]), 240)
        esz = kc.element_size()
        nbytes = 2 * B * H * n * D * esz + 4 * B * H * D * esz + 4 * B
        bms, by = bound_ms(nbytes, 4 * B * H * (n + 1) * D)
        log(f"time attention {dtype} B={B} len={n}: kernel {ms * 1e3:.2f} us, "
            f"bound {bms * 1e3:.2f} us ({by}), plain {plain_ms * 1e3:.2f} us, "
            f"sdpa {lib_ms * 1e3:.2f} us, max_abs_err={err:.3e} ({card})")
        if dtype == torch.float32:
            entries.append({
                "name": "decode_attention_deferred", "route": "cuda",
                "source": "zig_gpt2_tpu_torch/ops/csrc/decode_attention.cu",
                "replaces": "zig_gpt2_tpu/ops/attention.py:913",
                "launches": counts["attention"], "max_abs_err": err, "ms": ms,
                "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
                "library_ms": lib_ms})

    # Sampler: B=1 over the 50257-id vocab, f32 logits, plain temperature.
    B, V, T = 1, 50257, 0.8
    g = torch.Generator(device="cuda").manual_seed(4)
    logits = torch.randn(B, V, device="cuda", generator=g)
    seeds = torch.randint(0, 2**31 - 1, (B,), device="cuda", dtype=torch.int32, generator=g)
    err = float((sk.sample_categorical(logits, seeds, T).long()
                 - sk.sample_categorical_plain(logits, seeds, T).long()).abs().max().item())
    ms = time_ms(lambda i: sk.sample_categorical(logits, seeds, T), 400)
    plain_ms = time_ms(lambda i: sk.sample_categorical_plain(logits, seeds, T), 40,
                       graph=False)  # it copies 1/T from the host
    u = torch.rand(B, V, device="cuda", generator=g)
    lib_ms = time_ms(lambda i: torch.argmax(logits / T - torch.log(-torch.log(u)), -1), 400)
    bms, by = bound_ms(V * 4 * B + 8 * B, SAMPLER_OPS_PER_ELEM * V * B)
    log(f"time sampler f32 B={B} V={V}: kernel {ms * 1e3:.2f} us, bound {bms * 1e3:.2f} us "
        f"({by}), plain {plain_ms * 1e3:.2f} us, argmax-gumbel {lib_ms * 1e3:.2f} us, "
        f"max_abs_err={err} ({card})")
    entries.append({
        "name": "sample_categorical", "route": "cuda",
        "source": "zig_gpt2_tpu_torch/ops/csrc/sampling.cu",
        "replaces": "zig_gpt2_tpu/ops/sampling_kernel.py:37",
        "launches": counts["sampler"], "max_abs_err": err, "ms": ms,
        "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by, "library_ms": lib_ms})
    return entries


def time_ring_kernels(att, ops, torch, counts, card: str):
    """Both ring variants at B=16, R=1025, 1023 old rows per lane (starts
    spread over the ring, most intervals wrapping), rotating over the
    layers: float at 124M shapes in f32, INT8 at 1.5B shapes with bf16 q.
    The library yardstick is SDPA with a boolean mask over all R rows (the
    interval plus the next row, standing for the appended one), over a
    cache dequantized ahead of time for INT8."""
    import torch.nn.functional as F

    entries = []
    B, R, D, n = 16, RING_ROWS, 64, 1023
    start, length = ring_lanes(B, R, (n,), torch)
    mask = ops.decode_valid_mask(R, length + 1, start)[:, :, None, :]  # (B, 1, 1, R)
    for name, L, H, dtype, quant, replaces in (
            ("decode_attention_deferred_ring", 12, 12, torch.float32, False, ":913"),
            ("decode_attention_quant_deferred_ring", 48, 25, torch.bfloat16, True, ":928")):
        g = torch.Generator(device="cuda").manual_seed(10)
        if quant:
            args = int8_attention_inputs(ops, torch, g, L, B, H, R, D, dtype)
            kernel, plain = att.decode_attention_quant_deferred, \
                att.decode_attention_quant_deferred_plain
            q, kc, ks, vc, vs = args[0], args[5], args[6], args[7], args[8]
            kd = (kc.float() * ks[..., None]).to(dtype)
            vd = (vc.float() * vs[..., None]).to(dtype)
            nbytes = (2 * B * H * n * D + 2 * B * H * n * 4  # int8 rows and their scales
                      + 2 * B * H * D * q.element_size() + 2 * B * H * D + 2 * B * H * 4
                      + 8 * B)
            nops = (4 * D + 4) * B * H * (n + 1)
        else:
            args = [torch.randn(B, H, D, device="cuda", generator=g).to(dtype)
                    for _ in range(3)]
            args += [torch.randn(L, B, H, R, D, device="cuda", generator=g).to(dtype)
                     for _ in range(2)]
            kernel, plain = att.decode_attention_deferred, att.decode_attention_deferred_plain
            q, kd, vd = args[0], args[3], args[4]
            esz = kd.element_size()
            nbytes = 2 * B * H * n * D * esz + 4 * B * H * D * esz + 8 * B
            nops = 4 * B * H * (n + 1) * D
        err = max_err(kernel(*args, length, layer=0, start=start),
                      plain(*args, length, layer=0, start=start))
        ms = time_ms(lambda i: kernel(*args, length, layer=i % L, start=start), 10 * L)
        plain_ms = time_ms(lambda i: plain(*args, length, layer=i % L, start=start), L)
        q4 = q[:, :, None, :]
        lib_ms = time_ms(lambda i: F.scaled_dot_product_attention(q4, kd[i % L], vd[i % L],
                                                                  attn_mask=mask), 10 * L)
        bms, by = bound_ms(nbytes, nops)
        log(f"time {name} {dtype} B={B} H={H} R={R} len={n}: kernel {ms * 1e3:.2f} us, "
            f"bound {bms * 1e3:.2f} us ({by}), plain {plain_ms * 1e3:.2f} us, masked sdpa"
            f"{' over a pre-dequantized cache' if quant else ''} {lib_ms * 1e3:.2f} us, "
            f"max_abs_err={err:.3e} ({card})")
        entries.append({
            "name": name, "route": "cuda",
            "source": "zig_gpt2_tpu_torch/ops/csrc/decode_attention.cu",
            "replaces": f"zig_gpt2_tpu/ops/attention.py{replaces}",
            "launches": counts["attention_int8_ring" if quant else "attention_ring"],
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bms,
            "bound_by": by, "library_ms": lib_ms})
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


def time_quant_kernels(att, ops, qk, quantize, params, torch, counts, card: str):
    import torch.nn.functional as F

    entries = []
    # INT8 attention: B=1, 1.5B shapes, len 1023 old rows, rotating over the
    # 48 layers (the int8 cache is 157 MB, more than L2). The yardstick is
    # SDPA over the same cache dequantized ahead of time (f32 rows times
    # their scales, cast to q's dtype): it reads 2x or 4x the bytes.
    L, B, H, S, D, n = 48, 1, 25, 1024, 64, 1023
    g = torch.Generator(device="cuda").manual_seed(7)
    for dtype in (torch.bfloat16, torch.float32):
        args = int8_attention_inputs(ops, torch, g, L, B, H, S, D, dtype)
        q, kn, ksn, vn, vsn, kc, ks, vc, vs = args
        length = torch.full((B,), n, dtype=torch.int32, device="cuda")
        err = max_err(att.decode_attention_quant_deferred(*args, length, layer=0),
                      att.decode_attention_quant_deferred_plain(*args, length, layer=0))
        ms = time_ms(lambda i: att.decode_attention_quant_deferred(
            *args[:5], kc, ks, vc, vs, length, layer=i % L), 480)
        plain_ms = time_ms(lambda i: att.decode_attention_quant_deferred_plain(
            *args[:5], kc, ks, vc, vs, length, layer=i % L), 48)
        kd = (kc[:, :, :, :n + 1].float() * ks[..., :n + 1, None]).to(dtype)
        vd = (vc[:, :, :, :n + 1].float() * vs[..., :n + 1, None]).to(dtype)
        q4 = q[:, :, None, :]
        lib_ms = time_ms(lambda i: F.scaled_dot_product_attention(q4, kd[i % L], vd[i % L]),
                         480)
        del kd, vd
        qsz = q.element_size()
        nbytes = (2 * B * H * n * D + 2 * B * H * n * 4  # int8 rows and their scales
                  + 2 * B * H * D * qsz + 2 * B * H * D + 2 * B * H * 4 + 4 * B)
        bms, by = bound_ms(nbytes, (4 * D + 4) * B * H * (n + 1))
        log(f"time attention-int8 {dtype} B={B} H={H} len={n}: kernel {ms * 1e3:.2f} us, "
            f"bound {bms * 1e3:.2f} us ({by}), plain {plain_ms * 1e3:.2f} us, "
            f"sdpa over a pre-dequantized {dtype} cache {lib_ms * 1e3:.2f} us, "
            f"max_abs_err={err:.3e} ({card})")
        if dtype == torch.bfloat16:
            entries.append({
                "name": "decode_attention_quant_deferred", "route": "cuda",
                "source": "zig_gpt2_tpu_torch/ops/csrc/decode_attention.cu",
                "replaces": "zig_gpt2_tpu/ops/attention.py:928",
                "launches": counts["attention_int8"], "max_abs_err": err, "ms": ms,
                "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
                "library_ms": lib_ms})
        del args, kc, vc, ks, vs

    # qmm at B=1 (rows 1), bf16 activations as served, per linear shape,
    # rotating over the 48 layers so that the weights come from HBM (the
    # lm_head alone is 80 MB). The yardstick is torch.matmul on the same
    # weights dequantized ahead of time to bf16: it reads 4x the INT4 bytes.
    g = torch.Generator(device="cuda").manual_seed(8)
    L = params["blocks"]["attn"]["wq"]["scale"].shape[0]
    shapes = [("attn.wq/wk/wv/c_proj", [linears(params, i)[0][1:] for i in range(L)]),
              ("mlp.c_fc", [linears(params, i)[4][1:] for i in range(L)]),
              ("mlp.c_proj", [linears(params, i)[5][1:] for i in range(L)]),
              ("lm_head", [linears(params, None)[0][1:]])]
    step = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bytes": 0.0, "ops": 0.0}
    errs = []
    for label, layers in shapes:
        qw, scale, int4 = layers[0]
        k = qw.shape[0] * (2 if int4 else 1)
        x = torch.randn(1, k, device="cuda", generator=g).to(torch.bfloat16)
        dq = [quantize.dequantize_linear({"qw4" if i4 else "qw": w, "scale": s},
                                         torch.bfloat16)["w"] for w, s, i4 in layers]
        errs.append(max_err(qk.qmm(x, qw, scale, int4=int4),
                            qk.qmm_plain(x, qw, scale, int4=int4)))
        nl = len(layers)
        ms = time_ms(lambda i: qk.qmm(x, *layers[i % nl][:2], int4=int4), max(8 * nl, 64))
        plain_ms = time_ms(lambda i: qk.qmm_plain(x, *layers[i % nl][:2], int4=int4),
                           max(2 * nl, 8))
        lib_ms = time_ms(lambda i: torch.matmul(x, dq[i % nl]), max(8 * nl, 64))
        nbytes, nops = qmm_work(qw, scale, int4, 1, x.element_size())
        bms, by = bound_ms(nbytes, nops)
        log(f"time qmm {label} K={k} N={qw.shape[1]} {'int4' if int4 else 'int8'} "
            f"groups={scale.shape[0]} B=1 bf16: kernel {ms * 1e3:.2f} us, "
            f"bound {bms * 1e3:.2f} us ({by}), plain {plain_ms * 1e3:.2f} us, "
            f"torch.matmul on a pre-dequantized bf16 weight {lib_ms * 1e3:.2f} us, "
            f"max_abs_err={errs[-1]:.3e} ({card})")
        calls = 4 * L if label.startswith("attn") else (L if label.startswith("mlp") else 1)
        step["ms"] += calls * ms
        step["plain_ms"] += calls * plain_ms
        step["library_ms"] += calls * lib_ms
        step["bytes"] += calls * nbytes
        step["ops"] += calls * nops
        del dq
    bms, by = bound_ms(step["bytes"], step["ops"])
    log(f"time qmm per decode step (289 calls, B=1, bf16): kernel {step['ms']:.4f} ms, "
        f"bound {bms:.4f} ms ({by}), plain {step['plain_ms']:.4f} ms, "
        f"torch.matmul on pre-dequantized bf16 weights {step['library_ms']:.4f} ms ({card})")
    entries.append({
        "name": "qmm", "route": "cuda", "source": "zig_gpt2_tpu_torch/ops/csrc/qmm.cu",
        "replaces": "zig_gpt2_tpu/quant/kernels.py:256", "launches": counts["qmm"],
        "max_abs_err": max(errs), "ms": step["ms"], "plain_ms": step["plain_ms"],
        "bound_ms": bms, "bound_by": by, "library_ms": step["library_ms"]})
    return entries


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

    try:
        lib, secs, build_log = _build.build()
        log(f"phase build: {secs:.1f} s -> {lib.name}")
        for line in build_log.splitlines():
            if "registers" in line:
                log(f"  ptxas: {line.split(':', 1)[1].strip()}")
        phase("attention: float kernel vs plain at 124M shapes")
        check_attention(att, torch)
        phase("attention-int8: INT8-cache kernel vs plain at 1.5B shapes")
        check_attention_int8(att, ops, torch)
        phase("attention-ring: ring kernels vs plain, B=16 R=1025")
        check_attention_ring(att, ops, torch)
        phase("sampler: kernel vs plain, B=4 V=50257")
        check_sampler(sk, sampling, torch)
        vocab, merges = tok.train_bpe(DEMO_TEXT, vocab_size=512)
        encoder = tok.Encoder(vocab, merges)
        phase("serve: GPT-2 124M full width on InferenceEngine(device='cuda')")
        counts_124m, engine, ids = serve(pkg, torch, encoder, card)
        phase("trace: torch.profiler over 32 decode steps of the 124M path")
        trace_decode(gpt2, sampling, engine, ids, torch,
                     {"model": "124M", "weights": "float32", "kv_cache": "float32"}, card)
        phase("serve-batcher-124M: ContinuousBatcher(batch_size=8), ring cache")
        counts_b124 = serve_batcher_124m(pkg, batcher_mod, torch, engine, card)
        del engine
        phase("qmm: dequant-GEMV kernel vs plain on the 1.5B INT4 weights")
        config_1p5b, params_1p5b = build_1p5b(config_mod, gpt2, quantize, encoder, torch)
        check_qmm(qk, params_1p5b, torch)
        phase("serve-1.5B: GPT-2 1.5B INT4 + INT8 KV on "
              "InferenceEngine(kv_quant='int8', device='cuda')")
        counts_1p5b, engine, ids, floor = serve_1p5b(pkg, torch, encoder, config_1p5b,
                                                     params_1p5b, card)
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
        phase("times")
        paths = (counts_124m, counts_b124, counts_1p5b, counts_b1p5b)
        counts = {k: sum(c[k] for c in paths) for k in counts_124m}
        log(f"launches on the main paths (124M and 1.5B serve and serve-batcher phases): "
            f"{counts}")
        entries = time_float_kernels(att, sk, torch, counts, card)
        entries += time_quant_kernels(att, ops, qk, quantize, params_1p5b, torch, counts,
                                      card)
        entries += time_ring_kernels(att, ops, torch, counts, card)
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
