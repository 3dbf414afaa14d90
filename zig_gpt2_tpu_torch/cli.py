"""CLI driver for the PyTorch port.

Same interface and defaults as ``zig_gpt2_tpu.cli`` (temperature 0.8,
running to the end of the context window), for what this port serves:
GPT-2 on one device or over a (data x model) mesh of processes
(``--mesh DPxTP``), float or INT8/INT4 weights, or w8a8 (per-channel INT8
weights and per-row INT8 activations) (``--quant``), float or INT8 KV cache
(``--kv-quant``): one prompt streamed to stdout, or a file of
prompts served through the continuous batcher (``--batch-file``, one JSON
line ``{"prompt", "completion"}`` per finished request), with a shared
prefix's KV rows kept (``--prefix``). ``--draft-model`` decodes one prompt
speculatively (a draft config name, or ``ngram`` for prompt lookup,
which also composes with ``--batch-file``).

Examples::

    python -m zig_gpt2_tpu_torch.cli --demo "the quick brown"
    python -m zig_gpt2_tpu_torch.cli --model 1558M --quant int4 --kv-quant --demo "the quick"
    python -m zig_gpt2_tpu_torch.cli --model 1558M --quant w8a8 --kv-quant --demo "the quick"
    python -m zig_gpt2_tpu_torch.cli --model 1558M --quant int4 --kv-quant --demo \\
        --batch-file prompts.txt --batch-slots 16 --max-tokens 64 --metrics
    python -m zig_gpt2_tpu_torch.cli --model 1558M --quant int4 --kv-quant --demo \
        --batch-file prompts.txt --prefix "the quick brown fox"
    python -m zig_gpt2_tpu_torch.cli --model 1558M --quant int4 --kv-quant --demo \
        --draft-model demo --spec-k 4 --temp 0 "the quick"
    python -m zig_gpt2_tpu_torch.cli --demo --draft-model ngram --batch-file prompts.txt
    python -m zig_gpt2_tpu_torch.cli --model 1558M --quant int4 --kv-quant --demo \
        --mesh 1x2 --backend gloo --temp 0 "the quick"
    python -m zig_gpt2_tpu_torch.cli --model 124M --weights models/124M/raw \\
        --encoder-dir models/124M "Hello, my name is"
    python -m zig_gpt2_tpu_torch.cli --model 124M --weights models/124M/int4.npz \\
        --encoder-dir models/124M --profile traces/124M "Hello, my name is"

``--weights`` (and ``--draft-weights``) take a raw checkpoint directory or
a ``.npz`` tree (``tools.repack`` of either package: quantized leaves are
served as they are, with the padding its meta records). ``--profile DIR``
writes a ``torch.profiler`` trace of the serving run to ``DIR/trace.json``.

``--mesh DPxTP`` serves tensor- and data-parallel: the CLI starts dp * tp
processes itself (``torch.multiprocessing``, spawn; rendezvous at a file
in a temporary directory) unless ``RANK`` and ``WORLD_SIZE`` are set (a
launcher started it: ``MASTER_ADDR``/``MASTER_PORT`` then name the
rendezvous). Each rank takes card ``rank % device_count`` (``--device
cuda``) and the backend ``--backend`` names: ``gloo`` (the default; CPU
ranks, or several ranks sharing one card) or ``nccl`` (one card per rank:
NCCL refuses two ranks on one device). Rank 0 prints. Under a mesh the
float weights are padded for the model degree before ``--quant``
quantizes them (``parallel.sharding.pad_for_tp``); a ``.npz`` must come
padded (``tools.repack --tp``). Everything the JAX CLI serves under a mesh
is served: ``--seq-parallel`` (sequence-parallel prefill), ``--prefix``
and ``--draft-model ngram`` with ``--batch-file``. A draft model, or
``ngram`` on one prompt, is refused under ``--mesh`` with the JAX CLI's
reason: single-prompt speculation is single-device.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import tempfile
from pathlib import Path

def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="zig-gpt2-torch", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("prompt", nargs="?", default=None, help="prompt text")
    p.add_argument("--model", default=None,
                   help="config name: 124M/355M/774M/1558M/nano/micro (default 124M)")
    p.add_argument("--weights", default=None,
                   help="raw checkpoint dir (e.g. models/124M/raw) or a .npz tree "
                        "(tools.repack)")
    p.add_argument("--encoder-dir", default=None, help="dir holding encoder.json + vocab.bpe")
    p.add_argument("--dtype", default="bf16", choices=["fp32", "bf16"], help="weight/activation dtype")
    p.add_argument("--temp", type=float, default=0.8, help="sampling temperature (0 = greedy)")
    p.add_argument("--top-k", type=int, default=None)
    p.add_argument("--top-p", type=float, default=None, help="nucleus sampling mass")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--max-tokens", type=int, default=None,
                   help="default: run to the end of the context window")
    p.add_argument("--max-seq", type=int, default=None)
    p.add_argument("--stop", default=None, metavar="TOK",
                   help="stop token: an id, or 'eos' for <|endoftext|>")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="write a torch.profiler trace to DIR/trace.json")
    p.add_argument("--metrics", action="store_true", help="print timing metrics to stderr")
    p.add_argument("--demo", action="store_true",
                   help="random weights + a tokenizer trained on the fly (no files "
                        "needed): a tiny model, or --model's shape when given")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--quant", default=None, choices=["int8", "int4", "w8a8"],
                   help="weight-only INT8 (per-channel) or INT4 (grouped), or w8a8 "
                        "(per-channel INT8 weights, per-row INT8 activations); the "
                        "lm_head is INT8")
    p.add_argument("--kv-quant", action="store_true", help="INT8 KV cache")
    p.add_argument("--batch-file", default=None, metavar="FILE",
                   help="serve a file of prompts (one per line) through the "
                        "continuous-batching scheduler instead of a single prompt")
    p.add_argument("--batch-slots", type=int, default=8,
                   help="decode slots for --batch-file serving")
    p.add_argument("--prefix", default=None, metavar="TEXT",
                   help="--batch-file: register TEXT as a shared prompt prefix (a system "
                        "prompt): prompts starting with it admit from its stored KV rows and "
                        "compute only their suffix")
    p.add_argument("--decode-chunk", type=int, default=None,
                   help="decode steps per host sync (default 1); with --draft-model ngram "
                        "and --batch-file, speculative rounds per host sync")
    p.add_argument("--draft-model", default=None, metavar="NAME",
                   help="speculative decoding: the draft's config name (e.g. 124M; with "
                        "--demo any name but ngram is a small random draft), or 'ngram' for "
                        "prompt lookup over the token history. The draft proposes --spec-k "
                        "tokens per round and the --model target verifies them in one pass. "
                        "Single-prompt, except that ngram composes with --batch-file")
    p.add_argument("--draft-weights", default=None,
                   help="the draft's raw checkpoint directory or .npz tree")
    p.add_argument("--draft-quant", default=None, choices=["int8", "int4"],
                   help="quantize the draft's weights")
    p.add_argument("--draft-kv-quant", action="store_true", help="INT8 KV cache for the draft")
    p.add_argument("--spec-k", type=int, default=4, help="draft tokens per speculative round")
    p.add_argument("--mesh", default=None, metavar="DPxTP",
                   help="serve over a data x model mesh of processes, e.g. '1x2'")
    p.add_argument("--backend", default="gloo", choices=["gloo", "nccl"],
                   help="--mesh: the process group's backend (nccl needs a card per rank)")
    p.add_argument("--seq-parallel", action="store_true",
                   help="--mesh: sequence-parallel prefill (the residual stream between the "
                        "linears split over the model ranks by position)")
    return p


def _parse_mesh(text: str):
    try:
        dp, tp = (int(x) for x in text.lower().split("x"))
    except ValueError:
        sys.exit(f"error: --mesh {text!r}: expected DPxTP, e.g. 1x2")
    if dp < 1 or tp < 1:
        sys.exit(f"error: --mesh {text!r}: both degrees must be positive")
    return dp, tp


def _load_encoder(args):
    from zig_gpt2_tpu_torch.tokenizer import Encoder

    d = Path(args.encoder_dir or f"models/{args.model or '124M'}")
    enc_json, bpe = d / "encoder.json", d / "vocab.bpe"
    if not enc_json.exists():
        sys.exit(f"error: {enc_json} not found (use --demo for a self-contained run)")
    return Encoder.from_files(enc_json, bpe if bpe.exists() else None,
                              mode="bpe" if bpe.exists() else "greedy")


def demo_model(args, dtype):
    """--demo: (config, encoder, params) with random weights from
    ``args.seed`` and a BPE trained on a fixed text plus the prompt: a tiny
    model, or ``args.model``'s shape with the vocab rows past the
    tokenizer's masked."""
    import torch

    from zig_gpt2_tpu_torch.config import GPTConfig, get_config
    from zig_gpt2_tpu_torch.models import gpt2
    from zig_gpt2_tpu_torch.tokenizer import Encoder, train_bpe

    demo_text = (
        "the quick brown fox jumps over the lazy dog. "
        "hello world, streaming tokens from a tiny random model. "
    ) * 4 + (args.prompt or "")
    vocab, merges = train_bpe(demo_text, vocab_size=320)
    if args.model is None:
        config = GPTConfig(vocab_size=len(vocab), context_size=256,
                           n_layers=2, n_heads=4, n_embed=128)
    else:
        full = get_config(args.model)
        config = dataclasses.replace(full, vocab_size=len(vocab),
                                     padded_vocab_size=full.vocab_rows)
    gen = torch.Generator(device=args.device).manual_seed(args.seed)
    return config, Encoder(vocab, merges), gpt2.init_params(config, gen, dtype)


def _layout(config) -> str:
    """The KV cache layout the runtime chose (``gpt2.default_kv_packed``)."""
    return "packed" if config.kv_packed else "unpacked"


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    if args.prompt is None and args.batch_file is None:
        sys.exit('error: missing prompt (usage: zig-gpt2-torch "<prompt>")')
    if args.mesh is None:
        return _serve(args)
    dp, tp = _parse_mesh(args.mesh)
    if args.draft_model is not None and not _spec_serve(args):
        sys.exit("error: --draft-model is single-prompt (only 'ngram' composes with "
                 "--batch-file) and single-device: no --mesh")
    if args.device == "cuda":
        import torch

        if not torch.cuda.is_available():
            sys.exit("error: no CUDA device (pass --device cpu to run on the CPU)")
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        if int(os.environ["WORLD_SIZE"]) != dp * tp:
            sys.exit(f"error: --mesh {args.mesh} needs {dp * tp} processes, WORLD_SIZE is "
                     f"{os.environ['WORLD_SIZE']}")
        return _mesh_rank(int(os.environ["RANK"]), args, dp, tp, None)
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory(prefix="zg2_mesh_") as tmp:
        mp.spawn(_mesh_rank, args=(args, dp, tp, f"file://{tmp}/rendezvous"), nprocs=dp * tp)


def _spec_serve(args) -> bool:
    """--draft-model ngram with --batch-file: prompt lookup inside the
    continuous batcher (one verify extend per round)."""
    return args.draft_model == "ngram" and args.batch_file is not None


def _mesh_rank(rank: int, args, dp: int, tp: int, init_method) -> None:
    """One rank of ``--mesh``: join the group (unless the process has
    joined one already, which it then leaves as it is), build the mesh on
    this rank's device, serve; only rank 0 writes to stdout and stderr."""
    import torch
    import torch.distributed as dist

    from zig_gpt2_tpu_torch.parallel import distributed as pdist
    from zig_gpt2_tpu_torch.parallel.mesh import make_mesh

    if rank != 0:
        sys.stdout = sys.stderr = open(os.devnull, "w")
    device = args.device
    if device == "cuda":
        device = f"cuda:{rank % torch.cuda.device_count()}"
        torch.cuda.set_device(device)
    joined_here = not dist.is_initialized()
    pdist.initialize(init_method, dp * tp, rank, backend=args.backend)
    try:
        _serve(args, make_mesh(dp, tp, device))
    finally:
        if joined_here:
            pdist.shutdown()


def _serve(args, mesh=None) -> None:
    """The CLI's serving body, on one device or as one rank of ``mesh``."""
    import torch

    from zig_gpt2_tpu_torch.config import SamplingConfig, get_config
    from zig_gpt2_tpu_torch.runtime.engine import GenerationMetrics, InferenceEngine
    from zig_gpt2_tpu_torch.utils.profiling import profiler_trace

    device = str(mesh.device) if mesh is not None else args.device
    # Under a mesh the whole tree stays on the host until each rank slices it.
    load_device = "cpu" if mesh is not None else args.device
    if args.device == "cuda":
        if not torch.cuda.is_available():
            sys.exit("error: no CUDA device (pass --device cpu to run on the CPU)")
        # fp32 runs in full f32, like the JAX package at "highest" precision.
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    dtype = torch.float32 if args.dtype == "fp32" else torch.bfloat16

    if args.demo:
        config, encoder, params = demo_model(args, dtype)
    else:
        config = get_config(args.model or "124M")
        encoder = _load_encoder(args)
        if args.weights is None:
            sys.exit("error: --weights required (or use --demo)")
        from zig_gpt2_tpu_torch.utils import io as zio

        if str(args.weights).endswith(".npz"):  # a repacked (quantized) tree, as stored
            params, meta = zio.load_pytree_npz(args.weights, device=load_device,
                                               with_meta=True)
            if meta and (meta.get("padded_heads") or meta.get("padded_vocab_size")):
                # padding baked into the stored layouts (the JAX repacker's --tp)
                config = dataclasses.replace(config, padded_heads=meta.get("padded_heads"),
                                             padded_vocab_size=meta.get("padded_vocab_size"))
        else:
            params = zio.load_gpt2_raw(args.weights, config, dtype=dtype, device=load_device)
    if args.quant and "lm_head" not in params:
        from zig_gpt2_tpu_torch.quant.quantize import quantize_params

        tp = 1
        if mesh is not None:  # pad first: the quantized layouts are born aligned for tp
            from zig_gpt2_tpu_torch.parallel.sharding import pad_for_tp

            tp = mesh.tp
            params, config = pad_for_tp(params, config, tp)
        params = quantize_params(params, mode="int8" if args.quant == "w8a8" else args.quant,
                                 tp=tp)
    if args.quant == "w8a8":
        config = dataclasses.replace(config, act_quant=True)
    if args.seq_parallel and mesh is not None:
        config = dataclasses.replace(config, seq_parallel=True)

    sampling = SamplingConfig(temperature=args.temp, top_k=args.top_k,
                              top_p=args.top_p, seed=args.seed)
    stop_tokens = []
    if args.stop is not None:
        if args.stop == "eos":
            eos = encoder.vocab.get("<|endoftext|>")
            if eos is None:
                sys.exit("error: tokenizer has no <|endoftext|> token")
            stop_tokens = [eos]
        else:
            stop_tokens = [int(args.stop)]

    kv_quant = "int8" if args.kv_quant else None
    device_name = torch.cuda.get_device_name(device) if args.device == "cuda" else "cpu"
    spec_serve = _spec_serve(args)
    if args.draft_model is not None and not spec_serve:
        if args.batch_file is not None:
            sys.exit("error: --draft-model is single-prompt (only 'ngram' composes with "
                     "--batch-file)")
        _speculate(args, config, params, encoder, sampling, stop_tokens, kv_quant, dtype,
                   device_name)
        return
    if args.batch_file is not None:
        from zig_gpt2_tpu_torch.runtime.batcher import ContinuousBatcher

        prompts = [line for line in Path(args.batch_file).read_text().splitlines() if line]
        spec_kw = {}
        if spec_serve:  # --decode-chunk N: N speculative rounds per host sync
            spec_kw = dict(speculative="ngram", spec_k=args.spec_k,
                           spec_chunk=args.decode_chunk or 1)
        batcher = ContinuousBatcher(config, params, batch_size=args.batch_slots,
                                    max_seq=args.max_seq, sampling=sampling, kv_quant=kv_quant,
                                    decode_chunk=1 if spec_serve else (args.decode_chunk or 1),
                                    device=device, mesh=mesh, **spec_kw)
        if args.prefix:
            batcher.register_prefix(encoder.encode(args.prefix))
        rid_to_prompt = {batcher.submit(encoder.encode(p), args.max_tokens, stop_tokens): p
                         for p in prompts}
        with profiler_trace(args.profile, args.device):
            done = batcher.run()
        for req in done:
            print(json.dumps({"prompt": rid_to_prompt[req.rid],
                              "completion": encoder.decode(req.generated)}))
        if args.metrics:
            print(json.dumps({"device": device_name, "kv_layout": _layout(batcher.config),
                              **batcher.metrics.as_dict(args.batch_slots)}),
                  file=sys.stderr)
        return

    engine = InferenceEngine(config, params, encoder, max_seq=args.max_seq,
                             decode_chunk=args.decode_chunk, device=device,
                             kv_quant=kv_quant, mesh=mesh)
    metrics = GenerationMetrics()
    print(args.prompt, end="", flush=True)
    with profiler_trace(args.profile, args.device):
        engine.generate_text(args.prompt, args.max_tokens, sampling, stream_to=sys.stdout,
                             metrics=metrics, stop_tokens=stop_tokens)
    print()
    if args.metrics:
        print(json.dumps({
            "device": device_name,
            "kv_layout": _layout(engine.config),
            "prompt_tokens": metrics.prompt_tokens,
            "generated_tokens": metrics.generated_tokens,
            "prefill_ms": round(metrics.prefill_ms, 3),
            "ms_per_token": round(metrics.ms_per_token, 3),
            "ms_per_token_p50": round(metrics.ms_per_token_percentile(50), 3),
            "ms_per_token_p99": round(metrics.ms_per_token_percentile(99), 3),
            "tokens_per_sec": round(metrics.tokens_per_sec, 2),
        }), file=sys.stderr)


def _speculate(args, config, params, encoder, sampling, stop_tokens, kv_quant, dtype,
               device_name) -> None:
    """--draft-model on one prompt: a SpeculativeEngine with the draft
    named (``ngram``: prompt lookup; with --demo any other name is a small
    random draft on the demo tokenizer), streamed to stdout."""
    import torch

    from zig_gpt2_tpu_torch.config import GPTConfig, get_config
    from zig_gpt2_tpu_torch.models import gpt2
    from zig_gpt2_tpu_torch.runtime.engine import GenerationMetrics
    from zig_gpt2_tpu_torch.runtime.speculative import SpeculativeEngine
    from zig_gpt2_tpu_torch.utils.profiling import profiler_trace

    draft_config = draft_params = None
    if args.draft_model == "ngram":
        pass
    elif args.demo:  # the target's vocab rows, so that both laws share V
        draft_config = GPTConfig(vocab_size=config.vocab_size,
                                 padded_vocab_size=config.padded_vocab_size,
                                 context_size=config.context_size, n_layers=1, n_heads=2,
                                 n_embed=64)
        gen = torch.Generator(device=args.device).manual_seed(args.seed + 1)
        draft_params = gpt2.init_params(draft_config, gen, dtype)
    else:
        draft_config = get_config(args.draft_model)
        if args.draft_weights is None:
            sys.exit("error: --draft-weights required with --draft-model (or use --demo)")
        from zig_gpt2_tpu_torch.utils import io as zio

        if str(args.draft_weights).endswith(".npz"):
            draft_params = zio.load_pytree_npz(args.draft_weights, device=args.device)
        else:
            draft_params = zio.load_gpt2_raw(args.draft_weights, draft_config, dtype=dtype,
                                             device=args.device)
    if args.draft_quant and draft_params is not None and "lm_head" not in draft_params:
        from zig_gpt2_tpu_torch.quant.quantize import quantize_params

        draft_params = quantize_params(draft_params, mode=args.draft_quant)
    spec = SpeculativeEngine(config, params, draft_config, draft_params, k=args.spec_k,
                             max_seq=args.max_seq, kv_quant=kv_quant,
                             draft_kv_quant="int8" if args.draft_kv_quant else None,
                             device=args.device)
    metrics = GenerationMetrics()
    print(args.prompt, end="", flush=True)
    with profiler_trace(args.profile, args.device):
        spec.generate_text(args.prompt, encoder, args.max_tokens, sampling,
                           stream_to=sys.stdout, metrics=metrics, stop_tokens=stop_tokens)
    print()
    if args.metrics:
        print(json.dumps({
            "device": device_name,
            "draft": args.draft_model,
            "spec_k": args.spec_k,
            "rounds": spec.last_rounds,
            "prompt_tokens": metrics.prompt_tokens,
            "generated_tokens": metrics.generated_tokens,
            "prefill_ms": round(metrics.prefill_ms, 3),
            "ms_per_token": round(metrics.ms_per_token, 3),
            "tokens_per_sec": round(metrics.tokens_per_sec, 2),
        }), file=sys.stderr)


if __name__ == "__main__":
    main()
