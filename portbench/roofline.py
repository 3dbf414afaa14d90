"""The yardstick's arithmetic: one H100's peaks, and the operations and bytes
that the work of a kernel call or a served token needs.

Peaks (NVIDIA's data sheet, H100 SXM, dense): HBM 3.35 TB/s; float32 on
the CUDA cores 67 TFLOP/s; bf16 on the tensor cores 989 TFLOP/s; int8 1979
TOP/s. A call's least time is the larger of its bytes over the bandwidth
and its operations over the peak of the unit that runs it. Bytes count
each input read once and each output written once, whatever a kernel reads
again. (The arithmetic of the repository's kernel tables, frozen here.)

What the work of a token or a kernel call is depends on the architecture:
each model family counts it (``portbench/families/<model_type>/model.py``),
and the functions below hand a configuration to its family's.
"""

from __future__ import annotations

from portbench.spec import family

HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"float32": 67e12, "bfloat16": 989e12, "int8": 1979e12}
ACT_BYTES = {"float32": 4, "bfloat16": 2}


def least_seconds(ops: float, nbytes: float, peak: float) -> float:
    return max(nbytes / HBM_BYTES_PER_S, ops / peak)


def qmm_call(config: dict, body: str, k: int, n: int, rows: int) -> float:
    """Least seconds of one dequant-GEMV call ``rows`` x (K, N) of the program."""
    return family(config).model.qmm_call(config, body, k, n, rows)


def decode_attention_lane(config: dict, old_rows: int) -> float:
    """Least seconds of one lane's decode attention over ``old_rows`` cached
    positions and its own, over all layers."""
    return family(config).model.decode_attention_lane(config, old_rows)


def token_flops(config: dict, attended: int) -> float:
    """Model FLOPs of one token that attends ``attended`` positions."""
    return family(config).model.token_flops(config, attended)


def prompt_flops(config: dict, start: int, n: int) -> float:
    """Model FLOPs of prompt positions [start, n), causal."""
    return family(config).model.prompt_flops(config, start, n)


def peak_flops(config: dict) -> float:
    return PEAK_OPS_PER_S[config["compute_dtype"]]
