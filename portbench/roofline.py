"""The yardstick's arithmetic: one H100's peaks, and the operations and bytes
that the work of a kernel call or a served token needs.

Peaks (NVIDIA's data sheet, H100 SXM, dense): HBM 3.35 TB/s; float32 on
the CUDA cores 67 TFLOP/s; bf16 on the tensor cores 989 TFLOP/s; int8 1979
TOP/s. A call's least time is the larger of its bytes over the bandwidth
and its operations over the peak of the unit that runs it. Bytes count
each input read once and each output written once, whatever a kernel reads
again. (The arithmetic of the repository's kernel tables, frozen here.)
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"float32": 67e12, "bfloat16": 989e12, "int8": 1979e12}
ACT_BYTES = {"float32": 4, "bfloat16": 2}


def least_seconds(ops: float, nbytes: float, peak: float) -> float:
    return max(nbytes / HBM_BYTES_PER_S, ops / peak)


def model_width(config: dict, d: int) -> int:
    """A dimension as the model has it: the packed KV layout pads an odd head
    count with a zero phantom head (1.5B: 25 heads of 64 -> 1664 columns of
    Q/K/V and rows of the attention c_proj); that padding is the program's
    and is no work the inputs need."""
    H, E = config["n_head"], config["n_embd"]
    return E if H % 2 and d == (H + 1) * (E // H) else d


def qmm_call(config: dict, body: str, k: int, n: int, rows: int) -> float:
    """Least seconds of one dequant-GEMV call ``rows`` x (K, N), at the
    model's widths (``model_width``): the weight
    (INT4 packed two to a byte, or INT8), its f32 scales (per group of
    ``int4_group[K]`` rows for INT4, per column for INT8), x in the
    activation dtype and the f32 output; products at the peak of the body
    that runs them (one row or f32 x: the CUDA cores; more bf16 rows: bf16
    tensor cores; the w8a8 body: int8)."""
    act = config["compute_dtype"]
    k, n = model_width(config, k), model_width(config, n)
    if body == "int4":
        groups = k // int(config["int4_group"][str(k)])
        weight = k * n / 2
    else:
        groups, weight = 1, k * n
    nbytes = weight + 4 * groups * n + rows * k * ACT_BYTES[act] + 4 * rows * n
    if body == "w8a8":
        peak = PEAK_OPS_PER_S["int8"]
    elif rows == 1 or act == "float32":
        peak = PEAK_OPS_PER_S["float32"]
    else:
        peak = PEAK_OPS_PER_S["bfloat16"]
    return least_seconds(2.0 * rows * k * n, nbytes, peak)


def kv_row_bytes(config: dict) -> float:
    """Bytes of one position's K and V in one layer's cache, scales included:
    H x D values each, one f32 scale per head or head pair for INT8."""
    H, E = config["n_head"], config["n_embd"]
    if config["kv_cache"] == "int8":
        scales = (H + 1) // 2 if config.get("kv_scale") == "head_pair" else H
        return 2 * (E + 4 * scales)
    return 2 * E * ACT_BYTES[config["compute_dtype"]]


def decode_attention_lane(config: dict, old_rows: int) -> float:
    """Least seconds of one lane's decode attention over all layers: the
    ``old_rows`` cached positions read once, the new row, q in and the
    output out; bound by bytes (a few operations per byte)."""
    E, L = config["n_embd"], config["n_layer"]
    act = ACT_BYTES[config["compute_dtype"]]
    nbytes = L * ((old_rows + 1) * kv_row_bytes(config) + 2 * E * act)
    return nbytes / HBM_BYTES_PER_S


def token_flops(config: dict, attended: int) -> float:
    """Model FLOPs of one token: 2 (12 L E^2 + V E) for the weights, 4 L E
    per attended position for the scores and the values."""
    L, E, V = config["n_layer"], config["n_embd"], config["vocab_size"]
    return 2.0 * (12 * L * E * E + V * E) + 4.0 * L * E * attended


def prompt_flops(config: dict, start: int, n: int) -> float:
    """Model FLOPs of prompt positions [start, n), causal."""
    L, E, V = config["n_layer"], config["n_embd"], config["vocab_size"]
    count = n - start
    attended = (n * (n + 1) - start * (start + 1)) / 2
    return 2.0 * (12 * L * E * E + V * E) * count + 4.0 * L * E * attended


def peak_flops(config: dict) -> float:
    return PEAK_OPS_PER_S[config["compute_dtype"]]
