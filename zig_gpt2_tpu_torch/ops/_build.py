"""Build and load the package's CUDA kernels.

Every ``csrc/*.cu`` file is compiled by ``nvcc`` for ``sm_90a`` (one
process per source, all started together), the objects are linked into one
shared library with a plain C interface, and the library is loaded with
``ctypes``. The build happens at first use, into ``ops/build/`` (ignored by
git), under a name that carries a hash of the sources, the headers they
share (``csrc/*.cuh``) and the flags, so an edited source is rebuilt and an
unchanged one is loaded as it is.

Nothing here runs at import: the CPU tests import every module, and the CPU
has no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
# No -use_fast_math: the w8a8 body of qmm.cu needs IEEE division and
# rounding to stay bit-equal to its plain version.
NVCC_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C signatures of the library's entry points (every pointer and the stream
# as c_void_p, so ctypes never truncates one to 32 bits). The attention
# entry points take their operands, length, start (null for the prefix
# rows), out, the split scratch and tickets; B, H, S, D, layer, splits,
# chunk; scale; the dtype and packed codes; the stream.
_ATTENTION = [_I] * 7 + [_F, _I, _I, _P]
SIGNATURES = {
    "zg2_decode_attention_deferred": [_P] * 10 + _ATTENTION,
    "zg2_decode_attention_quant_deferred": [_P] * 14 + _ATTENTION,
    "zg2_decode_attention": [_P] * 8 + _ATTENTION,
    "zg2_decode_attention_quant": [_P] * 10 + _ATTENTION,
    "zg2_sample_categorical": [_P] * 8 + [_I] * 4 + [_F, _I, _P],
    "zg2_qmm": [_P] * 6 + [_I] * 9 + [_P],
    "zg2_qmm_w8a8": [_P] * 6 + [_I] * 8 + [_P],
    "zg2_wmm": [_P] * 5 + [_I] * 9 + [_P],
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    raise RuntimeError("nvcc not found: put the CUDA toolkit's bin on PATH "
                       "or set CUDA_HOME")


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest(sources: list[Path]) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def build() -> tuple[Path, float, str]:
    """Compile the kernels unless a library for these sources exists.
    Returns (library path, build seconds (0.0 when reused), compiler log)."""
    sources = _sources()
    lib = BUILD_DIR / f"libzg2_kernels_{_digest(sources)}.so"
    log_path = lib.with_suffix(".log")
    if lib.exists():
        return lib, 0.0, log_path.read_text() if log_path.exists() else ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [Path(tmp) / (src.stem + ".o") for src in sources]
        procs = [
            subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                             text=True)
            for src, obj in zip(sources, objs)
        ]
        logs = []
        failed = []
        for src, proc in zip(sources, procs):
            out, _ = proc.communicate()
            logs.append(f"== {src.name}\n{out}")
            if proc.returncode != 0:
                failed.append(src.name)
        if failed:
            raise RuntimeError(f"nvcc failed for {failed}:\n" + "\n".join(logs))
        staged = Path(tmp) / lib.name
        link = subprocess.run(
            [nvcc, *ARCH_FLAGS, "-shared", *map(str, objs), "-o", str(staged)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        log = "\n".join(logs)
        log_path.write_text(log)
        os.replace(staged, lib)  # atomic: a concurrent builder sees all or nothing
    return lib, time.perf_counter() - t0, log


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    path, _, _ = build()
    lib = ctypes.CDLL(str(path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


_TICKETS: dict = {}
_MIN_TICKETS = 4096


def tickets(device, n: int):
    """At least ``n`` int32 counters at 0 on ``device``, for the split
    combines of the attention, qmm and sampler kernels: the last block of each
    group sets its counter back to 0, so one tensor serves every launch on
    the stream. A larger request allocates a larger tensor; the older ones
    stay alive, since a captured CUDA graph may still hold their address."""
    import torch

    device = torch.device(device)
    held = _TICKETS.setdefault(device, [])
    if not held or held[-1].numel() < n:
        size = max(_MIN_TICKETS, 2 * n, 2 * held[-1].numel() if held else 0)
        held.append(torch.zeros(size, dtype=torch.int32, device=device))
    return held[-1]


def check(err: int, name: str) -> None:
    """Raise on a nonzero cudaError_t returned by a launch."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t {err}")
