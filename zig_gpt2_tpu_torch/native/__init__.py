"""The host-native BPE core (C++ through ctypes).

The port's counterpart of ``zig_gpt2_tpu.native``: the merge-rank BPE loop
of the repository's ``native/bpe.cpp`` (the C ABI ``zg2_bpe_create``,
``zg2_bpe_encode_words``, ``zg2_bpe_decode``, ``zg2_bpe_destroy``), built
into a shared library on first use and driven by ``NativeBPE``. The
tokenizer (``tokenizer.bpe.Encoder(native=True)``) uses it where it loads
and keeps its Python core otherwise, with the same ids either way.

The library is built with the C++ compiler alone (``$CXX``, default
``g++``, the flags of ``native/Makefile``) into ``native/lib/`` of this
package, named by a hash of the source and the flags, so that a changed
source is rebuilt and nothing is written into the repository's
``native/``. The compiler writes a temporary file in the same directory,
which is then renamed over the library's name: a concurrent process (a
parallel test worker) loads either nothing or the whole library, never a
half-written one.

``load_bpe()`` returns None when no compiler is on the PATH (a host without
a toolchain keeps the Python core); when a compiler is there and the build
or the load fails, ``load_error()`` says why. ``toolchain()`` names the
compiler found.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np

SOURCE = Path(__file__).resolve().parents[2] / "native" / "bpe.cpp"
LIB_DIR = Path(__file__).parent / "lib"
CXX_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-shared")

_lib: Optional[ctypes.CDLL] = None
_error: Optional[str] = None


def toolchain() -> Optional[str]:
    """The C++ compiler's path (``$CXX`` or ``g++``), or None."""
    return shutil.which(os.environ.get("CXX", "g++"))


def library_path() -> Path:
    """Where the library for this source and these flags lives."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return LIB_DIR / f"libzg2bpe_{h.hexdigest()[:16]}.so"


def _build(cxx: str, lib: Path) -> None:
    """Compile into a temporary file beside ``lib`` and rename it over
    ``lib`` (atomic within one directory)."""
    LIB_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=LIB_DIR, prefix=".build_", suffix=".so")
    os.close(fd)
    try:
        proc = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, str(SOURCE)],
                              capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(f"{cxx} failed on {SOURCE.name}:\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def load_bpe() -> Optional[ctypes.CDLL]:
    """The native BPE library, built first if needed; None when it cannot
    be had (no compiler, or see ``load_error()``). Tried once per process."""
    global _lib, _error
    if _lib is not None or _error is not None:
        return _lib
    cxx = toolchain()
    if cxx is None:
        _error = "no C++ compiler on the PATH"
        return None
    try:
        lib_path = library_path()
        if not lib_path.exists():
            _build(cxx, lib_path)
        lib = ctypes.CDLL(str(lib_path))
    except (OSError, RuntimeError, subprocess.SubprocessError) as e:
        _error = f"{type(e).__name__}: {e}"
        return None
    lib.zg2_bpe_create.restype = ctypes.c_void_p
    lib.zg2_bpe_create.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
    ]
    lib.zg2_bpe_destroy.argtypes = [ctypes.c_void_p]
    lib.zg2_bpe_encode_words.restype = ctypes.c_int64
    lib.zg2_bpe_encode_words.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int64, ctypes.POINTER(ctypes.c_int32),
    ]
    lib.zg2_bpe_decode.restype = ctypes.c_int64
    lib.zg2_bpe_decode.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
        ctypes.c_char_p, ctypes.c_int64,
    ]
    _lib = lib
    return _lib


def load_error() -> Optional[str]:
    """Why ``load_bpe()`` returned None, or None if it did not."""
    return _error


def _pack(strings: Sequence[bytes]) -> Tuple[bytes, np.ndarray]:
    blob = b"".join(strings)
    offsets = np.cumsum([len(s) for s in strings]).astype(np.int64)
    return blob, offsets


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


class NativeBPE:
    """ctypes handle around the C++ merge-rank core. Byte space throughout:
    the caller maps the GPT-2 unicode-space vocab and merges back to bytes
    first. ``vocab[i]`` is the token of id i."""

    def __init__(self, vocab: Sequence[bytes], merges: Sequence[Tuple[bytes, bytes]]):
        lib = load_bpe()
        if lib is None:
            raise RuntimeError(f"native BPE library unavailable: {load_error()}")
        self._lib = lib
        tok_blob, tok_off = _pack(list(vocab))
        mrg_blob, mrg_off = _pack([part for pair in merges for part in pair])
        self._handle = lib.zg2_bpe_create(tok_blob, _ptr(tok_off, ctypes.c_int64), len(vocab),
                                          mrg_blob, _ptr(mrg_off, ctypes.c_int64),
                                          len(merges))
        if not self._handle:
            raise RuntimeError("zg2_bpe_create failed")

    def __del__(self):
        handle = getattr(self, "_handle", None)
        if handle:
            self._lib.zg2_bpe_destroy(handle)
            self._handle = None

    def encode_words(self, words: Sequence[bytes]) -> Optional[List[int]]:
        """BPE ids of pre-tokenized byte words, or None when a word holds a
        piece the vocab lacks (the caller then takes its Python core)."""
        if not words:
            return []
        blob, offsets = _pack(list(words))
        out = np.empty(len(blob), np.int32)
        n = self._lib.zg2_bpe_encode_words(self._handle, blob,
                                           _ptr(offsets, ctypes.c_int64), len(words),
                                           _ptr(out, ctypes.c_int32))
        return None if n < 0 else out[:n].tolist()

    def decode(self, ids: Sequence[int]) -> Optional[bytes]:
        """The bytes of ``ids``, or None when an id is out of the vocab."""
        arr = np.asarray(list(ids), np.int32)
        cap = 16 + 64 * max(len(arr), 1)
        for _ in range(4):
            buf = ctypes.create_string_buffer(cap)
            n = self._lib.zg2_bpe_decode(self._handle, _ptr(arr, ctypes.c_int32), len(arr),
                                         buf, cap)
            if n >= 0:
                return buf.raw[:n]
            cap *= 8
        return None
