"""Byte-level BPE tokenizer (GPT-2), on the standard library alone.

The port's own copy of ``zig_gpt2_tpu.tokenizer.bpe``: merge-rank BPE over
OpenAI's GPT-2 pre-tokenizer, plus the reference's greedy longest-prefix
mode for parity tests. The JAX package compiles the pre-tokenizer with the
third-party ``regex`` module for ``\\p{L}`` and ``\\p{N}``; this copy uses
``re``, with the letter and number classes built once from
``unicodedata`` (categories L* and N*). ``\\d`` would not do: it misses
number characters such as '²', '½' and 'Ⅻ'. Whitespace is the ``regex``
module's ``\\s``, which unlike ``re``'s leaves out U+001C..U+001F. The two
agree wherever the interpreter's Unicode tables and the ``regex`` module's
agree (characters assigned only in a newer Unicode version may differ).

``Encoder(native=True)`` (the default) runs the merge loop in the C++ core
of ``zig_gpt2_tpu_torch.native`` where that loads, as the JAX package's
encoder does: only for ``mode="bpe"`` with contiguous ids, one native call
per new pre-token (its ids cached), and the Python core for a pre-token
holding a piece the vocab lacks. The ids are the same either way;
``native_active`` says which core runs.
"""

from __future__ import annotations

import functools
import json
import re
import sys
import unicodedata
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Tuple


def _char_class(pred) -> str:
    """A regex character-class body (no brackets) of every code point for
    which ``pred(char)`` holds, written as ranges."""
    parts = []
    start = prev = None
    for cp in range(sys.maxunicode + 1):
        if 0xD800 <= cp <= 0xDFFF or not pred(chr(cp)):
            continue
        if prev is not None and cp == prev + 1:
            prev = cp
            continue
        if start is not None:
            parts.append((start, prev))
        start = prev = cp
    if start is not None:
        parts.append((start, prev))
    esc = lambda cp: "\\U%08x" % cp  # noqa: E731
    return "".join(esc(a) if a == b else f"{esc(a)}-{esc(b)}" for a, b in parts)


@functools.lru_cache(maxsize=1)
def pretokenize_pattern() -> "re.Pattern[str]":
    """OpenAI's GPT-2 pre-tokenization pattern
    ``'s|'t|'re|'ve|'m|'ll|'d| ?\\p{L}+| ?\\p{N}+| ?[^\\s\\p{L}\\p{N}]+|\\s+(?!\\S)|\\s+``
    compiled with ``re`` (built once; it scans every code point)."""
    letters = _char_class(lambda c: unicodedata.category(c).startswith("L"))
    numbers = _char_class(lambda c: unicodedata.category(c).startswith("N"))
    space = _char_class(lambda c: c.isspace() and not "\x1c" <= c <= "\x1f")
    return re.compile(
        rf"""'s|'t|'re|'ve|'m|'ll|'d| ?[{letters}]+| ?[{numbers}]+"""
        rf"""| ?[^{space}{letters}{numbers}]+|[{space}]+(?![^{space}])|[{space}]+"""
    )


@functools.lru_cache(maxsize=1)
def bytes_to_unicode() -> Dict[int, str]:
    """The GPT-2 byte <-> printable-unicode table: printable latin-1 bytes
    map to themselves, the rest to 256 + offset."""
    bs = (list(range(ord("!"), ord("~") + 1)) + list(range(ord("\xa1"), ord("\xac") + 1))
          + list(range(ord("\xae"), ord("\xff") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, (chr(c) for c in cs)))


def _merge(word: Tuple[str, ...], a: str, b: str) -> Tuple[str, ...]:
    merged: List[str] = []
    i = 0
    while i < len(word):
        if i < len(word) - 1 and word[i] == a and word[i + 1] == b:
            merged.append(a + b)
            i += 2
        else:
            merged.append(word[i])
            i += 1
    return tuple(merged)


class Encoder:
    """Byte-level BPE encoder/decoder (merge-rank BPE, or the reference's
    greedy longest-prefix match with ``mode="greedy"``). ``native``: use
    the C++ merge core where it loads (see the module docstring)."""

    def __init__(self, vocab: Dict[str, int],
                 merges: Optional[Sequence[Tuple[str, str]]] = None,
                 mode: str = "bpe", native: bool = True):
        if mode not in ("bpe", "greedy"):
            raise ValueError(f"unknown mode {mode!r}")
        if mode == "bpe" and merges is None:
            raise ValueError("mode='bpe' requires merges (vocab.bpe)")
        self.vocab = dict(vocab)
        self.inv_vocab = {v: k for k, v in vocab.items()}
        self.merge_ranks = {tuple(m): i for i, m in enumerate(merges or ())}
        self.mode = mode
        self.byte_to_unicode = bytes_to_unicode()
        self.unicode_to_byte = {v: k for k, v in self.byte_to_unicode.items()}
        self._bpe_cache: Dict[str, Tuple[str, ...]] = {}
        self._native = self._init_native() if native and mode == "bpe" else None
        self._native_ids: Dict[str, List[int]] = {}

    @property
    def native_active(self) -> bool:
        """Whether the C++ merge core encodes (and decodes) for this encoder."""
        return self._native is not None

    def _to_bytes(self, token: str) -> Optional[bytes]:
        """A unicode-space token's bytes (None if a character is unmapped)."""
        try:
            return bytes(self.unicode_to_byte[ch] for ch in token)
        except KeyError:
            return None

    def _init_native(self):
        """The C++ core over this vocab, or None: ids that are not
        0..len-1 (the core indexes tokens by id), an unmapped token, or no
        library."""
        from zig_gpt2_tpu_torch.native import NativeBPE, load_bpe

        if sorted(self.vocab.values()) != list(range(len(self.vocab))):
            return None
        vocab_bytes = [self._to_bytes(t) for t in sorted(self.vocab, key=self.vocab.get)]
        merge_bytes = [(self._to_bytes(a), self._to_bytes(b))
                       for a, b in sorted(self.merge_ranks, key=self.merge_ranks.get)]
        if (any(t is None for t in vocab_bytes)
                or any(a is None or b is None for a, b in merge_bytes) or load_bpe() is None):
            return None
        return NativeBPE(vocab_bytes, merge_bytes)

    @classmethod
    def from_files(cls, encoder_json, vocab_bpe=None, mode: str = "bpe") -> "Encoder":
        """Load OpenAI-format files (encoder.json + vocab.bpe)."""
        with open(encoder_json, encoding="utf-8") as f:
            vocab = json.load(f)
        merges = None
        if vocab_bpe is not None:
            lines = Path(vocab_bpe).read_text(encoding="utf-8").split("\n")
            merges = [tuple(l.split()) for l in lines if l and not l.startswith("#")]
        return cls(vocab, merges, mode=mode)

    def _bpe(self, token: str) -> Tuple[str, ...]:
        """Apply merges in rank order to one pre-token."""
        cached = self._bpe_cache.get(token)
        if cached is not None:
            return cached
        word: Tuple[str, ...] = tuple(token)
        while len(word) > 1:
            pairs = set(zip(word, word[1:]))
            best = min(pairs, key=lambda p: self.merge_ranks.get(p, 1 << 60))
            if best not in self.merge_ranks:
                break
            word = _merge(word, *best)
        self._bpe_cache[token] = word
        return word

    def _greedy(self, token: str) -> List[str]:
        """The reference's greedy longest-prefix match."""
        pieces = []
        start = 0
        while start < len(token):
            end = len(token)
            while end > start and token[start:end] not in self.vocab:
                end -= 1
            if end == start:
                end = start + 1
            pieces.append(token[start:end])
            start = end
        return pieces

    def encode(self, text: str) -> List[int]:
        ids: List[int] = []
        for pre in pretokenize_pattern().findall(text):
            if self._native is not None:
                cached = self._native_ids.get(pre)
                if cached is None:
                    cached = self._native.encode_words([pre.encode("utf-8")])
                    if cached is None:  # a piece the vocab lacks: the Python core
                        cached = [self.vocab[p] for p in self._bpe(
                            "".join(self.byte_to_unicode[b] for b in pre.encode("utf-8")))]
                    self._native_ids[pre] = cached
                ids.extend(cached)
                continue
            mapped = "".join(self.byte_to_unicode[b] for b in pre.encode("utf-8"))
            pieces = self._bpe(mapped) if self.mode == "bpe" else self._greedy(mapped)
            ids.extend(self.vocab[p] for p in pieces)
        return ids

    def decode(self, ids: Iterable[int]) -> str:
        return self.decode_bytes(ids).decode("utf-8", errors="replace")

    def decode_bytes(self, ids: Iterable[int]) -> bytes:
        """Lossless byte decode (a stream decoder buffers partial UTF-8)."""
        ids = list(ids)
        if self._native is not None:
            out = self._native.decode(ids)
            if out is not None:
                return out
        text = "".join(self.inv_vocab[i] for i in ids)
        return bytes(self.unicode_to_byte[ch] for ch in text)

    def __len__(self) -> int:
        return len(self.vocab)


def train_bpe(text: str, vocab_size: int) -> Tuple[Dict[str, int], List[Tuple[str, str]]]:
    """Train a byte-level BPE vocab on ``text`` by greedy pair-frequency
    merging (for self-contained demos and tests, not production)."""
    b2u = bytes_to_unicode()
    vocab = {ch: i for i, ch in enumerate(sorted(b2u.values()))}
    if vocab_size < len(vocab):
        raise ValueError(f"vocab_size must be >= {len(vocab)} (byte alphabet)")
    words: Dict[Tuple[str, ...], int] = {}
    for pre in pretokenize_pattern().findall(text):
        mapped = tuple(b2u[b] for b in pre.encode("utf-8"))
        words[mapped] = words.get(mapped, 0) + 1
    merges: List[Tuple[str, str]] = []
    while len(vocab) < vocab_size:
        counts: Dict[Tuple[str, str], int] = {}
        for word, freq in words.items():
            for pair in zip(word, word[1:]):
                counts[pair] = counts.get(pair, 0) + freq
        if not counts:
            break
        best = max(counts, key=lambda p: (counts[p], p))
        merges.append(best)
        vocab[best[0] + best[1]] = len(vocab)
        new_words: Dict[Tuple[str, ...], int] = {}
        for word, freq in words.items():
            key = _merge(word, *best)
            new_words[key] = new_words.get(key, 0) + freq
        words = new_words
    return vocab, merges
