"""The port's native BPE core (``zig_gpt2_tpu_torch.native``: the
repository's ``native/bpe.cpp`` built by the port's own loader, driven
through ctypes) against the Python core and the JAX package's encoder.

The four cases of ``tests/test_native.py`` run on the port's tokenizer and
loader; the port's ids equal the JAX ``Encoder``'s (its Python core, which
its own test holds equal to its native one), with the port's core native
and Python, on that corpus and on a BPE trained here. Concurrent first
builds into one directory all load a whole library (the build renames a
finished file into place).

These tests skip only on a host without a C++ compiler; where one is on
the PATH, a library that does not build or load fails them.
"""

import subprocess
import sys
from pathlib import Path

import pytest

from zig_gpt2_tpu.tokenizer import bpe as jbpe
from zig_gpt2_tpu_torch import native
from zig_gpt2_tpu_torch.tokenizer import Encoder, train_bpe

pytestmark = pytest.mark.skipif(native.toolchain() is None, reason="no C++ compiler on the PATH")

CORPUS = (
    "the quick brown fox jumps over the lazy dog. "
    "Hello, world!  multiple  spaces\tand\nnewlines. "
    "numbers 12345 and punctuation?!... "
    "unicode: héllo wörld — naïve café 日本語 emoji 🎉🎊 "
    "contractions: don't we'll i'm you've she'd it's "
) * 3
TEXTS = [CORPUS, "edge;;;cases---with***rare^^^sequences", "a", " ",
         "   leading and trailing   ", "ünïcödé ☃ snowman", ""]
OTHER = ("a trained vocabulary of another text: tokenizers merge frequent pairs, "
         "1234 5678 ½ ² Ⅻ — «quotes» and 'apostrophes' ") * 4


@pytest.fixture(scope="module")
def encoders():
    vocab, merges = train_bpe(CORPUS, vocab_size=600)
    py = Encoder(vocab, merges, native=False)
    nat = Encoder(vocab, merges, native=True)
    assert nat.native_active, f"native encoder failed to initialize: {native.load_error()}"
    assert not py.native_active
    return py, nat


def test_encode_parity(encoders):
    py, nat = encoders
    for text in TEXTS:
        assert nat.encode(text) == py.encode(text), repr(text)


def test_decode_parity_and_roundtrip(encoders, rng):
    py, nat = encoders
    ids = py.encode(CORPUS)
    assert nat.decode(ids) == py.decode(ids)
    assert nat.decode_bytes(ids) == py.decode_bytes(ids)
    assert nat.decode(ids) == CORPUS
    rand_ids = [int(i) for i in rng.integers(0, len(py.vocab), 200)]
    assert nat.decode_bytes(rand_ids) == py.decode_bytes(rand_ids)


def test_native_bpe_direct(encoders):
    py, nat = encoders
    words = [b"the", b" quick", b" unknownishword", b"\xf0\x9f\x8e\x89"]
    want = []
    for w in words:
        mapped = "".join(py.byte_to_unicode[b] for b in w)
        want.extend(py.vocab[p] for p in py._bpe(mapped))
    assert nat._native.encode_words(words) == want


def test_native_rejects_noncontiguous_vocab():
    vocab, merges = train_bpe("abcabc", vocab_size=260)
    gappy = {t: (i if i < 5 else i + 7) for t, i in vocab.items()}
    enc = Encoder(gappy, merges, native=True)
    assert not enc.native_active  # the Python core instead
    assert enc.encode("abc")


@pytest.mark.parametrize("use_native", [True, False], ids=["native", "python"])
@pytest.mark.parametrize("corpus", ["test-native-corpus", "trained-here"])
def test_ids_equal_jax_encoder(use_native, corpus):
    text = CORPUS if corpus == "test-native-corpus" else OTHER
    vocab, merges = train_bpe(text, vocab_size=700)
    jvocab, jmerges = jbpe.train_bpe(text, vocab_size=700)
    assert vocab == jvocab and merges == jmerges
    port = Encoder(vocab, merges, native=use_native)
    assert port.native_active == use_native
    jax_enc = jbpe.Encoder(jvocab, jmerges, native=False)
    for t in TEXTS + [OTHER, text[::-1]]:
        ids = port.encode(t)
        assert ids == jax_enc.encode(t), repr(t[:40])
        assert port.decode_bytes(ids) == jax_enc.decode_bytes(ids)


def test_unknown_piece_falls_back_per_word():
    """A merge whose result the vocab lacks: the native core refuses the
    word (-1), the encoder takes its Python core for it, which raises
    KeyError as the Python-only encoder does (the JAX package's
    behaviour)."""
    vocab, merges = train_bpe(CORPUS, vocab_size=300)
    a, b = merges[0]
    del vocab[a + b]  # the first merge's token: ids stay unique but not contiguous
    vocab = {t: i for i, t in enumerate(sorted(vocab, key=vocab.get))}
    with pytest.raises(KeyError):
        Encoder(vocab, merges, native=False).encode(CORPUS)
    nat = Encoder(vocab, merges, native=True)
    assert nat.native_active
    with pytest.raises(KeyError):
        nat.encode(CORPUS)


def test_concurrent_first_builds_load_whole_libraries(tmp_path):
    """Four processes build into one empty directory at once: each loads a
    whole library and no temporary file is left."""
    code = ("import sys; from pathlib import Path; import zig_gpt2_tpu_torch.native as n; "
            "n.LIB_DIR = Path(sys.argv[1]); lib = n.load_bpe(); "
            "assert lib is not None, n.load_error(); print(n.library_path().name)")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path)], text=True,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for _ in range(4)]
    outs = [p.communicate(timeout=300)[0] for p in procs]
    assert all(p.returncode == 0 for p in procs), outs
    assert len({o.strip() for o in outs}) == 1
    assert sorted(f.name for f in tmp_path.iterdir()) == [outs[0].strip()]


def test_library_is_built_into_the_port(encoders):
    """The library lies in the port's ``native/lib`` (ignored by git); the
    repository's ``native/`` holds its two sources only."""
    assert native.library_path().exists()
    assert native.LIB_DIR == Path(native.__file__).parent / "lib"
    assert sorted(f.name for f in native.SOURCE.parent.iterdir()) == ["Makefile", "bpe.cpp"]
