"""Batcher, from the clients' side: the window's tokens_per_s, kept as a
per-layer number in a cell whose runs spread too widely for a bound on it
(host clock, tokens/s)."""

import math


def read(w):
    v = w.end_to_end.get("tokens_per_s")
    return v if v is not None and math.isfinite(v) else None
