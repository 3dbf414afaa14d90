"""Batcher, from the clients' side: the window's itl_ms_p95, kept as a
per-layer number in a cell whose runs spread too widely for a bound on it
(host clock, ms)."""

import math


def read(w):
    v = w.end_to_end.get("itl_ms_p95")
    return v if v is not None and math.isfinite(v) else None
