"""Model step: median of the program's per-step decode dispatch + host sync
(BatcherMetrics.sync_ms) over the window's steps, ms."""

import statistics


def read(w):
    return statistics.median(w.sync_ms) if w.sync_ms else None
