"""Batcher: host time inside admissions (the program's BatcherMetrics.prefill_s:
prefill or prefix extend, splice and first draw, as dispatched) over the
window, %."""


def read(w):
    return 100.0 * w.counters["prefill_s"] / w.seconds
