"""Batcher: occupied slot-steps over steps x slots in the window, % (the
program's BatcherMetrics counters)."""


def read(w):
    steps = w.counters["steps"]
    if not steps:
        return None
    return 100.0 * w.counters["occupied_slot_steps"] / (steps * w.batch)
