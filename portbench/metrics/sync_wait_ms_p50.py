"""Model step: median over the traced steps of the host time the program
spends in its one host read a step (the program's ``batcher.sync`` span:
waiting for the card to finish the dispatched step), ms."""

import statistics

from portbench import program_spans


def read(w):
    got = program_spans.per_step(w)
    if got is None:
        return None
    waits = [1e3 * program_spans.seconds(spans, "batcher.sync") for spans in got[1]
             if any(r.name == "batcher.sync" for _, r in spans)]
    return statistics.median(waits) if waits else None
