"""Batcher: median over the traced steps of the batcher's own host time (the
program's ``batcher.step`` spans less the time their ``model.*`` and
``batcher.sync`` descendants cover: host arrays, pinned copies, cache
allocation, the splice, the draws, the bookkeeping), ms."""

import statistics

from portbench import program_spans


def _counted(name):
    return name.startswith("model.") or name == "batcher.sync"


def _outer_counted_under(records, j, root):
    """Whether record j is a counted span under ``root`` with no counted
    span between them."""
    if not _counted(records[j].name):
        return False
    p = records[j].parent
    while p is not None:
        if p == root:
            return True
        if _counted(records[p].name):
            return False
        p = records[p].parent
    return False


def read(w):
    got = program_spans.per_step(w)
    if got is None:
        return None
    records, steps = got
    own = []
    for spans in steps:
        roots = [i for i, r in spans if r.name == "batcher.step"]
        if not roots:
            continue
        total = 0.0
        for i in roots:
            covered = sum(r.t1 - r.t0 for j, r in spans if _outer_counted_under(records, j, i))
            total += records[i].t1 - records[i].t0 - covered
        own.append(1e3 * total)
    return statistics.median(own) if own else None
