"""Batcher: padding rows over all rows the traced steps' admissions compute
(the program's ``batcher.admit_group`` and ``batcher.admit_prefix`` spans:
k lanes x bucket = prompt or suffix rows + padded rows), %."""

from portbench import program_spans

ADMISSIONS = ("batcher.admit_group", "batcher.admit_prefix")


def read(w):
    got = program_spans.per_step(w)
    if got is None:
        return None
    padded = sum(program_spans.attr_sum(s, ADMISSIONS, "padded") for s in got[1])
    rows = sum(program_spans.attr_sum(s, ADMISSIONS, "rows") for s in got[1])
    if padded + rows <= 0:
        return None
    return 100.0 * padded / (padded + rows)
