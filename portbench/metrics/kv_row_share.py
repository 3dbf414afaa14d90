"""KV cache: cache rows that hold live tokens over the rows reserved, summed
over the traced steps' decode dispatches (the program's ``batcher.decode``
spans: ``kv_rows_live`` over ``kv_rows_reserved``), %."""

from portbench import program_spans

DECODE = ("batcher.decode",)


def read(w):
    got = program_spans.per_step(w)
    if got is None:
        return None
    live = sum(program_spans.attr_sum(s, DECODE, "kv_rows_live") for s in got[1])
    reserved = sum(program_spans.attr_sum(s, DECODE, "kv_rows_reserved") for s in got[1])
    if reserved <= 0:
        return None
    return 100.0 * live / reserved
