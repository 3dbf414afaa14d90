"""Model step: the share of the traced steps' decode steps (the program's
``model.decode_step`` spans) that replay the decode step's CUDA graph
(attribute ``graph`` 1; an eager step's reads 0), %. None where no span
carries the attribute: a program without the graph."""

from portbench import program_spans


def read(w):
    got = program_spans.per_step(w)
    if got is None:
        return None
    flags = [r.attrs.get("graph") for spans in got[1] for _, r in spans
             if r.name == "model.decode_step"]
    flags = [f for f in flags if f is not None]
    if not flags:
        return None
    return 100.0 * sum(f == 1 for f in flags) / len(flags)
