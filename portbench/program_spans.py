"""The program's own span records (``zig_gpt2_tpu_torch.utils.profiling``:
kept while a ``torch.profiler`` session is active, so during the traced
stretches): those that lie inside a window's traced steps, for the per-layer
readers, and those of each stretch, for the trace's idle breakdown. A program that keeps no spans gives nothing, and so does a
window with no traced step."""

from __future__ import annotations


def records():
    """Every record the program keeps, in the order they began; None where
    the program keeps none."""
    try:
        from zig_gpt2_tpu_torch.utils import profiling

        return profiling.spans()
    except (ImportError, AttributeError):
        return None


def per_step(w):
    """(every record, per traced step [(index, record)] of those that lie
    inside it), or None where no record lies inside a traced step."""
    recs = records()
    if recs is None:
        return None
    steps = [[(i, r) for i, r in enumerate(recs) if st.t0 <= r.t0 and r.t1 <= st.t1]
             for st in w.steps]
    return (recs, steps) if any(steps) else None


def seconds(spans, name: str) -> float:
    return sum(r.t1 - r.t0 for _, r in spans if r.name == name)


def attr_sum(spans, names, attr: str) -> int:
    return sum(r.attrs[attr] for _, r in spans if r.name in names)
