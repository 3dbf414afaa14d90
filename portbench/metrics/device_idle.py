"""Device: share of the traced steps' time on the device clock (marker to
marker) in which no device op ran, %."""


def read(w):
    span = sum(st.span_s for st in w.steps)
    if span <= 0.0:
        return None
    return 100.0 * (1.0 - sum(st.busy_s for st in w.steps) / span)
