"""Model step: device kernels (not copies or fills) per batcher step, over the
traced steps (marker kernels excluded)."""

from portbench.trace import is_kernel


def read(w):
    if not w.steps:
        return None
    n = sum(1 for st in w.steps for name, _ in st.kernels if is_kernel(name))
    return n / len(w.steps)
