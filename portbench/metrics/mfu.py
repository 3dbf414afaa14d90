"""Whole step: model FLOPs of every token the window processed (prompt and
output; portbench.roofline.token_flops, no padding) over the window's
seconds times the peak of the configuration's compute dtype, %."""

from portbench import roofline


def read(w):
    if not w.flops:
        return None
    return 100.0 * w.flops / (w.seconds * roofline.peak_flops(w.config))
