"""Kernels: decode attention (ops/attention.py, ops/csrc/decode_attention.cu).
The least time to read each live lane's cached K/V rows and scales once per
layer, the rows counted from the harness's own bookkeeping of each request
(portbench.roofline.decode_attention_lane), over the kernel's device time
in the traced steps, %."""

from portbench import roofline

KERNELS = ("decode_attention_kernel",)


def read(w):
    bound = spent = 0.0
    for st, rows in zip(w.steps, w.step_tokens):
        spent += sum(sec for name, sec in st.kernels if any(k in name for k in KERNELS))
        bound += sum(roofline.decode_attention_lane(w.config, r) for r in rows)
    if spent <= 0.0 or bound <= 0.0:
        return None
    return 100.0 * bound / spent
