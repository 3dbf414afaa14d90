"""Kernels: the dequant GEMV ``qmm`` (quant/kernels.py, ops/csrc/qmm.cu). Its
least time for the calls of the traced steps (the program's qmm.by_shape
over each step: body, K, N, rows; portbench.roofline.qmm_call) over its
device time in those steps, %."""

from portbench import roofline

KERNELS = ("qmm_simt_kernel", "qmm_mma_kernel", "qmm_w8a8_kernel")


def read(w):
    bound = spent = 0.0
    for st in w.steps:
        spent += sum(sec for name, sec in st.kernels if any(k in name for k in KERNELS))
        bound += sum(count * roofline.qmm_call(w.config, *shape)
                     for shape, count in st.qmm_calls.items())
    if spent <= 0.0 or bound <= 0.0:
        return None
    return 100.0 * bound / spent
