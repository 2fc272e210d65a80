"""K2's share of its roofline: the least time its frozen work count
(`work.k2_ops`, FP32 operations a step) takes at 67 TFLOP/s, over K2's
device time a step in the traced sub-window."""
from perfbench import opcount


def read(window):
    p = window.profile
    k2 = sum(s for _, s in p.kernels("render_grad_kernel")) / p.n_units
    if k2 <= 0:
        return None
    bound_ms, _ = opcount.bound_ms(window.work["k2_ops"])
    return 100.0 * bound_ms * 1e-3 / k2
