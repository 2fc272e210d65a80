"""K1's share of its roofline: the least time its frozen work count
(`work.k1_ops`, FP32 operations a frame) takes at 67 TFLOP/s, over K1's
device time a frame in the traced sub-window."""
from perfbench import opcount


def read(window):
    p = window.profile
    k1 = sum(s for _, s in p.kernels("render_block_kernel")) / p.n_units
    if k1 <= 0:
        return None
    bound_ms, _ = opcount.bound_ms(window.work["k1_ops"])
    return 100.0 * bound_ms * 1e-3 / k1
