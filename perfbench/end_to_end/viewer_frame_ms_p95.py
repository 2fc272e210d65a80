"""The 95th percentile of every frame's latency in the window (render,
output and PNG, to the host), in milliseconds."""
import numpy as np


def read(window):
    return float(np.percentile([(u["t1"] - u["t0"]) * 1e3
                                for u in window.units], 95))
