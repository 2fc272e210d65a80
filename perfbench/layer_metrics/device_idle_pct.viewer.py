"""The share of the traced sub-window in which no operation ran on the
device: 100 − the union of device activity over the window's length."""


def read(window):
    p = window.profile
    return 100.0 * (1.0 - p.busy_s / p.window_s)
