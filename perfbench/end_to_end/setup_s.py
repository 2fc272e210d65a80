"""Seconds from the start of the process to the first timed call."""


def read(window):
    return window.setup_s
