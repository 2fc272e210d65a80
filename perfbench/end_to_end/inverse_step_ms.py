"""Milliseconds a train step: the window over the steps it completed."""


def read(window):
    return window.seconds / len(window.units) * 1e3
