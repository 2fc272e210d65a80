"""Milliseconds of one `sail.pack` (`Renderer._pack`: `Scene.pack` and
the copy to the card, once a frame that an orbit drag moved), the mean
over the traced sub-window's repacks."""
from perfbench import program_spans


def read(window):
    return program_spans.mean_ms(window.profile, "sail.pack")
