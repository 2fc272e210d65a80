"""Host milliseconds a frame inside `sail.deflate` (the PNG encode of
`png_bytes`: zlib at level 6), in the traced sub-window."""
from perfbench import program_spans


def read(window):
    return program_spans.ms_per_unit(window.profile, "sail.deflate")
