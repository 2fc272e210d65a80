"""Host milliseconds a train step inside `sail.edge_backward` (the
backward pass through each edge term's scalar), in the traced
sub-window."""
from perfbench import program_spans


def read(window):
    return program_spans.ms_per_unit(window.profile, "sail.edge_backward")
