"""Milliseconds a train step in which the device ran nothing while
the host was inside `sail.edge_terms` (`full_boundary_term`): how long
the card waited on the edge terms' host work, in the traced sub-window."""
from perfbench import program_spans


def read(window):
    return program_spans.idle_ms_per_unit(window.profile, "sail.edge_terms")
