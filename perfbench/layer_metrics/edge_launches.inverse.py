"""Kernel launch calls a train step whose start lies inside
`sail.edge_terms` (`full_boundary_term`), in the traced sub-window: an
exact count (0 on a host without a card)."""
from perfbench import program_spans


def read(window):
    return program_spans.launches_per_unit(window.profile,
                                           "sail.edge_terms")
