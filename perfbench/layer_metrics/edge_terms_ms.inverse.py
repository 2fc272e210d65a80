"""Host milliseconds a train step inside `sail.edge_terms`
(`full_boundary_term`: the silhouette and penumbra terms), the program's
range in the traced sub-window."""
from perfbench import program_spans


def read(window):
    return program_spans.ms_per_unit(window.profile, "sail.edge_terms")
