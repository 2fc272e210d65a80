"""Host milliseconds a train step inside `sail.bisect` (the Alhazen
center and radial bisections of the mirror silhouette), in the traced
sub-window."""
from perfbench import program_spans


def read(window):
    return program_spans.ms_per_unit(window.profile, "sail.bisect")
