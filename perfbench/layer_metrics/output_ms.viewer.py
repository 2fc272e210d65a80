"""Milliseconds a frame in `Renderer.output` (the display filter and the
copy to the host), the benchmark's span, mean over the window's frames."""


def read(window):
    t = window.spans.get("output")
    return sum(t) / len(t) * 1e3 if t else None
