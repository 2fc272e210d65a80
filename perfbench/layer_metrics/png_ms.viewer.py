"""Milliseconds a frame in `png_bytes`, the benchmark's span, mean over
the window's frames."""


def read(window):
    t = window.spans.get("png")
    return sum(t) / len(t) * 1e3 if t else None
