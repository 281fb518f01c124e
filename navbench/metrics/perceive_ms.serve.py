"""Mean synchronised time of one `Agent.perceive` call (one padded
batch) in the window, in ms (the traced run's spans)."""
from navbench.metrics import _window as _w


def read(record: dict):
    m = _w.mean(b - a for a, b in _w.spans_in(record, "perceive"))
    return None if m is None else m * 1e3
