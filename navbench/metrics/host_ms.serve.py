"""Per batch, the batcher's `_process` time less its two device
programs (perceive, score_navigation): the host map's updates, the graph
emission and the action translation, in ms (the traced run's spans)."""
from navbench.metrics import _window as _w


def read(record: dict):
    inner = _w.spans_in(record, "perceive") + _w.spans_in(record, "score")
    own = []
    for a, b in _w.spans_in(record, "process"):
        kids = sum(e - s for s, e in inner if a <= s and e <= b)
        own.append(b - a - kids)
    m = _w.mean(own)
    return None if m is None else m * 1e3
