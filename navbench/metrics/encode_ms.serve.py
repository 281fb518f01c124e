"""Mean synchronised time of one `Agent.encode_text` call (one session's
instruction, from `NavServer.create_session`) in the window, in ms (the
traced run's spans, which the driver closes with a device synchronise)."""
from navbench.metrics import _window as _w


def read(record: dict):
    m = _w.mean(b - a for a, b in _w.spans_in(record, "encode_text"))
    return None if m is None else m * 1e3
