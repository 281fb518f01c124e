"""Shared arithmetic of the per-layer readers."""


def spans_in(record: dict, name: str) -> list:
    """(start, end) of the `name` spans that started in the window."""
    t0, t1 = record["t0"], record["t_end"]
    return [(a, b) for a, b in record["spans"].get(name, ()) if t0 <= a < t1]


def mean(xs):
    xs = list(xs)
    return sum(xs) / len(xs) if xs else None
