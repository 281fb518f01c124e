"""The device's idle share of the traced stretch: 1 - (the union of its
kernel and copy intervals / the stretch's seconds), in %."""


def read(record: dict):
    tw = record["trace"]
    if tw["window_s"] <= 0 or tw["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - tw["busy_s"] / tw["window_s"])
