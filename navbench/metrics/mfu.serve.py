"""The whole step's share of the chip's peak: the least time the
window's model work could take at peak (FLOPs counted from the shapes
that ran, `navbench/work/model.py`, each part at its precision's peak)
over the window's seconds, in %."""
from navbench.common import PEAK_FLOPS
from navbench.work import model as _work


def read(record: dict):
    if not record["work"] or record["window_s"] <= 0:
        return None
    return 100.0 * _work.seconds_at_peak(record["work"], PEAK_FLOPS) \
        / record["window_s"]
