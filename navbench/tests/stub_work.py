"""The FLOP-count module of a stand-in architecture, named by a
configuration file under `work`: ETPNav's count with `STUB_FLOPS` more
fp32 FLOPs in every `text` count."""

from collections import Counter

from navbench.work import model as _etpnav
from navbench.work.model import nav, perceive, train_step

__all__ = ["STUB_FLOPS", "nav", "perceive", "text", "train_step"]

# far above any tiny run's own count, so that it shows in the total
STUB_FLOPS = 2.0 ** 70


def text(m: dict, B: float, L: int) -> Counter:
    return _etpnav.text(m, B, L) + Counter({"fp32": STUB_FLOPS})
