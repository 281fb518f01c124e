"""The reference module of a stand-in architecture, named by a
configuration file under `reference`: ETPNav's reference with a text
encoder whose memory is one higher everywhere, so a sound run of the
program reads wrong against it."""

from navbench.reference.model import Drop
from navbench.reference.model import Ref as _Ref

__all__ = ["Drop", "Ref"]


class Ref(_Ref):

    def encode_text(self, ids, mask, drop=None):
        return super().encode_text(ids, mask, drop) + 1.0
