"""Instruction token sequences drawn from the configuration's `assumed`
length list, and other fixed lists of sizes: every seed uses the same
sizes, in its own order."""

from __future__ import annotations

import numpy as np


class Cycle:
    """The values of a fixed list, in a new order of the seed's each time
    the list is used up."""

    def __init__(self, values, rng):
        self.values, self.rng, self.order = list(values), rng, []

    def next(self):
        if not self.order:
            self.order = list(self.rng.permutation(self.values))
        return self.order.pop()


class Instructions:
    def __init__(self, assumed: dict, vocab_size: int, rng):
        spec = assumed["instruction_tokens"]
        self.lengths = Cycle(spec["lengths"], rng)
        self.cls, self.sep = spec["cls_id"], spec["sep_id"]
        self.lo = spec["first_word_id"]
        self.vocab = vocab_size
        self.rng = rng

    def next(self) -> np.ndarray:
        """[CLS] words [SEP], of the next length of the seed's cycle."""
        n = int(self.lengths.next())
        words = self.rng.integers(self.lo, self.vocab, n - 2)
        return np.concatenate([[self.cls], words, [self.sep]]).astype(
            np.int64)
