"""Seeded weights for both sides of a cell: the program under test and the
plain reference get the same tensors, made here from `--seed`.

The names and shapes come from the model's parameter table (a list of
(name, shape) pairs). Every value is drawn on the device in one
`torch.randn` call of the whole parameter count, then cut into leaves
and scaled by kind:

- convolution kernels (4-D): He normal, sqrt(2 / fan_in);
- LayerNorm / GroupNorm scales: 1 + 0.02 N(0, 1); their shifts 0.02 N;
- every other tensor (dense weights and biases, embedding tables, CLIP's
  class and positional embeddings and projection): 0.02 N.

Norm parameters are found by their module's name (`ln`, `ln_1`,
`dep_ln`, `norm1`, `gn1`, `stem_gn`, ...).
"""

from __future__ import annotations

import math
import re
from typing import Dict, List, Sequence, Tuple

import torch

Table = List[Tuple[str, Tuple[int, ...]]]

_NORM = re.compile(r"(^|_)(ln|gn|norm)")


def kind(name: str, shape: Sequence[int]) -> str:
    """'conv', 'norm_scale', 'norm_shift' or 'dense' for one leaf."""
    parts = name.split(".")
    parent = parts[-2] if len(parts) > 1 else ""
    if len(shape) == 4:
        return "conv"
    if len(shape) == 1 and _NORM.search(parent):
        return "norm_scale" if parts[-1] == "weight" else "norm_shift"
    return "dense"


def make_weights(table: Table, seed: int,
                 device: torch.device) -> Dict[str, torch.Tensor]:
    """{name: fp32 tensor on `device`} for every leaf of `table`, from
    `seed` alone: the same seed and device give the same tensors."""
    g = torch.Generator(device=device).manual_seed(int(seed))
    total = sum(math.prod(s) for _, s in table)
    flat = torch.randn(total, generator=g, device=device)
    out, at = {}, 0
    for name, shape in table:
        n = math.prod(shape)
        t = flat[at:at + n].view(shape)
        at += n
        k = kind(name, shape)
        if k == "conv":
            t.mul_(math.sqrt(2.0 / (shape[1] * shape[2] * shape[3])))
        elif k == "norm_scale":
            t.mul_(0.02).add_(1.0)
        else:
            t.mul_(0.02)
        out[name] = t
    return out
