"""Helpers shared by the released-checkpoint converters
(`models/convert.py`, `clip_vit.py`, `depth_resnet.py`), which build
parameter trees of numpy arrays in the JAX package's layout."""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np


def to_numpy(t) -> np.ndarray:
    """A checkpoint tensor (or array) as a numpy array on the host."""
    if hasattr(t, "detach"):
        t = t.detach().cpu().numpy()
    return np.asarray(t)


def stack_layers(layers: list) -> Any:
    """Per-layer trees -> one tree with the layers on a leading axis."""
    first = layers[0]
    if isinstance(first, Mapping):
        return {k: stack_layers([l[k] for l in layers]) for k in first}
    return np.stack(layers)


def split_in_proj(w: np.ndarray, b: np.ndarray) -> dict:
    """torch MultiheadAttention's packed in_proj (3d, d) -> q/k/v dense
    trees, `w` as (in, out)."""
    d = w.shape[1]
    return {name: {"w": w[i * d:(i + 1) * d].T, "b": b[i * d:(i + 1) * d]}
            for i, name in enumerate(("q", "k", "v"))}
