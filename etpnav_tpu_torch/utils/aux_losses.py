"""Auxiliary loss registry (the port's counterpart of
`etpnav_tpu/utils/aux_losses.py`).

Capability target: vlnce_baselines/common/aux_losses.py:4-43 — a registry
that accumulates named, weighted, unreduced losses during a forward pass
and reduces them under a validity mask. It is an explicit instance, not a
module-level singleton, and the reference's
``torch.masked_select(...).mean()`` is a where-sum over a count (at least
1), so an all-masked loss reduces to 0 and the shapes stay static.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch


def _as_tensor(x, like: Optional[torch.Tensor] = None) -> torch.Tensor:
    t = torch.as_tensor(x)
    if like is not None:
        t = t.to(device=like.device, dtype=like.dtype)
    return t


def _masked_mean(loss: torch.Tensor, mask) -> torch.Tensor:
    if mask is None:
        return loss.mean()
    mask = torch.broadcast_to(_as_tensor(mask, loss), loss.shape)
    return (loss * mask).sum() / torch.clamp(mask.sum(), min=1.0)


class AuxLosses:
    def __init__(self):
        self._losses: Dict[str, torch.Tensor] = {}
        self._masks: Dict[str, Optional[torch.Tensor]] = {}
        self._weights: Dict[str, float] = {}
        self._active = False

    def clear(self):
        self._losses.clear()
        self._masks.clear()
        self._weights.clear()

    def activate(self):
        self._active = True

    def deactivate(self):
        self._active = False

    @property
    def is_active(self) -> bool:
        return self._active

    def register(self, name: str, loss, weight: float = 1.0, mask=None):
        """Record an unreduced per-element loss (register_loss,
        aux_losses.py:14-19). ``mask`` optionally pre-binds a validity mask
        for this loss; it composes with the mask later given to reduce()."""
        if not self._active:
            return
        self._losses[name] = _as_tensor(loss)
        self._masks[name] = None if mask is None else _as_tensor(mask)
        self._weights[name] = weight

    def reduce(self, mask=None) -> torch.Tensor:
        """Weighted sum of masked means (aux_losses.py:25-32): each loss is
        averaged over elements where BOTH its registration mask and the
        reduce-time ``mask`` are live."""
        total = torch.tensor(0.0, dtype=torch.float32)
        for name, loss in self._losses.items():
            m = self._masks[name]
            if mask is not None:
                rm = torch.broadcast_to(_as_tensor(mask, loss), loss.shape)
                m = rm if m is None else (
                    torch.broadcast_to(_as_tensor(m, loss), loss.shape) * rm)
            total = total.to(loss.device) + \
                self._weights[name] * _masked_mean(loss, m)
        return total

    def get(self, name: str) -> torch.Tensor:
        """The raw registered loss (get_loss, aux_losses.py:21-22)."""
        return self._losses[name]
