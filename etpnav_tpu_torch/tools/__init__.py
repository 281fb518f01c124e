"""The port's counterparts of the JAX package's attention experiments
(`tools/exp_attn_layout.py`, `tools/exp_attn_pack.py`): each times its
variants on the card and holds each to the fp32-logits reference of the
JAX tool. Run one with `python -m etpnav_tpu_torch.tools.<name>`, which
prints its result as one JSON line; `main(device="cpu", ...)` runs the
plain versions on the CPU at a size the caller picks.

This module holds what the two share: the seeded bf16 inputs, the
reference, the chained timing and the report.
"""

from __future__ import annotations

import math
import time
from typing import Callable, Dict, Tuple

import numpy as np
import torch

Variant = Tuple[Callable, float, str]    # (fn(q, k, v), tolerance, note)


def bf16_normals(seed: int, shape, device: torch.device, n: int = 3):
    """`n` arrays of standard normals from numpy's default_rng(seed), in
    order, as bf16 tensors on `device` (the JAX tools' inputs)."""
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
            .to(device=device, dtype=torch.bfloat16) for _ in range(n)]


def reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              scale: float) -> torch.Tensor:
    """The JAX tools' `xla_ref` on head-leading (B, H, L, hd) operands:
    fp32 logits, an fp32 softmax, the normalised p rounded to q's dtype
    before an fp32 p.v, the output rounded to q's dtype."""
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    p = torch.softmax(logits, dim=-1).to(q.dtype).float()
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)


def bf16_ulps(ref: torch.Tensor, n: float) -> float:
    """n bf16 ulps at the largest magnitude of `ref`."""
    top = ref.float().abs().max().item()
    return n * 2.0 ** (math.floor(math.log2(max(top, 1e-30))) - 7)


def _perturbed(q: torch.Tensor):
    """q + x * 1e-3 (in q's dtype) for x = 0..4: the JAX tools' chained
    scan perturbs q by (i % 5) * 1e-3 at iteration i."""
    one_e3 = torch.tensor(1e-3, dtype=q.dtype, device=q.device)
    return [q + torch.tensor(float(x), dtype=q.dtype, device=q.device)
            * one_e3 for x in range(5)]


def _chained_ms(fn: Callable, qs, k, v, iters: int) -> float:
    """ms per call of `iters` calls on q perturbed as the JAX tools do,
    one run: CUDA events on the card, the host clock on the CPU."""
    xs = [(i + 1) % 5 for i in range(iters)]
    if qs[0].device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for x in xs:
            fn(qs[x], k, v)
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters
    t0 = time.perf_counter()
    for x in xs:
        fn(qs[x], k, v)
    return (time.perf_counter() - t0) * 1e3 / iters


def run_variants(tool: str, variants: Dict[str, Variant], q: torch.Tensor,
                 k: torch.Tensor, v: torch.Tensor, ref: torch.Tensor,
                 iters: int) -> dict:
    """For each variant: its max |out - ref| (raises past its tolerance),
    then one untimed chained run of `iters` calls and the minimum of 3
    timed ones. Each variant launches its kernels 1 + 4 * iters times. A
    variant that fails raises."""
    dev = q.device
    qs = _perturbed(q)
    out = {}
    for name, (fn, tol, note) in variants.items():
        got = fn(q, k, v)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        err = (got.float() - ref.float()).abs().max().item()
        if not err <= tol:
            raise AssertionError(f"{tool} {name}: max_err {err} > {tol}")
        _chained_ms(fn, qs, k, v, iters)
        ms = min(_chained_ms(fn, qs, k, v, iters) for _ in range(3))
        out[name] = {"ms": ms, "max_err": err, "tol": tol, "note": note}
    return {"tool": tool,
            "device": (torch.cuda.get_device_name(dev)
                       if dev.type == "cuda" else "cpu"),
            "timer": "cuda events" if dev.type == "cuda" else "host clock",
            "shape": list(q.shape), "dtype": str(q.dtype).split(".")[-1],
            "iters": iters, "variants": out}
