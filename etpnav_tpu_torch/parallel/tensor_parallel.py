"""Tensor parallelism written out: what GSPMD does for the JAX package
from its sharding rules alone, here as Megatron-style collectives.

`parallel/mesh.py::shard_params` splits the parameters and records each
split's `TPSpec` as the parameter's `tp` attribute. The models reach the
mp group only through this module, which reads those records:

- `copy_to_mp`: the identity going forward, an all-reduce of the
  gradient going back (the input of a column-split product, which each
  rank differentiates only through its own columns);
- `reduce_from_mp`: an all-reduce going forward, the identity going back
  (the partial products of a row-split product);
- `parallel_linear`: a column-split `Linear` (q, k, v, the FFN
  intermediate, linear1: output split, bias split) or a row-split one
  (o, out.dense, the FFN output, linear2: input split, the replicated
  bias added once, after the all-reduce);
- `embedding`: the vocabulary-split lookup (ids outside the shard masked,
  looked up locally, all-reduced);
- `vocab_nll`: the vocabulary-split log-softmax and NLL of the tied MLM
  decoder (an all-reduce of the max, then of the sum of exps and of the
  target's logit); padded vocabulary entries are masked out.

On one process (no `tp` record) every function here is the plain op.
"""

from __future__ import annotations

import copy
from typing import Optional

import torch
import torch.distributed as dist
import torch.nn as nn

from etpnav_tpu_torch.ops.basic import linear, matmul_f32


def spec_of(t) -> Optional[object]:
    """The `TPSpec` of a parameter (or of a Linear's weight), or None."""
    if isinstance(t, nn.Module):
        t = t.weight
    return getattr(t, "tp", None)


def _all_reduce(t: torch.Tensor, group, op=None) -> torch.Tensor:
    t = t.clone()
    if op is None:
        dist.all_reduce(t, group=group)
    else:
        dist.all_reduce(t, op=op, group=group)
    return t


class _CopyToMP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _ReduceFromMP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_mp(x: torch.Tensor, group) -> torch.Tensor:
    if group is None:
        return x
    return _CopyToMP.apply(x, group)


def reduce_from_mp(x: torch.Tensor, group) -> torch.Tensor:
    if group is None:
        return x
    return _ReduceFromMP.apply(x, group)


class _LinearF32(torch.autograd.Function):
    """x . w^T for bf16 x and w as the fp32 sum (the partial product of a
    row-split layer, before its all-reduce); the backward takes an
    output gradient that holds bf16 values, as `_LinearRoundOnce`'s."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return matmul_f32(x, w.t())

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.to(x.dtype)
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = matmul_f32(g, w).to(x.dtype)
        if ctx.needs_input_grad[1]:
            dw = matmul_f32(g.reshape(-1, g.shape[-1]).t(),
                            x.reshape(-1, x.shape[-1])).to(w.dtype)
        return dx, dw


def parallel_linear(x: torch.Tensor, weight: torch.Tensor,
                    bias: torch.Tensor) -> torch.Tensor:
    """`ops.basic.linear` of a split weight. Column split (dim 0): the
    replicated input enters through `copy_to_mp` and the local output
    columns come back. Row split (dim 1): the local input columns give a
    partial product in fp32, which the group sums; the replicated bias is
    added once and the sum rounded once to x's dtype, where one process
    rounds."""
    spec = weight.tp
    if spec.dim == 0:
        return linear(copy_to_mp(x, spec.group), weight, bias)
    if x.dtype == torch.float32:
        part = torch.nn.functional.linear(x, weight)
    else:
        w = weight.to(x.dtype)
        if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
            part = _LinearF32.apply(x, w)
        else:
            part = matmul_f32(x, w.t())
    return (reduce_from_mp(part, spec.group) + bias).to(x.dtype)


def heads_of(proj: nn.Module, num_heads: int, head_dim: int):
    """(local heads, first of them, the layer's heads) of an attention
    whose q projection is `proj`: its output width over the head dim,
    this rank's offset among the layer's `num_heads`."""
    spec = spec_of(proj)
    local = proj.weight.shape[0] // head_dim
    return local, (0 if spec is None else spec.index * local), num_heads


def bias_to_mp(bias: Optional[torch.Tensor], proj: nn.Module):
    """An attention bias that carries a gradient (the graph's sprel
    bias), entering the local heads: each rank's d(bias) sums only its
    heads, so the group sums them going back."""
    spec = spec_of(proj)
    if bias is None or spec is None or not bias.requires_grad:
        return bias
    return copy_to_mp(bias, spec.group)


def embedding(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """table[ids] for a table that may be split on its rows: each rank
    looks up the ids of its shard, zeros the others, and the group sums
    the rows."""
    spec = getattr(table, "tp", None)
    if spec is None:
        return table[ids]
    local = ids - spec.start
    inside = (local >= 0) & (local < spec.shard)
    rows = table[local.clamp(0, spec.shard - 1)]
    rows = torch.where(inside[..., None], rows, rows.new_zeros(()))
    return reduce_from_mp(rows, spec.group)


def vocab_input(h: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """The replicated input of a product with a vocabulary-split table."""
    spec = getattr(table, "tp", None)
    return h if spec is None else copy_to_mp(h, spec.group)


def _masked_vocab(logits: torch.Tensor, spec) -> torch.Tensor:
    """Local vocabulary logits with the padded entries at -inf."""
    col = torch.arange(spec.shard, device=logits.device) + spec.start
    return torch.where(col < spec.full, logits,
                       logits.new_full((), float("-inf")))


def vocab_nll(logits: torch.Tensor, target: torch.Tensor,
              table: torch.Tensor) -> torch.Tensor:
    """-log_softmax(logits)[target] over the vocabulary of `table`, with
    the logits split like its rows: the global max and the sum of exps
    are all-reduced, and the target's logit comes from the rank that
    holds it. target >= 0 everywhere (clamp ignored labels first)."""
    spec = getattr(table, "tp", None)
    if spec is None:
        logp = torch.log_softmax(logits, dim=-1)
        return -logp.gather(-1, target[..., None])[..., 0]
    logits = _masked_vocab(logits, spec)
    with torch.no_grad():
        m = _all_reduce(logits.amax(-1, keepdim=True), spec.group,
                        dist.ReduceOp.MAX)
    sumexp = reduce_from_mp(torch.exp(logits - m).sum(-1), spec.group)
    local = target - spec.start
    inside = (local >= 0) & (local < spec.shard)
    picked = logits.gather(-1, local.clamp(0, spec.shard - 1)[..., None])
    picked = torch.where(inside, picked[..., 0], picked.new_zeros(()))
    picked = reduce_from_mp(picked, spec.group)
    return m[..., 0] + torch.log(sumexp) - picked


@torch.no_grad()
def full_vocab_logits(logits: torch.Tensor,
                      table: torch.Tensor) -> torch.Tensor:
    """The whole (..., vocab) logits of a vocabulary-split product (for
    the argmax of validation)."""
    from etpnav_tpu_torch.parallel.mesh import gather_tensor
    spec = getattr(table, "tp", None)
    if spec is None:
        return logits
    spec = type(spec)(logits.dim() - 1, spec.full, spec.shard, spec.index,
                      spec.size, spec.group)
    return gather_tensor(logits.contiguous(), spec)


def dropout_shard(proj: nn.Module):
    """(first column, full width) of the output of a column-split layer,
    for `ops.basic.dropout`'s `shard`, or None."""
    spec = spec_of(proj)
    return None if spec is None else (spec.start, spec.full)


@torch.no_grad()
def gathered(module: nn.Module) -> nn.Module:
    """A whole copy of a module whose parameters may be split: what runs
    a kernel that takes the whole weight (K-PRENORM) replicated under
    mp. The module itself when nothing is split."""
    from etpnav_tpu_torch.parallel.mesh import gather_tensor
    if not any(spec_of(p) is not None for p in module.parameters()):
        return module
    whole = copy.deepcopy(module)
    for p, q in zip(module.parameters(), whole.parameters()):
        spec = spec_of(p)
        if spec is not None:
            q.data = gather_tensor(p, spec)
            q.__dict__.pop("tp", None)
    return whole
