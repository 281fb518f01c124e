"""The port's recurrent VLN-BERT (`etpnav_tpu_torch/models/rec_vlnbert.py`)
against the JAX package's, on one set of weights carried over by
`rec_vlnbert_params_from_jax` and the same seeded numpy inputs, in fp32
on the CPU at dropout 0 (JAX at `highest` matmul precision), at the
sizes of tests/test_dagger_recvlnbert.py.

Tolerances, as in tests/test_planner_parity.py: 2e-5 absolute on the
language features, logits, states and the loss; 3e-5 on the gradients,
which sum over every step of the recurrence. Plus the PREVALENT
checkpoint converter on a synthetic state dict, and dropout by its
statistics only (torch's Philox stream cannot match jax.random).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from etpnav_tpu.models import rec_vlnbert as jrvb
from etpnav_tpu_torch.models import rec_vlnbert as rvb
from etpnav_tpu_torch.models.convert import (
    convert_rec_vlnbert,
    rec_vlnbert_params_from_jax,
)

torch.set_num_threads(2)

JCFG = jrvb.RecVLNBertConfig(
    vocab_size=512, hidden=48, heads=4, intermediate=64, la_layers=2,
    vl_layers=2, max_pos=32, rgb_dim=8, depth_dim=4, angle_dim=4,
    max_cands=4, hidden_dropout=0.0, attn_dropout=0.0)
CFG = rvb.RecVLNBertConfig(**dataclasses.asdict(JCFG))

ATOL = 2e-5
GRAD_ATOL = 3e-5
B, L, K, T = 3, 11, JCFG.max_cands, 4


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.asarray(a).copy())


@pytest.fixture(scope="module")
def weights():
    """JAX's initial parameters, with every bias and LayerNorm moved off
    its init value so that each one is exercised."""
    tree = _np(jrvb.init_params(jax.random.PRNGKey(0), JCFG))
    rng = np.random.default_rng(7)

    def perturb(path, a):
        name = getattr(path[-1], "key", None)
        if name in ("b", "bias", "scale"):
            a = a + 0.1 * rng.standard_normal(a.shape).astype(np.float32)
        return a

    tree = jax.tree_util.tree_map_with_path(perturb, tree)
    port = rec_vlnbert_params_from_jax(tree, CFG)
    return jax.tree_util.tree_map(jnp.asarray, tree), port


def _tokens(rng, b=B, l=L):
    toks = rng.integers(1, JCFG.vocab_size, (b, l))
    toks[0, -3:] = 0                           # padding tails
    toks[1, -5:] = 0
    return toks, toks != 0


def _cands(rng, *lead):
    return tuple(rng.standard_normal(lead + (d,)).astype(np.float32)
                 for d in (JCFG.rgb_dim, JCFG.depth_dim, JCFG.angle_dim))


def _cmask(rng, *lead):
    m = rng.random(lead) < 0.7
    m[..., 0] = True                           # STOP stays valid
    return m


def _close(got, want, atol=ATOL, what=""):
    np.testing.assert_allclose(np.asarray(got.detach() if
                                          torch.is_tensor(got) else got),
                               np.asarray(want), atol=atol, rtol=0,
                               err_msg=what)


@pytest.mark.parametrize("rxr", [False, True])
def test_encode_language_matches_jax(weights, rng, rxr):
    jp, tp = weights
    toks, mask = _tokens(rng)
    if rxr:
        feats = rng.standard_normal((B, L, JCFG.hidden)).astype(np.float32)
        js, jf = jrvb.encode_language(jp, JCFG, None, jnp.asarray(mask),
                                      text_feats=jnp.asarray(feats))
        ts, tf = rvb.encode_language(tp, CFG, None, _t(mask),
                                     text_feats=_t(feats))
    else:
        js, jf = jrvb.encode_language(jp, JCFG, jnp.asarray(toks),
                                      jnp.asarray(mask))
        ts, tf = rvb.encode_language(tp, CFG, _t(toks), _t(mask))
    _close(ts, js, what="state")
    _close(tf, jf, what="lang_feats")


def test_nav_step_matches_jax(weights, rng):
    """Logits (masked slots at NEG_INF = -1e9) and the new state; then a
    second step fed by the first's state, so the recurrence is held
    too."""
    jp, tp = weights
    toks, mask = _tokens(rng)
    js, jf = jrvb.encode_language(jp, JCFG, jnp.asarray(toks),
                                  jnp.asarray(mask))
    ts, tf = rvb.encode_language(tp, CFG, _t(toks), _t(mask))
    for step in range(2):
        rgb, dep, ang = _cands(rng, B, K)
        cm = _cmask(rng, B, K)
        jl, js = jrvb.nav_step(jp, JCFG, js, jf, jnp.asarray(mask),
                               jnp.asarray(rgb), jnp.asarray(dep),
                               jnp.asarray(ang), jnp.asarray(cm))
        tl, ts = rvb.nav_step(tp, CFG, ts, tf, _t(mask), _t(rgb), _t(dep),
                              _t(ang), _t(cm))
        assert (tl[~_t(cm)] == rvb.NEG_INF).all()
        _close(tl, jl, what=f"logits step {step}")
        _close(ts, js, what=f"state step {step}")


def _sequence_batch(rng):
    toks, mask = _tokens(rng)
    rgb, dep, ang = _cands(rng, B, T, K)
    cm = _cmask(rng, B, T, K)
    teach = np.stack([[rng.choice(np.flatnonzero(cm[b, t]))
                       for t in range(T)] for b in range(B)]).astype(
                           np.int32)
    smask = np.ones((B, T), bool)
    smask[1, 2:] = False
    smask[2, 1:] = False
    return toks, mask, rgb, dep, ang, cm, teach, smask


def test_sequence_nll_and_grads_match_jax(weights, rng):
    jp, tp = weights
    batch = _sequence_batch(rng)
    jloss, jgrads = jax.value_and_grad(jrvb.sequence_nll)(
        jp, JCFG, *map(jnp.asarray, batch), train=False)
    tp.zero_grad(set_to_none=True)
    loss = rvb.sequence_nll(tp, CFG, *map(_t, batch), train=False)
    loss.backward()
    _close(loss, jloss, what="loss")
    want = dict(rec_vlnbert_params_from_jax(_np(jgrads), CFG)
                .named_parameters())
    got = {n: (p.grad if p.grad is not None else torch.zeros_like(p))
           for n, p in tp.named_parameters()}
    assert set(got) == set(want)
    for name, g in got.items():
        _close(g, want[name].detach(), GRAD_ATOL, name)
    # the gradient reaches both stacks and the candidate fusion
    for name in ("lalayer.0.attention.attn.q.weight",
                 "addlayer.1.self.attn.k.weight", "vismerge.weight",
                 "embeddings.word_embeddings"):
        assert got[name].abs().max() > 0, name
    tp.zero_grad(set_to_none=True)


def test_prevalent_conversion_matches_jax(rng):
    """A synthetic PREVALENT state dict (tests/test_rec_vlnbert.py's
    layout, with the dead lang branch present) loads into the port to the
    JAX converter's tree; the fusion projections keep their values."""
    H, I, V = JCFG.hidden, JCFG.intermediate, JCFG.vocab_size
    sd = {}

    def lin(key, din, dout):
        sd[f"{key}.weight"] = torch.from_numpy(
            rng.standard_normal((dout, din)).astype(np.float32))
        sd[f"{key}.bias"] = torch.from_numpy(
            rng.standard_normal(dout).astype(np.float32))

    def ln(key, d):
        sd[f"{key}.weight"] = torch.from_numpy(
            1 + 0.1 * rng.standard_normal(d).astype(np.float32))
        sd[f"{key}.bias"] = torch.from_numpy(
            rng.standard_normal(d).astype(np.float32))

    for name, rows in (("word", V), ("position", JCFG.max_pos),
                       ("token_type", JCFG.type_vocab)):
        sd[f"embeddings.{name}_embeddings.weight"] = torch.from_numpy(
            rng.standard_normal((rows, H)).astype(np.float32))
    ln("embeddings.LayerNorm", H)
    for i in range(JCFG.la_layers):
        b = f"lalayer.{i}"
        for p in ("query", "key", "value"):
            lin(f"{b}.attention.self.{p}", H, H)
        lin(f"{b}.attention.output.dense", H, H)
        ln(f"{b}.attention.output.LayerNorm", H)
        lin(f"{b}.intermediate.dense", H, I)
        lin(f"{b}.output.dense", I, H)
        ln(f"{b}.output.LayerNorm", H)
    for i in range(JCFG.vl_layers):
        b = f"addlayer.{i}"
        for p in ("query", "key", "value"):
            lin(f"{b}.visual_attention.att.{p}", H, H)
            lin(f"{b}.visn_self_att.self.{p}", H, H)
            lin(f"{b}.lang_self_att.self.{p}", H, H)   # dead branch
        lin(f"{b}.visual_attention.output.dense", H, H)
        ln(f"{b}.visual_attention.output.LayerNorm", H)
        lin(f"{b}.visn_self_att.output.dense", H, H)
        ln(f"{b}.visn_self_att.output.LayerNorm", H)
        lin(f"{b}.visn_inter.dense", H, I)
        lin(f"{b}.visn_output.dense", I, H)
        ln(f"{b}.visn_output.LayerNorm", H)
    lin("pooler.dense", H, H)
    sd = {f"module.{k}": v for k, v in sd.items()}       # a DDP prefix

    from etpnav_tpu.models.convert import convert_rec_vlnbert as jconvert
    base = _np(jrvb.init_params(jax.random.PRNGKey(1), JCFG))
    want = rec_vlnbert_params_from_jax(
        _np(jconvert(sd, base, JCFG.la_layers, JCFG.vl_layers)), CFG)
    port = rec_vlnbert_params_from_jax(base, CFG)
    assert convert_rec_vlnbert(sd, port, CFG.la_layers,
                               CFG.vl_layers) is port
    for (n, p), (_, w) in zip(port.named_parameters(),
                              want.named_parameters()):
        assert torch.equal(p, w), n
    assert torch.equal(port.pooler.weight,
                       sd["module.pooler.dense.weight"])
    with pytest.raises(ValueError, match="layers"):
        convert_rec_vlnbert(sd, port, CFG.la_layers + 1, CFG.vl_layers)


def test_dropout_statistics(weights, rng):
    """Under training with a generator, the candidate tokens lose a
    `hidden_dropout` share of their entries and keep their mean scale;
    nav_step's outputs move with the draw and stay finite; without
    training they are the eval outputs."""
    _, tp = weights
    cfg = dataclasses.replace(CFG, hidden_dropout=0.1, attn_dropout=0.1)
    rgb, dep, ang = _cands(rng, 64, K)
    eval_tok = rvb.fuse_candidates(tp, cfg, _t(rgb), _t(dep), _t(ang))
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        tok = rvb.fuse_candidates(tp, cfg, _t(rgb), _t(dep), _t(ang),
                                  generator=gen, train=True)
    dropped = (tok == 0) & (eval_tok != 0)
    assert abs(dropped.float().mean().item() - 0.1) < 0.01
    kept = ~dropped
    ratio = (tok[kept] / eval_tok[kept]).mean().item()
    assert abs(ratio - 1 / 0.9) < 1e-4
    toks, mask = _tokens(rng)
    rgb, dep, ang = _cands(rng, B, K)
    cm = _t(_cmask(rng, B, K))
    with torch.no_grad():
        s, f = rvb.encode_language(tp, cfg, _t(toks), _t(mask))
        args = (s, f, _t(mask), _t(rgb), _t(dep), _t(ang), cm)
        l_eval, _ = rvb.nav_step(tp, cfg, *args)
        l_eval2, _ = rvb.nav_step(tp, cfg, *args, generator=gen)
        l1, _ = rvb.nav_step(tp, cfg, *args, generator=gen, train=True)
        l2, _ = rvb.nav_step(tp, cfg, *args, generator=gen, train=True)
    assert torch.equal(l_eval, l_eval2)
    assert torch.isfinite(l1[cm]).all() and torch.isfinite(l2[cm]).all()
    assert not torch.equal(l1, l2) and not torch.equal(l1, l_eval)
