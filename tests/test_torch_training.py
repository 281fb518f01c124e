"""The port's IL training step against the JAX package, at `tiny_config()`
in fp32 on the CPU (JAX at `highest` matmul precision), with the same
weights carried over by `models/convert.py` and the same seeded inputs.

- K-ATT-BWD's plain backward (through `AttentionFn`) against `jax.vjp` of
  the Pallas `fused_bias_attention` in interpret mode: dq, dk, dv and
  d(bias) at 2e-5 absolute, with a full and a broadcast bias.
- Attention dropout: the plain forward and backward against autograd
  through the same formula in float64 with the mask materialised (2e-5:
  the plain versions compute in fp32); the Philox bits (word k % 4 of the
  call at counter k // 4) against a pure-Python Philox4x32-10 and its
  published test vectors; the drop
  rate over 10^6 draws; the same bits in both layouts.
- `compute_il_loss` and every planner gradient against
  `jax.value_and_grad(compute_il_loss)` with dropout off, on one recorded
  interval: max |diff| <= 1e-4 * max |g_jax| + 1e-6 per tensor.
- One AdamW step against optax with the same gradients (1e-6), frozen
  subtrees bit-unchanged under `fix_lang_embedding`.
- `RolloutEngine.run("train")` against the JAX engine on two copies of
  the same `GeometricNavEnv`: integer and mask fields equal, features
  and logits within 2e-4 (tests/test_replay_equivalence.py's bound).
- The port's own replay equivalence, full and bucketed; the trainer's
  loop, checkpoints, evaluation and its device rule.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from etpnav_tpu.config import tiny_config as jax_tiny_config
from etpnav_tpu.env.geometric import GeometricNavEnv as JaxGeometricNavEnv
from etpnav_tpu.ops.pallas_attention import fused_bias_attention
from etpnav_tpu.training import finetune as jft
from etpnav_tpu_torch.config import tiny_config
from etpnav_tpu_torch.env.geometric import GeometricNavEnv
from etpnav_tpu_torch.models.convert import agent_params_from_jax, \
    load_jax_tree
from etpnav_tpu_torch.models.planner import PlannerParams
from etpnav_tpu_torch.ops import fused_attention as fa
from etpnav_tpu_torch.ops.basic import dropout
from etpnav_tpu_torch.training import finetune
from etpnav_tpu_torch.training.rollout import RolloutRecord

torch.set_num_threads(2)

ATOL = 2e-5
GRAD_REL = 1e-4
REPLAY_ATOL = 2e-4


def _t(a):
    return torch.from_numpy(np.array(a))


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _envs(env_cls, cfg, n, seed):
    return env_cls(n, seed=seed, vocab_size=cfg.planner.vocab_size,
                   max_instr_len=cfg.il.max_text_len,
                   image_size=cfg.clip.image_size,
                   depth_size=cfg.depth.input_size,
                   pad_id=cfg.planner.pad_token_id)


def _port_planner(cfg, tree) -> PlannerParams:
    module = PlannerParams(cfg.planner)
    load_jax_tree(module, _np_tree(tree))
    return module


# ---------------------------------------------------------------------------
# K-ATT-BWD against the Pallas kernel's custom VJP
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bias_kind", ["full", "broadcast"])
def test_attention_bwd_plain_matches_pallas_vjp(rng, bias_kind):
    B, H, Lq, Lk, hd = 2, 3, 12, 10, 16
    scale = hd ** -0.5
    q, k, v, dout = (rng.standard_normal(s).astype(np.float32)
                     for s in ((B, H, Lq, hd), (B, H, Lk, hd),
                               (B, H, Lk, hd), (B, H, Lq, hd)))
    pad = np.where(np.arange(Lk)[None] < np.array([[Lk], [6]]), 0.0,
                   -10000.0).astype(np.float32)                 # (B, Lk)
    if bias_kind == "full":
        bias = pad[:, None, :] + rng.standard_normal(
            (B, Lq, Lk)).astype(np.float32)
        tbias = _t(bias)
    else:
        bias = np.broadcast_to(pad[:, None, :], (B, Lq, Lk))
        tbias = _t(pad)[:, None, None, :]                       # (B,1,1,Lk)
    out, vjp = jax.vjp(
        lambda *a: fused_bias_attention(*a, scale, True), q, k, v,
        jnp.asarray(bias))
    want = vjp(jnp.asarray(dout))
    want_dbias = np.asarray(want[3])
    if bias_kind == "broadcast":
        want_dbias = want_dbias.sum(1)[:, None, None, :]

    tq, tk, tv = (_t(a).requires_grad_() for a in (q, k, v))
    tbias.requires_grad_()
    before = fa.attention_bwd_plain_calls.value
    got = fa.attention(tq, tk, tv, tbias, scale)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out),
                               atol=ATOL)
    got.backward(_t(dout))
    assert fa.attention_bwd_plain_calls.value == before + 1
    for name, g, w in (("dq", tq.grad, want[0]), ("dk", tk.grad, want[1]),
                       ("dv", tv.grad, want[2]),
                       ("dbias", tbias.grad, want_dbias)):
        assert tuple(g.shape) == np.shape(w), name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL,
                                   err_msg=name)


# ---------------------------------------------------------------------------
# attention dropout: Philox bits, statistics, forward and backward
# ---------------------------------------------------------------------------

_MASK32 = 0xFFFFFFFF


def _philox_ref(ctr, key):
    """Philox4x32-10 in Python integers (Salmon et al., SC'11)."""
    c0, c1, c2, c3 = ctr
    k0, k1 = key
    for i in range(10):
        if i:
            k0, k1 = (k0 + 0x9E3779B9) & _MASK32, (k1 + 0xBB67AE85) & _MASK32
        p0, p1 = 0xD2511F53 * c0, 0xCD9E8D57 * c2
        c0, c1, c2, c3 = ((p1 >> 32) ^ c1 ^ k0, p1 & _MASK32,
                          (p0 >> 32) ^ c3 ^ k1, p0 & _MASK32)
    return c0, c1, c2, c3


def test_dropout_bits_are_philox():
    # Random123's known-answer vectors for philox4x32-10
    kat = [((0, 0, 0, 0), (0, 0),
            (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
           ((_MASK32,) * 4, (_MASK32, _MASK32),
            (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
           ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
            (0xA4093822, 0x299F31D0),
            (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1))]
    for ctr, key, want in kat:
        assert _philox_ref(ctr, key) == want
    # the mask's int64 arithmetic against the reference, element by element
    seed, offset = 0x7EDCBA9876543210, 0x1234ABCD5678
    B, H, Lq, Lk, p = 2, 3, 5, 7, 0.1
    keep = fa.dropout_keep_mask(torch.tensor([seed, offset]), B, H, Lq, Lk,
                                p).numpy()
    threshold = int((1.0 - p) * 2.0 ** 32)
    key = (seed & _MASK32, seed >> 32)
    for b in range(B):
        for h in range(H):
            for i in range(Lq):
                for j in range(Lk):
                    word = _philox_ref(
                        (j // 4, i, b * H + h, offset & _MASK32), key)[j % 4]
                    assert keep[b, h, i, j] == (word < threshold)


def test_dropout_mask_rate_and_logical_indexing():
    so = torch.tensor([123456789, 987654321])
    keep = fa.dropout_keep_mask(so, 4, 8, 180, 180, 0.1)
    assert keep.numel() >= 10 ** 6
    assert abs(1.0 - keep.float().mean().item() - 0.1) < 0.005
    # a bit depends on its logical (b, h, q, k) only, not on the extents
    # of the sequence axes
    sub = fa.dropout_keep_mask(so, 4, 8, 33, 17, 0.1)
    assert torch.equal(sub, keep[:, :, :33, :17])
    other = fa.dropout_keep_mask(torch.tensor([123456789, 5]), 4, 8, 33,
                                 17, 0.1)
    assert not torch.equal(sub, other)


def _dropout_reference(q, k, v, bias, scale, keep, rate):
    """softmax(q.k^T * s + bias) with the mask applied to the normalised
    probabilities, by autograd in float64."""
    logits = torch.einsum("bhqd,bhkd->bhqk", q, k) * scale + bias
    p = torch.softmax(logits, -1) * keep / (1.0 - rate)
    return torch.einsum("bhqk,bhkd->bhqd", p, v)


def test_dropout_attention_plain_fwd_bwd_match_autograd(rng):
    B, H, Lq, Lk, hd, rate = 2, 4, 9, 11, 16, 0.1
    scale = hd ** -0.5
    gen = torch.Generator().manual_seed(3)
    so = fa.draw_seed_offset(gen, torch.device("cpu"))
    # natural layout: (B, L, H, hd) storage viewed as (B, H, L, hd)
    q, k, v = (_t(rng.standard_normal((B, L, H, hd)).astype(np.float32))
               .transpose(1, 2) for L in (Lq, Lk, Lk))
    bias = _t(rng.standard_normal((B, 1, Lq, Lk)).astype(np.float32))
    dout = _t(rng.standard_normal((B, H, Lq, hd)).astype(np.float32))

    leaves = [t.clone().requires_grad_() for t in (q, k, v, bias)]
    out = fa.AttentionFn.apply(*leaves, scale, rate, so)
    out.backward(dout)

    keep = fa.dropout_keep_mask(so, B, H, Lq, Lk, rate).double()
    ref = [t.detach().double().requires_grad_() for t in (q, k, v, bias)]
    want = _dropout_reference(*ref, scale, keep, rate)
    want.backward(dout.double())
    np.testing.assert_allclose(out.detach().numpy(),
                               want.detach().numpy(), atol=ATOL)
    for name, a, b in zip(("dq", "dk", "dv", "dbias"), leaves, ref):
        np.testing.assert_allclose(a.grad.numpy(), b.grad.numpy(),
                                   atol=ATOL, err_msg=name)
    # the head-leading copy of the same operands drops the same elements
    hl = [t.detach().contiguous().requires_grad_() for t in (q, k, v)]
    out_hl = fa.AttentionFn.apply(*hl, bias, scale, rate, so)
    out_hl.backward(dout)
    np.testing.assert_allclose(out_hl.detach().numpy(),
                               out.detach().numpy(), atol=1e-6)
    for a, b in zip(hl, leaves):
        np.testing.assert_allclose(a.grad.numpy(), b.grad.numpy(),
                                   atol=1e-6)
    # dropout is off without a generator, at rate 0 and outside training
    x = torch.ones(1000)
    assert dropout(x, 0.1, None, True) is x
    assert dropout(x, 0.0, gen, True) is x
    assert dropout(x, 0.1, gen, False) is x
    y = dropout(x, 0.1, gen, True)
    assert set(torch.unique(y).tolist()) <= {0.0, float(np.float32(1 / 0.9))}


# ---------------------------------------------------------------------------
# the training slice against the JAX package
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def slice_pair():
    """A JAX and a port trainer with the same weights, each with its
    first recorded interval from its own copy of the same env pool."""
    jcfg, cfg = jax_tiny_config(), tiny_config()
    jcfg = dataclasses.replace(
        jcfg, il=dataclasses.replace(jcfg.il, waypoint_aug=False))
    cfg = dataclasses.replace(
        cfg, il=dataclasses.replace(cfg.il, waypoint_aug=False))
    # Candidate angles agree to ~5e-7 rad (XLA folds 2*pi*k/120 into
    # another rounding), and candidate positions are quantised (3 degrees,
    # 0.25 m), so in about half of the env seeds one host-side threshold
    # of the graph building flips between the packages and the episodes
    # part; env seed 0 has no such near-tie.
    jtr = jft.FinetuneTrainer(jcfg, _envs(JaxGeometricNavEnv, jcfg, 2, 0),
                              seed=0)
    agent = agent_params_from_jax(_np_tree(jtr.params), cfg, device="cpu")
    tr = finetune.FinetuneTrainer(cfg, _envs(GeometricNavEnv, cfg, 2, 0),
                                  params=agent.params, seed=0, device="cpu")
    jrec = jtr.engine.run("train", sample_ratio=1.0)
    rec = tr.engine.run("train", sample_ratio=1.0)
    return jcfg, cfg, jtr, tr, jrec, rec


def test_rollout_record_matches_jax(slice_pair):
    *_, jrec, rec = slice_pair
    assert rec.step_valid.any() and (rec.teacher >= 0).any()
    for f in dataclasses.fields(RolloutRecord):
        got, want = getattr(rec, f.name), getattr(jrec, f.name)
        assert got.shape == want.shape, f.name
        if f.name in ("vp_rgb", "vp_dep", "vp_loc", "gmap_pos_fts",
                      "gmap_pair", "logits"):
            fin = np.isfinite(want)
            np.testing.assert_array_equal(np.isfinite(got), fin, f.name)
            np.testing.assert_allclose(got[fin], want[fin], atol=REPLAY_ATOL,
                                       err_msg=f.name)
        else:
            np.testing.assert_array_equal(got, want, f.name)


@pytest.fixture(scope="module")
def loss_and_grads(slice_pair):
    """compute_il_loss and its planner gradients on the JAX record, in
    both packages, dropout off."""
    jcfg, cfg, jtr, _, jrec, _ = slice_pair
    jp = jtr.params.planner
    jbatch = jft.record_to_batch(jrec)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: jft.compute_il_loss(p, jcfg, b, None)))(jp, jbatch)

    planner = _port_planner(cfg, jp)
    batch = finetune.record_to_batch(RolloutRecord(**{
        f.name: getattr(jrec, f.name)
        for f in dataclasses.fields(RolloutRecord)}), device="cpu")
    counts = (fa.attention_plain_calls.value,
              fa.attention_bwd_plain_calls.value)
    loss = finetune.compute_il_loss(planner, cfg, batch)
    loss.backward()
    launches = (fa.attention_plain_calls.value - counts[0],
                fa.attention_bwd_plain_calls.value - counts[1])
    grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p))
             for n, p in planner.named_parameters()}
    want = dict(_port_planner(cfg, jgrads).named_parameters())
    return (float(jloss), loss.item(), grads, want, launches,
            _np_tree(jgrads))


def test_il_loss_and_planner_grads_match_jax(slice_pair, loss_and_grads):
    _, cfg, *_ = slice_pair
    jloss, loss, grads, want, launches, _ = loss_and_grads
    assert np.isfinite(loss) and loss > 0
    assert abs(loss - jloss) <= 1e-5 * abs(jloss)
    # every attention of the replay ran forward and backward through
    # AttentionFn: text, pano, then cross + graph per navigation layer
    p = cfg.planner
    n_att = p.num_l_layers + p.num_pano_layers + 2 * p.num_x_layers
    assert launches == (n_att, n_att)
    assert set(grads) == set(want)
    for name, g in grads.items():
        w = want[name].detach()
        tol = GRAD_REL * w.abs().max().item() + 1e-6
        err = (g - w).abs().max().item()
        assert err <= tol, (name, err, tol)
    # the sprel bias's gradient reaches its linear layer
    sprel = [n for n in grads if "sprel" in n]
    assert sprel and all(grads[n].abs().max() > 0 for n in sprel)


@pytest.mark.parametrize("fix_lang", [False, True])
def test_adamw_step_matches_optax(slice_pair, loss_and_grads, fix_lang):
    jcfg, cfg, jtr, *_ = slice_pair
    *_, jgrads = loss_and_grads
    # a large rate, so a wrong decay or moment shows at 1e-6 on the
    # LayerNorm scales (~1)
    jcfg = dataclasses.replace(jcfg, il=dataclasses.replace(
        jcfg.il, lr=1e-2, fix_lang_embedding=fix_lang))
    cfg = dataclasses.replace(cfg, il=dataclasses.replace(
        cfg.il, lr=1e-2, fix_lang_embedding=fix_lang))
    jp = _np_tree(jtr.params.planner)
    tx = jft.make_il_optimizer(jcfg, jp)
    updates, _ = tx.update(jgrads, tx.init(jp), jp)
    want = dict(_port_planner(cfg, optax.apply_updates(jp, updates))
                .named_parameters())

    planner = _port_planner(cfg, jp)
    before = {n: p.detach().clone() for n, p in planner.named_parameters()}
    opt = finetune.make_il_optimizer(cfg, planner)
    grads = dict(_port_planner(cfg, jgrads).named_parameters())
    for n, p in planner.named_parameters():
        if p.requires_grad:
            p.grad = grads[n].detach().clone()
    opt.step()
    frozen = finetune.frozen_roots(cfg)
    assert bool(frozen) == fix_lang
    for n, p in planner.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(),
                                   want[n].detach().numpy(), atol=1e-6,
                                   err_msg=n)
        if n.split(".")[0] in frozen:
            assert not p.requires_grad and torch.equal(p, before[n]), n
    assert any(not torch.equal(p, before[n])
               for n, p in planner.named_parameters())


@pytest.mark.parametrize("bucketed", [False, True])
def test_replay_reproduces_rollout_logits(slice_pair, bucketed):
    """replay_logits(train=False) over the whole interval at once gives
    the logits the rollout scored step by step; also after slicing the
    record to its (T, G) buckets, with the last step cut as an interval
    that finished early."""
    _, cfg, _, tr, _, rec = slice_pair
    if bucketed:
        rec = dataclasses.replace(
            rec, step_valid=rec.step_valid.copy(), teacher=rec.teacher.copy())
        rec.step_valid[:, 3:] = False
        rec.teacher[:, 3:] = -100
        il = dataclasses.replace(cfg.il, train_traj_buckets=(2, 3, 4),
                                 train_gmap_buckets=(8, 12, 16))
        cut = finetune.bucket_record(rec, il)
        assert cut.step_valid.shape[1] == 3
        assert (int(rec.gmap_mask.sum(-1).max()) <= cut.gmap_mask.shape[2]
                <= rec.gmap_mask.shape[2])
        assert cut.step_valid.sum() == rec.step_valid.sum()
        rec = cut
    with torch.no_grad():
        logits = finetune.replay_logits(
            tr.params.planner, cfg,
            finetune.record_to_batch(rec, device="cpu"),
            train=False).numpy()
    checked = 0
    for b, t in zip(*np.nonzero(rec.step_valid)):
        mask = rec.gmap_mask[b, t]
        got, want = logits[b, t][mask], rec.logits[b, t][mask]
        np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
        fin = np.isfinite(want)
        np.testing.assert_allclose(got[fin], want[fin], atol=REPLAY_ATOL)
        checked += 1
    assert checked >= 4


def test_evaluate_matches_jax(slice_pair):
    """The argmax policy over the same weights and env pool gives the
    JAX package's episode metrics."""
    jcfg, cfg, _, tr, _, _ = slice_pair
    jtr = jft.FinetuneTrainer(jcfg, _envs(JaxGeometricNavEnv, jcfg, 2, 5),
                              params=None, seed=0)
    port = finetune.FinetuneTrainer(cfg, _envs(GeometricNavEnv, cfg, 2, 5),
                                    params=tr.params, seed=0, device="cpu")
    want, got = jtr.evaluate(2), port.evaluate(2)
    assert set(got) == set(want) and got["n_episodes"] == 2
    for key in want:
        np.testing.assert_allclose(got[key], want[key], atol=1e-4,
                                   err_msg=key)


# ---------------------------------------------------------------------------
# the trainer
# ---------------------------------------------------------------------------

def test_trainer_trains_and_checkpoints_round_trip(tmp_path):
    cfg = tiny_config()
    tr = finetune.FinetuneTrainer(cfg, _envs(GeometricNavEnv, cfg, 2, 3),
                                  ckpt_dir=str(tmp_path), seed=0,
                                  device="cpu")
    before = {n: p.detach().clone()
              for n, p in tr.params.planner.named_parameters()}
    logs = tr.train(2, save_every=1)
    assert np.isfinite(logs["IL_loss"]) and tr.iteration == 2
    assert any(not torch.equal(p, before[n])
               for n, p in tr.params.planner.named_parameters())
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "ckpt_iter1.pt", "ckpt_iter2.pt"]
    # a requeued trainer resumes from the newest checkpoint, optimizer
    # state included
    requeued = dataclasses.replace(cfg, il=dataclasses.replace(
        cfg.il, is_requeue=True))
    tr2 = finetune.FinetuneTrainer(requeued,
                                   _envs(GeometricNavEnv, cfg, 2, 3),
                                   ckpt_dir=str(tmp_path), seed=1,
                                   device="cpu")
    assert tr2.iteration == 2
    sa, sb = tr.params.state_dict(), tr2.params.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    oa, ob = tr.optimizer.state_dict(), tr2.optimizer.state_dict()
    assert oa["param_groups"] == ob["param_groups"]
    for i, st in oa["state"].items():
        assert all(torch.equal(v, ob["state"][i][k]) for k, v in st.items())


def test_trainer_raises_without_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tiny_config()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        finetune.FinetuneTrainer(cfg, _envs(GeometricNavEnv, cfg, 2, 3))
