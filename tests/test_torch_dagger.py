"""The port's legacy DAgger path (`etpnav_tpu_torch/models/cma.py`,
`etpnav_tpu_torch/training/dagger.py` and `run.py --trainer DAgger`)
against the JAX package, on the CPU at the sizes of
tests/test_dagger_cma.py and tests/test_dagger_recvlnbert.py, with one
set of weights carried over by `cma_params_from_jax` /
`instruction_encoder_from_jax` / `load_jax_tree`.

Tolerances: 2e-5 absolute on the CMA forwards and the losses (fp32,
JAX at `highest` matmul precision), 1e-6 on the parameters after one
Adam step. Adam's first step is lr * g / (|g| + eps) with eps = 1e-8: it
depends on rounding only where |g| is within a hundred eps of zero (a
key bias, whose gradient the softmax cancels), and there only the step's
bound lr is held. The collected
episodes, the store, the teacher and the greedy eval must be identical:
both packages draw from one numpy stream in the same order.
"""

import dataclasses
import gzip
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from etpnav_tpu.env.geometric import GeometricNavEnv as JaxGeometricNavEnv
from etpnav_tpu.models import cma as jcma
from etpnav_tpu.models import rec_vlnbert as jrvb
from etpnav_tpu.training import dagger as jdagger
from etpnav_tpu_torch.env.geometric import GeometricNavEnv
from etpnav_tpu_torch.env.protocol import StepResult
from etpnav_tpu_torch.models import cma
from etpnav_tpu_torch.models import rec_vlnbert as rvb
from etpnav_tpu_torch.models.convert import (
    cma_params_from_jax,
    instruction_encoder_from_jax,
    load_jax_tree,
    rec_vlnbert_params_from_jax,
)
from etpnav_tpu_torch.run import run
from etpnav_tpu_torch.training import dagger
from etpnav_tpu_torch.training.dagger import (
    DaggerConfig,
    DaggerTrainer,
    RecVLNBertDagger,
    TeacherRecollectionSampler,
    TrajectoryStore,
)
from test_dagger_cma import CFG as JCMA_CFG
from test_dagger_cma import _feature_fn
from test_dagger_recvlnbert import CFG as JRVB_CFG
from test_dagger_recvlnbert import _candidate_fn

torch.set_num_threads(2)

ATOL = 2e-5
CMA_CFG = cma.CMAConfig(**dataclasses.asdict(JCMA_CFG))
RVB_CFG = rvb.RecVLNBertConfig(**dataclasses.asdict(JRVB_CFG))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.asarray(a).copy())


def _jcfg(dcfg: DaggerConfig) -> jdagger.DaggerConfig:
    return jdagger.DaggerConfig(**dataclasses.asdict(dcfg))


def _env_pair(n, seed, cfg):
    kw = dict(num_envs=n, seed=seed, vocab_size=cfg.vocab_size,
              max_instr_len=12, image_size=16, depth_size=16)
    return JaxGeometricNavEnv(**kw), GeometricNavEnv(**kw)


def _same_store(a, b):
    ra, rb = list(a), list(b)
    assert len(ra) == len(rb) > 0
    for x, y in zip(ra, rb):
        assert set(x) == set(y)
        for k in x:
            assert x[k].dtype == y[k].dtype, k
            np.testing.assert_array_equal(x[k], y[k], err_msg=k)


# ---------------------------------------------------------------------------
# CMA policy and instruction encoder
# ---------------------------------------------------------------------------

def test_cma_forward_matches_jax(rng):
    jp = jcma.init_cma_params(jax.random.PRNGKey(0), JCMA_CFG)
    tp = cma_params_from_jax(_np(jp), CMA_CFG)
    toks = rng.integers(1, JCMA_CFG.vocab_size, (3, 12))
    toks[1, 8:] = 0
    ji, jm = jcma.encode_instruction(jp, JCMA_CFG, jnp.asarray(toks))
    ti, tm = cma.encode_instruction(tp, CMA_CFG, _t(toks))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_allclose(ti.detach().numpy(), ji, atol=ATOL, rtol=0)
    js = jcma.initial_state(JCMA_CFG, 3)
    ts = cma.initial_state(CMA_CFG, 3)
    for step in range(3):
        rgb = rng.standard_normal((3, 8)).astype(np.float32)
        dep = rng.standard_normal((3, 4)).astype(np.float32)
        jl, js = jcma.cma_step(jp, JCMA_CFG, ji, jm, jnp.asarray(rgb),
                               jnp.asarray(dep), js)
        tl, ts = cma.cma_step(tp, CMA_CFG, ti, tm, _t(rgb), _t(dep), ts)
        np.testing.assert_allclose(tl.detach().numpy(), jl, atol=ATOL,
                                   rtol=0, err_msg=f"logits {step}")
        np.testing.assert_allclose(ts.detach().numpy(), js, atol=ATOL,
                                   rtol=0, err_msg=f"state {step}")


def _enc_cfgs(**kw):
    base = dict(vocab_size=40, embedding_size=8, hidden_size=12)
    base.update(kw)
    return (jcma.InstructionEncoderConfig(**base),
            cma.InstructionEncoderConfig(**base))


@pytest.mark.parametrize("rnn_type", ["LSTM", "GRU"])
@pytest.mark.parametrize("bidir", [True, False])
@pytest.mark.parametrize("final", [False, True])
def test_instruction_encoder_rnn_matches_jax(rng, rnn_type, bidir, final):
    """Packed-sequence semantics on a padded batch (outputs zero past a
    sequence's end, the final state from its last valid step)."""
    jcfg, tcfg = _enc_cfgs(rnn_type=rnn_type, bidirectional=bidir,
                           final_state_only=final)
    jp = jcma.init_instruction_encoder(jax.random.PRNGKey(1), jcfg)
    tp = instruction_encoder_from_jax(_np(jp), tcfg)
    toks = rng.integers(1, jcfg.vocab_size, (3, 9))
    toks[0, 6:] = 0
    toks[2, 3:] = 0
    want = jcma.encode_instruction_rnn(jp, jcfg,
                                       {"instruction": jnp.asarray(toks)})
    got = cma.encode_instruction_rnn(tp, tcfg, {"instruction": _t(toks)})
    if final:
        assert got.shape == (3, tcfg.output_size)
        np.testing.assert_allclose(got.detach().numpy(), want, atol=ATOL,
                                   rtol=0)
        return
    np.testing.assert_allclose(got[0].detach().numpy(), want[0], atol=ATOL,
                               rtol=0)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert (got[0][2, 3:] == 0).all()


def test_instruction_encoder_rxr_features_match_jax(rng):
    jcfg, tcfg = _enc_cfgs(sensor_uuid="rxr_instruction", rnn_type="GRU")
    jp = jcma.init_instruction_encoder(jax.random.PRNGKey(2), jcfg)
    tp = instruction_encoder_from_jax(_np(jp), tcfg)
    assert not hasattr(tp, "embedding")
    feats = rng.standard_normal((2, 7, 8)).astype(np.float32)
    feats[1, 4:] = 0.0
    want = jcma.encode_instruction_rnn(
        jp, jcfg, {"rxr_instruction": jnp.asarray(feats)})
    got = cma.encode_instruction_rnn(tp, tcfg,
                                     {"rxr_instruction": _t(feats)})
    np.testing.assert_allclose(got[0].detach().numpy(), want[0], atol=ATOL,
                               rtol=0)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


def test_pretrained_embeddings_match_jax(tmp_path, rng):
    table = rng.standard_normal((40, 8)).astype(np.float32)
    path = tmp_path / "embeddings.json.gz"
    with gzip.open(path, "wt") as f:
        json.dump(table.tolist(), f)
    got = cma.load_pretrained_embeddings(str(path))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jcma.load_pretrained_embeddings(str(path))))
    _, tcfg = _enc_cfgs()
    enc = cma.init_instruction_encoder(tcfg, seed=0, embedding_weights=got)
    assert torch.equal(enc.embedding.detach(), got)


# ---------------------------------------------------------------------------
# one Adam update of each trainer against optax.adam
# ---------------------------------------------------------------------------

LR = 1e-3


def _check_adam_step(port_params, before, jgrads_tree, jnew_tree, loader):
    """Parameters after one step against optax's; where JAX's gradient is
    within 100 eps of zero, only Adam's step bound |dp| <= lr."""
    want = dict(loader(_np(jnew_tree)).named_parameters())
    grads = dict(loader(_np(jgrads_tree)).named_parameters())
    moved = 0
    for n, p in port_params.named_parameters():
        p, w, g = p.detach(), want[n].detach(), grads[n].detach()
        live = g.abs() > 100 * 1e-8
        np.testing.assert_allclose(p[live].numpy(), w[live].numpy(),
                                   atol=1e-6, rtol=0, err_msg=n)
        assert ((p - before[n]).abs()[~live] <= LR * (1 + 1e-5)).all(), n
        moved += int(live.sum())
    assert moved > 0


def test_cma_adam_update_matches_optax(tmp_path, rng):
    jp = jcma.init_cma_params(jax.random.PRNGKey(0), JCMA_CFG)
    dcfg = DaggerConfig(batch_size=3, lr=LR)
    tr = DaggerTrainer(None, CMA_CFG, dcfg, _feature_fn,
                       str(tmp_path / "store"), seed=0, device="cpu")
    load_jax_tree(tr.params, _np(jp))
    before = {n: p.detach().clone() for n, p in tr.params.named_parameters()}
    trajs = [{"tokens": rng.integers(1, 128, 12),
              "rgb": rng.standard_normal((n, 8)).astype(np.float16),
              "dep": rng.standard_normal((n, 4)).astype(np.float16),
              "teacher": rng.integers(0, 4, n).astype(np.int32)}
             for n in (5, 3)]
    batch = next(tr.update_batches(trajs, np.arange(2)))
    assert batch[1].shape == (3, 5, 8) and not batch[4][2].any()
    loss = tr.update_step(batch)

    tx = optax.adam(LR)
    jbatch = [jnp.asarray(a) for a in batch]
    jnew, _, jloss = jdagger._cma_update(jp, tx.init(jp), JCMA_CFG, tx,
                                         *jbatch)
    jgrads = jax.grad(lambda p: _cma_loss(p, *jbatch))(jp)
    assert abs(float(loss) - float(jloss)) <= ATOL
    _check_adam_step(tr.params, before, jgrads, jnew,
                     lambda t: cma_params_from_jax(t, CMA_CFG))


def _cma_loss(params, tokens, rgb, dep, teacher, step_mask):
    """The JAX CMA update's loss, for its gradients."""
    instr, imask = jcma.encode_instruction(params, JCMA_CFG, tokens)

    def step(state, xs):
        logits, state = jcma.cma_step(params, JCMA_CFG, instr, imask, *xs,
                                      state)
        return state, logits

    _, logits = jax.lax.scan(step, jcma.initial_state(JCMA_CFG,
                                                      teacher.shape[0]),
                             (rgb.transpose(1, 0, 2),
                              dep.transpose(1, 0, 2)))
    logp = jax.nn.log_softmax(logits.transpose(1, 0, 2), -1)
    nll = -jnp.take_along_axis(logp, teacher[..., None], axis=-1)[..., 0]
    return jnp.where(step_mask, nll, 0.0).sum() / jnp.maximum(
        step_mask.sum(), 1)


def test_rec_vlnbert_adam_update_matches_optax(tmp_path, rng):
    jenvs, envs = _env_pair(2, 3, JRVB_CFG)
    dcfg = DaggerConfig(batch_size=3, lr=LR, max_steps=4)
    jtr = jdagger.RecVLNBertDagger(jenvs, JRVB_CFG, _jcfg(dcfg),
                                   _candidate_fn, str(tmp_path / "j"),
                                   seed=0)
    tr = RecVLNBertDagger(envs, RVB_CFG, dcfg, _candidate_fn,
                          str(tmp_path / "t"), seed=0, device="cpu")
    load_jax_tree(tr.params, _np(jtr.params))
    before = {n: p.detach().clone() for n, p in tr.params.named_parameters()}
    K = JRVB_CFG.max_cands
    trajs = []
    for n, nt in ((4, 9), (2, 12)):
        cm = rng.random((n, K)) < 0.7
        cm[:, 0] = True
        trajs.append({
            "tokens": rng.integers(1, 512, nt),
            "rgb": rng.standard_normal((n, K, 8)).astype(np.float16),
            "dep": rng.standard_normal((n, K, 4)).astype(np.float16),
            "ang": rng.standard_normal((n, K, 4)).astype(np.float16),
            "cmask": cm, "teacher": np.zeros(n, np.int32)})
    batch = next(tr.update_batches(trajs, np.arange(2)))
    tokens, lmask, rgb, dep, ang, cmask, teach, smask = batch
    assert tokens.shape == (3, 12) and rgb.shape == (3, 4, K, 8)
    assert cmask[:, :, 0].all() and not smask[2].any()
    loss = tr.update_step(batch)

    jb = [jnp.asarray(a) for a in batch]
    jnew, _, jloss = jtr._jit_update(jtr.params, jtr.opt_state, *jb,
                                     jax.random.PRNGKey(0))
    jgrads = jax.grad(lambda p: jrvb.sequence_nll(
        p, JRVB_CFG, *jb, train=False))(jtr.params)
    assert abs(float(loss) - float(jloss)) <= ATOL
    _check_adam_step(tr.params, before, jgrads, jnew,
                     lambda t: rec_vlnbert_params_from_jax(t, RVB_CFG))


# ---------------------------------------------------------------------------
# collection, store and update shapes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("beta", [1.0, 0.5])
def test_rec_vlnbert_collect_matches_jax(tmp_path, beta):
    """On one env seed with the cheap proposer and the same weights, the
    port's collect writes JAX's store: tokens, teacher actions, candidate
    masks and fp16 features; at beta 0.5 the policy's argmax and the
    numpy stream's mixing draws pick half the actions."""
    jenvs, envs = _env_pair(2, 3, JRVB_CFG)
    dcfg = DaggerConfig(max_steps=5)
    jtr = jdagger.RecVLNBertDagger(jenvs, JRVB_CFG, _jcfg(dcfg),
                                   _candidate_fn, str(tmp_path / "j"),
                                   seed=0)
    tr = RecVLNBertDagger(envs, RVB_CFG, dcfg, _candidate_fn,
                          str(tmp_path / "t"), seed=0, device="cpu")
    load_jax_tree(tr.params, _np(jtr.params))
    jtr.collect(beta, episodes=3)
    tr.collect(beta, episodes=3)
    _same_store(jtr.store, tr.store)
    assert tr.store.shard_files()[0].endswith(".npz")
    assert tr.shapes["nav"] == {(2, JRVB_CFG.max_cands, 8)}
    # the stream stayed in step: the next draws agree
    assert jtr.rng.random() == tr.rng.random()


def test_cma_collect_matches_jax(tmp_path):
    jenvs, envs = _env_pair(2, 0, JCMA_CFG)
    dcfg = DaggerConfig(max_steps=30)
    jtr = jdagger.DaggerTrainer(jenvs, JCMA_CFG, _jcfg(dcfg), _feature_fn,
                                str(tmp_path / "j"), seed=0)
    tr = DaggerTrainer(envs, CMA_CFG, dcfg, _feature_fn,
                       str(tmp_path / "t"), seed=0, device="cpu")
    load_jax_tree(tr.params, _np(jtr.params))
    jtr.collect(0.5, episodes=2)
    tr.collect(0.5, episodes=2)
    _same_store(jtr.store, tr.store)
    assert tr.shapes["step"] == {(2, 8)}


def test_trajectory_store_roundtrip(tmp_path):
    """fp16 floats, other dtypes kept, records in order across shards,
    and a reopened store appends after the existing shards."""
    store = TrajectoryStore(str(tmp_path / "store"), flush_every=2)
    recs = [{"tokens": np.arange(5) + i,
             "rgb": np.full((3, 8), i, np.float32),
             "teacher": np.asarray([1, 2, i], np.int32)} for i in range(3)]
    for r in recs:
        store.append(r)
    store.flush()
    assert len(store.shard_files()) == 2 and len(store) == 3
    again = TrajectoryStore(str(tmp_path / "store"))
    again.append(recs[0])
    again.flush()
    back = list(again)
    assert len(back) == 4
    for got, want in zip(back, recs + recs[:1]):
        assert got["rgb"].dtype == np.float16
        assert got["teacher"].dtype == np.int32
        np.testing.assert_array_equal(got["tokens"], want["tokens"])
        np.testing.assert_array_equal(got["rgb"], want["rgb"])
        np.testing.assert_array_equal(got["teacher"], want["teacher"])


class _CrashFirst:
    """Reports the first env's first step as a crashed worker's."""

    def __init__(self, inner, method):
        self._inner = inner
        self._method = method
        self._fired = False

    def __getattr__(self, name):
        if name != self._method:
            return getattr(self._inner, name)

        def step(actions):
            results = getattr(self._inner, name)(actions)
            if not self._fired and self._inner.num_envs > 1:
                self._fired = True
                results[0] = StepResult(results[0].observation, True,
                                        {"crashed": True})
            return results
        return step


@pytest.mark.parametrize("policy", ["cma", "rec_vlnbert"])
def test_collect_drops_crashed_episodes(tmp_path, policy):
    if policy == "cma":
        _, envs = _env_pair(2, 0, JCMA_CFG)
        tr = DaggerTrainer(_CrashFirst(envs, "step_low_level"), CMA_CFG,
                           DaggerConfig(max_steps=30), _feature_fn,
                           str(tmp_path / "s"), device="cpu")
    else:
        _, envs = _env_pair(2, 3, JRVB_CFG)
        tr = RecVLNBertDagger(_CrashFirst(envs, "step"), RVB_CFG,
                              DaggerConfig(max_steps=5), _candidate_fn,
                              str(tmp_path / "s"), device="cpu")
    tr.collect(beta=1.0, episodes=1)
    assert len(tr.store) == 1           # the surviving env's episode only


@pytest.mark.parametrize("policy", ["cma", "rec_vlnbert"])
def test_update_one_shape(tmp_path, policy):
    """3 episodes at batch 2 over 2 epochs: every batch is padded to the
    full batch and the store-wide T (and token width), so one update()
    launches one shape; collect and evaluate keep the nav batch at B."""
    if policy == "cma":
        _, envs = _env_pair(3, 0, JCMA_CFG)
        tr = DaggerTrainer(envs, CMA_CFG, DaggerConfig(
            epochs=2, batch_size=2, max_steps=10), _feature_fn,
            str(tmp_path / "s"), device="cpu")
    else:
        _, envs = _env_pair(3, 7, JRVB_CFG)
        tr = RecVLNBertDagger(envs, RVB_CFG, DaggerConfig(
            epochs=2, batch_size=2, lr=1e-3, max_steps=5), _candidate_fn,
            str(tmp_path / "s"), device="cpu")
    tr.collect(beta=1.0, episodes=3)
    calls = []
    step = tr.update_step
    tr.update_step = lambda b: calls.append(b[1].shape) or step(b)
    assert np.isfinite(tr.update())
    assert len(calls) == 4 and len(tr.shapes["update"]) == 1
    assert calls[0][0] == 2
    if policy == "rec_vlnbert":
        tr.evaluate(3, success_distance=3.0)
        assert tr.shapes["nav"] == {(3, JRVB_CFG.max_cands, 8)}


def test_update_learns_teacher(tmp_path):
    """Pure-teacher collection, then supervised epochs drive the CE
    down."""
    _, envs = _env_pair(2, 3, JRVB_CFG)
    tr = RecVLNBertDagger(envs, RVB_CFG, DaggerConfig(
        epochs=1, batch_size=2, lr=3e-3, max_steps=5), _candidate_fn,
        str(tmp_path / "s"), seed=1, device="cpu")
    tr.collect(beta=1.0, episodes=2)
    first = tr.update(epochs=1)
    last = tr.update(epochs=3)
    assert np.isfinite([first, last]).all() and last < first


# ---------------------------------------------------------------------------
# oracle teacher, greedy eval, recollection
# ---------------------------------------------------------------------------

def test_oracle_teacher_matches_jax_and_stop_rules(tmp_path):
    """The teacher picks JAX's candidates; STOP inside the trigger
    radius, and STOP with no valid motion candidate."""
    jenvs, envs = _env_pair(2, 3, JRVB_CFG)
    jtr = jdagger.RecVLNBertDagger(jenvs, JRVB_CFG, jdagger.DaggerConfig(),
                                   _candidate_fn, str(tmp_path / "j"))
    tr = RecVLNBertDagger(envs, RVB_CFG, DaggerConfig(), _candidate_fn,
                          str(tmp_path / "t"), device="cpu")
    for e in (jenvs, envs):
        e.resume_all()
    cand = _candidate_fn(envs.reset())
    jcand = _candidate_fn(jenvs.reset())
    teach, pos = tr._teacher(cand)
    jteach, jpos = jtr._teacher(jcand)
    np.testing.assert_array_equal(teach, jteach)
    for a, b in zip(pos, jpos):
        np.testing.assert_array_equal(a, b)
    cur = envs.current_dist_to_goal()
    for i in range(envs.num_envs):
        if cur[i] < RecVLNBertDagger.STOP_TRIGGER_M:
            assert teach[i] == 0
        else:
            dg = envs.point_dists_to_goal(i, pos[i])
            assert dg[teach[i] - 1] == dg.min()
    tr.STOP_TRIGGER_M = 1e9                  # inside the radius: STOP
    assert (tr._teacher(cand)[0] == 0).all()
    tr.STOP_TRIGGER_M = 0.0
    cand["mask"][:] = False                  # nowhere to go: STOP
    assert (tr._teacher(cand)[0] == 0).all()


def test_greedy_evaluate_matches_jax(tmp_path):
    """The greedy eval's SR / SPL / nDTW equal JAX's: the first decision
    is the policy's argmax on the same weights, STOP from the second
    on."""
    jenvs, envs = _env_pair(2, 3, JRVB_CFG)
    dcfg = DaggerConfig(max_steps=4)
    jtr = jdagger.RecVLNBertDagger(jenvs, JRVB_CFG, _jcfg(dcfg),
                                   _candidate_fn, str(tmp_path / "j"))
    tr = RecVLNBertDagger(envs, RVB_CFG, dcfg, _candidate_fn,
                          str(tmp_path / "t"), device="cpu")
    load_jax_tree(tr.params, _np(jtr.params))
    jnav, nav, calls = jtr._jit_nav, tr._nav, {"j": 0, "t": 0}

    def jscripted(params, **kw):
        logits, state = jnav(params, **kw)
        calls["j"] += 1
        if calls["j"] >= 2:
            logits = jnp.full_like(logits, -1e9).at[:, 0].set(0.0)
        return logits, state

    def scripted(*args):
        logits, state = nav(*args)
        calls["t"] += 1
        if calls["t"] >= 2:
            logits = torch.full_like(logits, -1e9)
            logits[:, 0] = 0.0
        return logits, state

    jtr._jit_nav, tr._nav = jscripted, scripted
    want = jtr.evaluate(episodes=2)
    got = tr.evaluate(episodes=2)
    assert got and set(got) == set(want)
    for key in ("success", "spl", "ndtw", "distance_to_goal",
                "steps_taken"):
        assert np.isfinite(got[key]), key
        np.testing.assert_allclose(got[key], want[key], rtol=1e-12,
                                   err_msg=key)


def test_recollection_sampler_matches_jax():
    jenvs, envs = _env_pair(2, 0, JCMA_CFG)
    want = next(iter(jdagger.TeacherRecollectionSampler(
        jenvs, _feature_fn, max_steps=30)))
    got = next(iter(TeacherRecollectionSampler(envs, _feature_fn,
                                               max_steps=30)))
    assert set(got) == set(want)
    for k in got:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["rgb"].shape[0] == got["teacher"].shape[0]


# ---------------------------------------------------------------------------
# the runner: run.py --trainer DAgger (as tests/test_run_dagger.py)
# ---------------------------------------------------------------------------

def _exp(tmp_path, extra=""):
    p = tmp_path / "exp.yaml"
    p.write_text("BASE: tiny\n" + extra)
    return ["--exp-config", str(p), "--device", "cpu", "--trainer", "DAgger",
            "--num-envs", "2"]


@pytest.mark.parametrize("policy", ["rec_vlnbert", "cma"])
def test_run_dagger_trains(tmp_path, policy):
    losses = run(_exp(tmp_path) + [f"DAGGER.policy={policy}",
                                   f"DAGGER.store_dir={tmp_path / 's'}"])
    assert isinstance(losses, list) and len(losses) == 1
    assert np.isfinite(losses).all()
    assert len(TrajectoryStore(str(tmp_path / "s"))) >= 2


def test_run_dagger_eval(tmp_path):
    """--run-type eval runs the greedy legacy eval loop (a forced stop at
    the step cap scores every episode)."""
    stats = run(_exp(tmp_path) + ["--run-type", "eval", "--episode-count",
                                  "2", f"DAGGER.store_dir={tmp_path / 's'}"])
    for key in ("success", "spl", "ndtw"):
        assert np.isfinite(stats[key]), key


@pytest.mark.parametrize("extra,match", [
    (["--run-type", "eval", "DAGGER.policy=cma"], "rec_vlnbert"),
    (["--run-type", "inference"], "inference"),
    (["--ckpt", "some_ckpt.pt"], "cannot load checkpoints"),
    (["--run-type", "serve"], "no session surface"),
    (["DAGGER.policy=seq2seq"], "unknown DAGGER.policy"),
])
def test_run_dagger_refusals(tmp_path, extra, match):
    """JAX's refusals, with JAX's messages."""
    with pytest.raises(ValueError, match=match):
        run(_exp(tmp_path) + extra + [f"DAGGER.store_dir={tmp_path / 's'}"])


def test_dagger_trainers_raise_without_a_gpu(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DaggerTrainer(None, CMA_CFG, DaggerConfig(), _feature_fn,
                      str(tmp_path / "s"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run([a for a in _exp(tmp_path) if a not in ("--device", "cpu")]
            + [f"DAGGER.store_dir={tmp_path / 's'}"])
    assert dagger.make_adam(torch.nn.Linear(2, 2), 0.1).defaults["eps"] \
        == 1e-8
