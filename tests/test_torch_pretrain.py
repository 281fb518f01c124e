"""The port's pretraining stage (`training/pretrain.py`,
`data/pretrain_data.py`, the planner's lang2visn branch and pretraining
heads) against the JAX package's, on the CPU at the tiny shapes of
`tests/test_pretrain.py`, with the same seeded numpy weights carried
across by `pretrain_params_from_jax`.

- Sampler: every task's batch, and the MetaSampler's task stream, equal
  to JAX's with `np.array_equal`.
- The four forwards and losses at fp32 with dropout off (JAX at
  `highest` matmul precision): logits within ATOL (3e-5 absolute; only
  the order of fp32 sums differs), losses within LOSS_REL.
- The mlm and sap losses and every gradient against `jax.grad`:
  max |diff| <= GRAD_REL * max |g_jax| + 1e-6 per tensor (the bound of
  `tests/test_torch_training.py`).
- The same two losses with `use_bf16=True`, the JAX side compiled with
  `xla_allow_excess_precision` off and its attention through the Pallas
  kernels in interpret mode, as `tests/test_torch_bf16_parity.py` does.
- Every optimizer family, both schedules, the global-norm clip and
  Lookahead against optax over 8 updates, with a subtree whose loss
  takes no gradient; the learning rate of updates 0..warmup+2 equal to
  JAX's schedule in fp32; the no-decay mask leaf by leaf.
- The trainer: checkpoint and exact resume, the loss falling over 30
  SAP steps, validation, the YAML PRETRAIN section.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from etpnav_tpu.config import tiny_config as jax_tiny_config
from etpnav_tpu.data import pretrain_data as jpd
from etpnav_tpu.ops import attention as jax_attention
from etpnav_tpu.ops import pallas_attention as jpa
from etpnav_tpu.training import pretrain as jpt
from etpnav_tpu_torch import config_yaml
from etpnav_tpu_torch.config import tiny_config
from etpnav_tpu_torch.data import pretrain_data as pd
from etpnav_tpu_torch.models.convert import load_jax_tree, \
    pretrain_params_from_jax
from etpnav_tpu_torch.ops import fused_attention as fa
from etpnav_tpu_torch.training import pretrain as pt

torch.set_num_threads(2)

ATOL = 3e-5
LOSS_REL = 1e-5
GRAD_REL = 1e-4
TASKS = ("mlm", "sap", "mrc", "og")

SHAPES = dict(max_txt_len=16, max_traj_steps=4, num_views=12, max_cands=4,
              max_gmap_len=24, image_feat_size=32, depth_feat_size=16,
              vocab_size=512, mask_token_id=3, mask_vocab_range=(10, 500),
              image_prob_size=24, num_objs=3)


def _configs(**pretrain):
    """(JAX config, port config) at the tiny shapes, all four tasks."""
    out = []
    for base in (jax_tiny_config(), tiny_config()):
        pl = dataclasses.replace(base.planner, max_txt_len=16,
                                 image_feat_size=32, depth_feat_size=16,
                                 num_nav_types=3)
        p = dataclasses.replace(base.pretrain, **{
            "batch_size": 4, "warmup_steps": 2, "num_train_steps": 50,
            "learning_rate": 5e-4, "tasks": TASKS,
            "task_ratios": (1.0,) * 4, "image_prob_size": 24,
            "num_objs": 3, **pretrain})
        out.append(dataclasses.replace(base, planner=pl, pretrain=p))
    return out


def random_tree(jcfg, seed=3):
    """The JAX `init_pretrain_params` tree (shapes from eval_shape) with
    seeded numpy values: norm scales near 1, biases ~0.1, the rest std
    0.02 (embedding tables 0.5, so the tied decoder's logits spread)."""
    shapes = jax.eval_shape(
        lambda k: jpt.init_pretrain_params(k, jcfg.planner, TASKS, 24),
        jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)

    def fill(path, s):
        name = getattr(path[-1], "key", None)
        z = rng.standard_normal(s.shape)
        if name == "scale":
            z = 1.0 + 0.1 * z
        elif name in ("bias", "b"):
            z = 0.1 * z
        elif name == "word_embeddings":
            z = 0.5 * z
        else:
            z = 0.05 * z
        return z.astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


@pytest.fixture(scope="module")
def pair():
    jcfg, cfg = _configs()
    tree = random_tree(jcfg)
    params = pretrain_params_from_jax(tree, cfg)
    sampler = jpd.PretrainSampler(jpd.PretrainShapes(**SHAPES), seed=4,
                                  num_scans=2, scan_size=12)
    batches = {t: sampler.sample_batch(4, t) for t in TASKS}
    return jcfg, cfg, tree, params, batches


def _port_batch(batch):
    return pt.batch_to_device(batch, "cpu")


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("task", TASKS)
def test_sampler_batches_equal_jax(task):
    js = jpd.PretrainSampler(jpd.PretrainShapes(**SHAPES), seed=11,
                             num_scans=2, scan_size=12)
    ps = pd.PretrainSampler(pd.PretrainShapes(**SHAPES), seed=11,
                            num_scans=2, scan_size=12)
    for _ in range(2):
        want, got = js.sample_batch(3, task), ps.sample_batch(3, task)
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            assert np.array_equal(got[k], want[k]), k


def test_meta_sampler_stream_equals_jax():
    js = jpd.PretrainSampler(jpd.PretrainShapes(**SHAPES), seed=2,
                             num_scans=2, scan_size=12)
    ps = pd.PretrainSampler(pd.PretrainShapes(**SHAPES), seed=2,
                            num_scans=2, scan_size=12)
    jm = iter(jpd.MetaSampler(js, 2, (1.0, 2.0, 1.0, 1.0), seed=5,
                              tasks=TASKS))
    pm = iter(pd.MetaSampler(ps, 2, (1.0, 2.0, 1.0, 1.0), seed=5,
                             tasks=TASKS))
    tasks = []
    for _ in range(8):
        (jt, jb), (t, b) = next(jm), next(pm)
        assert t == jt
        tasks.append(t)
        assert all(np.array_equal(b[k], jb[k]) for k in jb)
    assert len(set(tasks)) >= 3


# ---------------------------------------------------------------------------
# forwards, losses, gradients (fp32)
# ---------------------------------------------------------------------------

_FORWARDS = {"sap": "forward_sap", "mlm": "forward_mlm",
             "mrc": "forward_mrc", "og": "forward_og"}
_LOSSES = {"sap": "sap_loss", "mlm": "mlm_loss", "mrc": "mrc_loss",
           "og": "og_loss"}


@pytest.mark.parametrize("task", TASKS)
def test_forward_and_loss_match_jax(pair, task):
    jcfg, cfg, tree, params, batches = pair
    batch = batches[task]
    jfwd = getattr(jpt, _FORWARDS[task])
    want = np.asarray(jax.jit(lambda p, b: jfwd(p, jcfg.planner, b))(
        tree, batch))
    jloss = float(jax.jit(lambda p, b: getattr(jpt, _LOSSES[task])(
        p, jcfg.planner, b, None))(tree, batch))
    tb = _port_batch(batch)
    with torch.no_grad():
        got = getattr(pt, _FORWARDS[task])(params, cfg.planner, tb).numpy()
        loss = getattr(pt, _LOSSES[task])(params, cfg.planner, tb).item()
    assert got.shape == want.shape
    fin = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), fin)
    assert fin.any()
    np.testing.assert_allclose(got[fin], want[fin], atol=ATOL)
    assert np.isfinite(loss) and loss > 0
    assert abs(loss - jloss) <= LOSS_REL * abs(jloss), (loss, jloss)


def _attention_counts():
    return (fa.attention_plain_calls.value,
            fa.attention_bwd_plain_calls.value)


@pytest.mark.parametrize("task", ["mlm", "sap"])
def test_loss_and_grads_match_jax_grad(pair, task):
    jcfg, cfg, tree, _, batches = pair
    batch = batches[task]
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: getattr(jpt, _LOSSES[task])(p, jcfg.planner, b, None)))(
        tree, batch)
    params = pretrain_params_from_jax(tree, cfg)
    before = _attention_counts()
    loss = getattr(pt, _LOSSES[task])(params, cfg.planner,
                                      _port_batch(batch))
    loss.backward()
    after = _attention_counts()
    # every attention ran forward and backward through AttentionFn: text,
    # pano (over B*T panoramas), then per cross-modal layer either graph
    # cross + self (sap) or text-into-graph cross + text self (mlm)
    p = cfg.planner
    n_att = p.num_l_layers + p.num_pano_layers + 2 * p.num_x_layers
    assert (after[0] - before[0], after[1] - before[1]) == (n_att, n_att)
    assert abs(loss.item() - float(jloss)) <= LOSS_REL * abs(float(jloss))
    want = dict(pretrain_params_from_jax(
        jax.tree_util.tree_map(np.asarray, jgrads), cfg).named_parameters())
    reached = 0
    for name, prm in params.named_parameters():
        w = want[name].detach()
        g = prm.grad if prm.grad is not None else torch.zeros_like(prm)
        tol = GRAD_REL * w.abs().max().item() + 1e-6
        err = (g - w).abs().max().item()
        assert err <= tol, (name, err, tol)
        reached += prm.grad is not None
    assert reached > 10
    if task == "mlm":
        # the tied decoder: the word table's gradient comes through the
        # decoder for every row and through the lookup for the ids used
        gw = params.embeddings.word_embeddings.grad
        assert (gw.abs().sum(-1) > 0).all()
        assert params.global_encoder.encoder[0].lang_ffn.intermediate \
            .weight.grad is not None
        assert params.global_sap_head.dense1.weight.grad is None


# ---------------------------------------------------------------------------
# bf16
# ---------------------------------------------------------------------------

def strict(fn, *args):
    """fn(*args) compiled with every bf16 rounding kept."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})(*args)


@pytest.fixture
def jax_attention_kernels(monkeypatch):
    """attn_probs_bf16 off; every JAX attention through its Pallas kernel
    in interpret mode (K-ATT's rounding points)."""
    monkeypatch.setattr(jax_attention, "PROBS_BF16", False)
    monkeypatch.setattr(jax_attention, "USE_FUSED_ATTENTION", True)
    monkeypatch.setattr(jax_attention, "USE_FUSED_ATTENTION_NOBIAS", True)
    for name in ("fused_attention", "fused_attention_nhd",
                 "fused_bias_attention"):
        monkeypatch.setattr(jpa, name, functools.partial(
            getattr(jpa, name), interpret=True))


# bf16 losses relative to JAX's, about twice what was measured on the
# CPU over weight seeds 3, 5, 7: mlm 6.2e-7 / 1.4e-7 / 1.2e-7 (its
# lang2visn branch and decoder run in fp32, as in JAX), sap 2.6e-5 / 0 /
# 8e-8. The fp32 sums of the bf16 stacks run in another order, so a value
# next to a rounding tie lands one bf16 ulp apart, and at seed 3 one such
# ulp reaches the SAP logits.
BF16_LOSS_REL = {"mlm": 2e-6, "sap": 5e-5}


@pytest.mark.parametrize("task", ["mlm", "sap"])
def test_bf16_losses_match_jax(pair, jax_attention_kernels, task):
    jcfg, cfg, tree, _, batches = pair
    jcfg = dataclasses.replace(jcfg, planner=dataclasses.replace(
        jcfg.planner, use_bf16=True))
    cfg = dataclasses.replace(cfg, planner=dataclasses.replace(
        cfg.planner, use_bf16=True))
    batch = batches[task]
    jloss = float(strict(lambda p, b: getattr(jpt, _LOSSES[task])(
        p, jcfg.planner, b, None), tree,
        {k: jnp.asarray(v) for k, v in batch.items()}))
    params = pretrain_params_from_jax(tree, cfg)
    with torch.no_grad():
        loss = getattr(pt, _LOSSES[task])(params, cfg.planner,
                                          _port_batch(batch)).item()
    rel = abs(loss - jloss) / abs(jloss)
    assert rel <= BF16_LOSS_REL[task], (loss, jloss, rel)


# ---------------------------------------------------------------------------
# optimizer family, schedules, clip, lookahead
# ---------------------------------------------------------------------------

def _grad_tree(tree, rng, norm):
    """Seeded gradients with global norm `norm`; the MLM head's are zero
    (a head the step's loss does not reach)."""
    g = jax.tree_util.tree_map(
        lambda x: rng.standard_normal(x.shape).astype(np.float32), tree)
    g["mlm_head"] = jax.tree_util.tree_map(np.zeros_like, g["mlm_head"])
    total = np.sqrt(sum(float((x.astype(np.float64) ** 2).sum())
                        for x in jax.tree_util.tree_leaves(g)))
    return jax.tree_util.tree_map(
        lambda x: (x * (norm / total)).astype(np.float32), g)


# 8 updates: warmup (the first at the schedule's count 0), RAdam's
# rectification from update 6 (rho >= 5 at b2 = 0.98), Lookahead's sync
# at k; gradient norms alternate around grad_norm so the clip both
# scales and passes
OPT_CASES = [("adamw", {}), ("adam", {}), ("adamax", {}), ("radam", {}),
             ("ralamb", {}), ("rangerlars", {}),
             ("rangerlars", {"lookahead_k": 2}),
             ("adamw", {"lr_sched": "noam"})]


@pytest.mark.parametrize("optim,extra", OPT_CASES,
                         ids=[f"{o}-{'-'.join(map(str, e.values())) or 'default'}"
                              for o, e in OPT_CASES])
def test_optimizer_matches_optax(optim, extra):
    jcfg, cfg = _configs(optim=optim, learning_rate=1e-2, **extra)
    tree = jax.tree_util.tree_map(np.asarray, random_tree(jcfg, seed=8))
    tx = jpt.make_optimizer(jcfg)
    state = tx.init(tree)
    jp = tree
    params = pretrain_params_from_jax(tree, cfg)
    opt = pt.make_optimizer(cfg, params)
    rng = np.random.default_rng(1)
    for i in range(8):
        g = _grad_tree(tree, rng, cfg.pretrain.grad_norm
                       * (0.5 if i % 2 else 3.0))
        u, state = jax.jit(tx.update)(g, state, jp)
        jp = jax.tree_util.tree_map(np.asarray, optax.apply_updates(jp, u))
        grads = dict(pretrain_params_from_jax(g, cfg).named_parameters())
        for name, p in params.named_parameters():
            p.grad = (None if name.startswith("mlm_head.")
                      else grads[name].detach().clone())
        opt.step()
    want = dict(pretrain_params_from_jax(jp, cfg).named_parameters())
    init = dict(pretrain_params_from_jax(tree, cfg).named_parameters())
    decay = pt.decay_mask(params)
    for name, p in params.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(),
                                   want[name].detach().numpy(), atol=1e-6,
                                   rtol=1e-5, err_msg=name)
        # with no gradient (the MLM head) only weight decay moves a tensor
        moves = not name.startswith("mlm_head.") or decay[name]
        assert torch.equal(p, init[name]) != moves, name
    assert opt.param_groups[0]["count"] == 8


@pytest.mark.parametrize("sched", ["warmup_linear", "noam"])
def test_schedule_matches_jax(sched):
    _, cfg = _configs(lr_sched=sched, warmup_steps=3, num_train_steps=10)
    lr = pt.schedule(cfg)
    p = cfg.pretrain
    for step in list(range(p.warmup_steps + 3)) + [9, 10, 12]:
        if sched == "noam":
            want = jpt.noam_schedule(step, p.learning_rate, p.warmup_steps)
        else:
            want = jnp.maximum(jpt.warmup_linear(
                step, p.learning_rate, p.warmup_steps, p.num_train_steps),
                1e-8)
        assert np.float32(lr(step)) == np.float32(want), (step, lr(step),
                                                          want)
    if sched == "warmup_linear":
        assert lr(0) == float(np.float32(1e-8))


def test_clip_is_optax_formula():
    """Norm >= max scales by max / norm, with no +1e-6 (torch's
    clip_grad_norm_); a norm below max passes the gradient unchanged."""
    _, cfg = _configs(optim="adamw", learning_rate=1.0, weight_decay=0.0,
                      grad_norm=2.0)
    for scale, want_norm in ((4.0, 2.0), (0.5, 0.5)):
        w = torch.nn.Linear(3, 1, bias=False)
        opt = pt.PretrainOptimizer(w.named_parameters(), cfg,
                                   {"weight": True})
        w.weight.grad = torch.full((1, 3), scale / np.sqrt(3.0))
        opt.step()
        mu = opt.state[w.weight]["mu"]
        # mu = (1 - b1) * clipped g after one update
        norm = (mu / (1 - cfg.pretrain.betas[0])).norm().item()
        assert norm == pytest.approx(want_norm, rel=1e-6)


def test_lookahead_slow_copy_is_not_an_alias():
    _, cfg = _configs(optim="rangerlars")
    params = pt.init_pretrain_params(cfg.planner,
                                     torch.Generator().manual_seed(0),
                                     ("sap",))
    opt = pt.make_optimizer(cfg, params)
    for p in params.parameters():
        p.grad = torch.ones_like(p)
    opt.step()
    p = params.global_sap_head.dense2.weight
    slow = opt.state[p]["slow"]
    assert slow.data_ptr() != p.data_ptr()
    assert not torch.equal(slow, p)       # fast moved, slow did not


def test_decay_mask_equals_jax_leaf_by_leaf():
    """The port decides decay by module type; JAX by path name. Read
    JAX's mask off one adamw update from zero gradients (only the masked
    decay moves a leaf), carry it through `load_jax_tree`'s name map, and
    compare tensor by tensor."""
    jcfg, cfg = _configs(optim="adamw")
    tree = jax.tree_util.tree_map(np.ones_like, random_tree(jcfg))
    tx = jpt.make_optimizer(jcfg)
    u, _ = jax.jit(tx.update)(jax.tree_util.tree_map(np.zeros_like, tree),
                              tx.init(tree), tree)
    mask_tree = jax.tree_util.tree_map(
        lambda x: np.full(x.shape, float(np.any(np.asarray(x) != 0)),
                          np.float32), u)
    mask = pt.PretrainParams(cfg.planner, TASKS, 24)
    load_jax_tree(mask, mask_tree)
    ours = pt.decay_mask(mask)
    assert set(ours) == {n for n, _ in mask.named_parameters()}
    for name, p in mask.named_parameters():
        assert (p == float(ours[name])).all(), name
    assert ours["embeddings.word_embeddings"]
    assert ours["global_encoder.gmap_step_embeddings"]
    assert not ours["mlm_head.bias"]
    assert not ours["global_encoder.encoder.0.lang_ffn.output.ln.weight"]
    assert ours["global_encoder.sprel_linear.weight"]


# ---------------------------------------------------------------------------
# trainer
# ---------------------------------------------------------------------------

def _trainer(cfg, seed=0, **kw):
    return pt.PretrainTrainer(cfg, pd.PretrainShapes(**SHAPES), seed=seed,
                              num_scans=2, scan_size=12, device="cpu", **kw)


def test_checkpoint_resume_is_exact(tmp_path):
    _, cfg = _configs(optim="rangerlars", lookahead_k=2)
    tr = _trainer(cfg)
    logs = tr.train_steps(3)
    assert all(np.isfinite(v) for v in logs.values())
    tr.save_checkpoint(str(tmp_path / "model_step_3.pt"))
    batch = tr._put(tr.sampler.sample_batch(4, "mlm"))
    loss_a = tr.train_step("mlm", batch)

    tr2 = _trainer(cfg, seed=7)
    assert tr2.resume_latest(str(tmp_path))
    assert tr2.step == 3
    assert tr2.optimizer.param_groups[0]["count"] == 3
    loss_b = tr2.train_step("mlm", batch)
    # the restored generator draws the same dropout, the restored
    # moments and slow copy take the same update
    assert torch.equal(loss_a, loss_b)
    for (n, p), q in zip(tr.params.named_parameters(),
                         tr2.params.parameters()):
        assert torch.equal(p, q), n
    assert not _trainer(cfg).resume_latest(str(tmp_path / "empty"))


def test_sap_loss_decreases_and_validates():
    _, cfg = _configs(batch_size=8)
    tr = _trainer(cfg)
    first, last = [], []
    for i in range(30):
        batch = tr._put(tr.sampler.sample_batch(8, "sap"))
        loss = float(tr.train_step("sap", batch))
        (first if i < 5 else last).append(loss)
    assert np.mean(last[-5:]) < np.mean(first), (first, last)
    val = tr.validate(n_batches=1)
    assert set(val) == {"mlm_acc", "sap_acc", "mrc_kl", "og_acc"}
    assert 0.0 <= val["sap_acc"] <= 1.0 and np.isfinite(val["mrc_kl"])


def test_train_steps_saves_every_valid_steps(tmp_path):
    _, cfg = _configs(valid_steps=2)
    tr = _trainer(cfg)
    logs = tr.train_steps(4, ckpt_dir=str(tmp_path))
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "model_step_2.pt", "model_step_4.pt"]
    assert "val_sap_acc" in logs


def test_yaml_pretrain_section(tmp_path):
    cfg = config_yaml.config_from_dict({
        "BASE": "tiny", "PRETRAIN": {"optim": "ralamb", "tasks": ["mlm"],
                                     "task_ratios": [1.0], "resume": True}})
    assert cfg.pretrain.optim == "ralamb"
    assert cfg.pretrain.tasks == ("mlm",)
    assert cfg.pretrain.resume is True
    # TPU-only keys of the section are refused like IL's
    with pytest.raises(KeyError, match="rng_impl"):
        config_yaml.config_from_dict({"PRETRAIN": {"rng_impl": "rbg"}})
    shapes = pt.pretrain_shapes(tiny_config())
    assert shapes.max_gmap_len == 48 and shapes.max_txt_len == 16
    assert shapes.mask_vocab_range[1] <= tiny_config().planner.vocab_size


# ---------------------------------------------------------------------------
# real-data source and record loader
# ---------------------------------------------------------------------------

def _mp3d(tmp_path, prob_size):
    from test_vector_env import _mp3d_artifacts, _mp3d_shapes
    jsh = _mp3d_shapes(image_prob_size=prob_size)
    _mp3d_artifacts(tmp_path, jsh,
                    img_cols=jsh.image_feat_size + prob_size)
    files = ([str(tmp_path / "anno.json")], str(tmp_path / "img.h5"),
             str(tmp_path / "dep.h5"), str(tmp_path))
    return jsh, pd.PretrainShapes(**dataclasses.asdict(jsh)), files


@pytest.mark.parametrize("task", ["mlm", "sap", "mrc"])
def test_mp3d_source_batches_equal_jax(tmp_path, task):
    """MP3DTrajectoryData over tiny annotation, connectivity and HDF5
    files: every batch equal to the JAX package's, element for element."""
    from etpnav_tpu.data.mp3d_pretrain import MP3DTrajectoryData as JData
    from etpnav_tpu_torch.data.mp3d_pretrain import MP3DTrajectoryData
    jsh, sh, files = _mp3d(tmp_path, 4)
    jd, d = JData(jsh, *files, seed=3), MP3DTrajectoryData(sh, *files,
                                                           seed=3)
    for _ in range(3):
        want, got = jd.sample_batch(4, task), d.sample_batch(4, task)
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            assert np.array_equal(got[k], want[k]), k
    with pytest.raises(NotImplementedError, match="object annotations"):
        d.sample_batch(2, "og")


def test_mp3d_check_store_matches_jax(tmp_path):
    from etpnav_tpu.data.mp3d_pretrain import check_store as jcheck
    from etpnav_tpu_torch.data.mp3d_pretrain import check_store
    jsh, sh, files = _mp3d(tmp_path, 4)
    quiet = lambda _: None   # noqa: E731
    want = jcheck(*files, shapes=jsh, print_fn=quiet)
    got = check_store(*files, shapes=sh, print_fn=quiet)
    assert got == want and got["mrc_capable"]


def test_record_loader_batches_match_sample_batch(tmp_path):
    """Records written per task, loaded through the DataLoader unshuffled:
    SAP and OG batches equal `sample_batch` of a sampler with the same
    seed (no load-time draw); MLM and MRC equal it outside their
    load-time masks, with the masks' semantics; every batch has
    `sample_batch`'s keys, dtypes and shapes."""
    from etpnav_tpu_torch.data import pretrain_loader as pl
    sh = pd.PretrainShapes(**SHAPES)
    files, want = {}, {}
    for task in TASKS:
        files[task] = pl.write_task_records(
            str(tmp_path / f"{task}.rec"),
            pd.PretrainSampler(sh, seed=9, num_scans=2, scan_size=12),
            task, 6)
        want[task] = pd.PretrainSampler(
            sh, seed=9, num_scans=2, scan_size=12).sample_batch(3, task)
    for task in TASKS:
        loader = pl.build_task_loader([files[task]], task, sh, 3,
                                      shuffle=False, seed=1)
        batches = list(loader)
        assert len(batches) == 2
        got = batches[0]
        assert set(got) == set(want[task])
        for k, w in want[task].items():
            assert got[k].dtype == w.dtype and got[k].shape == w.shape, k
            if k in ("txt_ids", "txt_labels", "vp_img",
                     "vp_view_mrc_masks"):
                continue
            assert np.array_equal(got[k], w), (task, k)
        if task in ("sap", "og"):
            assert all(np.array_equal(got[k], want[task][k]) for k in got)
        if task == "mlm":
            # the tokens before masking, from either side's labels
            lab, wl = got["txt_labels"], want[task]["txt_labels"]
            orig = np.where(wl >= 0, wl, want[task]["txt_ids"])
            assert (lab >= 0).any()
            assert np.array_equal(np.where(lab >= 0, lab, got["txt_ids"]),
                                  orig)
            assert not (lab[~got["txt_masks"]] >= 0).any()
        if task == "mrc":
            m = got["vp_view_mrc_masks"]
            assert m.any(axis=1).all()
            for i in range(3):
                t = int(got["last_step"][i])
                assert (got["vp_img"][i, t][m[i]] == 0).all()
    # MetaLoader's task stream is MetaSampler's for the same seed
    loaders = {t: pl.build_task_loader([files[t]], t, sh, 3, seed=2)
               for t in TASKS}
    meta = pl.MetaLoader(loaders, (1.0, 2.0, 1.0, 1.0), seed=5)
    ref = iter(pd.MetaSampler(pd.PretrainSampler(sh, seed=0, num_scans=1,
                                                 scan_size=8), 1,
                              (1.0, 2.0, 1.0, 1.0), seed=5, tasks=TASKS))
    assert [next(meta)[0] for _ in range(10)] == [next(ref)[0]
                                                   for _ in range(10)]
    # per-worker generators differ by worker, not by run
    assert pl.worker_rng(1, 0).random() == pl.worker_rng(1, 0).random()
    assert pl.worker_rng(1, 0).random() != pl.worker_rng(1, 1).random()


def test_trainer_takes_batches_from_the_record_loader(tmp_path):
    from etpnav_tpu_torch.data import pretrain_loader as pl
    _, cfg = _configs()
    sh = pd.PretrainShapes(**SHAPES)
    loaders = {t: pl.build_task_loader([pl.write_task_records(
        str(tmp_path / f"{t}.rec"), pd.PretrainSampler(
            sh, seed=1, num_scans=2, scan_size=12), t, 4)], t, sh, 4)
        for t in TASKS}
    tr = _trainer(cfg, batches=pl.MetaLoader(loaders, (1.0,) * 4, seed=0))
    logs = tr.train_steps(4)
    assert tr.step == 4 and all(np.isfinite(v) for v in logs.values())
