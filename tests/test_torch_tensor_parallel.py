"""The port's tensor parallelism (`parallel/tensor_parallel.py`, the rules
of `parallel/mesh.py`, and K-ATT / K-ATT-BWD's head base) against the JAX
package on the CPU, at `tiny_config()`.

- the split rules: every parameter of the agent and of the pretraining
  model splits on the dim of JAX's `param_spec` for its counterpart,
  transposed for a dense kernel (`test_pretrain.py:77-104`);
- the head base: `dropout_keep_mask` of heads `head_base ..` of a layer
  equals that slice of the layer's global mask bit for bit, its defaults
  are the one-process mask (a Philox reference computed here), and the
  plain K-ATT / K-ATT-BWD with a head base equal the global call's slice;
- mp 2 and mp 4 (gloo ranks on the CPU, `test_torch_distributed.py`'s
  rank program): the pretraining SAP and MLM losses and gathered
  gradients equal the one-process port's and JAX's, also at a
  vocabulary mp does not divide; `perceive` with the agent split by the
  rules equals the one-process run (`test_sharded_perceive.py`), also
  with K-PRENORM's configuration (its split weights gathered); after a
  dropout-on MLM step the replicated parameters are equal on both ranks,
  and the step equals one process's with the same dropout draws; one
  fine-tune iteration at mp 2 (mp rank 0 rolls out, the record reaches
  its peer byte for byte) equals a one-process learn step on that
  record, dropout on, and its checkpoint loads into one process; at the
  default precision (bf16 planner, dropout on) the SAP, MLM and IL steps
  at mp 2 equal one process's bf16 steps, at tolerances the fp32 steps
  fail.
"""

import copy
import dataclasses

import numpy as np
import pytest
import torch

from etpnav_tpu_torch.config import tiny_config
from etpnav_tpu_torch.ops import fused_attention as fa
from etpnav_tpu_torch.parallel import mesh as M
from test_torch_distributed import (
    PARAM_ATOL,
    PRETRAIN_STEP_ATOL,
    _grads,
    _np_tree,
    cfg_for,
    check_pretrain,
    pretrain_ref,
    run_mesh,
    shapes_for,
)

torch.set_num_threads(1)

__all__ = ["pretrain_ref"]       # the fixture, shared with the dp tests

# perceive at mp 2 against one process (the JAX test's mp tolerance): the
# row-split products sum in another order
PERCEIVE_ATOL = 1e-4
# bf16 steps at mp 2 against one process's bf16 steps: the loss (the
# row-split sums land on the same bf16 values; fp32 differs by 2e-5 and
# more) and the relative L2 error of every gathered gradient (a few
# bf16 roundings move with the fp32 sum order: 3e-4 - 8e-4; fp32 against
# bf16 is 5e-3 and more)
BF16_LOSS_REL = 1e-5
BF16_GRAD_REL = 2e-3
PERCEIVE_KEYS = ("rgb_fts", "dep_fts", "loc_fts", "pano_embeds",
                 "avg_pano_embeds")


def agent_heads(cfg) -> dict:
    return {"clip": cfg.clip.heads, "waypoint": cfg.waypoint.num_heads,
            "planner": cfg.planner.num_heads}


# ---------------------------------------------------------------------------
# the rules against JAX's
# ---------------------------------------------------------------------------

def _jax_path(module, name: str) -> str:
    """The JAX tree path of a port parameter: the layer indices of the
    stacks dropped, a dense or conv kernel `w`, a norm's `scale`."""
    from etpnav_tpu_torch.models.depth_resnet import Conv, GroupNorm
    from etpnav_tpu_torch.ops.basic import LayerNorm, Linear
    *owner, leaf = name.split(".")
    mod = module.get_submodule(".".join(owner)) if owner else module
    if isinstance(mod, (Linear, Conv)):
        leaf = {"weight": "w", "bias": "b"}[leaf]
    elif isinstance(mod, (LayerNorm, GroupNorm)):
        leaf = {"weight": "scale", "bias": "bias"}[leaf]
    return "/".join(p for p in owner + [leaf] if not p.isdigit())


def _check_specs(module, jtree):
    from jax.sharding import PartitionSpec as P

    from etpnav_tpu.parallel import mesh as jmesh
    from etpnav_tpu_torch.ops.basic import Linear
    known = {"/".join(p for p in path.split("/") if not p.isdigit())
             for path in jmesh.tree_paths(jtree)}
    n_split = 0
    for name, p in module.named_parameters():
        path = _jax_path(module, name)
        assert path in known, (name, path)
        spec = jmesh.param_spec(path)
        owner = module.get_submodule(name.rsplit(".", 1)[0]) \
            if "." in name else module
        if spec == P():
            want = None
        elif isinstance(owner, Linear) and name.endswith("weight"):
            want = 1 - list(spec).index("mp")     # (in, out) -> (out, in)
        else:
            want = list(spec).index("mp")
        assert M.param_spec(name) == want, (name, path, spec)
        n_split += want is not None
    return n_split


def test_param_specs_match_jax():
    import jax

    from etpnav_tpu.config import tiny_config as jax_tiny_config
    from etpnav_tpu.training import agent as jagent
    from etpnav_tpu.training import pretrain as JPT
    from etpnav_tpu_torch.training.agent import AgentParams
    from etpnav_tpu_torch.training.pretrain import PretrainParams
    cfg, jcfg = tiny_config(), jax_tiny_config()
    jagent_params = jagent.init_agent_params(jax.random.PRNGKey(0), jcfg)
    n = _check_specs(AgentParams(cfg), jagent_params._asdict())
    assert n > 40
    tasks = ("mlm", "sap", "mrc", "og")
    jtree = JPT.init_pretrain_params(jax.random.PRNGKey(0), jcfg.planner,
                                     tasks, cfg.pretrain.image_prob_size)
    assert _check_specs(PretrainParams(cfg.planner, tasks), jtree) > 40


def test_shard_params_refuses_heads_mp_does_not_divide():
    from etpnav_tpu_torch.training.agent import AgentParams
    mesh = M.Mesh(1, 3, 0, 1)
    with pytest.raises(ValueError, match="does not divide the 4 heads of "
                                         "planner.lang_encoder.0.attention"):
        M.shard_params(mesh, AgentParams(tiny_config()),
                       agent_heads(tiny_config()))
    with pytest.raises(ValueError, match="no head count"):
        M.shard_params(mesh, AgentParams(tiny_config()), {"planner": 3})


def test_shard_and_gather_round_trip():
    """A one-rank view of mp 3 over an uneven dim: the shards are the
    zero-padded slices, and `full_shape` / `shard_of` invert."""
    t = torch.arange(10.0).view(5, 2)
    specs = [M.TPSpec(0, 5, 2, i, 3) for i in range(3)]
    shards = [M.shard_of(t, s) for s in specs]
    assert [s.shape[0] for s in shards] == [2, 2, 2]
    assert torch.equal(torch.cat(shards)[:5], t)
    assert torch.equal(shards[2][1], torch.zeros(2))
    p = torch.nn.Parameter(shards[1])
    p.tp = specs[1]
    assert M.full_shape(p) == (5, 2)


# ---------------------------------------------------------------------------
# the head base
# ---------------------------------------------------------------------------

def test_dropout_keep_mask_head_base_is_global_slice():
    from test_torch_training import _MASK32, _philox_ref
    seed, offset = 0x0123456789ABCDEF, 0x55AA33CC
    so = torch.tensor([seed, offset])
    B, H, Lq, Lk, p = 3, 6, 5, 9, 0.1
    whole = fa.dropout_keep_mask(so, B, H, Lq, Lk, p)
    # the defaults are the one-process mask: counter word b * H + h
    assert torch.equal(whole, fa.dropout_keep_mask(
        so, B, H, Lq, Lk, p, head_base=0, heads_total=H))
    threshold = int((1.0 - p) * 2.0 ** 32)
    key = (seed & _MASK32, seed >> 32)
    for b, h, i, j in ((0, 0, 0, 0), (2, 5, 4, 8), (1, 3, 2, 6)):
        word = _philox_ref((j // 4, i, b * H + h, offset & _MASK32),
                           key)[j % 4]
        assert bool(whole[b, h, i, j]) == (word < threshold)
    for mp in (2, 3, 6):
        hl = H // mp
        for r in range(mp):
            part = fa.dropout_keep_mask(so, B, hl, Lq, Lk, p,
                                        head_base=r * hl, heads_total=H)
            assert torch.equal(part, whole[:, r * hl:(r + 1) * hl]), (mp, r)
    with pytest.raises(ValueError, match="outside"):
        fa.dropout_keep_mask(so, B, 4, Lq, Lk, p, head_base=3,
                             heads_total=6)


def test_attention_head_base_plain_fwd_bwd_slice():
    """K-ATT and K-ATT-BWD's plain versions with a head base, dropout on:
    the outputs and gradients of heads 3..5 of a 6-head call."""
    g = torch.Generator().manual_seed(0)
    B, H, Lq, Lk, hd = 2, 6, 7, 11, 64
    q, k, v, dout = (torch.randn(B, H, L, hd, generator=g)
                     for L in (Lq, Lk, Lk, Lq))
    bias = torch.randn(B, 1, Lq, Lk, generator=g)
    so = torch.tensor([987654321, 1234567])
    out, lse = fa.attention_fwd(q, k, v, bias, 0.125, 0.1, so,
                                return_lse=True)
    grads = fa.attention_bwd(q, k, v, bias, out, lse, dout, 0.125, 0.1, so,
                             True)
    sl = slice(3, 6)
    part, plse = fa.attention_fwd(q[:, sl], k[:, sl], v[:, sl], bias, 0.125,
                                  0.1, so, return_lse=True, head_base=3,
                                  heads_total=6)
    torch.testing.assert_close(part, out[:, sl], rtol=0, atol=1e-6)
    pgrads = fa.attention_bwd(q[:, sl], k[:, sl], v[:, sl], bias, part,
                              plse, dout[:, sl], 0.125, 0.1, so, True,
                              head_base=3, heads_total=6)
    for got, want in zip(pgrads[:3], grads[:3]):
        torch.testing.assert_close(got, want[:, sl], rtol=0, atol=1e-5)
    # d(bias) of the slice is its heads' share of the whole head sum
    rest = fa.attention_bwd(q[:, :3], k[:, :3], v[:, :3], bias,
                            out[:, :3], lse[:, :3], dout[:, :3], 0.125, 0.1,
                            so, True, head_base=0, heads_total=6)[3]
    torch.testing.assert_close(pgrads[3] + rest, grads[3], rtol=0,
                               atol=1e-5)
    # without the head base the slice would draw heads 0..2's bits
    wrong = fa.attention_fwd(q[:, sl], k[:, sl], v[:, sl], bias, 0.125,
                             0.1, so)
    assert not torch.allclose(wrong, out[:, sl])


# ---------------------------------------------------------------------------
# the checks run on each rank of the mp worlds (test_torch_distributed's
# _w_mesh calls them by name)
# ---------------------------------------------------------------------------

def _perceive(mesh, inp, out_dir):
    from etpnav_tpu_torch.training.agent import AgentParams, perceive
    out = {}
    for fused in (False, True):
        cfg = tiny_config()
        cfg = dataclasses.replace(cfg, clip=dataclasses.replace(
            cfg.clip, use_fused_block=fused))
        params = AgentParams(cfg)
        params.load_state_dict(inp["agent"])
        M.shard_params(mesh, params, agent_heads(cfg))
        with torch.inference_mode():
            res = perceive(params, cfg, inp["rgb"], inp["depth"])
        out[fused] = {k: v.clone() for k, v in res.items()}
    return out


def _dropout_step(mesh, inp, out_dir):
    """One MLM step with dropout on; the whole state after it, and each
    rank's replicated parameters."""
    from etpnav_tpu_torch.training import pretrain as PT
    cfg = cfg_for(512)
    tr = PT.PretrainTrainer(cfg, shapes_for(512), seed=0, num_scans=2,
                            scan_size=12, device="cpu", mesh=mesh)
    M.load_full_state_dict(tr.params, inp["pretrain"][512])
    loss = tr.train_step("mlm", tr._put(inp["batches"][512]["mlm"]))
    replicated = {n: p.detach().clone() for n, p in
                  tr.params.named_parameters() if not hasattr(p, "tp")}
    return {"whole": M.full_state_dict(tr.params),
            "replicated": replicated, "loss": float(loss)}


def _finetune_iteration(mesh, inp, out_dir):
    """One SS-ETP iteration at this layout (mp rank 0 rolls out, dropout
    on); the record each rank learned on, the loss, the whole planner
    after, and a checkpoint."""
    import os

    from etpnav_tpu_torch.env.geometric import GeometricNavEnv
    from etpnav_tpu_torch.training.agent import AgentParams
    from etpnav_tpu_torch.training.finetune import FinetuneTrainer
    cfg = tiny_config()
    params = AgentParams(cfg)
    params.load_state_dict(inp["agent"])
    envs = GeometricNavEnv(2, seed=0, vocab_size=cfg.planner.vocab_size,
                           max_instr_len=cfg.il.max_text_len,
                           image_size=cfg.clip.image_size,
                           depth_size=cfg.depth.input_size,
                           pad_id=cfg.planner.pad_token_id)
    tr = FinetuneTrainer(cfg, envs, params=params, seed=0, device="cpu",
                         mesh=mesh, ckpt_dir=out_dir)
    seen = []
    broadcast = tr.mesh.broadcast_mp

    def keep(rec):
        rec = broadcast(rec)
        seen.append(rec)
        return rec

    tr.mesh.broadcast_mp = keep
    logs = tr.train(1)
    tr.save_checkpoint(os.path.join(out_dir, "ckpt_iter1.pt"))
    return {"rec": seen[0], "loss": logs["IL_loss"],
            "planner": {k: v.clone() for k, v in
                        tr.params.planner.state_dict().items()},
            "split": any(hasattr(p, "tp")
                         for p in tr.train_planner.parameters())}


def bf16(cfg):
    """`cfg` at r2r_config()'s precision: the planner in bf16."""
    return dataclasses.replace(cfg, planner=dataclasses.replace(
        cfg.planner, use_bf16=True))


def _bf16_steps(mesh, inp, out_dir):
    """The default precision (bf16 planner, every dropout on) at this
    layout: a pretraining SAP and MLM step, each from the same weights
    and seeds, and an IL learn step; the loss, the gathered gradients and
    the whole state after each."""
    return _precision_steps(mesh, inp, True)


def _precision_steps(mesh, inp, use_bf16: bool) -> dict:
    from etpnav_tpu_torch.models.planner import PlannerParams
    from etpnav_tpu_torch.training import finetune
    from etpnav_tpu_torch.training import pretrain as PT
    out = {}
    for task in ("sap", "mlm"):
        cfg = cfg_for(512)
        cfg = bf16(cfg) if use_bf16 else cfg
        tr = PT.PretrainTrainer(cfg, shapes_for(512), seed=0, num_scans=2,
                                scan_size=12, device="cpu", mesh=mesh)
        M.load_full_state_dict(tr.params, inp["pretrain"][512])
        loss = tr.train_step(task, tr._put(inp["batches"][512][task]))
        out[task] = {"loss": float(loss), "grads": _grads(tr.params),
                     "after": M.full_state_dict(tr.params)}
    cfg = bf16(tiny_config()) if use_bf16 else tiny_config()
    planner = PlannerParams(cfg.planner)
    planner.load_state_dict(inp["il_planner"])
    if mesh is not None:
        M.shard_params(mesh, planner, {"": cfg.planner.num_heads})
    loss = finetune.learn_step(
        planner, finetune.make_il_optimizer(cfg, planner), cfg,
        inp["il_batch"], torch.Generator().manual_seed(1), mesh)
    out["il"] = {"loss": float(loss), "grads": _grads(planner),
                 "after": M.full_state_dict(planner)}
    return out


# ---------------------------------------------------------------------------
# mp 2 and mp 4
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def agent_inp():
    import jax

    from etpnav_tpu.config import tiny_config as jax_tiny_config
    from etpnav_tpu.training import agent as jagent
    from etpnav_tpu_torch.models.convert import agent_params_from_jax
    cfg = tiny_config()
    jparams = jagent.init_agent_params(jax.random.PRNGKey(0),
                                       jax_tiny_config())
    params = agent_params_from_jax(_np_tree(jparams), cfg,
                                   device="cpu").params
    rng = np.random.default_rng(0)
    rgb = torch.from_numpy(rng.integers(
        0, 256, (2, 12, cfg.clip.image_size, cfg.clip.image_size, 3))
        .astype(np.uint8))
    depth = torch.from_numpy(rng.random(
        (2, 12, cfg.depth.input_size, cfg.depth.input_size, 1))
        .astype(np.float32))
    # an IL batch: one recorded interval of 2 episodes under these weights
    from etpnav_tpu_torch.env.geometric import GeometricNavEnv
    from etpnav_tpu_torch.training import finetune
    envs = GeometricNavEnv(2, seed=0, vocab_size=cfg.planner.vocab_size,
                           max_instr_len=cfg.il.max_text_len,
                           image_size=cfg.clip.image_size,
                           depth_size=cfg.depth.input_size,
                           pad_id=cfg.planner.pad_token_id)
    tr = finetune.FinetuneTrainer(cfg, envs, params=copy.deepcopy(params),
                                  seed=0, device="cpu")
    rec = finetune.bucket_record(tr.engine.run("train", sample_ratio=1.0),
                                 cfg.il)
    return {"agent": {k: v.clone() for k, v in params.state_dict().items()},
            "rgb": rgb, "depth": depth,
            "il_planner": {k: v.clone() for k, v in
                           params.planner.state_dict().items()},
            "il_batch": finetune.record_to_batch(rec, "cpu")}


@pytest.fixture(scope="module")
def mp2(pretrain_ref, agent_inp, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mp2")
    inp = {k: pretrain_ref[k] for k in ("pretrain", "batches")}
    inp.update(agent_inp)
    inp["extra"] = ("_perceive", "_dropout_step", "_finetune_iteration",
                    "_bf16_steps")
    return run_mesh(1, 2, inp, tmp), tmp


def test_pretrain_losses_mp2(mp2, pretrain_ref):
    check_pretrain(mp2[0], pretrain_ref, "mp2")


def test_pretrain_losses_mp4(pretrain_ref, tmp_path):
    inp = {k: pretrain_ref[k] for k in ("pretrain", "batches")}
    check_pretrain(run_mesh(1, 4, inp, tmp_path), pretrain_ref, "mp4")


def test_perceive_mp2_matches_one_process(mp2, agent_inp):
    """`perceive` with the agent split at mp 2 (the CLIP, waypoint and pano
    encoder attentions and FFNs by the rules) equals the one-process
    run; with `use_fused_block`, K-PRENORM takes its gathered weights."""
    from etpnav_tpu_torch.training.agent import AgentParams, perceive
    results, _ = mp2
    for fused in (False, True):
        cfg = tiny_config()
        cfg = dataclasses.replace(cfg, clip=dataclasses.replace(
            cfg.clip, use_fused_block=fused))
        params = AgentParams(cfg)
        params.load_state_dict(agent_inp["agent"])
        with torch.inference_mode():
            want = perceive(params, cfg, agent_inp["rgb"],
                            agent_inp["depth"])
        for res in results:
            got = res["_perceive"][fused]
            for key in ("cand_valid", "cand_angles", "cand_distances",
                        "nav_types", "view_masks"):
                assert torch.equal(got[key], want[key]), (fused, key)
            for key in PERCEIVE_KEYS:
                err = float((got[key] - want[key]).abs().max())
                assert err <= PERCEIVE_ATOL, (fused, key, err)


def test_mp2_dropout_step_keeps_replicas_equal(mp2, pretrain_ref):
    """After an MLM step with dropout on (hidden, attention and the
    split FFN activations), the replicated parameters are equal on both
    ranks, and the step equals one process's: one generator state per mp
    group, the attention masks those heads' of the global mask."""
    from etpnav_tpu_torch.training import pretrain as PT
    results, _ = mp2
    a, b = (r["_dropout_step"] for r in results)
    assert a["replicated"].keys() == b["replicated"].keys()
    for name, t in a["replicated"].items():
        assert torch.equal(t, b["replicated"][name]), name
    cfg = cfg_for(512)
    one = PT.PretrainTrainer(cfg, shapes_for(512), seed=0, num_scans=2,
                             scan_size=12, device="cpu")
    one.params.load_state_dict(pretrain_ref["pretrain"][512])
    loss = one.train_step("mlm",
                          one._put(pretrain_ref["batches"][512]["mlm"]))
    # the same masks: the loss of the dropped forward agrees
    assert a["loss"] == b["loss"] == pytest.approx(float(loss), rel=2e-4)
    for name, p in one.params.named_parameters():
        err = float((a["whole"][name] - p.detach()).abs().max())
        assert err <= PRETRAIN_STEP_ATOL, (name, err)
        assert torch.equal(a["whole"][name], b["whole"][name]), name


def test_finetune_iteration_mp2(mp2, agent_inp):
    """mp rank 0 rolled out and its peer learned on the same bytes; the
    iteration equals a one-process learn step on that record with the
    same dropout draws, and its checkpoint loads into one process."""
    from etpnav_tpu_torch.env.geometric import GeometricNavEnv
    from etpnav_tpu_torch.models.planner import PlannerParams
    from etpnav_tpu_torch.training import finetune
    results, tmp = mp2
    a, b = (r["_finetune_iteration"] for r in results)
    assert a["split"] and b["split"]
    for f in dataclasses.fields(a["rec"]):
        assert np.array_equal(getattr(a["rec"], f.name),
                              getattr(b["rec"], f.name)), f.name
    assert a["loss"] == b["loss"]
    cfg = tiny_config()
    planner = PlannerParams(cfg.planner)
    planner.load_state_dict({k[len("planner."):]: v for k, v in
                             agent_inp["agent"].items()
                             if k.startswith("planner.")})
    opt = finetune.make_il_optimizer(cfg, planner)
    brec = finetune.bucket_record(a["rec"], cfg.il)
    loss = finetune.learn_step(
        planner, opt, cfg, finetune.record_to_batch(brec, "cpu"),
        torch.Generator().manual_seed(1))
    assert a["loss"] == pytest.approx(float(loss), rel=2e-4)
    for name, p in planner.named_parameters():
        for res in (a, b):
            err = float((res["planner"][name] - p.detach()).abs().max())
            assert err <= PARAM_ATOL, (name, err)
    envs = GeometricNavEnv(2, seed=0, vocab_size=cfg.planner.vocab_size,
                           max_instr_len=cfg.il.max_text_len,
                           image_size=cfg.clip.image_size,
                           depth_size=cfg.depth.input_size,
                           pad_id=cfg.planner.pad_token_id)
    one = finetune.FinetuneTrainer(cfg, envs, seed=5, device="cpu",
                                   ckpt_dir=str(tmp))
    assert one.resume_latest() and one.iteration == 1
    for name, t in a["planner"].items():
        assert torch.equal(one.params.planner.state_dict()[name], t), name
    one.train(1)                       # training continues


def _rel_l2(got: dict, want: dict) -> float:
    """||got - want|| / ||want|| over every tensor of `want`."""
    num = sum(float((got[k].double() - w.double()).pow(2).sum())
              for k, w in want.items())
    den = sum(float(w.double().pow(2).sum()) for w in want.values())
    return (num / den) ** 0.5


def test_mp2_bf16_steps_match_one_process(mp2, pretrain_ref, agent_inp):
    """At the default precision (bf16 planner, dropout on), where the
    row-split layers run `_LinearF32`'s partial products and
    `parallel_linear`'s bf16 branch: the SAP, MLM and IL steps at mp 2
    equal one process's bf16 steps. The gradients' tolerance is one that
    the same steps in fp32 fail (checked here), so an fp32 path standing
    in for the bf16 one would not pass."""
    results, _ = mp2
    inp = {"pretrain": pretrain_ref["pretrain"],
           "batches": pretrain_ref["batches"],
           "il_planner": agent_inp["il_planner"],
           "il_batch": agent_inp["il_batch"]}
    one = _precision_steps(None, inp, True)
    f32 = _precision_steps(None, inp, False)
    a, b = (r["_bf16_steps"] for r in results)
    for key in ("sap", "mlm", "il"):
        want = one[key]
        # the tolerances tell bf16 from fp32
        assert abs(f32[key]["loss"] - want["loss"]) > \
            BF16_LOSS_REL * abs(want["loss"]), key
        assert _rel_l2(f32[key]["grads"], want["grads"]) > BF16_GRAD_REL, key
        step_atol = (2.001 * tiny_config().il.lr if key == "il"
                     else PRETRAIN_STEP_ATOL)
        for res in (a, b):
            got = res[key]
            assert got["loss"] == pytest.approx(want["loss"],
                                                rel=BF16_LOSS_REL), key
            assert got["grads"].keys() == want["grads"].keys(), key
            err = _rel_l2(got["grads"], want["grads"])
            assert err <= BF16_GRAD_REL, (key, err)
            for name, t in want["after"].items():
                diff = float((got["after"][name] - t).abs().max())
                assert diff <= step_atol, (key, name, diff)
        # the replicas stay bit-equal
        for name, t in a[key]["after"].items():
            assert torch.equal(t, b[key]["after"][name]), (key, name)
