"""The port's distribution (`parallel/mesh.py`, and the dp x mp paths of
`PretrainTrainer` and `FinetuneTrainer`) against the JAX package on the
CPU, at `tiny_config()`.

Ranks are gloo processes on the CPU started by `spawn` below on
torch.multiprocessing (at most 4 per spawn, each spawn under its own time
limit of 120 s, after which every child still running is killed; torch
threads capped at 1); they write their results to files. The JAX side runs in the
test process on its 8 virtual devices (`tests/conftest.py`). Weights come
across through `pretrain_params_from_jax` / `agent_params_from_jax`.

- the two-process tests of `tests/test_multiprocess_distributed.py`
  (`GATHER_OK 5`; `BUCKET 20 64` at R2R caps) and
  `test_utils_misc.py`'s no-context `init_distributed` (returns False);
  a missing device raises; the one-process mesh is the identity;
- pretraining: the SAP and MLM losses at dp 2, mp 2, mp 4 and dp 2 x
  mp 2 equal the one-process port's and JAX's (dp 4, mp 2) at rel 2e-4,
  and the gathered gradients equal the one-process port's; the same at
  a vocabulary that mp does not divide (511; JAX's reference there is
  its dp 8 mesh, as its device_put refuses an uneven split);
- the IL learn step at dp 2 (dropout off): the loss equals JAX's on the
  whole batch (rel 2e-4) and the parameters after the AdamW step equal
  the one-process step's (atol 2e-5), with the ranks' valid-step counts
  uneven (the normalisation hazard: a mean of per-rank means differs);
- checkpoints: one process -> dp 2 x mp 2 re-splits exactly, and the
  dp 2 x mp 2 checkpoint loads into one process;
- dropout streams: the dp slots draw different masks, the mp peers the
  same; after a dp 2 x mp 2 step the unsplit parameters are bit-equal
  on all four ranks;
- run.py under torchrun, with MESH dp 2 and with no MESH section (the
  launched world becomes dp 2).

`_w_mesh` is the rank program of every layout; `test_torch_tensor_
parallel.py` runs it at mp 2 and mp 4 too.
"""

import ast
import copy
import dataclasses
import json
import os
import pathlib
import socket
import sys
import time

import numpy as np
import pytest
import torch

from etpnav_tpu_torch.config import r2r_config, tiny_config
from etpnav_tpu_torch.parallel import mesh as M

torch.set_num_threads(1)

TESTS = str(pathlib.Path(__file__).resolve().parent)
ROOT = str(pathlib.Path(TESTS).parent)
REL = 2e-4
GRAD_ATOL = 2e-6
PARAM_ATOL = 2e-5
# two pretraining steps' worth of Adam's largest move (lr 5e-5 halfway
# through warmup): a near-zero gradient may take either sign
PRETRAIN_STEP_ATOL = 1e-4
SPAWN_TIMEOUT = 120
VOCABS = (512, 511)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(rank, target, world, address, args):
    torch.set_num_threads(1)
    target(rank, world, address, *args)


def spawn(target, world: int, args=()):
    """Run `target(rank, world, address, *args)` in `world` fresh processes
    (torch.multiprocessing, spawn), `address` the "localhost:PORT" that
    `init_distributed` takes. A child that fails fails the call and
    torch.multiprocessing ends its peers; past SPAWN_TIMEOUT every child
    still running is killed and the call raises."""
    ctx = torch.multiprocessing.start_processes(
        _rank_main, args=(target, world, f"localhost:{free_port()}",
                          tuple(args)),
        nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + SPAWN_TIMEOUT
    try:
        while not ctx.join(timeout=max(0.0, deadline - time.monotonic())):
            if time.monotonic() >= deadline:
                raise TimeoutError(f"{target.__name__}: ranks still running "
                                   f"after {SPAWN_TIMEOUT} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join()


def shapes_for(vocab: int):
    from etpnav_tpu_torch.data.pretrain_data import PretrainShapes
    return PretrainShapes(
        max_txt_len=16, max_traj_steps=4, num_views=12, max_cands=4,
        max_gmap_len=24, image_feat_size=32, depth_feat_size=16,
        vocab_size=vocab, mask_token_id=3, mask_vocab_range=(10, vocab - 12))


def cfg_for(vocab: int):
    cfg = tiny_config()
    return dataclasses.replace(cfg, planner=dataclasses.replace(
        cfg.planner, vocab_size=vocab))


def heads(cfg) -> dict:
    return {"": cfg.planner.num_heads}


# ---------------------------------------------------------------------------
# rank programs (run in the children; no JAX here)
# ---------------------------------------------------------------------------

def _w_collectives(rank, world, address, out_dir):
    """The two JAX two-process workers: a gather of rank-shaped dicts, and
    the learn bucket agreed at R2R caps."""
    from etpnav_tpu_torch.training.finetune import bucket_record
    from etpnav_tpu_torch.training.rollout import RolloutRecord
    assert M.init_distributed(address, world, rank, device="cpu")
    mesh = M.make_mesh()
    assert (mesh.dp, mesh.mp, mesh.dp_index) == (world, 1, rank)
    stats = {f"ep{rank}_{i}": {"sr": float(rank), "spl": 0.5 + i}
             for i in range(2 + rank)}
    merged = {}
    for d in M.all_gather_object(stats):
        merged.update(d)
    assert merged["ep1_2"]["sr"] == 1.0

    cfg = r2r_config()
    p, il = cfg.planner, cfg.il
    B, T, G, L = 8, il.max_traj_len, p.max_gmap_len, il.max_text_len
    P = cfg.waypoint.max_predictions + 12
    Mm = T * cfg.waypoint.max_predictions

    def z(*s, dt=np.float32):
        return np.zeros(s, dt)

    rec = RolloutRecord(
        txt_ids=z(B, L, dt=np.int32), txt_masks=np.ones((B, L), bool),
        vp_rgb=z(B, T, P, p.image_feat_size),
        vp_dep=z(B, T, P, p.depth_feat_size),
        vp_loc=z(B, T, P, 4), vp_nav=z(B, T, P, dt=np.int32),
        vp_mask=np.ones((B, T, P), bool),
        agg_node_step=np.full((B, T, G), -1, np.int32),
        agg_ent_slot=z(B, T, Mm, dt=np.int32),
        agg_ent_tok=z(B, T, Mm, dt=np.int32), agg_ent_val=z(B, T, Mm),
        gmap_step_ids=z(B, T, G, dt=np.int32), gmap_pos_fts=z(B, T, G, 7),
        gmap_mask=np.zeros((B, T, G), bool),
        gmap_visited=np.zeros((B, T, G), bool), gmap_pair=z(B, T, G, G),
        teacher=np.full((B, T), -100, np.int32),
        step_valid=np.zeros((B, T), bool), logits=z(B, T, G))
    # rank-dependent demand: rank 0 needs (T=9, G=30), rank 1 (T=14, G=50)
    t_need, g_need = (9, 30) if rank == 0 else (14, 50)
    rec.step_valid[:, :t_need] = True
    rec.gmap_mask[:, :, :g_need] = True
    rec.teacher[:, :t_need] = 0
    out = bucket_record(rec, il)
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump({"gather": len(merged),
                   "bucket": [out.step_valid.shape[1],
                              out.gmap_mask.shape[2]]}, f)
    M.shutdown()


def _grads(params):
    """Every gradient, gathered whole."""
    out = {}
    for name, p in params.named_parameters():
        if p.grad is not None:
            spec = getattr(p, "tp", None)
            out[name] = (M.gather_tensor(p.grad, spec) if spec is not None
                         else p.grad).clone()
    return out


def _rows(batch: dict, mesh, n: int) -> dict:
    """This dp slot's rows of a whole batch of n rows."""
    k = n // mesh.dp
    return {key: v[mesh.dp_index * k:(mesh.dp_index + 1) * k]
            for key, v in batch.items()}


def _pretrain_losses(mesh, inp) -> dict:
    from etpnav_tpu_torch.training import pretrain as PT
    out = {}
    for vocab in inp["pretrain"]:
        cfg = cfg_for(vocab)
        for task in ("sap", "mlm"):
            params = PT.PretrainParams(cfg.planner, ("mlm", "sap"))
            params.load_state_dict(inp["pretrain"][vocab])
            M.shard_params(mesh, params, heads(cfg))
            whole = inp["batches"][vocab][task]
            batch = PT.batch_to_device(
                _rows(whole, mesh, len(whole["txt_ids"])), "cpu")
            loss = PT.LOSS_FNS[task](params, cfg.planner, batch, None,
                                     mesh=mesh)
            loss.backward()
            mesh.sync_grads(list(params.parameters()))
            out[(vocab, task)] = (float(mesh.dp_sum(loss)), _grads(params))
    return out


def _il_step(mesh, inp) -> dict:
    from etpnav_tpu_torch.models.planner import PlannerParams
    from etpnav_tpu_torch.training import finetune
    cfg = tiny_config()
    planner = PlannerParams(cfg.planner)
    planner.load_state_dict(inp["il"]["planner"])
    opt = finetune.make_il_optimizer(cfg, planner)
    whole = inp["il"]["batch"]
    batch = _rows(whole, mesh, len(whole["txt_ids"]))
    loss = finetune.learn_step(planner, opt, cfg, batch, None, mesh)
    return {"loss": float(loss), "planner": planner.state_dict()}


def _dropout_streams(mesh) -> list:
    """Each rank's first attention-dropout mask from its trainer's
    generator, gathered."""
    from etpnav_tpu_torch.ops import fused_attention as fa
    from etpnav_tpu_torch.training.finetune import FinetuneTrainer
    tr = FinetuneTrainer(tiny_config(), None, seed=0, device="cpu",
                         mesh=mesh)
    so = fa.draw_seed_offset(tr.generator, torch.device("cpu"))
    mask = fa.dropout_keep_mask(so, 2, 4, 8, 8, 0.1)
    return M.all_gather_object(mask)


def _pretrain_ckpt(mesh, inp, out_dir) -> dict:
    """Load the one-process checkpoint, report the re-split state whole,
    step once and write a checkpoint of this layout."""
    from etpnav_tpu_torch.training import pretrain as PT
    cfg = cfg_for(512)
    tr = PT.PretrainTrainer(cfg, shapes_for(512), seed=0, num_scans=2,
                            scan_size=12, device="cpu", mesh=mesh)
    tr.load_checkpoint(inp["ckpt_in"])
    # copies: the step below moves the live tensors
    loaded = copy.deepcopy({"params": M.full_state_dict(tr.params),
                            "opt": M.full_optimizer_state(tr.optimizer),
                            "step": tr.step})
    batch = tr._put(_rows(inp["batches"][512]["sap"], mesh, 8))
    _step_without_dropout(tr, batch)
    tr.save_checkpoint(os.path.join(out_dir, "model_step_2.pt"))
    return {"loaded": loaded, "after": M.full_state_dict(tr.params),
            "replicated": {n: p.detach().clone() for n, p in
                           tr.params.named_parameters()
                           if not hasattr(p, "tp")}}


def _step_without_dropout(tr, batch):
    """One SAP step of a PretrainTrainer with every dropout off (the dp
    slots' dropout streams differ by design)."""
    gen, tr.generator = tr.generator, None
    tr.train_step("sap", batch)
    tr.generator = gen


def _w_mesh(rank, world, address, dp, mp, in_path, out_dir):
    """One rank of a dp x mp world: every check the input asks for, its
    results written to out_dir/rank{rank}.pt."""
    torch.set_num_threads(1)
    assert M.init_distributed(address, world, rank, device="cpu",
                              backend="gloo")
    mesh = M.make_mesh(dp, mp)
    assert mesh.rank == rank and (mesh.dp, mesh.mp) == (dp, mp)
    inp = torch.load(in_path, weights_only=False)
    out = {"pretrain": _pretrain_losses(mesh, inp)}
    if "il" in inp:
        out["il"] = _il_step(mesh, inp)
    if dp > 1:
        out["masks"] = _dropout_streams(mesh)
    if "ckpt_in" in inp:
        out["ckpt"] = _pretrain_ckpt(mesh, inp, out_dir)
    for name in inp.get("extra", ()):
        # the checks of test_torch_tensor_parallel.py
        import test_torch_tensor_parallel as tpt
        out[name] = getattr(tpt, name)(mesh, inp, out_dir)
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    M.barrier()
    M.shutdown()


def run_mesh(dp: int, mp: int, inp: dict, tmp) -> list:
    """Spawn the dp x mp world on `inp`; each rank's results."""
    tmp = pathlib.Path(tmp)
    tmp.mkdir(parents=True, exist_ok=True)
    torch.save(inp, tmp / "in.pt")
    spawn(_w_mesh, dp * mp, [dp, mp, str(tmp / "in.pt"), str(tmp)])
    return [torch.load(tmp / f"rank{r}.pt", weights_only=False)
            for r in range(dp * mp)]


# ---------------------------------------------------------------------------
# references (the test process: the one-process port and JAX)
# ---------------------------------------------------------------------------

def _np_tree(tree):
    import jax
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def pretrain_ref():
    """For each vocabulary: the JAX init as port weights, an SAP and an
    MLM batch of 8, the one-process port's losses and gradients, and
    JAX's losses at (dp 4, mp 2)."""
    import jax

    from etpnav_tpu.config import tiny_config as jax_tiny_config
    from etpnav_tpu.data.pretrain_data import PretrainSampler
    from etpnav_tpu.parallel import mesh as jmesh
    from etpnav_tpu.training import pretrain as JPT
    from etpnav_tpu_torch.models.convert import pretrain_params_from_jax
    from etpnav_tpu_torch.training import pretrain as PT

    ref = {"pretrain": {}, "batches": {}, "loss": {}, "grads": {},
           "jax": {}}
    for vocab in VOCABS:
        cfg = cfg_for(vocab)
        jcfg = jax_tiny_config()
        jcfg = dataclasses.replace(jcfg, planner=dataclasses.replace(
            jcfg.planner, vocab_size=vocab))
        jparams = JPT.init_pretrain_params(jax.random.PRNGKey(0),
                                           jcfg.planner)
        params = pretrain_params_from_jax(_np_tree(jparams), cfg,
                                          ("mlm", "sap"))
        ref["pretrain"][vocab] = params.state_dict()
        sampler = PretrainSampler(shapes_for(vocab), seed=3, num_scans=2,
                                  scan_size=12)
        ref["batches"][vocab] = {}
        # JAX's device_put refuses an uneven split of the vocabulary, so
        # at 511 its reference is the dp-only mesh
        jm = jmesh.make_mesh(dp=4, mp=2) if vocab % 2 == 0 else \
            jmesh.make_mesh(dp=8, mp=1)
        jp = jmesh.shard_params(jm, jparams)
        for task in ("sap", "mlm"):
            batch = sampler.sample_batch(8, task)
            ref["batches"][vocab][task] = batch
            params.zero_grad(set_to_none=True)
            loss = PT.LOSS_FNS[task](params, cfg.planner,
                                     PT.batch_to_device(batch, "cpu"))
            loss.backward()
            ref["loss"][(vocab, task)] = loss.item()
            ref["grads"][(vocab, task)] = {
                n: p.grad.clone() for n, p in params.named_parameters()
                if p.grad is not None}
            fn = jax.jit(lambda p, b, t=task: JPT._LOSS_FNS[t](
                p, jcfg.planner, b, None))
            ref["jax"][(vocab, task)] = float(fn(
                jp, jmesh.shard_batch(jm, batch)))
    return ref


def check_pretrain(results, ref, layout):
    """Every rank's losses equal the one-process port's and JAX's, and its
    gathered gradients the one-process port's."""
    for r, res in enumerate(results):
        for key, (loss, grads) in res["pretrain"].items():
            want = ref["loss"][key]
            assert loss == pytest.approx(want, rel=REL), (layout, r, key)
            assert loss == pytest.approx(ref["jax"][key], rel=REL), \
                (layout, r, key)
            wg = ref["grads"][key]
            assert set(grads) == set(wg), (layout, key)
            for name, g in grads.items():
                err = float((g - wg[name]).abs().max())
                tol = GRAD_ATOL + 1e-4 * float(wg[name].abs().max())
                assert err <= tol, (layout, r, key, name, err)


# ---------------------------------------------------------------------------
# the runtime
# ---------------------------------------------------------------------------

def test_init_distributed_single_process_noop(monkeypatch):
    """No launch context (no torchrun, SLURM or explicit address) -> no
    process group and False (test_utils_misc.py:96-103)."""
    for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                "MASTER_PORT", "SLURM_NTASKS", "SLURM_PROCID"):
        monkeypatch.delenv(var, raising=False)
    assert M.init_distributed() is False
    assert not torch.distributed.is_initialized()
    mesh = M.make_mesh()
    assert (mesh.dp, mesh.mp, mesh.dp_group, mesh.mp_group) == (1, 1,
                                                                 None, None)
    assert M.make_mesh(1, 1).rank == 0
    with pytest.raises(ValueError, match="world size"):
        M.make_mesh(2, 1)
    with pytest.raises(ValueError, match="world size"):
        M.make_mesh(1, 2)
    assert M.sync_max((3, 4)) == [3, 4]
    assert M.all_gather_object({"a": 1}) == [{"a": 1}]


def test_init_distributed_missing_device_raises(monkeypatch):
    """A rank whose CUDA device does not exist raises; it never shares
    another device quietly."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        M.init_distributed("localhost:1", 2, 1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="cuda:1"):
        M.init_distributed("localhost:1", 2, 1)
    assert not torch.distributed.is_initialized()


@pytest.fixture(scope="module")
def two_rank_out(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("collectives")
    spawn(_w_collectives, 2, [str(tmp)])
    return [json.loads((tmp / f"rank{r}.json").read_text())
            for r in range(2)]


def test_two_process_gather(two_rank_out):
    """Every rank merges the 2 + 3 episodes of the two ranks (GATHER_OK 5
    of the JAX test)."""
    for out in two_rank_out:
        assert out["gather"] == 5, out


def test_two_process_bucket_sync_full_size(two_rank_out):
    """Both ranks learn at the bucket of the larger demand (T=14, G=50)
    at R2R caps: (12, 20) -> 20, (48, 64, 96) -> 64."""
    for out in two_rank_out:
        assert out["bucket"] == [20, 64], out


def test_spawn_failure_kills_the_world(tmp_path):
    """A rank that exits nonzero fails the spawn, and its peer (blocked in
    a collective it will never finish) is ended, not left behind."""
    with pytest.raises(torch.multiprocessing.ProcessExitedException,
                       match="process 1 terminated with exit code 3"):
        spawn(_w_fail_rank1, 2, [str(tmp_path)])
    pid = int((tmp_path / "rank0.pid").read_text())
    with pytest.raises(ProcessLookupError):
        os.kill(pid, 0)


def _w_fail_rank1(rank, world, address, out_dir):
    if rank == 0:     # before the rendezvous, which rank 1 waits for too
        (pathlib.Path(out_dir) / "rank0.pid").write_text(str(os.getpid()))
    M.init_distributed(address, world, rank, device="cpu")
    if rank == 1:
        raise SystemExit(3)
    M.barrier()


def test_param_rules_on_port_names():
    """The rules of the JAX package on the port's names and layout."""
    assert M.param_spec("lang_encoder.0.ffn.intermediate.weight") == 0
    assert M.param_spec("lang_encoder.0.ffn.intermediate.bias") == 0
    assert M.param_spec("lang_encoder.0.ffn.output.dense.weight") == 1
    assert M.param_spec("lang_encoder.0.ffn.output.dense.bias") is None
    assert M.param_spec("global_encoder.encoder.1.visual_attention.attn."
                        "k.weight") == 0
    assert M.param_spec("img_embeddings.pano_encoder.layers.0.attn.o."
                        "weight") == 1
    assert M.param_spec("img_embeddings.pano_encoder.layers.0.attn.o."
                        "bias") is None
    assert M.param_spec("embeddings.word_embeddings") == 0
    assert M.param_spec("embeddings.position_embeddings") is None
    assert M.param_spec("mlm_head.bias") == 0
    assert M.param_spec("mlm_head.transform.bias") is None
    assert M.param_spec("embeddings.ln.weight") is None


# ---------------------------------------------------------------------------
# dp
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def il_ref():
    """A recorded interval of 4 episodes of the port (JAX weights), the
    ranks' valid-step counts made uneven, the one-process learn step on
    all 4 and JAX's loss on them."""
    import jax

    from etpnav_tpu.config import tiny_config as jax_tiny_config
    from etpnav_tpu.training import agent as jagent
    from etpnav_tpu.training import finetune as jft
    from etpnav_tpu_torch.env.geometric import GeometricNavEnv
    from etpnav_tpu_torch.models.convert import agent_params_from_jax
    from etpnav_tpu_torch.training import finetune

    cfg, jcfg = tiny_config(), jax_tiny_config()
    jparams = jagent.init_agent_params(jax.random.PRNGKey(0), jcfg)
    agent = agent_params_from_jax(_np_tree(jparams), cfg, device="cpu")
    envs = GeometricNavEnv(4, seed=0, vocab_size=cfg.planner.vocab_size,
                           max_instr_len=cfg.il.max_text_len,
                           image_size=cfg.clip.image_size,
                           depth_size=cfg.depth.input_size,
                           pad_id=cfg.planner.pad_token_id)
    tr = finetune.FinetuneTrainer(cfg, envs, params=agent.params, seed=0,
                                  device="cpu")
    planner0 = {k: v.clone() for k, v in tr.params.planner.state_dict()
                .items()}
    rec = tr.engine.run("train", sample_ratio=1.0)
    # uneven counts: the second rank's episodes end one step earlier
    counts = rec.step_valid.sum(1)
    if counts[:2].sum() == counts[2:].sum():
        last = int(np.flatnonzero(rec.step_valid[2]).max())
        rec.step_valid[2, last] = False
        rec.teacher[2, last] = -100
    batch = finetune.record_to_batch(rec, device="cpu")
    counts = rec.step_valid.sum(1)
    assert counts[:2].sum() != counts[2:].sum()
    loss = finetune.learn_step(tr.params.planner, tr.optimizer, cfg, batch)
    jbatch = jft.record_to_batch(rec)
    jloss = jax.jit(lambda p, b: jft.compute_il_loss(p, jcfg, b, None))(
        jparams.planner, jbatch)
    return {"planner": planner0, "batch": batch, "loss": float(loss),
            "jax_loss": float(jloss),
            "after": tr.params.planner.state_dict(), "counts": counts}


@pytest.fixture(scope="module")
def dp2(pretrain_ref, il_ref, tmp_path_factory):
    inp = {k: pretrain_ref[k] for k in ("pretrain", "batches")}
    inp["il"] = {k: il_ref[k] for k in ("planner", "batch")}
    return run_mesh(2, 1, inp, tmp_path_factory.mktemp("dp2"))


def test_pretrain_losses_dp2(dp2, pretrain_ref):
    check_pretrain(dp2, pretrain_ref, "dp2")


def test_il_learn_step_dp2_matches_one_process(dp2, il_ref):
    """Each rank learns on 2 of the 4 episodes (their live-step counts
    differ). The global loss equals JAX's and the one-process port's on
    all 4, and the parameters after AdamW equal the one-process step's."""
    counts = il_ref["counts"]
    # what a mean of per-rank means would have given instead
    assert counts[:2].sum() != counts[2:].sum()
    for res in dp2:
        assert res["il"]["loss"] == pytest.approx(il_ref["jax_loss"],
                                                  rel=REL)
        assert res["il"]["loss"] == pytest.approx(il_ref["loss"], rel=REL)
        for name, want in il_ref["after"].items():
            got = res["il"]["planner"][name]
            err = float((got - want).abs().max())
            assert err <= PARAM_ATOL, (name, err)
    # the replicas stay bit-equal
    for name, t in dp2[0]["il"]["planner"].items():
        assert torch.equal(t, dp2[1]["il"]["planner"][name]), name


def test_dp_ranks_draw_different_masks(dp2):
    masks = dp2[0]["masks"]
    assert len(masks) == 2 and not torch.equal(masks[0], masks[1])


# ---------------------------------------------------------------------------
# dp x mp and checkpoints
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def dp2mp2(pretrain_ref, tmp_path_factory):
    """dp 2 x mp 2 on the same inputs, loading a checkpoint written by
    one process after one SAP step."""
    from etpnav_tpu_torch.training import pretrain as PT
    tmp = tmp_path_factory.mktemp("dp2mp2")
    cfg = cfg_for(512)
    tr = PT.PretrainTrainer(cfg, shapes_for(512), seed=0, num_scans=2,
                            scan_size=12, device="cpu")
    tr.params.load_state_dict(pretrain_ref["pretrain"][512])
    tr.train_step("sap", tr._put(pretrain_ref["batches"][512]["sap"]))
    ckpt = str(tmp / "one_process.pt")
    tr.save_checkpoint(ckpt)
    inp = {k: pretrain_ref[k] for k in ("pretrain", "batches")}
    inp["ckpt_in"] = ckpt
    results = run_mesh(2, 2, inp, tmp)
    # the one-process trainer's own next step on the whole batch
    _step_without_dropout(tr, tr._put(pretrain_ref["batches"][512]["sap"]))
    return results, ckpt, tmp, tr


def test_pretrain_losses_dp2_mp2(dp2mp2, pretrain_ref):
    check_pretrain(dp2mp2[0], pretrain_ref, "dp2 x mp2")


def test_checkpoints_load_across_layouts(dp2mp2):
    """One process -> dp 2 x mp 2: every tensor, the optimizer's moments
    and the step re-split exactly (gathered back, they are the file's).
    dp 2 x mp 2 -> one process: the file is the one-process format and
    loads; the two layouts' next steps agree."""
    from etpnav_tpu_torch.training import checkpoints
    from etpnav_tpu_torch.training import pretrain as PT
    results, ckpt, tmp, tr = dp2mp2
    state = checkpoints.load_checkpoint(ckpt, map_location="cpu")
    for res in results:
        loaded = res["ckpt"]["loaded"]
        assert loaded["step"] == state["step"] == 1
        for name, t in state["params"].items():
            assert torch.equal(loaded["params"][name], t), name
        for i, st in state["opt_state"]["state"].items():
            for key, v in st.items():
                assert torch.equal(loaded["opt"]["state"][i][key], v), \
                    (i, key)
    # every rank's whole state after the step is the same
    for res in results[1:]:
        for name, t in results[0]["ckpt"]["after"].items():
            assert torch.equal(res["ckpt"]["after"][name], t), name
    one = PT.PretrainTrainer(cfg_for(512), shapes_for(512), seed=0,
                             num_scans=2, scan_size=12, device="cpu")
    assert one.resume_latest(str(tmp))
    assert one.step == 2
    for name, p in one.params.named_parameters():
        assert torch.equal(p.detach(), results[0]["ckpt"]["after"][name])
        err = float((p.detach() - dict(tr.params.named_parameters())[name]
                     .detach()).abs().max())
        assert err <= PRETRAIN_STEP_ATOL, (name, err)
    mu = one.optimizer.state[next(iter(one.params.parameters()))]["mu"]
    assert mu.shape == next(iter(one.params.parameters())).shape


def test_dp2_mp2_replicas_equal(dp2mp2):
    """After a step at dp 2 x mp 2 every rank holds the same unsplit
    parameters, bit for bit: the four ranks sum over two dp groups, and
    the broadcast from mp rank 0 after the sum leaves one value."""
    results = dp2mp2[0]
    rep = [r["ckpt"]["replicated"] for r in results]
    assert len(rep[0]) > 20
    for other in rep[1:]:
        assert other.keys() == rep[0].keys()
        for name, t in rep[0].items():
            assert torch.equal(other[name], t), name


def test_dropout_streams_per_dp_slot(dp2mp2):
    """dp slots draw different masks; the mp peers of a slot the same."""
    masks = dp2mp2[0][0]["masks"]
    assert len(masks) == 4
    assert torch.equal(masks[0], masks[1]) and torch.equal(masks[2],
                                                           masks[3])
    assert not torch.equal(masks[0], masks[2])


# ---------------------------------------------------------------------------
# run.py under torchrun
# ---------------------------------------------------------------------------

def torchrun(tmp_path, *overrides) -> str:
    """`torchrun --nproc_per_node 2 -m etpnav_tpu_torch.run` training SS-ETP
    on two CPU ranks (tiny config, 2 envs each) with the YAML overrides;
    its output. The whole process group is killed at SPAWN_TIMEOUT."""
    import signal
    import subprocess
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=ROOT)
    proc = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node",
         "2", "--master_port", str(free_port()), "-m",
         "etpnav_tpu_torch.run", "--exp-config",
         os.path.join(ROOT, "configs", "r2r_tiny.yaml"), "--device", "cpu",
         "--num-envs", "2", "--ckpt-dir", str(tmp_path / "ck"),
         *overrides], cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=SPAWN_TIMEOUT)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise
    assert proc.returncode == 0, out[-3000:]
    return out


def test_runner_under_torchrun(tmp_path):
    """`torchrun --nproc_per_node 2 -m etpnav_tpu_torch.run` with MESH dp 2
    and the gloo backend trains on two CPU ranks; both report the one
    global loss, rank 0 writes the one-process checkpoint, and one
    process resumes from it."""
    from etpnav_tpu_torch.env.geometric import GeometricNavEnv
    from etpnav_tpu_torch.training.finetune import FinetuneTrainer
    ck = tmp_path / "ck"
    out = torchrun(tmp_path, "MESH.dp=2", "MESH.backend=gloo")
    done = [ln.split("train done:")[1] for ln in out.splitlines()
            if "train done:" in ln]
    assert len(done) == 2, out[-3000:]
    loss = [ast.literal_eval(d.strip())["IL_loss"] for d in done]
    assert loss[0] == loss[1] and np.isfinite(loss[0])
    assert sorted(os.listdir(ck)) == ["ckpt_iter1.pt", "ckpt_iter2.pt"]
    cfg = tiny_config()
    envs = GeometricNavEnv(2, seed=0, vocab_size=cfg.planner.vocab_size,
                           max_instr_len=cfg.il.max_text_len,
                           image_size=cfg.clip.image_size,
                           depth_size=cfg.depth.input_size,
                           pad_id=cfg.planner.pad_token_id)
    one = FinetuneTrainer(cfg, envs, seed=3, device="cpu", ckpt_dir=str(ck))
    assert one.resume_latest() and one.iteration == 2


def test_runner_under_torchrun_without_mesh(tmp_path):
    """Launched on two processes with no MESH section (dp = -1, mp = 1),
    the runner lays the world out as dp 2, as the JAX runner's mesh over
    every device: it does not train two copies of one process."""
    out = torchrun(tmp_path)
    mesh = sorted(ln.split("mesh:")[1].strip() for ln in out.splitlines()
                  if "mesh:" in ln)
    assert mesh == ["dp 2 x mp 1, rank 0 on cpu",
                    "dp 2 x mp 1, rank 1 on cpu"], out[-3000:]


if __name__ == "__main__":
    sys.exit(pytest.main([__file__, "-q"]))
