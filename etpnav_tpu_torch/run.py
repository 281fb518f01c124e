"""CLI entry point: config -> seed -> trainer registry -> train / eval /
inference / serve (counterpart of `etpnav_tpu/run.py`).

Capability target: the reference's run.py:20-113 (argparse, config merge,
seeding, baseline_registry trainer lookup, mode dispatch). --run-type
serve has no reference counterpart: it exposes the SS-ETP policy as a
network service (serving.py + serving_http.py).

    python -m etpnav_tpu_torch.run --exp-config configs/r2r.yaml \
        --run-type train IL.lr=2e-5
    python -m etpnav_tpu_torch.run --exp-config configs/r2r.yaml \
        --run-type serve --ckpt checkpoints/ckpt_iter12000.pt --port 8080
    python -m etpnav_tpu_torch.run --exp-config configs/r2r_tiny.yaml \
        --device cpu --run-type eval --episode-count 4
    python -m etpnav_tpu_torch.run --exp-config configs/pretrain.yaml \
        --trainer Pretrain CHECKPOINT_FOLDER=ckpt/pretrain
    python -m etpnav_tpu_torch.run --exp-config configs/r2r.yaml \
        PRETRAINED_PATH=ckpt/pretrain/model_step_100000.pt
    python -m etpnav_tpu_torch.run --exp-config configs/dagger_r2r.yaml \
        --trainer DAgger --num-envs 8 [DAGGER.policy=cma]
    python -m etpnav_tpu_torch.run --exp-config configs/r2r.yaml \
        --run-type eval --video --episode-count 4
    torchrun --nproc_per_node 4 -m etpnav_tpu_torch.run \
        --exp-config configs/r2r.yaml MESH.dp=2 MESH.mp=2

With MESH.dp * MESH.mp > 1 (the JAX runner's mesh, run.py:89-94), or
under a launcher that started more than one process, the runner starts
torch.distributed from torchrun's (or SLURM's) environment
(`parallel/mesh.py::init_distributed`, MESH.backend or nccl on CUDA),
lays the world out as dp x mp (MESH.dp = -1, the default, is world //
mp) and trains SS-ETP or Pretrain on it; each
rank's device is cuda:LOCAL_RANK, or the one `--device` names (ranks
sharing one card need MESH.backend=gloo). Evaluation stays per rank.

Everything runs on the GPU unless `--device cpu` is passed; with no GPU
and no `--device cpu` the trainer raises. `run(argv)` parses the command
line and the YAML (which needs PyYAML); `run_config(cfg, **options)`
does the work from a config object and needs no PyYAML.
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import os
import random
import threading
import zlib
from typing import Callable, Dict

import numpy as np

logger = logging.getLogger("etpnav_tpu_torch")


def hash_split(split: str) -> int:
    """Deterministic split hash (python hash() is process-salted)."""
    return zlib.crc32(split.encode())


TRAINER_REGISTRY: Dict[str, Callable] = {}

# inputs of the JAX runner that the port does not read, and why
NOT_PORTED = {
    "pretrained_path directory": "a directory names a JAX (orbax) pretrain "
                                 "checkpoint, which the port does not read; "
                                 "pretrain with `--trainer Pretrain` and "
                                 "give its model_step_N.pt file",
}


def _not_ported(what: str):
    return NotImplementedError(f"{what} is not ported to etpnav_tpu_torch: "
                               f"{NOT_PORTED[what]}")


def register_trainer(name: str):
    def deco(factory):
        TRAINER_REGISTRY[name] = factory
        return factory
    return deco


@register_trainer("SS-ETP")
def _build_ss_etp(cfg, args):
    """The fine-tune trainer over its env pools: habitat workers when
    habitat-sim is installed, else the geometric world, in process or
    (`--workers`) in worker processes; `--pipeline-halves N` splits the
    envs into N pools for the pipelined rollout."""
    from etpnav_tpu_torch.env.geometric import GeometricNavEnv
    from etpnav_tpu_torch.env.habitat_adapter import (
        habitat_available,
        make_habitat_envs,
    )
    from etpnav_tpu_torch.training.finetune import FinetuneTrainer

    halves = max(args.pipeline_halves, 1)
    mesh = getattr(args, "mesh", None)
    dp_index = 0 if mesh is None else mesh.dp_index
    num_envs = args.num_envs or cfg.num_environments
    if num_envs != cfg.il.batch_size:
        logger.warning("NUM_ENVIRONMENTS %d != IL.batch_size %d: the learn "
                       "step's batch is the env pool (the reference keeps "
                       "the two equal)", num_envs, cfg.il.batch_size)
    if num_envs % halves:
        raise ValueError(f"--pipeline-halves {halves} does not divide "
                         f"{num_envs} envs")
    per_pool = num_envs // halves
    # train uses the train split, eval/infer the EVAL/INFERENCE split; the
    # geometric world has no named splits, so the split seeds disjoint
    # procedural scenes instead
    split = (cfg.eval.split if args.run_type == "eval"
             else cfg.inference.split if args.run_type == "inference"
             else "train")
    split_seed = cfg.seed + (0 if split == "train"
                             else 10_000 + abs(hash_split(split)) % 10_000)
    # each dp slot drives envs of its own
    split_seed += dp_index * halves
    env_kwargs = dict(vocab_size=cfg.planner.vocab_size,
                      max_instr_len=cfg.il.max_text_len,
                      image_size=cfg.clip.image_size,
                      depth_size=cfg.depth.input_size,
                      pad_id=cfg.planner.pad_token_id)
    use_habitat = habitat_available()
    if not use_habitat:
        logger.warning("habitat-sim not available; using GeometricNavEnv")

    def make_pool(i):
        if use_habitat:
            return make_habitat_envs(cfg, num_envs=per_pool, split=split,
                                     seed=cfg.seed + dp_index * halves + i)
        if args.workers:
            from etpnav_tpu_torch.env.vector import construct_geometric_envs
            return construct_geometric_envs(
                per_pool, workers=True, seed=split_seed + i,
                restart_on_crash=cfg.restart_crashed_workers,
                shm_obs=cfg.shm_observations, **env_kwargs)
        return GeometricNavEnv(num_envs=per_pool, seed=split_seed + i,
                               **env_kwargs)

    pools = []
    try:
        for i in range(halves):
            pools.append(make_pool(i))
        return FinetuneTrainer(cfg, pools[0] if halves == 1 else pools,
                               ckpt_dir=args.ckpt_dir, seed=cfg.seed,
                               device=args.device, mesh=mesh)
    except BaseException:
        for pool in pools:
            if hasattr(pool, "close"):
                pool.close()
        raise


@register_trainer("DAgger")
def _build_dagger(cfg, args):
    """Legacy DAgger path: frozen-encoder features + oracle teacher over
    either policy family (dagger_trainer.py:187-629). The feature and
    candidate functions run the CLIP/depth towers and the waypoint
    predictor on the trainer's device; DAGGER.encoder_ckpt (a released
    fine-tune checkpoint) loads the converted frozen towers, else they
    are random (only useful for pipeline tests; a warning is logged).
    DAGGER.policy_ckpt (PREVALENT's pytorch_model.bin) loads the
    recurrent VLN-BERT."""
    import torch

    from etpnav_tpu_torch.device import resolve_device
    from etpnav_tpu_torch.env.geometric import GeometricNavEnv
    from etpnav_tpu_torch.env.habitat_adapter import (
        habitat_available,
        make_habitat_envs,
    )
    from etpnav_tpu_torch.models import clip_vit, depth_resnet
    from etpnav_tpu_torch.models.convert import load_jax_tree
    from etpnav_tpu_torch.training import agent as agent_mod
    from etpnav_tpu_torch.training.dagger import (
        DaggerConfig,
        DaggerTrainer,
        RecVLNBertDagger,
    )

    device = resolve_device(args.device)
    num_envs = args.num_envs or cfg.num_environments
    if habitat_available():
        # the same simulator choice as the SS-ETP builder: the legacy
        # path drives the real simulator when one is present
        envs = make_habitat_envs(cfg, num_envs=num_envs, seed=cfg.seed)
    else:
        logger.warning("habitat-sim not available; using GeometricNavEnv")
        envs = GeometricNavEnv(
            num_envs=num_envs, seed=cfg.seed,
            vocab_size=cfg.planner.vocab_size,
            max_instr_len=cfg.il.max_text_len,
            image_size=cfg.clip.image_size,
            depth_size=cfg.depth.input_size,
            pad_id=cfg.planner.pad_token_id)
    d = cfg.dagger
    dcfg = DaggerConfig(
        iterations=d.iterations, episodes_per_iter=d.episodes_per_iter,
        epochs=d.epochs, batch_size=d.batch_size, lr=d.lr, p=d.p,
        max_steps=d.max_steps)
    params = agent_mod.init_agent_params(cfg, cfg.seed)
    if d.encoder_ckpt:
        from etpnav_tpu_torch.models.convert import convert_full_policy
        trees = convert_full_policy(
            torch.load(d.encoder_ckpt, map_location="cpu"),
            planner_cfg=cfg.planner, clip_cfg=cfg.clip,
            depth_cfg=cfg.depth)
        for k in ("clip", "depth"):
            if k in trees:
                load_jax_tree(getattr(params, k), trees[k], k)
        logger.info("DAgger frozen towers loaded from %s", d.encoder_ckpt)
    else:
        logger.warning("DAGGER.encoder_ckpt unset: frozen towers are "
                       "randomly initialized (pipeline-test mode)")
    agent = agent_mod.Agent(cfg, params, device=device)

    if d.policy == "cma":
        from etpnav_tpu_torch.models.cma import CMAConfig
        s = cfg.depth.input_size // 32
        depth_channels = cfg.depth.output_size // (s * s)

        # pooled forward-view features, the quantities the reference
        # captures through its space_pool_{rgb,depth} forward hooks
        # (dagger_trainer.py:255-266)
        @torch.inference_mode()
        def feature_fn(obs):
            rgb = agent._t(np.stack([o["rgb"][0] for o in obs]))
            dep = agent._t(np.stack([o["depth"][0] for o in obs]))
            r = clip_vit.encode_image_uint8(agent.params.clip, cfg.clip,
                                            rgb)
            dd = depth_resnet.encode_depth(agent.params.depth, cfg.depth,
                                           dep).mean((1, 2))
            return (r.float().cpu().numpy(), dd.float().cpu().numpy())

        ccfg = CMAConfig(vocab_size=cfg.planner.vocab_size,
                         rgb_dim=cfg.clip.output_dim,
                         depth_dim=depth_channels,
                         pad_token_id=cfg.planner.pad_token_id)
        return DaggerTrainer(envs, ccfg, dcfg, feature_fn, d.store_dir,
                             seed=cfg.seed, device=device)

    if d.policy != "rec_vlnbert":
        raise ValueError(f"unknown DAGGER.policy {d.policy!r}")
    from etpnav_tpu_torch.models.rec_vlnbert import RecVLNBertConfig
    K = cfg.waypoint.max_predictions

    @torch.inference_mode()
    def candidate_fn(obs):
        wp = agent_mod.encode_panorama(
            agent.params, cfg, agent._t(np.stack([o["rgb"] for o in obs])),
            agent._t(np.stack([o["depth"] for o in obs])))

        def host(key, dtype):
            return wp[key].cpu().numpy().astype(dtype)

        return {
            "rgb": host("rgb_fts", np.float32)[:, :K],
            "depth": host("dep_fts", np.float32)[:, :K],
            "ang": host("loc_fts", np.float32)[:, :K],
            "angles": host("cand_angles", np.float64),
            "dists": host("cand_distances", np.float64),
            "mask": host("cand_valid", bool),
        }

    p = cfg.planner
    rcfg = RecVLNBertConfig(
        vocab_size=p.vocab_size, hidden=p.hidden_size, heads=p.num_heads,
        intermediate=p.intermediate_size,
        la_layers=(d.la_layers if d.la_layers > 0 else p.num_l_layers),
        vl_layers=(d.vl_layers if d.vl_layers > 0 else p.num_x_layers),
        max_pos=p.max_position_embeddings, eps=p.lang_layer_norm_eps,
        rgb_dim=p.image_feat_size, depth_dim=p.depth_feat_size,
        angle_dim=p.angle_feat_size, max_cands=K + 1,
        hidden_dropout=p.hidden_dropout, attn_dropout=p.attn_dropout,
        pad_token_id=p.pad_token_id)
    trainer = RecVLNBertDagger(envs, rcfg, dcfg, candidate_fn,
                               d.store_dir, seed=cfg.seed, device=device)
    if d.policy_ckpt:
        # PREVALENT pytorch_model.bin -> the policy's transformer
        # (vlnbert_init.py:10-18); Adam starts afresh on the loaded
        # weights, as the JAX runner re-inits its optimizer state
        from etpnav_tpu_torch.models.convert import convert_rec_vlnbert
        from etpnav_tpu_torch.training.dagger import make_adam
        convert_rec_vlnbert(torch.load(d.policy_ckpt, map_location="cpu"),
                            trainer.params, rcfg.la_layers, rcfg.vl_layers)
        trainer.optimizer = make_adam(trainer.params, dcfg.lr)
        logger.info("DAgger policy loaded from %s", d.policy_ckpt)
    return trainer


@register_trainer("Pretrain")
def _build_pretrain(cfg, args):
    from etpnav_tpu_torch.training.pretrain import (
        PretrainTrainer,
        pretrain_shapes,
    )
    return PretrainTrainer(cfg, pretrain_shapes(cfg), seed=cfg.seed,
                           device=args.device,
                           mesh=getattr(args, "mesh", None))


def load_pretrained_path(trainer, path: str) -> None:
    """MODEL.pretrained_path into a fine-tune trainer: a pretrain
    checkpoint of the port (it carries `PretrainTrainer`'s marker) goes
    to the warm start; any other file must be a released PyTorch planner
    checkpoint and goes to the converter, or raises ValueError. A
    directory (a JAX orbax checkpoint) is refused."""
    from etpnav_tpu_torch.training.warm_start import is_pretrain_checkpoint
    if os.path.isdir(path):
        raise _not_ported("pretrained_path directory")
    if is_pretrain_checkpoint(path):
        trainer.load_pretrained(path)
        logger.info("warm-started the planner from pretrain checkpoint %s",
                    path)
        return
    try:
        trainer.load_pretrained_planner(path)
    except Exception as e:
        raise ValueError(
            f"MODEL.pretrained_path {path} is neither a pretrain checkpoint "
            "of etpnav_tpu_torch nor a released planner checkpoint "
            f"({type(e).__name__}: {e})") from e
    logger.info("loaded the released pretrained planner from %s", path)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="etpnav_tpu_torch runner")
    ap.add_argument("--exp-config", default=None,
                    help="YAML experiment config (required by run())")
    ap.add_argument("--run-type",
                    choices=["train", "eval", "inference", "serve"],
                    default="train")
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the kernels' plain "
                         "PyTorch versions on the CPU")
    ap.add_argument("--host", default="0.0.0.0",
                    help="serve: bind address")
    ap.add_argument("--port", type=int, default=8080,
                    help="serve: bind port (0 = ephemeral)")
    ap.add_argument("--serve-max-batch", type=int, default=8,
                    help="serve: device batch slots per dispatch")
    ap.add_argument("--serve-nonblocking", action="store_true",
                    help="serve: return (httpd, nav) instead of "
                         "blocking (programmatic use / tests)")
    ap.add_argument("--trainer", default="SS-ETP",
                    choices=sorted(TRAINER_REGISTRY))
    ap.add_argument("--num-envs", type=int, default=0,
                    help="0 = cfg NUM_ENVIRONMENTS (reference keeps "
                         "IL.batch_size equal to it)")
    ap.add_argument("--workers", action="store_true",
                    help="run each env in a worker process "
                         "(env/vector.py; RESTART_CRASHED_WORKERS, "
                         "SHM_OBSERVATIONS)")
    ap.add_argument("--pipeline-halves", type=int, default=1,
                    help="split the envs into N pools rolled out in "
                         "threads (training/pipeline.py); 1 = one pool")
    ap.add_argument("--ckpt-dir", default="checkpoints")
    ap.add_argument("--ckpt", default=None, help="checkpoint to load")
    ap.add_argument("--episode-count", type=int, default=-1)
    ap.add_argument("--predictions-file", default="",
                    help="defaults to INFERENCE.predictions_file")
    ap.add_argument("--video", action="store_true",
                    help="write per-episode navigator videos to "
                         "cfg.video_dir during eval (VIDEO_DIR pipeline)")
    ap.add_argument("--gt-path", default=None,
                    help="{split}_gt.json.gz with reference locations "
                         "(ndtw supervision / eval)")
    ap.add_argument("opts", nargs="*", help="SECTION.key=value overrides")
    return ap


def serving_config(cfg):
    """Config adjustments for the inference-only serving surface.

    The nav stack serves in fp32 unless PLANNER.nav_use_bf16 says
    otherwise: the reference evaluates fp32 (it autocasts only the train
    rollout, ss_trainer_ETP.py:502), and the JAX package makes the same
    choice. An explicit PLANNER.nav_use_bf16 wins."""
    if cfg.planner.nav_use_bf16 is None:
        cfg = dataclasses.replace(cfg, planner=dataclasses.replace(
            cfg.planner, nav_use_bf16=False))
    return cfg


def run(args=None):
    """Parse the command line and the YAML config, then `run_config`."""
    from etpnav_tpu_torch.config_yaml import load_config, parse_cli_opts
    parser = build_parser()
    args = parser.parse_args(args)
    if not args.exp_config:
        parser.error("--exp-config is required")
    cfg = load_config(args.exp_config, parse_cli_opts(args.opts))
    return run_config(cfg, args)


def run_config(cfg, args: argparse.Namespace = None, **options):
    """Run `cfg` as `run` would. `args` is a parsed command line (the
    parser's defaults when None); keyword `options` override its fields
    by their dest names (`run_type="serve"`, `device="cpu"`, ...)."""
    ns = vars(args) if args is not None else vars(build_parser().parse_args(
        []))
    unknown = set(options) - set(ns)
    if unknown:
        raise TypeError(f"unknown runner options {sorted(unknown)}")
    args = argparse.Namespace(**{**ns, **options})

    random.seed(cfg.seed)
    np.random.seed(cfg.seed)
    logging.basicConfig(level=logging.INFO)

    args.mesh = None
    started = False
    from etpnav_tpu_torch.parallel import mesh as meshlib
    if cfg.mesh.dp > 1 or cfg.mesh.mp > 1 or meshlib.launched_world() > 1:
        if args.run_type == "serve" or args.trainer == "DAgger":
            raise ValueError(f"MESH dp={cfg.mesh.dp} mp={cfg.mesh.mp} "
                             f"over {meshlib.launched_world()} launched "
                             "process(es): serving and the DAgger trainer "
                             "run on one process")
        import torch.distributed as dist
        started = not dist.is_initialized()
        meshlib.init_distributed(
            backend=cfg.mesh.backend or None,
            device=None if args.device == "cuda" else args.device)
        args.device = meshlib.rank_device(args.device)
        args.mesh = meshlib.make_mesh(cfg.mesh.dp, cfg.mesh.mp)
        logger.info("mesh: dp %d x mp %d, rank %d on %s", args.mesh.dp,
                    args.mesh.mp, args.mesh.rank, args.device)
    try:
        return _run_mode(cfg, args)
    finally:
        if started:
            meshlib.shutdown()


def _run_mode(cfg, args):
    if args.run_type == "serve":
        if args.trainer != "SS-ETP":
            raise ValueError("serving exposes the SS-ETP policy; "
                             f"--trainer {args.trainer} has no session "
                             "surface")
        cfg = serving_config(cfg)
        # no envs: the service's clients own their simulators/cameras
        from etpnav_tpu_torch.training.finetune import FinetuneTrainer
        trainer = FinetuneTrainer(cfg, None, ckpt_dir=args.ckpt_dir,
                                  seed=cfg.seed, device=args.device)
    else:
        trainer = TRAINER_REGISTRY[args.trainer](cfg, args)
    try:
        return _run_trainer(trainer, cfg, args)
    finally:
        if hasattr(trainer, "close"):
            trainer.close()      # the env pools' worker processes


def _run_trainer(trainer, cfg, args):
    dagger = hasattr(trainer, "collect")
    if dagger and args.run_type == "inference":
        raise ValueError("the DAgger trainer has no leaderboard "
                         "inference mode; use --run-type train or eval")
    if dagger and args.run_type == "eval" and not hasattr(trainer,
                                                          "evaluate"):
        raise ValueError("this DAgger policy has no eval loop; "
                         "use DAGGER.policy=rec_vlnbert")
    ckpt = args.ckpt or (cfg.inference.ckpt_path
                         if args.run_type in ("inference", "serve")
                         else None)
    if ckpt:
        if not hasattr(trainer, "load_checkpoint"):
            raise ValueError(
                f"trainer {args.trainer!r} cannot load checkpoints; "
                "for DAgger use DAGGER.encoder_ckpt for the frozen towers")
        trainer.load_checkpoint(ckpt)
    elif cfg.pretrained_path and hasattr(trainer, "load_pretrained"):
        load_pretrained_path(trainer, cfg.pretrained_path)

    gt_paths = None
    if args.gt_path:
        from etpnav_tpu_torch.data.episodes import load_gt_paths
        gt_paths = load_gt_paths(args.gt_path)

    if args.run_type == "serve":
        from etpnav_tpu_torch.serving import NavServer
        from etpnav_tpu_torch.serving_http import make_http_server, serve
        nav = NavServer(cfg, trainer.agent, max_batch=args.serve_max_batch)
        if args.serve_nonblocking:
            httpd = make_http_server(nav, args.host, args.port)
            threading.Thread(target=httpd.serve_forever,
                             daemon=True).start()
            logger.info("serving (nonblocking) on %s:%d",
                        *httpd.server_address[:2])
            return httpd, nav
        logger.info("warming device programs, then serving on %s:%d",
                    args.host, args.port)
        return serve(nav, args.host, args.port)

    if args.run_type == "train" and hasattr(trainer, "train_steps"):
        # pretraining: PRETRAIN.resume picks up the newest model_step_N
        # of CHECKPOINT_FOLDER (the JAX runner's layout)
        if (cfg.pretrain.resume and not args.ckpt
                and trainer.resume_latest(cfg.checkpoint_folder)):
            logger.info("resumed pretraining at step %d", trainer.step)
        os.makedirs(cfg.checkpoint_folder, exist_ok=True)
        logs = trainer.train_steps(
            max(cfg.pretrain.num_train_steps - trainer.step, 0),
            ckpt_dir=cfg.checkpoint_folder)
        logger.info("pretrain done: %s", logs)
        return logs
    if hasattr(trainer, "train_steps"):
        raise ValueError(f"--trainer Pretrain has no --run-type "
                         f"{args.run_type}; use train")
    if dagger and args.run_type == "train":
        logs = trainer.train()
        logger.info("DAgger train done: %s", logs)
        return logs
    if dagger:                                 # the greedy legacy eval
        n = args.episode_count if args.episode_count > 0 else 24
        stats = trainer.evaluate(n, success_distance=cfg.il.success_distance)
        logger.info("DAgger eval: %s", stats)
        return stats
    if args.run_type == "train":
        # IL.is_requeue gates auto-resume (ss_trainer_ETP.py:216-236)
        if (cfg.il.is_requeue and not args.ckpt
                and trainer.resume_latest(args.ckpt_dir)):
            logger.info("requeue: resumed at iteration %d",
                        trainer.iteration)
        remaining = max(cfg.il.iters - trainer.iteration, 0)
        logs = trainer.train(remaining, gt_paths=gt_paths,
                             save_every=cfg.il.log_every)
        trainer.save_checkpoint(os.path.join(
            args.ckpt_dir, f"ckpt_iter{trainer.iteration}.pt"))
        logger.info("train done: %s", logs)
        return logs
    if args.run_type == "eval":
        n = (args.episode_count if args.episode_count > 0
             else cfg.eval.episode_count if cfg.eval.episode_count > 0
             else 100)
        if cfg.eval.fast_eval:
            # every-5th-episode subsample (ss_trainer_ETP.py:569); the
            # procedural world has no fixed list, so the count shrinks
            # by the same factor
            n = max(1, -(-n // 5))
            logger.info("fast_eval: evaluating %d episodes", n)
        if cfg.eval.ckpt_path_dir:
            # the reference's eval mode: poll the checkpoint folder,
            # evaluate every checkpoint once (base_il_trainer.py:874-889)
            from etpnav_tpu_torch.training.eval_loop import \
                eval_checkpoint_loop
            results = eval_checkpoint_loop(
                trainer, cfg.eval.ckpt_path_dir, cfg.results_dir,
                episode_count=n, split=cfg.eval.split, gt_paths=gt_paths)
            logger.info("eval loop: %d checkpoints", len(results))
            return results
        stats = trainer.evaluate(
            n, gt_paths=gt_paths,
            video_dir=cfg.video_dir if args.video else None)
        logger.info("eval: %s", stats)
        return stats
    n = (args.episode_count if args.episode_count > 0
         else cfg.inference.episode_count
         if cfg.inference.episode_count > 0 else 100)
    preds = args.predictions_file or cfg.inference.predictions_file
    fmt = cfg.inference.format or cfg.task_type
    return trainer.inference(n, preds, fmt=fmt)


if __name__ == "__main__":
    run()
