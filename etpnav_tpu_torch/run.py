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

# trainers and options of the JAX runner that are not ported yet, with the
# ROADMAP item that ports each
NOT_PORTED = {
    "DAgger": "ROADMAP §1 item 8 (legacy DAgger policies)",
    "--video": "ROADMAP §1 item 8 (eval videos)",
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
                                     seed=cfg.seed + i)
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
                               device=args.device)
    except BaseException:
        for pool in pools:
            if hasattr(pool, "close"):
                pool.close()
        raise


@register_trainer("Pretrain")
def _build_pretrain(cfg, args):
    from etpnav_tpu_torch.training.pretrain import (
        PretrainTrainer,
        pretrain_shapes,
    )
    return PretrainTrainer(cfg, pretrain_shapes(cfg), seed=cfg.seed,
                           device=args.device)


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
                    choices=sorted({*TRAINER_REGISTRY, "DAgger"}))
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
                    help="eval navigator videos (not ported yet)")
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
    if args.video:
        raise _not_ported("--video")

    random.seed(cfg.seed)
    np.random.seed(cfg.seed)
    logging.basicConfig(level=logging.INFO)

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
    elif args.trainer in TRAINER_REGISTRY:
        trainer = TRAINER_REGISTRY[args.trainer](cfg, args)
    else:
        raise _not_ported(args.trainer)
    try:
        return _run_trainer(trainer, cfg, args)
    finally:
        if hasattr(trainer, "close"):
            trainer.close()      # the env pools' worker processes


def _run_trainer(trainer, cfg, args):
    ckpt = args.ckpt or (cfg.inference.ckpt_path
                         if args.run_type in ("inference", "serve")
                         else None)
    if ckpt:
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
        stats = trainer.evaluate(n, gt_paths=gt_paths)
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
