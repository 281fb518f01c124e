"""End-to-end learning validation on the geometric world (the port's
counterpart of `tools/learning_demo.py`).

Usage: python -m etpnav_tpu_torch.tools.learning_demo [--iters 400]
       [--eval-every 100] [--num-envs 8] [--eval-episodes 24]
       [--ckpt-dir runs/conv] [--device cuda|cpu] [--config r2r|tiny]

Trains the full-size model (CLIP ViT-B/32 + depth ResNet + waypoint TRM
+ cross-modal planner; `--config tiny` for a CPU smoke run) with
schedule-sampled IL on the synthetic instruction language of
`GeometricNavEnv` and evaluates on a held-out env pool (seed + 1000),
printing one JSON line per eval point: the held-out metrics, `sr_sem`,
the IL loss, `sec_per_iter` and its split into rollout, learn and eval
seconds, and the cumulative (T, G) learn buckets. This is the sim-free
analogue of the reference's fine-tuning run (ss_trainer_ETP.py:440-512):
it shows that the whole stack learns instruction-following end to end,
not that it reaches R2R numbers.

--ckpt-dir makes the run durable across sessions: it resumes from the
newest `ckpt_iter{N}.pt` in the directory (printing `resumed_at`), saves
on SIGTERM / exit and every --save-every iterations, and prunes old
checkpoints. Iteration numbers are global, so appending successive
sessions' output yields one monotone curve. Neither the dropout stream
nor the rollout's sampling stream is in a checkpoint; a resumed session
reseeds only its train envs (by the resume iteration), as the JAX tool
does.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import glob
import json
import os
import re
import signal
import time
from typing import Callable, List, Optional


def prune_checkpoints(ckpt_dir: str, keep: int = 1):
    """Delete all but the newest `keep` `ckpt_iter{N}.pt` files; the
    temporary file of an unfinished save (`.tmp-<pid>`) is never
    counted or deleted."""
    cands = [p for p in glob.glob(os.path.join(ckpt_dir, "ckpt_iter*"))
             if ".tmp-" not in os.path.basename(p)]

    def it(p):
        m = re.search(r"iter(\d+)", os.path.basename(p))
        return int(m.group(1)) if m else -1

    for p in sorted(cands, key=it)[:-keep]:
        os.remove(p)


def demo_config(name: str, depth_u16: bool = False):
    """`r2r_config()`, or `tiny_config()` for a CPU smoke run."""
    from etpnav_tpu_torch.config import r2r_config, tiny_config
    cfg = r2r_config() if name == "r2r" else tiny_config()
    if depth_u16:
        cfg = dataclasses.replace(
            cfg, il=dataclasses.replace(cfg.il, depth_transport_uint16=True))
    return cfg


def make_envs(cfg, num_envs: int, seed: int):
    """A `GeometricNavEnv` pool at `cfg`'s observation and text shapes."""
    from etpnav_tpu_torch.env.geometric import GeometricNavEnv
    return GeometricNavEnv(
        num_envs=num_envs, seed=seed,
        vocab_size=cfg.planner.vocab_size,
        max_instr_len=cfg.il.max_text_len,
        image_size=cfg.clip.image_size,
        depth_size=cfg.depth.input_size,
        pad_id=cfg.planner.pad_token_id)


def heldout_eval(trainer, heldout, episodes: int) -> dict:
    """`trainer.evaluate(episodes)` on the `heldout` pool; the train pool
    is put back after."""
    train_envs = trainer.engine.envs
    trainer.engine.envs = heldout
    try:
        return trainer.evaluate(episodes)
    finally:
        trainer.engine.envs = train_envs


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=400)
    ap.add_argument("--eval-every", type=int, default=100)
    ap.add_argument("--num-envs", type=int, default=8)
    ap.add_argument("--eval-episodes", type=int, default=24)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default="",
                    help="resume/save checkpoints here (cross-session runs)")
    ap.add_argument("--save-every", type=int, default=100,
                    help="mid-run checkpoint interval (0 = exit-save only)")
    ap.add_argument("--depth-u16", action="store_true",
                    help="uint16 depth transport (halves depth upload)")
    ap.add_argument("--pretrained-ckpt", default="",
                    help="warm-start the planner from a PretrainTrainer "
                         "checkpoint of the port (training/warm_start.py; "
                         "tools/pretrain_synth.py writes one)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--config", default="r2r", choices=("r2r", "tiny"))
    return ap


_print = functools.partial(print, flush=True)


def main(argv: Optional[List[str]] = None, *, params=None,
         emit: Callable[[str], None] = _print) -> List[dict]:
    """Run the demo with the command line `argv`; every JSON line goes to
    `emit`, and the list of the printed objects is returned. `params`
    (an `AgentParams`) replaces the seeded random weights."""
    args = parser().parse_args(argv)
    from etpnav_tpu_torch.training.finetune import FinetuneTrainer

    cfg = demo_config(args.config, args.depth_u16)
    lines: List[dict] = []

    def out(payload: dict):
        lines.append(payload)
        emit(json.dumps(payload))

    trainer = FinetuneTrainer(cfg, make_envs(cfg, args.num_envs, args.seed),
                              params=params, seed=args.seed,
                              ckpt_dir=args.ckpt_dir or "checkpoints",
                              device=args.device)
    if args.pretrained_ckpt:
        trainer.load_pretrained(args.pretrained_ckpt)
        out({"warm_started_from": args.pretrained_ckpt})
    if args.ckpt_dir and trainer.resume_latest():
        out({"resumed_at": trainer.iteration})
        # a fresh episode stream per session: the env pool's rng is not
        # in the checkpoint, so resuming with the same seed would train
        # again on the seed's first episodes every session
        trainer.envs = make_envs(cfg, args.num_envs,
                                 args.seed + trainer.iteration)
        trainer.engine.envs = trainer.envs
    heldout = make_envs(cfg, args.num_envs, args.seed + 1000)

    def evaluate(payload: dict):
        t = time.time()
        stats = heldout_eval(trainer, heldout, args.eval_episodes)
        payload["eval_s"] = round(time.time() - t, 2)
        payload.update({k: round(v, 3) for k, v in stats.items()})
        # SR standard error over n Bernoulli episodes: the curve's noise
        sr = stats.get("success", 0.0)
        n = max(stats.get("n_episodes", 1), 1)
        payload["sr_sem"] = round((sr * (1.0 - sr) / n) ** 0.5, 3)
        if trainer.bucket_counts:
            # the realised (T, G) learn-program mix, this session
            payload["buckets"] = {f"T{t}_G{g}": c for (t, g), c in
                                  sorted(trainer.bucket_counts.items())}
        out(payload)

    if trainer.iteration == 0:
        evaluate({"iter": 0})
    t0 = time.time()
    start = trainer.iteration

    def _term(signum, frame):   # `timeout` sends SIGTERM: save, then exit
        raise KeyboardInterrupt
    previous = signal.signal(signal.SIGTERM, _term)

    try:
        while trainer.iteration < args.iters:
            n = min(args.eval_every, args.iters - trainer.iteration)
            logs = trainer.train(
                n, save_every=(args.save_every or None) if args.ckpt_dir
                else None)
            evaluate({"iter": trainer.iteration,
                      "IL_loss": round(logs["IL_loss"], 3),
                      "sec_per_iter": round(
                          (time.time() - t0) / (trainer.iteration - start),
                          2),
                      "rollout_s": round(logs["rollout_s"], 3),
                      "learn_s": round(logs["learn_s"], 3)})
            if args.ckpt_dir:
                prune_checkpoints(args.ckpt_dir)
    except KeyboardInterrupt:
        out({"interrupted_at": trainer.iteration})
    finally:
        signal.signal(signal.SIGTERM, previous)
        if args.ckpt_dir and trainer.iteration > start:
            path = os.path.join(args.ckpt_dir,
                                f"ckpt_iter{trainer.iteration}.pt")
            if not os.path.exists(path):
                t = time.time()
                trainer.save_checkpoint(path)
                out({"saved": path, "save_s": round(time.time() - t, 1)})
            prune_checkpoints(args.ckpt_dir)
        trainer.close()
    return lines


if __name__ == "__main__":
    main()
