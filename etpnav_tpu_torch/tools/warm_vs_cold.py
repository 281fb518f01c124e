"""Warm against cold: does the two-stage recipe's warm start help
downstream IL? (The port's counterpart of `tools/warm_vs_cold.py`; the
reference composes pretrain -> fine-tune through MODEL.pretrained_path,
run_r2r/main.bash.)

Usage:
  python -m etpnav_tpu_torch.tools.warm_vs_cold --tiny --device cpu
  python -m etpnav_tpu_torch.tools.warm_vs_cold --pretrain-steps 300

Protocol: pretrain `PretrainTrainer` on synthetic scan graphs, save its
checkpoint, then train two `FinetuneTrainer`s from the same seed on the
same `GeometricNavEnv` stream, one cold and one warm-started through
`FinetuneTrainer.load_pretrained`, and report the IL loss and held-out
SR / SPL at matched iterations. One JSON line per eval point per arm;
the last line is the side-by-side summary.

The pretraining distribution is the synthetic sampler's, not MP3D, so
the transfer to the geometric world may be weak or negative: a negative
transfer is a recorded result, not a fault.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import tempfile
import time
from typing import Callable, List, Optional

NOTE = ("synthetic pretrain distribution != the geometric world; negative "
        "transfer is a recorded result, not a bug")

_print = functools.partial(print, flush=True)


def main(argv: Optional[List[str]] = None,
         emit: Callable[[str], None] = _print) -> dict:
    """Run both arms with the command line `argv`; every JSON line goes
    to `emit`; returns the summary line's object."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--pretrain-steps", type=int, default=300)
    ap.add_argument("--iters", type=int, default=40)
    ap.add_argument("--eval-every", type=int, default=20)
    ap.add_argument("--eval-episodes", type=int, default=12)
    ap.add_argument("--num-envs", type=int, default=4)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    from etpnav_tpu_torch.tools.learning_demo import heldout_eval, make_envs
    from etpnav_tpu_torch.tools.pretrain_synth import pretrain_setup
    from etpnav_tpu_torch.training.finetune import FinetuneTrainer
    from etpnav_tpu_torch.training.pretrain import PretrainTrainer

    cfg, shapes = pretrain_setup("tiny" if args.tiny else "r2r",
                                 args.pretrain_steps, args.batch)
    t0 = time.time()
    pre = PretrainTrainer(cfg, shapes, seed=args.seed, num_scans=8,
                          scan_size=16, device=args.device)
    logs = pre.train_steps(args.pretrain_steps)
    val = pre.validate()
    with tempfile.TemporaryDirectory(prefix="warmstart_") as tmp:
        ckpt = os.path.join(tmp, f"model_step_{args.pretrain_steps}.pt")
        pre.save_checkpoint(ckpt)
        del pre
        emit(json.dumps({"pretrain_steps": args.pretrain_steps,
                         **{k: round(v, 4) for k, v in logs.items()},
                         **{k: round(v, 4) for k, v in val.items()},
                         "pretrain_s": round(time.time() - t0, 1)}))
        summary = {}
        for arm in ("cold", "warm"):
            tr = FinetuneTrainer(cfg, make_envs(cfg, args.num_envs,
                                                args.seed),
                                 seed=args.seed, device=args.device)
            if arm == "warm":
                tr.load_pretrained(ckpt)
            heldout = make_envs(cfg, args.num_envs, args.seed + 1000)
            done = 0
            while done < args.iters:
                n = min(args.eval_every, args.iters - done)
                logs = tr.train(n)
                done += n
                stats = heldout_eval(tr, heldout, args.eval_episodes)
                point = {"arm": arm, "iter": done,
                         "IL_loss": round(logs["IL_loss"], 4),
                         **{k: round(v, 3) for k, v in stats.items()}}
                emit(json.dumps(point))
            summary[arm] = {"IL_loss": point["IL_loss"],
                            "success": point.get("success"),
                            "spl": point.get("spl")}
            tr.close()
    summary["delta_IL_loss"] = round(
        summary["cold"]["IL_loss"] - summary["warm"]["IL_loss"], 4)
    last = {"summary": summary, "note": NOTE}
    emit(json.dumps(last))
    return last


if __name__ == "__main__":
    main()
