"""Pretrain the planner on synthetic graph data and save a checkpoint
for the two-stage warm start (the port's counterpart of
`tools/pretrain_synth.py`).

Usage: python -m etpnav_tpu_torch.tools.pretrain_synth [--steps 500]
       [--out runs/pretrain] [--batch 32] [--num-scans 8]
       [--scan-size 24] [--device cuda|cpu] [--config r2r|tiny]

The analogue of the reference's stage 1 (pretrain_src/train_r2r.py:
MLM + SAP on offline MP3D graphs) at demo scale: `PretrainSampler`
synthesises scan graphs in the layout of the released HDF5 data,
`PretrainTrainer` runs the task-mixed recipe, and the saved
`model_step_N.pt` loads into `FinetuneTrainer.load_pretrained`, as
`learning_demo --pretrained-ckpt` does.

Prints one JSON line per log interval; the last line names the
checkpoint and carries `validate()`'s accuracies.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time


def pretrain_setup(config: str, steps: int, batch: int):
    """(cfg, shapes) of the JAX tool: `r2r_config()` with the reference's
    R2R pretraining shapes, or the tiny config with the JAX tool's tiny
    shapes; the pretrain section's batch, step count and warmup (a tenth
    of the steps) from the arguments."""
    from etpnav_tpu_torch.config import r2r_config, tiny_config
    from etpnav_tpu_torch.data.pretrain_data import PretrainShapes
    if config == "tiny":
        cfg = tiny_config()
        cfg = dataclasses.replace(
            cfg, planner=dataclasses.replace(
                cfg.planner, max_txt_len=16, image_feat_size=32,
                depth_feat_size=16))
        shapes = PretrainShapes(
            max_txt_len=16, max_traj_steps=4, num_views=12, max_cands=4,
            max_gmap_len=24, image_feat_size=32, depth_feat_size=16,
            vocab_size=512, mask_token_id=3, mask_vocab_range=(10, 500))
    else:
        cfg = r2r_config()
        shapes = PretrainShapes()
    cfg = dataclasses.replace(
        cfg, pretrain=dataclasses.replace(
            cfg.pretrain, batch_size=batch, num_train_steps=steps,
            warmup_steps=max(steps // 10, 1)))
    return cfg, shapes


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=500)
    ap.add_argument("--out", default="runs/pretrain")
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--num-scans", type=int, default=8)
    ap.add_argument("--scan-size", type=int, default=24)
    ap.add_argument("--log-every", type=int, default=100)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--config", default="r2r", choices=("r2r", "tiny"))
    args = ap.parse_args(argv)
    from etpnav_tpu_torch.training.pretrain import PretrainTrainer

    cfg, shapes = pretrain_setup(args.config, args.steps, args.batch)
    tr = PretrainTrainer(cfg, shapes, seed=args.seed,
                         num_scans=args.num_scans, scan_size=args.scan_size,
                         device=args.device)
    t0 = time.time()
    done = 0
    while done < args.steps:
        n = min(args.log_every, args.steps - done)
        logs = tr.train_steps(n)
        done += n
        print(json.dumps({"step": done,
                          **{k: round(v, 4) for k, v in logs.items()},
                          "sec_per_step": round((time.time() - t0) / done,
                                                3)}), flush=True)
    val = tr.validate()
    os.makedirs(args.out, exist_ok=True)
    path = os.path.join(args.out, f"model_step_{done}.pt")
    tr.save_checkpoint(path)
    last = {"saved": path, **{k: round(v, 4) for k, v in val.items()}}
    print(json.dumps(last), flush=True)
    return last


if __name__ == "__main__":
    main()
