"""Checkpoint conversion CLI: released PyTorch weights -> the port's own
checkpoint of one sub-module (counterpart of `etpnav_tpu/convert_cli.py`).

    python -m etpnav_tpu_torch.convert_cli --kind planner \
        --torch-ckpt model_step_82500.pt --out ckpt/planner.pt
    python -m etpnav_tpu_torch.convert_cli --kind waypoint \
        --torch-ckpt check_cwp_bestdist_hfov90 --out ckpt/waypoint.pt
    python -m etpnav_tpu_torch.convert_cli --kind clip \
        --torch-ckpt ViT-B-32.pt --out ckpt/clip.pt
    python -m etpnav_tpu_torch.convert_cli --kind depth \
        --torch-ckpt gibson-2plus-resnet50.pth --out ckpt/depth.pt

Covers the reference's load-time key surgery (vlnbert_init.py:21-30,
ss_trainer_ETP.py:196-236, resnet_encoders.py:37-50). The output is
`training/checkpoints.save_checkpoint` of the sub-module's `state_dict()`
(`PlannerParams`, `WaypointParams`, `ClipParams` or `DepthParams` at
`r2r_config()` or `rxr_config()` widths), which
`module.load_state_dict(load_checkpoint(path))` reads back.
"""

from __future__ import annotations

import argparse

import torch

KINDS = ("planner", "waypoint", "clip", "depth")


def load_torch_state_dict(path: str, kind: str):
    """The state dict of a released file, with the load-time key surgery.

    Released files hold non-tensor objects, so they are unpickled
    (`weights_only=False`): convert only files from a source you trust.
    openai CLIP's `ViT-B-32.pt` is a TorchScript archive. With
    `weights_only=False`, `torch.load` hands such an archive to
    `torch.jit.load` with a warning (PyTorch 2.11 with CUDA 12.8 and
    2.13 for the CPU both do, the former checked by chip_smoke.py);
    where a version refuses it instead, it is read with `torch.jit.load`
    here. Either way its `.state_dict()` is taken."""
    try:
        ckpt = torch.load(path, map_location="cpu", weights_only=False)
    except RuntimeError:
        ckpt = torch.jit.load(path, map_location="cpu")
    if kind == "depth":
        # ddppo: {'state_dict': {'actor_critic.net.visual_encoder.*'}}
        sd = ckpt.get("state_dict", ckpt)
        out = {}
        for k, v in sd.items():
            parts = k.split(".")
            if "visual_encoder" in parts:
                i = parts.index("visual_encoder")
                out[".".join(parts[i + 1:])] = v
            else:
                out[k] = v
        return out
    if isinstance(ckpt, dict) and "state_dict" in ckpt:
        return ckpt["state_dict"]
    if hasattr(ckpt, "state_dict"):   # TorchScript clip archives
        return ckpt.state_dict()
    if isinstance(ckpt, dict) and "predictor" in ckpt:
        return ckpt["predictor"]
    return ckpt


def convert(kind: str, torch_ckpt: str, task_type: str = "r2r"):
    """The released file as the port's sub-module, loaded on the CPU."""
    from etpnav_tpu_torch import config as C
    from etpnav_tpu_torch.models import clip_vit, depth_resnet, planner, \
        waypoint
    from etpnav_tpu_torch.models.convert import convert_planner, \
        convert_waypoint, load_jax_tree

    sd = load_torch_state_dict(torch_ckpt, kind)
    cfg = C.r2r_config() if task_type == "r2r" else C.rxr_config()
    if kind == "planner":
        p = cfg.planner
        module = planner.PlannerParams(p)
        tree = convert_planner(sd, p.num_l_layers, p.num_pano_layers,
                               p.num_x_layers)
    elif kind == "waypoint":
        module = waypoint.WaypointParams(cfg.waypoint)
        tree = convert_waypoint(sd, cfg.waypoint.num_layers)
    elif kind == "clip":
        module = clip_vit.ClipParams(cfg.clip)
        tree = clip_vit.convert_openai_clip(sd, cfg.clip)
    elif kind == "depth":
        module = depth_resnet.DepthParams(cfg.depth)
        tree = depth_resnet.convert_ddppo_depth(sd, cfg.depth)
    else:
        raise ValueError(f"unknown kind {kind!r}; options: {KINDS}")
    load_jax_tree(module, tree, kind)
    return module


def main(args=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--kind", required=True, choices=KINDS)
    ap.add_argument("--torch-ckpt", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--task-type", default="r2r", choices=["r2r", "rxr"])
    ns = ap.parse_args(args)
    module = convert(ns.kind, ns.torch_ckpt, ns.task_type)
    from etpnav_tpu_torch.training.checkpoints import save_checkpoint
    save_checkpoint(ns.out, module.state_dict())
    n = sum(p.numel() for p in module.parameters())
    print(f"converted {ns.kind}: {n / 1e6:.1f}M params -> {ns.out}")


if __name__ == "__main__":
    main()
