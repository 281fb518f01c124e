"""The learning demo under one variant of the learn path, to find which
part of the port's training moves its learning curve.

Usage (the demo's own flags follow the variant):
    python -m etpnav_tpu_torch.tools.learn_ab --variant VARIANT \
        [learning_demo flags]

Variants:
  kernels          the demo as it is (bf16 at r2r_config, every attention
                   on K-ATT and K-ATT-BWD);
  plain_attention  K-ATT's and K-ATT-BWD's wrappers sent to their plain
                   PyTorch versions, on the card's tensors too;
  fp32             the planner in fp32 (`PlannerConfig.use_bf16` off).

Prints the demo's JSON lines, each with a "variant" key.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys

VARIANTS = ("kernels", "plain_attention", "fp32")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variant", choices=VARIANTS, required=True)
    args, rest = ap.parse_known_args(argv)
    from etpnav_tpu_torch.ops import fused_attention as fa
    from etpnav_tpu_torch.tools import learning_demo

    if args.variant == "plain_attention":
        fa.attention_fwd, fa.attention_bwd = fa.attention_plain, \
            fa.attention_bwd_plain
    elif args.variant == "fp32":
        config = learning_demo.demo_config

        def fp32_config(*a, **kw):
            cfg = config(*a, **kw)
            return dataclasses.replace(cfg, planner=dataclasses.replace(
                cfg.planner, use_bf16=False))
        learning_demo.demo_config = fp32_config

    def emit(line: str):
        print(json.dumps({"variant": args.variant, **json.loads(line)}),
              flush=True)
    return learning_demo.main(rest, emit=emit)


if __name__ == "__main__":
    main(sys.argv[1:])
