"""Pretrain -> fine-tune warm start (counterpart of
`etpnav_tpu/training/warm_start.py`).

The reference trains in two stages: proxy-task pretraining on offline
graph data (pretrain_src), then IL fine-tuning from
MODEL.pretrained_path (run_r2r/main.bash), with key surgery at
vlnbert_init.py:21-30 that keeps the trunk and the SAP head and drops the
pretrain-only heads. Here both stages hold the same module tree, so the
surgery works on state-dict names and is exact:

- the trunk (embeddings, lang_encoder, img_embeddings, global_encoder,
  global_sap_head) of `PretrainParams` is the fine-tune planner's
  (`forward_sap` is `forward_navigation`, so the SAP head transfers);
- the pretrain-only heads (mlm_head, local_encoder, image_classifier,
  og_head) are dropped;
- inside each global-encoder layer, the lang2visn branch (lang_self_att,
  lang_ffn), which only the MLM path runs, is dropped.
"""

from __future__ import annotations

import re
from typing import Dict

import torch
import torch.nn as nn

from etpnav_tpu_torch.parallel import mesh as meshlib
from etpnav_tpu_torch.training import checkpoints
from etpnav_tpu_torch.training.pretrain import CHECKPOINT_MARKER

#: top-level subtrees that exist only in the pretrain model
PRETRAIN_ONLY_HEADS = ("mlm_head", "local_encoder", "image_classifier",
                       "og_head")
#: per-layer subtrees of the global encoder that only the MLM path runs
LANG2VISN_KEYS = ("lang_self_att", "lang_ffn")

_LANG2VISN = re.compile(r"^global_encoder\.encoder\.\d+\.(%s)\." %
                        "|".join(LANG2VISN_KEYS))


def pretrain_to_planner(state: Dict[str, torch.Tensor]
                        ) -> Dict[str, torch.Tensor]:
    """A `PretrainParams` state dict -> the fine-tune planner's: the
    pretrain-only heads and the lang2visn branch dropped, every other
    tensor kept as it is."""
    return {k: v for k, v in state.items()
            if k.split(".")[0] not in PRETRAIN_ONLY_HEADS
            and not _LANG2VISN.match(k)}


def is_pretrain_checkpoint(path: str) -> bool:
    """Whether `path` is a file that `PretrainTrainer.save_checkpoint`
    wrote (it carries the marker key). A file `torch.load` cannot read
    with `weights_only=True` is not."""
    try:
        state = checkpoints.load_checkpoint(path, map_location="cpu")
    except Exception:       # pickled objects, TorchScript archives, ...
        return False
    return isinstance(state, dict) and CHECKPOINT_MARKER in state


def load_pretrained_planner(path: str, planner: nn.Module) -> None:
    """Load the trunk of a `PretrainTrainer` checkpoint into the fine-tune
    `planner`, in place; a planner split over a tensor-parallel group
    takes its shards. Any difference of structure (a missing or extra
    tensor) or of shape between the two stages raises ValueError before
    anything is copied: a partial load is never silent."""
    state = checkpoints.load_checkpoint(path, map_location="cpu")
    if not (isinstance(state, dict) and CHECKPOINT_MARKER in state):
        raise ValueError(f"{path} is not a pretrain checkpoint of "
                         "etpnav_tpu_torch")
    trunk = pretrain_to_planner(state["params"])
    like = {k: v.shape for k, v in planner.state_dict().items()}
    like.update({k: meshlib.full_shape(p)
                 for k, p in planner.named_parameters()})
    missing, extra = sorted(set(like) - set(trunk)), sorted(set(trunk)
                                                            - set(like))
    if missing or extra:
        raise ValueError(
            f"pretrain checkpoint {path} does not match the fine-tune "
            f"planner: missing {missing[:5]}, extra {extra[:5]} — the two "
            "stages were built from different PlannerConfigs")
    for k, v in trunk.items():
        if tuple(v.shape) != tuple(like[k]):
            raise ValueError(
                f"pretrain checkpoint tensor {k} has shape "
                f"{tuple(v.shape)}, the fine-tune planner "
                f"{tuple(like[k])} — the two stages were built from "
                "different PlannerConfigs")
    meshlib.load_full_state_dict(planner, trunk)
