"""YAML experiment configs over the frozen dataclass tree (counterpart of
`etpnav_tpu/config_yaml.py`, with the same sections, presets and
refusal of unknown keys).

YAML layout:
    BASE: r2r              # or rxr / tiny preset
    IL: {lr: 1.0e-5, iters: 15000, expert_policy: spl}
    PRETRAIN: {optim: adamw, num_train_steps: 100000}
    CLIP: {use_fused_block: true}

A TPU-only key of a ported section (IL.rng_impl, PLANNER.remat_policy,
...) is not a field here and raises KeyError like any unknown key, with
a message that says it is TPU-only.

MESH takes the JAX package's dp and mp and the port's own `backend`
(`parallel/mesh.py`). TEXT_LLM is the port's own section
(`config.TextLLMConfig`): `enabled: true` selects the DeepSeek-V2
instruction encoder in place of the BERT text stack (the preset
`BASE: rxr_dsv2lite` is RxR-CE with DeepSeek-V2-Lite, 16 of its 64
experts held; `python -m etpnav_tpu_torch.run --exp-config X.yaml
--run-type serve` with X.yaml = `BASE: rxr_dsv2lite` serves it). The
trainers refuse it: the encoder is frozen. An unknown section or key raises KeyError. Nothing
is dropped silently. PyYAML is imported only by the functions that
parse YAML, so `config_from_dict` and the runner's `run_config` need no
PyYAML.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

from etpnav_tpu_torch import config as C

_SECTION_FIELDS = {
    "PLANNER": "planner",
    "WAYPOINT": "waypoint",
    "CLIP": "clip",
    "DEPTH": "depth",
    "GRAPH": "graph",
    "IL": "il",
    "PRETRAIN": "pretrain",
    "DAGGER": "dagger",
    "EVAL": "eval",
    "INFERENCE": "inference",
    "PATHS": "paths",
    "MESH": "mesh",
    "TEXT_LLM": "text_llm",
}

# keys of the JAX package's config that act on the TPU program only
# (ROADMAP §1, "Not carried over")
_TPU_ONLY = {"remat_policy", "rng_impl", "dropout_bits8", "attn_probs_bf16"}

_PRESETS = {
    "r2r": C.r2r_config,
    "rxr": C.rxr_config,
    "rxr_dsv2lite": C.rxr_dsv2lite_config,
    "tiny": C.tiny_config,
}


def _replace_section(section_obj, overrides: Dict[str, Any]):
    fields = {f.name for f in dataclasses.fields(section_obj)}
    unknown = set(overrides) - fields
    if unknown & _TPU_ONLY:
        raise KeyError(f"config keys {sorted(unknown & _TPU_ONLY)} of "
                       f"{type(section_obj).__name__} act on the JAX "
                       "package's TPU program only; the port has no such "
                       "switch")
    if unknown:
        raise KeyError(f"unknown config keys {sorted(unknown)} for "
                       f"{type(section_obj).__name__} (the port keeps "
                       "only the fields it reads; etpnav_tpu_torch/"
                       "config.py)")
    coerced = {}
    for k, v in overrides.items():
        cur = getattr(section_obj, k)
        if isinstance(cur, tuple) and isinstance(v, list):
            v = tuple(v)
        coerced[k] = v
    return dataclasses.replace(section_obj, **coerced)


def config_from_dict(d: Dict[str, Any]) -> C.ExperimentConfig:
    base = d.get("BASE", "r2r")
    if base not in _PRESETS:
        raise KeyError(f"unknown BASE preset {base!r}; "
                       f"options: {sorted(_PRESETS)}")
    cfg = _PRESETS[base]()
    top_overrides = {}
    top_fields = {f.name for f in dataclasses.fields(cfg)}
    for key, value in d.items():
        if key == "BASE":
            continue
        if key in _SECTION_FIELDS:
            field = _SECTION_FIELDS[key]
            cfg = dataclasses.replace(cfg, **{
                field: _replace_section(getattr(cfg, field), value)})
        elif (key.lower() in top_fields
              and key.lower() not in _SECTION_FIELDS.values()):
            top_overrides[key.lower()] = value
        else:
            raise KeyError(f"unknown config section {key!r}")
    if top_overrides:
        cfg = dataclasses.replace(cfg, **top_overrides)
    return cfg


def load_config(path: str, opts: Dict[str, Any] = None
                ) -> C.ExperimentConfig:
    """YAML file + CLI 'SECTION.key=value' (or top-level 'KEY=value')
    overrides -> ExperimentConfig."""
    import yaml
    with open(path) as f:
        d = yaml.safe_load(f) or {}
    for dotted, value in (opts or {}).items():
        section, _, key = dotted.partition(".")
        if not key:                  # a top-level key: SEED=3
            d[section] = value
            continue
        d.setdefault(section, {})
        if isinstance(d[section], dict):
            d[section][key] = value
        else:
            d[section] = value
    return config_from_dict(d)


def parse_cli_opts(pairs) -> Dict[str, Any]:
    """['IL.lr=1e-5', 'CLIP.use_fused_block=true'] -> {'IL.lr': 1e-5,
    ...} with YAML-typed values (run.py `opts`)."""
    import yaml
    out = {}
    for p in pairs or []:
        k, _, v = p.partition("=")
        out[k] = yaml.safe_load(v)
    return out
