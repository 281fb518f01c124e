"""A configuration file of `navbench/configs/` and the program's config
object it names.

The file holds the config function of the program (`function`), the
overrides passed to it, and under `model` every size and switch of the
model as plain numbers: the reference reads those, and `check` holds the
program's config object to them, so both sides run one configuration.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

SECTIONS = ("planner", "clip", "depth", "waypoint", "graph", "il")


def _plain(v: Any) -> Any:
    if isinstance(v, tuple):
        return [_plain(x) for x in v]
    return v


def model_block(cfg) -> Dict[str, dict]:
    """Every field of the model's sections of a program config, as JSON
    values (tuples become lists)."""
    out = {"task_type": cfg.task_type}
    for sec in SECTIONS:
        out[sec] = {k: _plain(v) for k, v in
                    dataclasses.asdict(getattr(cfg, sec)).items()}
    return out


def build(spec: dict):
    """The program's config object named by a configuration file."""
    from etpnav_tpu_torch import config as pconfig
    fn = getattr(pconfig, spec["function"])
    return fn(**spec.get("overrides", {}))


def check(spec: dict, cfg) -> None:
    """Raise unless the program's config agrees with the file's `model`
    block on every value the file states."""
    have = model_block(cfg)
    want = spec["model"]
    bad = []
    for sec, fields in want.items():
        if not isinstance(fields, dict):
            if have.get(sec) != fields:
                bad.append((sec, fields, have.get(sec)))
            continue
        for k, v in fields.items():
            got = have.get(sec, {}).get(k, "<missing>")
            if got != v:
                bad.append((f"{sec}.{k}", v, got))
    if bad:
        raise ValueError(f"program config differs from the file: {bad}")
