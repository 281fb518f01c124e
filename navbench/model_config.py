"""A configuration file of `navbench/configs/` and the program's config
object it names.

The file holds the config function of the program (`function`), the
overrides passed to it, and under `model` every size and switch of the
model as plain numbers: the reference reads those, and `check` holds the
program's config object to them, so both sides run one configuration.
Each key of `model` is a field of the program's config object: a
section (a dataclass, stated whole) or a value such as `task_type`.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterable

# ETPNav's sections, which the configurations of navbench/configs/ state
ETPNAV = ("task_type", "planner", "clip", "depth", "waypoint", "graph", "il")


def _plain(v: Any) -> Any:
    if isinstance(v, tuple):
        return [_plain(x) for x in v]
    return v


def model_block(cfg, keys: Iterable[str] = ETPNAV) -> Dict[str, Any]:
    """The fields `keys` of a program config as JSON values: a section
    as a dict of its fields, tuples as lists. Raises ValueError on a key
    that is no field of the config."""
    fields = {f.name for f in dataclasses.fields(cfg)}
    out = {}
    for key in keys:
        if key not in fields:
            raise ValueError(f"the program config has no field {key!r}")
        v = getattr(cfg, key)
        out[key] = ({k: _plain(x) for k, x in dataclasses.asdict(v).items()}
                    if dataclasses.is_dataclass(v) else _plain(v))
    return out


def build(spec: dict):
    """The program's config object named by a configuration file."""
    from etpnav_tpu_torch import config as pconfig
    fn = getattr(pconfig, spec["function"])
    return fn(**spec.get("overrides", {}))


def check(spec: dict, cfg) -> None:
    """Raise unless the program's config agrees with the file's `model`
    block on every value the file states, in every section it names."""
    want = spec["model"]
    have = model_block(cfg, want)
    bad = []
    for sec, fields in want.items():
        got = have[sec]
        if isinstance(fields, dict) and isinstance(got, dict):
            bad += [(f"{sec}.{k}", v, got.get(k, "<missing>"))
                    for k, v in fields.items()
                    if got.get(k, "<missing>") != v]
        elif got != fields:
            bad.append((sec, fields, got))
    if bad:
        raise ValueError(f"program config differs from the file: {bad}")
