"""The benchmark's handles on the program under test: its config object,
its parameter table and the seeded weights loaded into it. Everything
else a driver takes from the program goes through its public entry
points (`NavServer`, `FinetuneTrainer`)."""

from __future__ import annotations

import torch

from navbench import model_config, weights


def load_config(spec: dict):
    cfg = model_config.build(spec)
    model_config.check(spec, cfg)
    return cfg


def agent_params(cfg, seed: int, device):
    """The program's AgentParams holding the benchmark's seeded weights
    (made on `device`), and the parameter table they were made from."""
    from etpnav_tpu_torch.training.agent import AgentParams
    with torch.device("meta"):
        params = AgentParams(cfg)
    table = [(n, tuple(t.shape)) for n, t in params.state_dict().items()]
    params.load_state_dict(weights.make_weights(table, seed, device),
                           strict=True, assign=True)
    return params, table
