"""The weight seed of a cell: random weights rank the [stop] slot first at
every step for about half the seeds, which would end every episode at
its first step and make the work of a run depend on the seed. So a cell
takes the first of sub_seed(seed, 1, j), j = 0, 1, ..., whose agent
steps `probe_sessions` probe sessions of the traffic's longest episode
through `NavServer` without stopping; both sides then use that seed."""

from __future__ import annotations

import numpy as np
import torch

from navbench import common, weights
from navbench.instructions import Instructions


def settle_weights(ctx, server, table, rgb, dep, device,
                   longest: int) -> int:
    """Load candidate weights into the server's agent until one takes
    `longest` steps (capped at the server's force stop) without
    stopping; returns its seed."""
    from navbench.drivers.serve_closed import drive
    tries = ctx.traffic["params"]["weight_tries"]
    rng = np.random.default_rng(common.sub_seed(ctx.seed, 4))
    instr = Instructions(ctx.config["assumed"],
                         server.cfg.planner.vocab_size, rng)
    longest = min(longest, server.max_steps)
    params = server.agent.params.state_dict()
    for j in range(tries):
        wseed = common.sub_seed(ctx.seed, 1, j)
        if j:
            new = weights.make_weights(table, wseed, device)
            with torch.no_grad():
                for name, t in params.items():
                    t.copy_(new[name])
            del new
        ok = True
        for _ in range(ctx.traffic["params"]["probe_sessions"]):
            sid = server.create_session(instr.next())
            took = drive(server, sid, rgb, dep, rng, longest, [])
            server.close_session(sid)
            ok = ok and took == longest
        if ok:
            return wseed
    raise RuntimeError(f"no weight seed in {tries} tries takes the "
                       f"longest episode ({longest} steps)")
