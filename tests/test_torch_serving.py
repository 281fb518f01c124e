"""The port's `NavServer` session lifecycle (`etpnav_tpu_torch/serving.py`),
the counterpart of tests/test_serving.py, on the CPU at `tiny_config()`.

Covers concurrent episodes against the geometric world, request
coalescing, the one-step-in-flight rule, steps after a stop or a
shutdown, the service counters (failed dispatches counted apart),
malformed requests refused at entry, and the two timeouts: one before
the batcher claims the request leaves the session usable, one after the
claim poisons it for good.

The timeout tests avoid two races. A test that patches `_collect` waits
longer than the batcher's 0.05 s queue wait before it steps, so the
batcher is inside the patched function. The after-claim test holds
`_process` until the client has timed out, so the claim surely comes
first and the policy's own step result lands after the poison.
"""

import threading
import time

import numpy as np
import pytest
import torch

from etpnav_tpu_torch.config import tiny_config
from etpnav_tpu_torch.env.geometric import GeometricNavEnv
from etpnav_tpu_torch.serving import NavServer
from etpnav_tpu_torch.training.agent import Agent, init_agent_params

torch.set_num_threads(2)

JOIN_S = 300


@pytest.fixture(scope="module")
def agent():
    cfg = tiny_config()
    return cfg, Agent(cfg, init_agent_params(cfg, seed=0), device="cpu")


@pytest.fixture(scope="module")
def server_and_cfg(agent):
    cfg, ag = agent
    server = NavServer(cfg, ag, max_batch=4, max_wait_ms=100.0, max_steps=4)
    yield server, cfg
    server.shutdown()


@pytest.fixture
def fresh_server(agent):
    """A server of its own for a test that patches it."""
    cfg, ag = agent
    server = NavServer(cfg, ag, max_batch=2, max_wait_ms=5.0)
    yield server, cfg
    server.shutdown()


def _make_env(cfg, seed):
    return GeometricNavEnv(
        num_envs=1, seed=seed, vocab_size=cfg.planner.vocab_size,
        max_instr_len=cfg.il.max_text_len, image_size=cfg.clip.image_size,
        depth_size=cfg.depth.input_size, pad_id=cfg.planner.pad_token_id)


def _random_obs(cfg):
    rng = np.random.default_rng(0)
    tokens = rng.integers(1, cfg.planner.vocab_size, 8)
    rgb = rng.integers(0, 256, (12, cfg.clip.image_size,
                                cfg.clip.image_size, 3)).astype(np.uint8)
    dep = rng.random((12, cfg.depth.input_size, cfg.depth.input_size,
                      1)).astype(np.float32)
    return tokens, rgb, dep, np.zeros(3), np.array([0.0, 0.0, 0.0, 1.0])


def _run_episode(server, cfg, seed, out):
    env = _make_env(cfg, seed)
    obs = env.reset()[0]
    sid = server.create_session(obs["instruction"])
    steps = 0
    try:
        while True:
            pos, ori = env.get_pos_ori()
            res = server.step(sid, obs["rgb"], obs["depth"], pos[0], ori[0])
            steps += 1
            assert res["action"]["act"] in (0, 4)
            assert np.isfinite(res["stop_prob"])
            assert res["num_nodes"] >= 1
            r = env.step([res["action"]])[0]
            obs = r.observation
            if res["done"] or r.done:
                break
        info = server.close_session(sid)
        out[seed] = {"steps": steps, "closed": info["steps"],
                     "history": len(info["history"])}
    except Exception as e:          # surfaced by the main thread
        out[seed] = e


def test_concurrent_sessions_complete(server_and_cfg):
    server, cfg = server_and_cfg
    out = {}
    threads = [threading.Thread(target=_run_episode,
                                args=(server, cfg, s, out))
               for s in (1, 2, 3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=JOIN_S)
    assert not any(t.is_alive() for t in threads)
    assert len(out) == 3
    for r in out.values():
        assert not isinstance(r, Exception), r
        assert 1 <= r["steps"] <= 5
        assert r["closed"] == r["history"] == r["steps"]


def test_simultaneous_steps_coalesce(server_and_cfg):
    """Three steps submitted together run as one perceive dispatch (two
    if the batcher woke between arrivals)."""
    server, cfg = server_and_cfg
    calls = []
    orig = server.agent.perceive

    def counting(*a, **kw):
        calls.append(1)
        return orig(*a, **kw)

    server.agent.perceive = counting
    try:
        envs = [_make_env(cfg, 10 + i) for i in range(3)]
        obs = [e.reset()[0] for e in envs]
        sids = [server.create_session(o["instruction"]) for o in obs]
        barrier = threading.Barrier(3)
        results = {}

        def one(i):
            barrier.wait()
            pos, ori = envs[i].get_pos_ori()
            results[i] = server.step(sids[i], obs[i]["rgb"],
                                     obs[i]["depth"], pos[0], ori[0])

        ts = [threading.Thread(target=one, args=(i,)) for i in range(3)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=JOIN_S)
        assert len(results) == 3
        assert len(calls) <= 2
        for sid in sids:
            server.close_session(sid)
    finally:
        server.agent.perceive = orig


def test_concurrent_same_session_step_rejected(server_and_cfg):
    """At most one step in flight per session: a second concurrent call
    fails fast instead of applying the observation twice."""
    server, cfg = server_and_cfg
    env = _make_env(cfg, 42)
    obs = env.reset()[0]
    sid = server.create_session(obs["instruction"])
    pos, ori = env.get_pos_ori()
    errs = []
    gate = threading.Event()
    orig = server._process

    def held(batch):            # keeps the first step in flight
        gate.wait(JOIN_S)
        return orig(batch)

    server._process = held
    try:
        t = threading.Thread(target=server.step, args=(
            sid, obs["rgb"], obs["depth"], pos[0], ori[0]))
        t.start()
        deadline = time.monotonic() + JOIN_S
        while (not server._sessions[sid].in_flight
               and time.monotonic() < deadline):
            time.sleep(0.005)
        try:
            server.step(sid, obs["rgb"], obs["depth"], pos[0], ori[0])
        except RuntimeError as e:
            errs.append(str(e))
        gate.set()
        t.join(timeout=JOIN_S)
    finally:
        gate.set()
        server._process = orig
    assert errs and "in flight" in errs[0]
    server.close_session(sid)


def test_warmup_runs_all_programs(server_and_cfg):
    server, cfg = server_and_cfg
    buckets = {*(cfg.planner.gmap_len_buckets or ()),
               cfg.planner.max_gmap_len}
    assert server.warmup() == 2 + len(buckets)


def test_step_after_shutdown_rejected(agent):
    cfg, ag = agent
    server = NavServer(cfg, ag, max_batch=2, max_wait_ms=5.0)
    server.shutdown()
    _, rgb, dep, pos, ori = _random_obs(cfg)
    with pytest.raises(RuntimeError, match="shut down"):
        server.step(0, rgb, dep, pos, ori)


def test_step_after_stop_rejected(server_and_cfg):
    server, cfg = server_and_cfg
    env = _make_env(cfg, 99)
    obs = env.reset()[0]
    sid = server.create_session(obs["instruction"])
    done = False
    for _ in range(6):
        pos, ori = env.get_pos_ori()
        res = server.step(sid, obs["rgb"], obs["depth"], pos[0], ori[0])
        if res["done"]:
            done = True
            break
        obs = env.step([res["action"]])[0].observation
    assert done                      # max_steps=4 forces a stop
    with pytest.raises(RuntimeError, match="already stopped"):
        server.step(sid, obs["rgb"], obs["depth"], pos[0], ori[0])
    server.close_session(sid)


def test_server_stats(fresh_server):
    server, cfg = fresh_server
    s0 = server.stats()
    assert s0["steps_served"] == 0 and s0["batches"] == 0
    tokens, rgb, dep, pos, ori = _random_obs(cfg)
    sid = server.create_session(tokens)
    res = server.step(sid, rgb, dep, pos, ori)
    st = server.stats()
    assert st["steps_served"] == 1 and st["batches"] == 1
    assert st["failed_batches"] == 0
    assert 0 < st["mean_occupancy"] <= 1.0
    assert st["live_sessions"] == (0 if res["done"] else 1)
    assert st["queue_depth"] == 0
    # the CPU runs the depth trunk eagerly: no graph, no eager card call
    assert (st["depth_graph_replays"], st["depth_eager_calls"],
            st["depth_graph_captures"]) == (0, 0, 0)


def test_server_stats_count_failures_separately(fresh_server):
    """A failing dispatch shows in failed_batches, not in steps_served,
    and poisons its session."""
    server, cfg = fresh_server

    def fail(batch):
        raise RuntimeError("injected device failure")

    server._process = fail
    tokens, rgb, dep, pos, ori = _random_obs(cfg)
    sid = server.create_session(tokens)
    with pytest.raises(RuntimeError, match="injected"):
        server.step(sid, rgb, dep, pos, ori)
    st = server.stats()
    assert st["failed_batches"] == 1
    assert st["steps_served"] == 0 and st["batches"] == 0
    assert st["live_sessions"] == 0


def test_malformed_request_rejected_at_entry(server_and_cfg):
    """A wrong-shaped observation fails only its own request, at step()
    entry, and the session stays usable."""
    server, cfg = server_and_cfg
    env = _make_env(cfg, 77)
    obs = env.reset()[0]
    sid = server.create_session(obs["instruction"])
    pos, ori = env.get_pos_ori()
    failed0 = server.stats()["failed_batches"]
    with pytest.raises(ValueError, match="rgb shape"):
        server.step(sid, np.zeros((12, 8, 8, 3), np.uint8), obs["depth"],
                    pos[0], ori[0])
    with pytest.raises(ValueError, match="depth shape"):
        server.step(sid, obs["rgb"], obs["depth"][:, :2], pos[0], ori[0])
    with pytest.raises(ValueError, match="pos shape"):
        server.step(sid, obs["rgb"], obs["depth"], np.zeros(2), ori[0])
    assert server.stats()["failed_batches"] == failed0
    res = server.step(sid, obs["rgb"], obs["depth"], pos[0], ori[0])
    assert res["action"]["act"] in (0, 4)
    server.close_session(sid)


def test_timeout_before_claim_leaves_session_usable(fresh_server):
    """A request that times out before the batcher commits to it is
    skipped; the retry is applied exactly once."""
    server, cfg = fresh_server
    orig_collect = server._collect

    def slow_collect():
        time.sleep(1.0)              # the batcher claims nothing in time
        return orig_collect()

    tokens, rgb, dep, pos, ori = _random_obs(cfg)
    sid = server.create_session(tokens)
    server._collect = slow_collect
    # past the unpatched _collect's 0.05 s queue wait: the batcher is in
    # the patched one when the step arrives
    time.sleep(0.2)
    with pytest.raises(TimeoutError):
        server.step(sid, rgb, dep, pos, ori, timeout=0.1)
    server._collect = orig_collect
    res = server.step(sid, rgb, dep, pos, ori)
    assert res["action"]["act"] in (0, 4)
    assert server.stats()["steps_served"] == 1


def test_timeout_after_claim_poisons_session(agent, fresh_server):
    """A client timeout after the batcher claimed the request marks the
    session done for good: the step still runs server-side, so a retry
    would register the same observation twice. The seeded policy does not
    stop on this step, so the step's own result must not clear the
    mark."""
    cfg, ag = agent
    tokens, rgb, dep, pos, ori = _random_obs(cfg)
    probe = NavServer(cfg, ag, max_batch=2, max_wait_ms=5.0)
    try:
        assert not probe.step(probe.create_session(tokens), rgb, dep, pos,
                              ori)["done"]
    finally:
        probe.shutdown()

    server, _ = fresh_server
    orig_process = server._process
    timed_out = threading.Event()

    def held_process(batch):
        timed_out.wait(JOIN_S)       # claimed; runs once the client gave up
        return orig_process(batch)

    server._process = held_process
    sid = server.create_session(tokens)
    try:
        with pytest.raises(TimeoutError):
            server.step(sid, rgb, dep, pos, ori, timeout=2.0)
    finally:
        timed_out.set()
    deadline = time.monotonic() + JOIN_S
    while (server.stats()["steps_served"] == 0
           and time.monotonic() < deadline):
        time.sleep(0.02)
    assert server.stats()["steps_served"] == 1
    assert server.stats()["live_sessions"] == 0
    with pytest.raises(RuntimeError, match="already stopped"):
        server.step(sid, rgb, dep, pos, ori)
    assert server.stats()["steps_served"] == 1
