"""The port's tracer (`etpnav_tpu_torch/utils/logging.py`) and the spans
the program places, on the CPU at `tiny_config()`.

Off, the tracer records nothing and hands out one shared no-op context.
On, a served session and a training iteration give the same actions,
losses and parameters as with it off, and their spans nest and line up
as the metrics that read them assume: one `serve.queue_wait` per served
request, claimed by a later `serve.batch` on the batcher's thread; five
consecutive children per `serve.batch`; each `rollout.*` span once per
rollout step inside `train.rollout`; the learn spans inside
`train.learn`. On the CPU no span has a device time.
"""

import sys
import threading

import numpy as np
import pytest
import torch

from etpnav_tpu_torch.config import tiny_config
from etpnav_tpu_torch.env.geometric import GeometricNavEnv
from etpnav_tpu_torch.serving import NavServer
from etpnav_tpu_torch.training.agent import Agent, init_agent_params
from etpnav_tpu_torch.training.finetune import FinetuneTrainer
from etpnav_tpu_torch.utils import logging as tracing

torch.set_num_threads(2)

JOIN_S = 300
SERVE = ("serve.stage", "serve.perceive", "serve.map", "serve.score",
         "serve.translate")
ROLLOUT = ("rollout.perceive", "rollout.map", "rollout.score",
           "rollout.teacher", "rollout.record", "rollout.env")
LEARN = ("learn.forward", "learn.backward", "learn.optimizer")


@pytest.fixture(autouse=True)
def _tracer_off():
    tracing.enable()            # an empty ring
    tracing.disable()
    yield
    tracing.disable()


@pytest.fixture(scope="module")
def agent():
    cfg = tiny_config()
    return cfg, Agent(cfg, init_agent_params(cfg, seed=0), device="cpu")


def _obs(cfg, seed):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(1, cfg.planner.vocab_size, 8)
    rgb = rng.integers(0, 256, (12, cfg.clip.image_size,
                                cfg.clip.image_size, 3)).astype(np.uint8)
    dep = rng.random((12, cfg.depth.input_size, cfg.depth.input_size,
                      1)).astype(np.float32)
    return tokens, rgb, dep


def _session(server, cfg, seed, steps=3):
    """One session of `steps` steps on observations from `seed`: the
    served results."""
    tokens, rgb, dep = _obs(cfg, seed)
    sid = server.create_session(tokens)
    out = []
    pos = np.zeros(3)
    for _ in range(steps):
        res = server.step(sid, rgb, dep, pos, np.array([0., 0., 0., 1.]))
        out.append(res)
        if res["done"]:
            break
        if res["action"]["act"] == 4:
            pos = np.asarray(res["action"]["ghost_pos"], np.float64)
    server.close_session(sid)
    return out


def _by_id(spans):
    return {s["id"]: s for s in spans}


def _named(spans, name):
    return [s for s in spans if s["name"] == name]


def test_off_records_nothing(agent):
    t = tracing.Tracer()
    assert t.span("x") is tracing.NO_SPAN
    assert t.sequence() is tracing.NO_SPAN
    with t.span("x") as sp, t.sequence() as seq:
        seq.next("y")
        assert sp is tracing.NO_SPAN
    t.record("z", 0.0, 1.0)
    assert t.current_key() is None
    assert t.export() == {"spans": [], "dropped": 0}
    # the program's spans, with the process's tracer off
    assert tracing.span("serve.batch") is tracing.NO_SPAN
    cfg, ag = agent
    server = NavServer(cfg, ag, max_batch=2, max_wait_ms=5.0, max_steps=3)
    try:
        _session(server, cfg, 0, steps=2)
    finally:
        server.shutdown()
    assert tracing.export() == {"spans": [], "dropped": 0}


def test_ring_drops_oldest_and_counts():
    t = tracing.Tracer(capacity=3)
    t.enable()
    for i in range(5):
        with t.span(f"s{i}"):
            pass
    out = t.export()
    assert [s["name"] for s in out["spans"]] == ["s2", "s3", "s4"]
    assert out["dropped"] == 2
    t.enable()                           # a new recording
    assert t.export() == {"spans": [], "dropped": 0}
    t2 = tracing.Tracer(capacity=2)
    t2.enable()
    for i in range(3):
        with t2.span(f"s{i}"):
            pass
    assert [s["name"] for s in t2.export()["spans"]] == ["s1", "s2"]


def test_nesting_keys_and_sequences():
    t = tracing.Tracer()
    t.enable()
    with t.span("outer", key=7, device="cpu") as outer:
        assert t.current_key() == 7
        with t.sequence() as seq:
            seq.next("a", key=(7, 0))
            with t.span("inner"):
                pass
            seq.next("b")
        with pytest.raises(RuntimeError):
            with t.sequence() as seq:
                seq.next("c")
                raise RuntimeError
        with t.span("after"):
            pass
    t.record("given", 1.0, 2.0, key="k", thread=5, extra=3)
    sp = {s["name"]: s for s in t.export()["spans"]}
    assert sp["outer"]["parent"] is None and sp["outer"]["key"] == 7
    for name in ("a", "b", "c", "after"):
        assert sp[name]["parent"] == outer.id, name
    assert sp["inner"]["parent"] == sp["a"]["id"]
    assert sp["inner"]["key"] == sp["a"]["key"] == sp["b"]["key"] == (7, 0)
    assert sp["c"]["key"] == 7              # the parent's
    assert sp["a"]["t1"] <= sp["b"]["t0"]
    assert sp["outer"]["device_ms"] is None     # no CUDA device
    assert sp["given"] == {"id": sp["given"]["id"], "name": "given",
                           "t0": 1.0, "t1": 2.0, "parent": None,
                           "thread": 5, "key": "k", "device_ms": None,
                           "extra": 3}
    assert t.current_key() is None and not t._stack()


def test_threads_keep_their_own_nesting():
    """Many threads record at once (a short switch interval): no span is
    lost, ids stay unique, and each child names its own thread's
    parent."""
    t = tracing.Tracer()
    t.enable()
    n, per = 16, 200

    def work(i):
        for j in range(per):
            with t.span("outer", key=(i, j)):
                with t.sequence() as seq:
                    seq.next("a")
                    seq.next("b")

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(i,))
                   for i in range(n)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(JOIN_S)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(old)
    out = t.export()
    spans = out["spans"]
    assert out["dropped"] == 0 and len(spans) == 3 * n * per
    byid = _by_id(spans)
    assert len(byid) == len(spans)
    for s in spans:
        if s["name"] == "outer":
            assert s["parent"] is None
        else:
            p = byid[s["parent"]]
            assert p["name"] == "outer" and p["thread"] == s["thread"]
            assert s["key"] == p["key"]


def test_serving_same_with_tracing_and_spans_line_up(agent):
    cfg, ag = agent
    runs = []
    for on in (False, True):
        server = NavServer(cfg, ag, max_batch=2, max_wait_ms=5.0,
                           max_steps=4)
        if on:
            tracing.enable()
        try:
            runs.append(_session(server, cfg, 3, steps=4))
        finally:
            tracing.disable()
            server.shutdown()
    off, on = runs
    assert len(off) == len(on)
    for a, b in zip(off, on):
        assert a["done"] == b["done"] and a["stop_prob"] == b["stop_prob"]
        assert a["action"].keys() == b["action"].keys()
        for k in a["action"]:
            np.testing.assert_array_equal(a["action"][k], b["action"][k])
    spans = tracing.export()["spans"]
    assert len(_named(spans, "serve.encode_text")) == 1
    assert len(_named(spans, "serve.queue_wait")) == len(on)


def test_served_spans_line_up_under_concurrency(agent):
    cfg, ag = agent
    server = NavServer(cfg, ag, max_batch=2, max_wait_ms=20.0, max_steps=3)
    served = []
    tracing.enable()
    try:
        threads = [threading.Thread(
            target=lambda s=s: served.append(
                (threading.get_ident(), _session(server, cfg, s))))
            for s in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(JOIN_S)
        assert not any(t.is_alive() for t in threads)
        batcher = server._thread.ident
    finally:
        tracing.disable()
        server.shutdown()
    spans = tracing.export()["spans"]
    byid = _by_id(spans)
    batches = {s["key"]: s for s in _named(spans, "serve.batch")}
    assert len(batches) == server.stats()["batches"]
    clients = {ident for ident, _ in served}
    waits = _named(spans, "serve.queue_wait")
    assert len(waits) == sum(len(r) for _, r in served)
    # one wait per (sid, step), on the client's thread, claimed by a
    # batch that starts after it ends, on the batcher's thread
    assert len({tuple(w["key"]) for w in waits}) == len(waits)
    for w in waits:
        b = batches[w["batch"]]
        assert w["thread"] in clients and w["t0"] <= w["t1"] <= b["t0"]
        assert b["thread"] == batcher
    per_sid = {}
    for w in waits:
        per_sid.setdefault(w["key"][0], []).append(w["key"][1])
    assert all(sorted(k) == list(range(len(k))) for k in per_sid.values())
    assert len(_named(spans, "serve.encode_text")) == 3
    # one collect per batch, before it; five consecutive children each
    collects = {s["key"]: s for s in _named(spans, "serve.collect")}
    assert collects.keys() == batches.keys()
    for bid, b in batches.items():
        c = collects[bid]
        assert c["thread"] == batcher and c["t1"] <= b["t0"]
        kids = sorted((s for s in spans if s["parent"] == b["id"]),
                      key=lambda s: s["t0"])
        assert tuple(s["name"] for s in kids) == SERVE
        assert all(s["key"] == bid and s["thread"] == batcher
                   for s in kids)
        assert b["t0"] <= kids[0]["t0"] and kids[-1]["t1"] <= b["t1"]
        for x, y in zip(kids, kids[1:]):
            assert x["t1"] <= y["t0"]
    # each program's upload, inside perceive and scoring; no device time
    ups = _named(spans, "agent.upload")
    assert {byid[u["parent"]]["name"] for u in ups} == {
        "serve.perceive", "serve.score", "serve.encode_text"}
    assert all(s["device_ms"] is None for s in spans)
    # one depth trunk per perceive, eager on the CPU
    depth = _named(spans, "agent.depth")
    assert sorted(byid[d["parent"]]["key"] for d in depth) == sorted(batches)
    assert all(byid[d["parent"]]["name"] == "serve.perceive"
               and d["graph"] is False for d in depth)


def test_deadline_batches_counts_only_batches_the_wait_closed(agent):
    cfg, ag = agent
    server = NavServer(cfg, ag, max_batch=2, max_wait_ms=1000.0,
                       max_steps=3)
    try:
        tokens, rgb, dep = _obs(cfg, 0)
        sids = [server.create_session(tokens) for _ in range(3)]
        ori = np.array([0., 0., 0., 1.])
        server.step(sids[0], rgb, dep, np.zeros(3), ori)   # alone
        st = server.stats()
        assert (st["batches"], st["deadline_batches"]) == (1, 1)
        go = threading.Barrier(2)

        def step(sid):
            go.wait(JOIN_S)
            server.step(sid, rgb, dep, np.zeros(3), ori)

        threads = [threading.Thread(target=step, args=(s,))
                   for s in sids[1:]]
        for t in threads:
            t.start()
        for t in threads:
            t.join(JOIN_S)
        assert not any(t.is_alive() for t in threads)
        st = server.stats()
        assert (st["batches"], st["deadline_batches"]) == (2, 1)
    finally:
        server.shutdown()


def _trainer(cfg):
    env = GeometricNavEnv(2, seed=0, vocab_size=512, max_instr_len=16,
                          image_size=32, depth_size=64)
    return FinetuneTrainer(cfg, env, seed=0, device="cpu")


def test_training_same_with_tracing_and_spans_nest():
    cfg = tiny_config()
    off = _trainer(cfg)
    loss_off = off.train(1)["IL_loss"]
    on = _trainer(cfg)
    tracing.enable()
    try:
        loss_on = on.train(1)["IL_loss"]
    finally:
        tracing.disable()
    assert loss_on == loss_off
    for (k, a), (_, b) in zip(off.params.named_parameters(),
                              on.params.named_parameters()):
        assert torch.equal(a, b), k
    assert on.logs["rollout_s"] and on.logs["learn_s"]
    # the iteration's perceive and depth trunk graph counts, all 0 on
    # the CPU
    for k in ("perceive_graph_replays", "perceive_eager_calls",
              "perceive_graph_captures", "depth_graph_replays",
              "depth_eager_calls", "depth_graph_captures"):
        assert on.logs[k] == off.logs[k] == [0], k

    spans = tracing.export()["spans"]
    byid = _by_id(spans)
    (roll,), (learn,) = (_named(spans, "train.rollout"),
                         _named(spans, "train.learn"))
    assert roll["key"] == learn["key"] == 0
    assert roll["t1"] <= learn["t0"]

    def inside(s, outer):
        while s["parent"] is not None:
            s = byid[s["parent"]]
            if s is outer:
                return True
        return False

    steps = {}
    for s in spans:
        if s["name"].startswith("rollout."):
            assert inside(s, roll) and s["key"][0] == 0, s
            assert roll["t0"] <= s["t0"] <= s["t1"] <= roll["t1"]
            steps.setdefault(s["key"][1], []).append(s)
    assert sorted(steps) == list(range(-1, len(steps) - 1))
    assert sorted(s["name"] for s in steps.pop(-1)) == [
        "rollout.env", "rollout.record", "rollout.text"]
    for k, ss in steps.items():
        assert sorted(s["name"] for s in ss) == sorted(ROLLOUT), k
    # one depth trunk inside each step's rollout.perceive
    depth = _named(spans, "agent.depth")
    assert sorted(byid[d["parent"]]["key"][1] for d in depth) == sorted(steps)
    assert all(byid[d["parent"]]["name"] == "rollout.perceive"
               and d["graph"] is False for d in depth)
    rollout = sorted((s for s in spans if s["name"].startswith("rollout.")),
                     key=lambda s: s["t0"])
    for x, y in zip(rollout, rollout[1:]):
        assert x["t1"] <= y["t0"]
    (batch,) = _named(spans, "learn.batch")
    assert batch["parent"] == learn["id"]
    kids = sorted((s for s in spans if s["name"] in LEARN),
                  key=lambda s: s["t0"])
    assert tuple(s["name"] for s in kids) == LEARN
    assert all(s["parent"] == learn["id"] and s["key"] == 0
               and s["device_ms"] is None for s in kids)
    assert batch["t1"] <= kids[0]["t0"] and kids[-1]["t1"] <= learn["t1"]
