"""HTTP serving of the port (`etpnav_tpu_torch/serving_http.py`), the
counterpart of tests/test_serving_http.py, on the CPU at `tiny_config()`.

Covers full episodes driven over HTTP against the port's geometric world
(concurrent clients coalescing in the batcher, one of them the JAX
package's client), the npz step protocol, env-layer compatibility of
wire-decoded actions, the HTTP error mapping (400/404/409/500), the
runner's serve mode end to end and its `--trainer` refusal, and wire
parity: the port's `to_jsonable` / `action_from_wire` produce the JAX
package's bytes and structures, and the same episodes over HTTP take
exactly the actions of an in-process `NavServer` on the same weights.

Servers bind port 0 and every thread is joined with a timeout. No
assertion depends on which side of the batcher's 0.05 s queue wait a
request lands.
"""

import dataclasses
import json
import socket
import threading

import numpy as np
import pytest
import torch

from etpnav_tpu import serving_http as jhttp
from etpnav_tpu_torch import serving_http as sh
from etpnav_tpu_torch.config import tiny_config
from etpnav_tpu_torch.env.geometric import GeometricNavEnv
from etpnav_tpu_torch.serving import NavServer
from etpnav_tpu_torch.serving_http import (
    HttpNavClient,
    HttpNavError,
    action_from_wire,
    make_http_server,
    to_jsonable,
)
from etpnav_tpu_torch.training.agent import Agent, init_agent_params

torch.set_num_threads(2)

JOIN_S = 300


def _serve(nav):
    httpd = make_http_server(nav, host="127.0.0.1", port=0)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    return httpd, t, f"http://127.0.0.1:{httpd.server_address[1]}"


def _stop(httpd, t, nav):
    httpd.shutdown()
    t.join(timeout=JOIN_S)
    httpd.server_close()
    nav.shutdown()
    assert not t.is_alive()


@pytest.fixture(scope="module")
def agent():
    cfg = tiny_config()
    return cfg, Agent(cfg, init_agent_params(cfg, seed=0), device="cpu")


@pytest.fixture(scope="module")
def http_stack(agent):
    cfg, ag = agent
    nav = NavServer(cfg, ag, max_batch=4, max_wait_ms=100.0, max_steps=4)
    httpd, t, url = _serve(nav)
    yield url, cfg
    _stop(httpd, t, nav)


def _make_env(cfg, seed):
    return GeometricNavEnv(
        num_envs=1, seed=seed, vocab_size=cfg.planner.vocab_size,
        max_instr_len=cfg.il.max_text_len, image_size=cfg.clip.image_size,
        depth_size=cfg.depth.input_size, pad_id=cfg.planner.pad_token_id)


def _run_episode(client, cfg, seed, out):
    """One episode of the geometric world driven through `client` (an
    HTTP client of either package, or a NavServer in process); records
    the step results."""
    env = _make_env(cfg, seed)
    obs = env.reset()[0]
    results = []
    try:
        sid = client.create_session(obs["instruction"])
        while True:
            pos, ori = env.get_pos_ori()
            res = client.step(sid, obs["rgb"], obs["depth"], pos[0], ori[0])
            results.append(res)
            assert res["action"]["act"] in (0, 4)
            assert np.isfinite(res["stop_prob"])
            r = env.step([res["action"]])[0]   # wire-decoded action drives env
            obs = r.observation
            if res["done"] or r.done:
                break
        info = client.close_session(sid)
        out[seed] = {"results": results, "closed": info["steps"]}
    except Exception as e:              # surfaced by the main thread
        out[seed] = e


def _run_concurrent(clients, cfg, seeds):
    out = {}
    threads = [threading.Thread(target=_run_episode, args=(c, cfg, s, out))
               for c, s in zip(clients, seeds)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=JOIN_S)
    assert not any(t.is_alive() for t in threads)
    for r in out.values():
        assert not isinstance(r, Exception), r
    return out


def test_http_episodes_concurrent(http_stack):
    """Three concurrent episodes, one driven by the JAX package's client
    (the wire format is shared)."""
    url, cfg = http_stack
    client = HttpNavClient(url)
    assert client.healthz() == {"ok": True}
    clients = [HttpNavClient(url), HttpNavClient(url),
               jhttp.HttpNavClient(url)]
    out = _run_concurrent(clients, cfg, (1, 2, 3))
    assert sorted(out) == [1, 2, 3]
    for r in out.values():
        assert 1 <= len(r["results"]) <= 5
        assert r["closed"] == len(r["results"])
    stats = client.stats()
    assert stats["steps_served"] >= sum(len(r["results"])
                                        for r in out.values())
    assert stats["batches"] >= 1
    assert 0 <= stats["deadline_batches"] <= stats["batches"]
    assert (stats["depth_graph_replays"], stats["depth_eager_calls"],
            stats["depth_graph_captures"]) == (0, 0, 0)


def test_http_error_mapping(http_stack):
    url, cfg = http_stack
    client = HttpNavClient(url)

    with pytest.raises(HttpNavError) as e:      # malformed create
        client._req("POST", "/sessions", b"not json")
    assert e.value.code == 400

    with pytest.raises(HttpNavError) as e:      # unknown session
        client.close_session(999_999)
    assert e.value.code == 404

    env = _make_env(cfg, 7)
    obs = env.reset()[0]
    sid = client.create_session(obs["instruction"])

    with pytest.raises(HttpNavError) as e:      # wrong rgb shape
        client.step(sid, obs["rgb"][:, :4], obs["depth"],
                    np.zeros(3), np.array([0.0, 0, 0, 1]))
    assert e.value.code == 400

    with pytest.raises(HttpNavError) as e:      # not an npz body
        client._req("POST", f"/sessions/{sid}/step", b"garbage",
                    content_type="application/x-npz")
    assert e.value.code == 400

    with pytest.raises(HttpNavError) as e:      # no such route
        client._req("GET", "/nope")
    assert e.value.code == 404

    # drive to completion, then a step on the stopped session -> 409
    steps = 0
    while True:
        pos, ori = env.get_pos_ori()
        res = client.step(sid, obs["rgb"], obs["depth"], pos[0], ori[0])
        steps += 1
        obs = env.step([res["action"]])[0].observation
        if res["done"]:
            break
        assert steps < 10
    with pytest.raises(HttpNavError) as e:
        pos, ori = env.get_pos_ori()
        client.step(sid, obs["rgb"], obs["depth"], pos[0], ori[0])
    assert e.value.code == 409
    client.close_session(sid)


def test_http_internal_error_is_500_and_bad_length_is_400(http_stack,
                                                          monkeypatch):
    """Unknown RuntimeErrors are server faults (500), not session
    conflicts (409); a malformed Content-Length gets a clean 400 instead
    of a dropped connection."""
    url, cfg = http_stack
    client = HttpNavClient(url)
    env = _make_env(cfg, 31)
    obs = env.reset()[0]
    sid = client.create_session(obs["instruction"])

    def fail(*a, **k):
        raise RuntimeError("CUDA error: device lost")
    monkeypatch.setattr(sh.NavServer, "step", fail)
    with pytest.raises(HttpNavError) as e:
        pos, ori = env.get_pos_ori()
        client.step(sid, obs["rgb"], obs["depth"], pos[0], ori[0])
    assert e.value.code == 500
    assert "device lost" in e.value.detail
    monkeypatch.undo()
    client.close_session(sid)

    host, port = url.replace("http://", "").split(":")
    with socket.create_connection((host, int(port)), timeout=30) as s:
        s.sendall(b"POST /sessions HTTP/1.1\r\n"
                  b"Host: x\r\nContent-Length: abc\r\n\r\n")
        reply = s.recv(4096).decode()
    assert reply.startswith("HTTP/1.1 400"), reply
    assert "Content-Length" in reply


def test_to_jsonable_roundtrip_and_wire_parity():
    action = {"act": 4, "front_pos": np.array([1.0, 0.0, 2.0]),
              "ghost_pos": np.array([3.0, 0.0, 4.0]),
              "stop_pos": None,
              "back_path": [(2, np.array([0.5, 0.0, 0.25])),
                            (np.int64(3), np.array([0.1, 0.0, 1 / 3]))],
              "tryout": True, "prob": np.float32(0.25)}
    ours = json.dumps(to_jsonable(action))
    assert ours == json.dumps(jhttp.to_jsonable(action))
    wire = json.loads(ours)
    back, jback = action_from_wire(wire), jhttp.action_from_wire(wire)
    assert back["act"] == 4 and back["tryout"] is True
    assert back["stop_pos"] is None
    for key in ("front_pos", "ghost_pos"):
        np.testing.assert_array_equal(back[key], action[key])
        assert back[key].dtype == jback[key].dtype == np.float64
    assert [v for v, _ in back["back_path"]] == [2, 3]
    for (v, p), (jv, jp), (_, want) in zip(back["back_path"],
                                           jback["back_path"],
                                           action["back_path"]):
        assert isinstance(v, int) and v == jv
        np.testing.assert_array_equal(p, want)
        np.testing.assert_array_equal(p, jp)
    assert isinstance(back["back_path"][0], tuple)


def _same_actions(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if k == "back_path":
            assert (a[k] is None) == (b[k] is None)
            for (v, p), (w, q) in zip(a[k] or [], b[k] or []):
                assert v == w
                np.testing.assert_array_equal(p, q)
        elif isinstance(a[k], np.ndarray) or isinstance(b[k], np.ndarray):
            np.testing.assert_array_equal(a[k], b[k])
        else:
            assert a[k] == b[k], k


def test_http_actions_equal_in_process_server(agent):
    """The same episodes over HTTP and through an in-process NavServer on
    the same weights take the same actions, step for step. The episodes
    run one at a time, so every batch holds one session either way."""
    cfg, ag = agent
    seeds = (4, 5)
    nav = NavServer(cfg, ag, max_batch=2, max_steps=4)
    httpd, t, url = _serve(nav)
    try:
        over_http = {}
        for s in seeds:
            _run_episode(HttpNavClient(url), cfg, s, over_http)
    finally:
        _stop(httpd, t, nav)
    nav = NavServer(cfg, ag, max_batch=2, max_steps=4)
    try:
        in_process = {}
        for s in seeds:
            _run_episode(nav, cfg, s, in_process)
    finally:
        nav.shutdown()
    for s in seeds:
        assert not isinstance(over_http[s], Exception), over_http[s]
        assert not isinstance(in_process[s], Exception), in_process[s]
        a, b = over_http[s]["results"], in_process[s]["results"]
        assert len(a) == len(b) >= 1
        for x, y in zip(a, b):
            _same_actions(x["action"], y["action"])
            assert x["done"] == y["done"]
            assert x["stop_prob"] == y["stop_prob"]
            assert (x["num_nodes"], x["num_ghosts"]) == (y["num_nodes"],
                                                         y["num_ghosts"])


def test_cli_serve_end_to_end(tmp_path):
    """--run-type serve builds the SS-ETP policy without envs, binds the
    gateway, and serves a full episode over the wire."""
    from etpnav_tpu_torch.run import run
    p = tmp_path / "exp.yaml"
    p.write_text("BASE: tiny\n")
    httpd, nav = run(["--exp-config", str(p), "--run-type", "serve",
                      "--device", "cpu", "--host", "127.0.0.1", "--port",
                      "0", "--serve-max-batch", "2", "--serve-nonblocking"])
    try:
        assert nav.cfg.planner.nav_use_bf16 is False    # serving_config
        url = f"http://127.0.0.1:{httpd.server_address[1]}"
        out = {}
        _run_episode(HttpNavClient(url), nav.cfg, 11, out)
        assert not isinstance(out[11], Exception), out[11]
        assert len(out[11]["results"]) >= 1
    finally:
        httpd.shutdown()
        httpd.server_close()
        nav.shutdown()


def test_cli_serve_rejects_other_trainers(tmp_path):
    from etpnav_tpu_torch.run import run
    p = tmp_path / "exp.yaml"
    p.write_text("BASE: tiny\n")
    for trainer in ("Pretrain", "DAgger"):
        with pytest.raises(ValueError, match="SS-ETP"):
            run(["--exp-config", str(p), "--run-type", "serve",
                 "--device", "cpu", "--trainer", trainer])


def test_cli_serve_dsv2_encoder_counters(tmp_path):
    """TEXT_LLM.enabled serves the DeepSeek-V2 instruction encoder through
    `run.py --run-type serve`, and `/stats` carries its text counters:
    every routing of a session's encode goes to a held expert
    (`moe_rows`) or elsewhere (`moe_rows_elsewhere`)."""
    from etpnav_tpu_torch.config import tiny_dsv2_config
    from etpnav_tpu_torch.run import run
    c = tiny_dsv2_config().text_llm
    p = tmp_path / "exp.yaml"
    import yaml
    p.write_text(yaml.safe_dump({"BASE": "tiny", "TEXT_LLM": {
        k: list(v) if isinstance(v, tuple) else v
        for k, v in dataclasses.asdict(c).items()}}))
    httpd, nav = run(["--exp-config", str(p), "--run-type", "serve",
                      "--device", "cpu", "--host", "127.0.0.1", "--port",
                      "0", "--serve-max-batch", "2", "--serve-nonblocking"])
    try:
        assert nav.cfg.text_llm == c
        client = HttpNavClient(f"http://127.0.0.1:{httpd.server_address[1]}")
        before = client.stats()
        out = {}
        _run_episode(client, nav.cfg, 12, out)
        assert not isinstance(out[12], Exception), out[12]
        stats = client.stats()
        L, k = nav.cfg.il.max_text_len, c.num_experts_per_tok
        n_moe = c.num_layers - c.first_k_dense_replace
        assert stats["text_encodes"] - before["text_encodes"] == 1
        assert 0 < stats["text_tokens"] - before["text_tokens"] <= L
        assert (stats["moe_rows"] + stats["moe_rows_elsewhere"]
                - before["moe_rows"] - before["moe_rows_elsewhere"]
                == n_moe * L * k)
        assert 0 < stats["moe_groups"] - before["moe_groups"] \
            <= n_moe * len(c.held)
    finally:
        httpd.shutdown()
        httpd.server_close()
        nav.shutdown()
