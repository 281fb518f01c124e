"""The whole perceive as one CUDA graph per input signature
(`Agent.perceive`, `ops/cuda_graph.py`) where the CPU can hold it, at
`tiny_config()`.

A CPU agent's perceive stays eager: bit-equal to the module's eager
`perceive`, with and without the waypoint augmentation. `CapturedGraphs`
of several tensors runs its function eagerly off the GPU and hands back
its tuple or dict. The agent's gate declines the graph with a generator,
with the tracer on and while torch.profiler records, which the tests
see with `CapturedGraphs.engages` patched to True and the graph's call
spied on, so that nothing is captured. The perceive counters read 0 on
the CPU in the agent, in `NavServer.stats()` and over HTTP at `/stats`
(in the trainer's logs: tests/test_torch_tracing.py). The constants
the agent makes once equal the values perceive uploaded at every call
before. The graphs themselves need a card: chip_smoke.py phase 4d holds
them there.
"""

import threading
import types

import numpy as np
import pytest
import torch

from etpnav_tpu_torch.config import tiny_config
from etpnav_tpu_torch.models import clip_vit, waypoint
from etpnav_tpu_torch.ops.basic import mask_to_bias
from etpnav_tpu_torch.ops.cuda_graph import CapturedGraphs
from etpnav_tpu_torch.serving import NavServer
from etpnav_tpu_torch.serving_http import HttpNavClient, make_http_server
from etpnav_tpu_torch.training import agent as agent_mod
from etpnav_tpu_torch.training.agent import Agent, init_agent_params
from etpnav_tpu_torch.utils import logging as tracing

torch.set_num_threads(2)

JOIN_S = 120
ZERO = {"perceive_graph_replays": 0, "perceive_eager_calls": 0,
        "perceive_graph_captures": 0}


@pytest.fixture(scope="module")
def agent():
    cfg = tiny_config()
    return cfg, Agent(cfg, init_agent_params(cfg, seed=0), device="cpu")


def _obs(cfg, B=2, seed=0):
    rng = np.random.default_rng(seed)
    rgb = rng.integers(0, 256, (B, 12, cfg.clip.image_size,
                                cfg.clip.image_size, 3)).astype(np.uint8)
    dep = rng.random((B, 12, cfg.depth.input_size, cfg.depth.input_size,
                      1)).astype(np.float32)
    return rgb, dep


def _equal(got: dict, want: dict) -> None:
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("augment", [False, True])
def test_cpu_perceive_is_the_module_perceive(agent, augment):
    cfg, ag = agent
    rgb, dep = _obs(cfg, seed=1)
    gen = torch.Generator().manual_seed(5) if augment else None
    got = ag.perceive(rgb, dep, gen)
    ref_gen = torch.Generator().manual_seed(5) if augment else None
    with torch.inference_mode():
        want = agent_mod.perceive(ag.params, cfg, torch.from_numpy(rgb),
                                  torch.from_numpy(dep), ref_gen,
                                  train_sampling=augment)
    _equal(got, want)
    assert ag.perceive_graph_stats() == ZERO


@pytest.mark.parametrize("as_dict", [False, True])
def test_captured_graphs_of_two_tensors_run_cpu_eagerly(as_dict):
    calls = []

    def fn(a, b):
        calls.append((a, b))
        out = (a + b, a * b)
        return dict(zip("sp", out)) if as_dict else out

    g = CapturedGraphs(fn)
    a = torch.arange(6.0).reshape(2, 3)
    b = torch.full((2, 3), 2.0)
    assert not g.engages(a, b)
    for _ in range(2):
        out = g(a, b)
        if as_dict:
            assert list(out) == ["s", "p"]
            out = tuple(out.values())
        assert isinstance(out, tuple) and len(out) == 2
        assert torch.equal(out[0], a + b) and torch.equal(out[1], a * b)
    assert len(calls) == 2 and calls[0][0] is a and calls[0][1] is b
    assert (g.replays, g.captures, g.eager_calls) == (0, 0, 0)


def test_eager_counts_calls_on_a_cuda_device_alone():
    g = CapturedGraphs(lambda x, scale=1: ("ran", scale))
    assert g.eager(torch.zeros(2), scale=3) == ("ran", 3)
    assert g.eager_calls == 0
    on_card = types.SimpleNamespace(is_cuda=True)
    assert g.eager(on_card, scale=2) == ("ran", 2)
    assert (g.replays, g.captures, g.eager_calls) == (0, 0, 1)


def test_gate_declines_generator_tracer_and_profiler(agent, monkeypatch):
    """With `engages` True, the plain call takes the graph; a generator,
    the tracer and the profiler each take the eager path, which equals
    the module's perceive."""
    cfg, ag = agent
    rgb, dep = _obs(cfg, seed=2)
    graphed = []

    def spy(self, *xs):
        if self is ag._perceive_graphs:     # not the depth trunk's
            graphed.append(len(xs))
        return self.fn(*xs)

    monkeypatch.setattr(CapturedGraphs, "engages",
                        staticmethod(lambda *xs: True))
    monkeypatch.setattr(CapturedGraphs, "__call__", spy)
    with torch.inference_mode():
        want = agent_mod.perceive(ag.params, cfg, torch.from_numpy(rgb),
                                  torch.from_numpy(dep))
    _equal(ag.perceive(rgb, dep), want)
    assert graphed == [2]

    gen = torch.Generator().manual_seed(1)
    ag.perceive(rgb, dep, gen)
    assert graphed == [2]

    tracing.enable()
    try:
        _equal(ag.perceive(rgb, dep), want)
    finally:
        tracing.disable()
    assert graphed == [2]

    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]):
        assert agent_mod.profiling()
        _equal(ag.perceive(rgb, dep), want)
    assert graphed == [2]
    assert not agent_mod.profiling()
    # CPU tensors: the declined calls count no eager card call
    assert ag.perceive_graph_stats() == ZERO


def test_counters_in_server_stats_and_http(agent):
    cfg, ag = agent
    nav = NavServer(cfg, ag, max_batch=2, max_wait_ms=5.0)
    httpd = make_http_server(nav, host="127.0.0.1", port=0)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    try:
        nav.warmup()
        st = nav.stats()
        assert {k: st[k] for k in ZERO} == ZERO
        over_http = HttpNavClient(
            f"http://127.0.0.1:{httpd.server_address[1]}").stats()
        assert {k: over_http[k] for k in ZERO} == ZERO
    finally:
        httpd.shutdown()
        t.join(timeout=JOIN_S)
        httpd.server_close()
        nav.shutdown()
    assert not t.is_alive()


def test_constants_equal_the_per_call_uploads(agent):
    """`perceive_constants` holds what perceive uploaded at each call,
    exactly: CLIP's fold vectors, the neighbour bias, the pano angles."""
    cfg, _ = agent
    dev = torch.device("cpu")
    c = agent_mod.perceive_constants(cfg, dev)
    ps = cfg.clip.patch_size
    s = torch.from_numpy(np.tile(1.0 / (255.0 * clip_vit.CLIP_STD),
                                 ps * ps)).to(dev)
    t = torch.from_numpy(np.tile(-clip_vit.CLIP_MEAN / clip_vit.CLIP_STD,
                                 ps * ps)).to(dev)
    mask = torch.from_numpy(waypoint.circular_neighbor_mask(
        cfg.waypoint.num_images, cfg.waypoint.neighbor).astype(bool))
    bias = mask_to_bias(mask.to(dev))[None, None, :, :]
    pano = torch.from_numpy(waypoint.pano_angle_features()).to(dev)
    for got, want in ((c["clip_fold"][0], s), (c["clip_fold"][1], t),
                      (c["neighbor_bias"], bias), (c["pano_loc"], pano)):
        assert got.dtype == want.dtype and got.shape == want.shape
        assert torch.equal(got, want)
    assert c["clip_fold"][0].dtype == torch.float32
    assert tuple(c["neighbor_bias"].shape) == (
        1, 1, cfg.waypoint.num_images, cfg.waypoint.num_images)
