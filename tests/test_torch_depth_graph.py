"""The depth trunk's CUDA graphs (`etpnav_tpu_torch/ops/cuda_graph.py`,
`Agent.perceive`) where the CPU can hold them, at `tiny_config()`.

A CPU agent's perceive stays eager: bit-equal to the module's eager
`perceive`, with and without the waypoint augmentation, and the graph
counters stay at 0 in the agent and in `NavServer.stats()`. The launch
counters' recording, which a capture takes and each replay adds again,
is exact and holds this thread's launches alone. The graphs themselves
need a card: chip_smoke.py phase 4c holds them there.
"""

import sys
import threading

import numpy as np
import pytest
import torch

from etpnav_tpu_torch.config import tiny_config
from etpnav_tpu_torch.ops import cuda_build
from etpnav_tpu_torch.ops.cuda_graph import CapturedGraphs
from etpnav_tpu_torch.serving import NavServer
from etpnav_tpu_torch.training import agent as agent_mod
from etpnav_tpu_torch.training.agent import Agent, init_agent_params

torch.set_num_threads(2)

JOIN_S = 120
ZERO = {"depth_graph_replays": 0, "depth_eager_calls": 0,
        "depth_graph_captures": 0}


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


@pytest.mark.parametrize("augment", [False, True])
def test_cpu_perceive_is_the_eager_perceive(agent, augment):
    cfg, ag = agent
    rgb, dep = _obs(cfg)
    gen = torch.Generator().manual_seed(3) if augment else None
    got = ag.perceive(rgb, dep, gen)
    ref_gen = torch.Generator().manual_seed(3) if augment else None
    with torch.inference_mode():
        want = agent_mod.perceive(ag.params, cfg, torch.from_numpy(rgb),
                                  torch.from_numpy(dep), ref_gen,
                                  train_sampling=augment)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert torch.equal(got[k], want[k]), k
    assert ag.depth_graph_stats() == ZERO


def test_captured_graphs_run_cpu_tensors_eagerly():
    calls = []

    def fn(x):
        calls.append(x)
        return x * 2

    g = CapturedGraphs(fn)
    x = torch.arange(6.0).reshape(2, 3)
    assert not g.engages(x)
    assert torch.equal(g(x), x * 2) and torch.equal(g(x), x * 2)
    assert len(calls) == 2 and calls[0] is x
    assert (g.replays, g.captures, g.eager_calls) == (0, 0, 0)


def test_captured_graphs_copy_each_tensor_of_a_tuple():
    from etpnav_tpu_torch.ops.cuda_graph import _apply
    x = torch.arange(6.0)
    out = _apply(torch.Tensor.clone, (x, x * 2))
    assert isinstance(out, tuple) and len(out) == 2
    assert torch.equal(out[0], x) and out[0].data_ptr() != x.data_ptr()
    assert torch.equal(out[1], x * 2)
    one = _apply(torch.Tensor.clone, x)
    assert torch.is_tensor(one) and torch.equal(one, x)
    g = CapturedGraphs(lambda t: (t + 1, t.sum()))
    a, b = g(x)
    assert torch.equal(a, x + 1) and b.item() == 15.0


def test_server_stats_carry_the_depth_graph_counters(agent):
    cfg, ag = agent
    server = NavServer(cfg, ag, max_batch=2, max_wait_ms=5.0)
    try:
        lengths = {*(cfg.planner.gmap_len_buckets or ()),
                   cfg.planner.max_gmap_len}
        assert server.warmup() == 2 + len(lengths)
        st = server.stats()
        assert {k: st[k] for k in ZERO} == ZERO
        assert {"steps_served", "batches", "failed_batches",
                "deadline_batches", "mean_occupancy", "live_sessions",
                "queue_depth", "perceive_graph_replays",
                "perceive_eager_calls", "perceive_graph_captures", *ZERO,
                "text_encodes", "text_tokens",
                "moe_rows", "moe_groups", "moe_rows_elsewhere"} == st.keys()
    finally:
        server.shutdown()


def test_recording_holds_this_threads_launches_alone():
    """Other threads add to the same counters while one thread records;
    the record holds that thread's adds, the totals lose none, and
    taking the record back and adding it again (a capture, then its
    replays) moves each counter by exactly its count."""
    a, b = cuda_build.LaunchCounter(), cuda_build.LaunchCounter()
    n_threads, per_thread = 8, 2000
    go = threading.Barrier(n_threads + 1)

    def noise():
        go.wait(JOIN_S)
        for _ in range(per_thread):
            a.add()
            b.add(2)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=noise) for _ in range(n_threads)]
        for t in threads:
            t.start()
        with cuda_build.recording_launches() as rec:
            go.wait(JOIN_S)
            for _ in range(per_thread):
                a.add()
            b.add(54)
        for t in threads:
            t.join(JOIN_S)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert rec == {a: per_thread, b: 54}
    assert a.value == (n_threads + 1) * per_thread
    assert b.value == 2 * n_threads * per_thread + 54
    cuda_build.add_launches(rec, -1)
    assert (a.value, b.value) == (n_threads * per_thread,
                                  2 * n_threads * per_thread)
    cuda_build.add_launches(rec)
    cuda_build.add_launches(rec)
    assert (a.value, b.value) == ((n_threads + 2) * per_thread,
                                  2 * n_threads * per_thread + 108)
    # outside the block nothing is recorded
    a.add()
    assert rec == {a: per_thread, b: 54}
