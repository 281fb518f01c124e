"""The arithmetic of `navbench/program_trace.py` on hand-made spans:
nested spans flattened to the innermost, idle intervals split over them
by overlap, the device's idle intervals on the host clock, and the
serving and training numbers read from a record."""

import pytest

from navbench import program_trace as pt


def sp(i, name, t0, t1, parent=None, thread=1, key=None, device_ms=None,
       **kw):
    return {"id": i, "name": name, "t0": t0, "t1": t1, "parent": parent,
            "thread": thread, "key": key, "device_ms": device_ms, **kw}


def test_idle_split_over_two_spans_by_overlap():
    spans = [sp(0, "serve.batch", 0.0, 10.0),
             sp(1, "serve.map", 2.0, 5.0, parent=0),
             sp(2, "serve.score", 5.0, 8.0, parent=0),
             sp(3, "agent.upload", 5.0, 6.0, parent=2)]
    seg = pt.innermost(spans)
    assert seg == [(0.0, 2.0, "serve.batch"), (2.0, 5.0, "serve.map"),
                   (5.0, 6.0, "agent.upload"), (6.0, 8.0, "serve.score"),
                   (8.0, 10.0, "serve.batch")]
    # one gap across map and score, one partly outside every span
    got = pt.split_idle([(4.0, 7.0), (9.0, 12.0)], seg)
    assert got == pytest.approx({"serve.map": 1.0, "agent.upload": 1.0,
                                 "serve.score": 1.0, "serve.batch": 1.0,
                                 "untraced": 2.0})


def test_device_idle_on_the_host_clock():
    # device clock = host + 100; busy [101, 102] and [101.5, 103], [105, 106]
    ev = [(101.0, 102.0), (101.5, 103.0), (105.0, 106.0)]
    assert pt.idle_intervals(ev, 100.0, 0.5, 7.0) == [
        (0.5, 1.0), (3.0, 5.0), (6.0, 7.0)]
    assert pt.idle_intervals([], 0.0, 1.0, 2.0) == [(1.0, 2.0)]


def test_serve_numbers():
    spans = [sp(0, "serve.queue_wait", 0.0, 0.004, thread=9, key=(0, 0),
                batch=0),
             sp(1, "serve.collect", 0.001, 0.006, key=0),
             sp(2, "serve.batch", 0.007, 0.107, key=0)]
    t = 0.007
    for i, (n, d) in enumerate(zip(pt.SERVE_STAGES,
                                   (0.01, 0.05, 0.02, 0.01, 0.005))):
        spans.append(sp(3 + i, n, t, t + d, parent=2, key=0))
        t += d
    spans.append(sp(8, "agent.upload", 0.018, 0.02, parent=4, key=0,
                    device_ms=1.5))
    spans.append(sp(9, "agent.upload", 0.07, 0.071, parent=6, key=0,
                    device_ms=0.5))
    spans.append(sp(10, "serve.encode_text", 0.0, 0.003, thread=9, key=0))
    got = pt.serve_numbers(spans, 0.0, 1.0, idle=[(0.037, 0.047)],
                           window_s=0.2)
    assert got["queue_wait_ms"] == pytest.approx(4.0)
    assert got["collect_ms"] == pytest.approx(5.0)
    assert got["text_ms"] == pytest.approx(3.0)
    assert got["upload_ms"] == pytest.approx(2.0)
    assert got["stage_cover_min"] == pytest.approx(0.95)
    # the gap lies in serve.perceive (0.017-0.067): nothing in map
    assert got["idle_by_span"] == pytest.approx({"serve.perceive": 0.01})
    assert got["idle_map"] == 0.0


def test_train_numbers():
    spans = [sp(0, "train.rollout", 0.0, 1.0, key=0),
             sp(1, "rollout.env", 0.0, 0.1, parent=0, key=(0, -1)),
             sp(2, "rollout.perceive", 0.1, 0.3, parent=0, key=(0, 0)),
             sp(3, "rollout.env", 0.3, 0.9, parent=0, key=(0, 0)),
             sp(4, "train.learn", 1.0, 1.2, key=0),
             sp(5, "learn.batch", 1.0, 1.05, parent=4, key=0),
             sp(6, "learn.forward", 1.05, 1.1, parent=4, key=0,
                device_ms=40.0),
             sp(7, "learn.backward", 1.1, 1.15, parent=4, key=0,
                device_ms=60.0),
             sp(8, "learn.optimizer", 1.15, 1.16, parent=4, key=0,
                device_ms=5.0)]
    got = pt.train_numbers(spans, 0.0, 2.0, idle=[(0.5, 0.7), (0.95, 1.0)],
                           window_s=1.25)
    assert got["env_ms"] == pytest.approx(700.0)
    assert got["perceive_ms"] == pytest.approx(200.0)
    assert got["rollout_cover_min"] == pytest.approx(0.9)
    assert got["learn_cover_min"] == pytest.approx(0.8)
    assert (got["fwd_ms"], got["bwd_ms"], got["adamw_ms"]) == (40.0, 60.0,
                                                               5.0)
    assert got["idle_by_span"] == pytest.approx({"rollout.env": 0.2,
                                                 "train.rollout": 0.05})
    assert got["idle_env"] == pytest.approx(16.0)
