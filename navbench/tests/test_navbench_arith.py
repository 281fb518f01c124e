"""Percentiles, seeds and the per-layer readers' window arithmetic."""

import importlib.util
import os

import pytest

from navbench import common
from navbench.work import model as work

METRICS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "metrics")


def reader(name):
    spec = importlib.util.spec_from_file_location(
        "m_" + name.replace(".", "_"), os.path.join(METRICS, name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@pytest.mark.parametrize("values,q,want", [
    ([5.0], 95, 5.0),
    (list(range(1, 101)), 95, 95),
    (list(range(1, 101)), 50, 50),
    (list(range(1, 21)), 95, 19),
    ([3.0, 1.0, 2.0], 50, 2.0),
    ([3.0, 1.0, 2.0], 100, 3.0),
])
def test_percentile_nearest_rank(values, q, want):
    assert common.percentile(values, q) == want


def test_percentile_needs_values():
    with pytest.raises(ValueError):
        common.percentile([], 95)


def test_sub_seed_is_deterministic_and_small():
    big = 2 ** 33 + 7
    a, b = common.sub_seed(big, 1, 0), common.sub_seed(big, 1, 0)
    assert a == b and 0 <= a < 2 ** 31
    assert common.sub_seed(big, 1, 1) != a
    assert common.sub_seed(big + 1, 1, 0) != a


def _record():
    return {
        "t0": 10.0, "t_end": 20.0, "window_s": 10.0,
        "spans": {"process": [(9.0, 9.5), (11.0, 11.1), (12.0, 12.2)],
                  "perceive": [(11.0, 11.05), (12.0, 12.1)],
                  "score": [(11.06, 11.08), (12.11, 12.15)]},
        "stats": ({"batches": 5, "steps_served": 30},
                  {"batches": 15, "steps_served": 90}),
        "max_batch": 8,
        "trace": {"busy_s": 0.5, "window_s": 2.0, "attention_s": 0.2},
        "attention_bound_s": 0.05,
        "work": {"bf16": 989e12 * 0.1, "fp32": 67e12 * 0.1},
        "rollout_s": [1.0, 2.0], "learn_s": [0.1, 0.2],
    }


def test_span_readers_use_the_window_only():
    r = _record()
    assert reader("perceive_ms.serve")(r) == pytest.approx(75.0)
    assert reader("score_ms.serve")(r) == pytest.approx(30.0)
    # process 100 and 200 ms less their two programs: 30 and 60 ms
    assert reader("host_ms.serve")(r) == pytest.approx(45.0)


def test_counter_and_trace_readers():
    r = _record()
    assert reader("occupancy.serve")(r) == pytest.approx(75.0)
    assert reader("device_idle.serve")(r) == pytest.approx(75.0)
    assert reader("device_idle.train")(r) == pytest.approx(75.0)
    assert reader("attn_roofline.serve")(r) == pytest.approx(25.0)
    # 0.1 s at each precision's peak over a 10 s window
    assert reader("mfu.serve")(r) == pytest.approx(2.0)
    assert reader("mfu.train")(r) == pytest.approx(2.0)
    assert reader("rollout_s.train")(r) == pytest.approx(1.5)
    assert reader("learn_ms.train")(r) == pytest.approx(150.0)


def test_readers_return_nothing_without_data():
    r = _record()
    r["spans"] = {}
    r["trace"] = {"busy_s": 0.0, "window_s": 2.0, "attention_s": 0.0}
    r["stats"] = ({"batches": 3, "steps_served": 9},) * 2
    r["rollout_s"], r["learn_s"], r["work"] = [], [], {}
    for name in ("perceive_ms.serve", "host_ms.serve", "occupancy.serve",
                 "device_idle.serve", "attn_roofline.train",
                 "rollout_s.train", "learn_ms.train", "mfu.serve"):
        assert reader(name)(r) is None, name


def test_seconds_at_peak():
    w = {"bf16": 989e12, "fp32": 67e12}
    assert work.seconds_at_peak(w, common.PEAK_FLOPS) == pytest.approx(2.0)
