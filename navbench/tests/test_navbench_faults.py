"""The run's verdict with the timed path broken underneath: a sound run
at tiny_config() on the CPU is correct under the cell's limits, and
each fault the cell can have makes `correct` false. (One chip, so no
exchange between chips can be left out.)"""

import json
import os
import time

import pytest
import torch

from navbench import common, model_config

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def tiny_spec(**keys) -> dict:
    """The configuration file of tiny_config(), with `keys` added at its
    top level."""
    from etpnav_tpu_torch.config import tiny_config
    return {"name": "tiny", "function": "tiny_config", "overrides": {},
            "model": model_config.model_block(tiny_config()),
            "assumed": {"instruction_tokens": {
                "lengths": [5, 9, 16], "cls_id": 2, "sep_id": 3,
                "first_word_id": 10},
                "path_m": {"lengths": [2.0, 3.5, 5.0], "hops": [2, 3]}},
            **keys}


def _run(driver, traffic: str, cell: str, spec: dict = None,
         trace: bool = False) -> tuple:
    """(correct, the driver's output) of a short CPU run of the traffic
    under the cell's limits, at the configuration file `spec`
    (`tiny_spec()` where None)."""
    from etpnav_tpu_torch.config import tiny_config
    cfg = tiny_config()
    spec = tiny_spec() if spec is None else spec
    with open(os.path.join(ROOT, "navbench", "traffic",
                           traffic + ".json")) as f:
        tr = json.load(f)
    tr["params"].update(clients=3, envs=2, episodes=16, warm_buckets=[
        [cfg.il.max_traj_len, cfg.planner.max_gmap_len]],
        trace_seconds=0.2)
    with open(os.path.join(ROOT, "navbench", "limits", cell + ".json")) as f:
        limits = json.load(f)["numbers"]
    torch.set_num_threads(2)
    ctx = common.Context(root=ROOT, cell={"name": cell, "chips": 1},
                         config=spec, traffic=tr, limits=limits,
                         seed=2 ** 32 + 99, seconds=1.5, trace=trace,
                         t_start=time.perf_counter(), device="cpu")
    out = driver.run(ctx)
    checks = common.judge(out["readings"], limits)
    return bool(checks) and all(c["ok"] for c in checks), out


def serve():
    from navbench.drivers import serve_closed
    return _run(serve_closed, "serve.c8", "r2r.serve.c8")[0]


def train():
    from navbench.drivers import train_il
    return _run(train_il, "train.il", "r2r.train.il")[0]


def test_sound_runs_are_correct():
    assert serve()
    assert train()


def test_serve_answer_altered(monkeypatch):
    """The waypoint heatmap shifted where it is produced."""
    from etpnav_tpu_torch.models import waypoint
    orig = waypoint.waypoint_heatmap
    monkeypatch.setattr(waypoint, "waypoint_heatmap",
                        lambda *a, **k: orig(*a, **k) + 1.0)
    assert not serve()


def test_serve_action_altered(monkeypatch):
    """The global logits negated where they are produced: the served
    action becomes the reference's worst."""
    from etpnav_tpu_torch.training import agent
    orig = agent.score_navigation

    def flipped(*a, **k):
        out = orig(*a, **k)
        lg = out["global_logits"]
        return dict(out, global_logits=torch.where(torch.isfinite(lg),
                                                   -lg, lg))

    monkeypatch.setattr(agent, "score_navigation", flipped)
    assert not serve()


def test_serve_half_the_batch_left_out(monkeypatch):
    """Perception computed for the first half of the batch's live rows
    only (the others' pano embeddings left at zero; padding rows carry
    zero images)."""
    from etpnav_tpu_torch.training import agent
    orig = agent.perceive

    def half(params, cfg, rgb, depth, *a, **k):
        out = orig(params, cfg, rgb, depth, *a, **k)
        live = torch.nonzero(rgb.flatten(1).any(1))[:, 0]
        pe = out["pano_embeds"].clone()
        pe[live[(len(live) + 1) // 2:]] = 0.0
        return dict(out, pano_embeds=pe)

    monkeypatch.setattr(agent, "perceive", half)
    assert not serve()


def test_train_state_unchanged(monkeypatch):
    """A learn step whose optimizer leaves the parameters as they were."""
    from etpnav_tpu_torch.training import finetune
    orig = finetune.make_il_optimizer

    def frozen(*a, **k):
        opt = orig(*a, **k)
        opt.step = lambda closure=None: None
        return opt

    monkeypatch.setattr(finetune, "make_il_optimizer", frozen)
    assert not train()


def test_train_half_the_batch_left_out(monkeypatch):
    """The loss over the first half of the batch's rows, the mean taken
    over their live steps."""
    from etpnav_tpu_torch.training import finetune
    orig = finetune.compute_il_loss

    def half(params, cfg, batch, *a, **k):
        b = dict(batch)
        sv = b["step_valid"].clone()
        sv[sv.shape[0] // 2:] = False
        b["step_valid"] = sv
        return orig(params, cfg, b, *a, **k)

    monkeypatch.setattr(finetune, "compute_il_loss", half)
    assert not train()


def test_train_rollout_answer_altered(monkeypatch):
    """The rollout's scoring scaled where it is produced."""
    from etpnav_tpu_torch.training import agent
    orig = agent.score_navigation

    def shifted(*a, **k):
        out = orig(*a, **k)
        return {"gmap_embeds": out["gmap_embeds"] * 1.5,
                "global_logits": out["global_logits"] * 1.5}

    monkeypatch.setattr(agent, "score_navigation", shifted)
    assert not train()


def _reused(fn):
    """`fn` with each tensor it returns written into one buffer of its
    own, the same buffer on every call (as a program with static output
    buffers would)."""
    bufs = {}

    def call(*a, **k):
        out = dict(fn(*a, **k))
        for key, v in out.items():
            if isinstance(v, torch.Tensor):
                b = bufs.get(key)
                if b is None or b.shape != v.shape or b.dtype != v.dtype:
                    b = bufs[key] = torch.empty_like(v)
                b.copy_(v)
                out[key] = b
        return out

    return call


def test_serve_reused_buffers_are_correct(monkeypatch):
    """A sound program whose perception and scoring write their outputs
    into the same buffers on every call is still correct: the kept
    batches are copied as they are kept."""
    from etpnav_tpu_torch.training import agent
    monkeypatch.setattr(agent, "perceive", _reused(agent.perceive))
    monkeypatch.setattr(agent, "score_navigation",
                        _reused(agent.score_navigation))
    assert serve()


@pytest.mark.parametrize("fault", ["half_batch", "rollout_scaled"])
def test_train_fault_after_set_up(monkeypatch, fault):
    """A fault that starts after set-up's checked iterations, so only
    the window's kept iteration can see it: the loss over the first half
    of the batch's rows from the fourth learn step on, or the rollout's
    scoring scaled from the fourth rollout on."""
    from etpnav_tpu_torch.training import agent, finetune
    calls = {"learn": 0, "rollout": 0}
    if fault == "half_batch":
        orig = finetune.compute_il_loss

        def late(params, cfg, batch, *a, **k):
            if not bool(batch["step_valid"].any()):
                return orig(params, cfg, batch, *a, **k)   # warm-up
            calls["learn"] += 1
            if calls["learn"] > 3:
                b = dict(batch)
                sv = b["step_valid"].clone()
                sv[sv.shape[0] // 2:] = False
                b["step_valid"] = sv
                batch = b
            return orig(params, cfg, batch, *a, **k)

        monkeypatch.setattr(finetune, "compute_il_loss", late)
    else:
        orig = finetune.FinetuneTrainer.train
        score = agent.score_navigation

        def counted(self, *a, **k):
            calls["rollout"] += 1
            return orig(self, *a, **k)

        def late(*a, **k):
            out = score(*a, **k)
            if calls["rollout"] <= 3:
                return out
            return {"gmap_embeds": out["gmap_embeds"] * 1.5,
                    "global_logits": out["global_logits"] * 1.5}

        monkeypatch.setattr(finetune.FinetuneTrainer, "train", counted)
        monkeypatch.setattr(agent, "score_navigation", late)
    assert not train()


class _NoDeviceWindow:
    """`trace.DeviceWindow` on the CPU: no device to profile, an empty
    summary."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def summary(self, spans=None, order=()):
        return {}


def _traced_serve(spec=None) -> tuple:
    """`_run` of a traced serving run on the CPU, and the arguments of
    its `compare.serve_readings` call."""
    from navbench import compare, trace
    from navbench.drivers import serve_closed
    calls = []
    orig = compare.serve_readings

    def kept(*a, **k):
        calls.append(a)
        return orig(*a, **k)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(compare, "serve_readings", kept)
        mp.setattr(trace, "DeviceWindow", _NoDeviceWindow)
        ok, out = _run(serve_closed, "serve.c8", "r2r.serve.c8", spec,
                       trace=True)
    return ok, out, calls[0]


@pytest.fixture(scope="module")
def default_serve():
    return _traced_serve()


STUB = {"reference": "navbench.tests.stub_reference",
        "work": "navbench.tests.stub_work"}


@pytest.mark.parametrize("case", ["default", "stub", "missing_section"])
def test_a_configuration_names_its_modules(request, case):
    """A stand-in architecture joins by files alone: a configuration file
    that names the stub reference and count modules of this directory is
    resolved, run, judged against the stub's reference (whose text memory
    is one higher: incorrect) and counted by the stub's count (its FLOPs
    in the record's work). The default modules judge the same run
    correct. A file that names a section the program's config lacks is
    refused."""
    from navbench.tests import stub_work
    if case == "missing_section":
        spec = tiny_spec()
        spec["model"]["experts"] = {"num_experts": 8}
        with pytest.raises(ValueError, match="experts"):
            _traced_serve(spec)
        return
    if case == "default":
        ok, out, _ = request.getfixturevalue("default_serve")
    else:
        ok, out, _ = _traced_serve(tiny_spec(**STUB))
    assert ok == (case == "default")
    assert (out["record"]["work"]["fp32"] >= stub_work.STUB_FLOPS) == (
        case == "stub")


def test_serve_readings_by_the_default_module(default_serve):
    """The reference module a configuration without `reference` resolves
    to gives `serve_readings` the same readings, on the same kept batches,
    as ETPNav's `Ref` and `Drop` imported directly."""
    import types
    from navbench import compare
    from navbench.reference import model
    from navbench.reference.model import Drop, Ref
    _, out, args = default_serve
    assert args[0] is model
    direct = types.SimpleNamespace(Ref=Ref, Drop=Drop)
    again = compare.serve_readings(*args)
    assert compare.serve_readings(direct, *args[1:]) == again
    assert again == out["readings"]


@pytest.mark.card
def test_control_fails_at_the_cells_size(card):
    """On the card: the fp8 control fails the cells' limits on three
    seeds at the cells' own sizes (`navbench/control.py`)."""
    import subprocess
    import sys
    for cell, secs, others in (("r2r.serve.c8", "10", "fp8"),
                               ("rxr.train.il", "1", "fp8,half")):
        out = subprocess.run(
            [sys.executable, "navbench/control.py", "--workload", cell,
             "--seeds", "11,12,13", "--seconds", secs, "--others", others],
            capture_output=True, text=True, cwd=ROOT, timeout=1200)
        assert out.returncode == 0, out.stderr[-3000:]
        with open(os.path.join(ROOT, "navbench", "limits",
                               cell + ".json")) as f:
            limits = json.load(f)["numbers"]
        for line in out.stdout.splitlines():
            if not line.startswith('{"cell"'):
                continue
            row = json.loads(line)
            assert all(c["ok"] for c in common.judge(row["program"], limits))
            for o in others.split(","):
                checks = common.judge(row[o], limits)
                assert not all(c["ok"] for c in checks), (o, row["seed"])
