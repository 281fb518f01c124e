"""The port's pipelined rollout (`etpnav_tpu_torch/training/pipeline.py`)
on the CPU at `tiny_config()`: the counterpart of tests/test_pipeline.py.

- Two halves in threads record exactly what their two engines record
  run one after the other with the same seeds (`np.array_equal` on every
  field: the engines share one Agent, each keeps its own generators), and
  the concatenated record trains through `learn_step`.
- Nine halves with the interpreter switching threads every microsecond
  record what they record one after the other, and the shared launch
  counter loses no update.
- Eval over two halves fills one dedup dict.
- The rollout over process workers (forkserver, shared-memory
  observations) records exactly what it records over the same envs in
  process, and the trainer takes a list of pools as the JAX trainer does
  (engine i seeded `seed + i`).
"""

import dataclasses

import numpy as np
import pytest
import torch

from etpnav_tpu_torch.config import tiny_config
from etpnav_tpu_torch.env.geometric import GeometricNavEnv
from etpnav_tpu_torch.env.vector import (
    GeometricEnvFactory,
    ProcessVectorEnv,
    geometric_obs_spec,
)
from etpnav_tpu_torch.ops import fused_attention as fa
from etpnav_tpu_torch.training import finetune
from etpnav_tpu_torch.training.agent import Agent, init_agent_params
from etpnav_tpu_torch.training.pipeline import (
    PipelinedRollout,
    concat_records,
)
from etpnav_tpu_torch.training.rollout import RolloutEngine, RolloutRecord

torch.set_num_threads(2)


def _env_kwargs(cfg):
    return dict(vocab_size=cfg.planner.vocab_size,
                max_instr_len=cfg.il.max_text_len,
                image_size=cfg.clip.image_size,
                depth_size=cfg.depth.input_size,
                pad_id=cfg.planner.pad_token_id)


def _engine(cfg, agent, seed):
    envs = GeometricNavEnv(num_envs=2, seed=seed, **_env_kwargs(cfg))
    return RolloutEngine(cfg, agent, envs, seed=seed)


@pytest.fixture(scope="module")
def agent():
    cfg = tiny_config()
    return cfg, Agent(cfg, init_agent_params(cfg, 0), device="cpu")


def _assert_records_equal(a: RolloutRecord, b: RolloutRecord):
    for f in dataclasses.fields(RolloutRecord):
        np.testing.assert_array_equal(getattr(a, f.name),
                                      getattr(b, f.name), f.name)


def test_pipelined_rollout_trains_and_equals_sequential_engines(agent):
    cfg, ag = agent
    pipe = PipelinedRollout([_engine(cfg, ag, 1), _engine(cfg, ag, 2)])
    rec = pipe.run("train", sample_ratio=1.0)
    assert rec.step_valid.shape[0] == 4             # 2 halves x 2 envs
    want = concat_records([_engine(cfg, ag, s).run("train", sample_ratio=1.0)
                           for s in (1, 2)])
    _assert_records_equal(rec, want)
    # the concatenated record trains through the standard learn step
    params = init_agent_params(cfg, 0)
    opt = finetune.make_il_optimizer(cfg, params.planner)
    loss = finetune.learn_step(params.planner, opt, cfg,
                               finetune.record_to_batch(rec, "cpu"),
                               torch.Generator().manual_seed(3))
    assert np.isfinite(float(loss))


def test_pipelined_rollout_under_forced_thread_switching(agent):
    """9 halves (more threads than this host's cores) with the
    interpreter switching threads every microsecond: every record and
    the shared attention counter equal a sequential run's (a lost update
    or a draw from another engine's generator would break either)."""
    import sys
    cfg, ag = agent
    seeds = range(40, 49)

    def engines():
        return [RolloutEngine(cfg, ag, GeometricNavEnv(
            num_envs=1, seed=s, **_env_kwargs(cfg)), seed=s) for s in seeds]
    before = fa.attention_plain_calls.value
    want = concat_records([e.run("train", sample_ratio=0.5)
                           for e in engines()])
    n_seq = fa.attention_plain_calls.value - before
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        before = fa.attention_plain_calls.value
        got = PipelinedRollout(engines()).run("train", sample_ratio=0.5)
        n_thr = fa.attention_plain_calls.value - before
    finally:
        sys.setswitchinterval(interval)
    _assert_records_equal(got, want)
    assert n_thr == n_seq > 0


def test_pipelined_eval_dedup(agent):
    cfg, ag = agent
    pipe = PipelinedRollout([_engine(cfg, ag, 5), _engine(cfg, ag, 6)])
    stats = {}
    assert pipe.run("eval", stat_eps=stats) is None
    assert len(stats) >= 4                # both halves' episodes, unique
    for m in stats.values():
        assert 0.0 <= m["spl"] <= 1.0


def test_rollout_over_process_workers_equals_in_process(agent):
    """Engine -> batched RPC -> forkserver workers with shm observations
    records exactly what the same envs record in process."""
    cfg, ag = agent
    kw = _env_kwargs(cfg)
    factories = [GeometricEnvFactory(31_000 + i, kw) for i in range(2)]
    procs = ProcessVectorEnv(factories, shm_obs_spec=geometric_obs_spec(kw),
                             shm_copy=False)
    try:
        local = ProcessVectorEnv(factories, threaded=True)
        rec = RolloutEngine(cfg, ag, procs, seed=0).run("train",
                                                         sample_ratio=1.0)
        want = RolloutEngine(cfg, ag, local, seed=0).run("train",
                                                          sample_ratio=1.0)
        assert rec.step_valid[:, 0].all()
        _assert_records_equal(rec, want)
        stats = {}
        RolloutEngine(cfg, ag, procs, seed=0).run("eval", stat_eps=stats)
        assert len(stats) >= 2
    finally:
        procs.close()


def test_trainer_takes_a_list_of_pools_as_jax_does(agent):
    """A list of pools makes a PipelinedRollout with engine i seeded
    seed + i (the JAX trainer's `finetune.py:364-373`), and one training
    iteration runs over it."""
    cfg, _ = agent
    pools = [GeometricNavEnv(num_envs=1, seed=s, **_env_kwargs(cfg))
             for s in (8, 9)]
    tr = finetune.FinetuneTrainer(cfg, pools, seed=4, device="cpu")
    assert isinstance(tr.engine, PipelinedRollout)
    assert [e.envs for e in tr.engine.engines] == pools
    # engine i draws from seed + i, as RolloutEngine(seed=4 + i)
    for i, e in enumerate(tr.engine.engines):
        ref = RolloutEngine(cfg, tr.agent, pools[i], seed=4 + i)
        assert e.np_rng.random() == ref.np_rng.random()
        assert torch.equal(e.generator.get_state(),
                           ref.generator.get_state())
    logs = tr.train(1)
    assert np.isfinite(logs["IL_loss"])
