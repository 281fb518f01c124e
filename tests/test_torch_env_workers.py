"""The port's env worker pool (`etpnav_tpu_torch/env/vector.py`) and its
shared-memory observation plane (`env/shm_transport.py`, with the
native gather of `native.py`) on the CPU, against the JAX package.

The counterparts of tests/test_vector_env.py (protocol, threaded mode,
crash recovery, the restart budget and its decay, an oracle call on a
dead worker, the restart passthrough) and tests/test_shm_obs.py (layout,
round trip and staleness, shm against the pipe, zero-copy views, a
crash with shm, `stack_arrays` / `gather_copy` against `np.stack`),
plus what the port adds: workers start from a forkserver with factories
that plain pickle moves, a closure is refused, and a crashed worker's
segment is unlinked. Every pool has 2 workers. Observations are compared
exactly (`np.array_equal`) with the JAX package's own env, shm layout and
gather on the same seeds.
"""

import os
import pathlib
import sys
import types

import numpy as np
import pytest

from etpnav_tpu import native as jnative
from etpnav_tpu.env import shm_transport as jshmt
from etpnav_tpu.env.geometric import GeometricNavEnv as JaxGeometricNavEnv
from etpnav_tpu_torch import native
from etpnav_tpu_torch.env import shm_transport as shmt
from etpnav_tpu_torch.env import vector
from etpnav_tpu_torch.env.protocol import StepResult
from etpnav_tpu_torch.env.vector import (
    GeometricEnvFactory,
    ProcessVectorEnv,
    construct_geometric_envs,
)

ROOT = pathlib.Path(__file__).resolve().parents[1]
ENV_KW = dict(vocab_size=64, max_instr_len=8, image_size=16, depth_size=16)
SHM_KW = dict(ENV_KW, num_views=4)


def _pool(n=2, seed=500, restart=True, **kw):
    return ProcessVectorEnv(
        [GeometricEnvFactory(seed + i, ENV_KW) for i in range(n)],
        restart_on_crash=restart, **kw)


def _jax_obs(seed):
    return JaxGeometricNavEnv(num_envs=1, seed=seed, **ENV_KW).reset()[0]


def _shm_names(envs):
    return [c.name for c in envs._shm_channels if c is not None]


def _shm_exists(name):
    return os.path.exists(f"/dev/shm/{name.lstrip('/')}")


# ---------------------------------------------------------------------------
# the pool (tests/test_vector_env.py)
# ---------------------------------------------------------------------------

def test_forkserver_pool_moves_factories_by_plain_pickle():
    """The default start method is a forkserver, and the factory is a
    class plain pickle moves; a closure is refused when the pool is
    built, with a message that says why. No cloudpickle in the port."""
    envs = _pool(seed=77)
    try:
        assert envs._context == "forkserver"
        obs = envs.reset()
        for i, o in enumerate(obs):
            want = _jax_obs(77 + i)
            for k in ("rgb", "depth", "instruction"):
                np.testing.assert_array_equal(o[k], want[k])
        assert envs.current_dist_to_goal().shape == (2,)
    finally:
        envs.close()

    def make():
        return None
    with pytest.raises(TypeError, match="plain pickle"):
        ProcessVectorEnv([make, make])
    src = (ROOT / "etpnav_tpu_torch" / "env" / "vector.py").read_text()
    assert "cloudpickle" not in src


def test_workers_start_without_the_parent_main_module(monkeypatch):
    """While workers start, the parent's main module is named
    env/worker_main.py (so a worker does not re-run the parent's script),
    and restored after; a factory from the main script keeps it."""
    main = types.ModuleType("__main__")
    main.__spec__ = None
    monkeypatch.setitem(sys.modules, "__main__", main)
    with vector._workers_skip_parent_main([GeometricEnvFactory(0, ENV_KW)]):
        assert main.__spec__.name == "etpnav_tpu_torch.env.worker_main"
    assert main.__spec__ is None
    local = type("Local", (), {"__module__": "__main__"})()
    with vector._workers_skip_parent_main([local]):
        assert main.__spec__ is None


@pytest.mark.parametrize("threaded", [True, False])
def test_process_vector_env_protocol(threaded):
    if threaded:
        envs = ProcessVectorEnv(
            [GeometricEnvFactory(1000 + i, ENV_KW) for i in range(2)],
            threaded=True)
    else:
        envs = construct_geometric_envs(2, workers=True, seed=1, **ENV_KW)
    try:
        obs = envs.reset()
        assert len(obs) == 2
        for i, o in enumerate(obs):
            np.testing.assert_array_equal(o["rgb"], _jax_obs(1000 + i)["rgb"])
        pos, ori = envs.get_pos_ori()
        assert pos.shape == (2, 3) and ori.shape == (2, 4)
        assert envs.current_dist_to_goal().shape == (2,)
        # distinct worlds per worker (the scene sharding analogue)
        assert len({e.episode_id for e in envs.current_episodes()}) == 2
        # batched step + pause
        assert len(envs.step_low_level([1, 1])) == 2
        envs.pause_at(1)
        assert envs.num_envs == 1
        assert len(envs.step_low_level([2])) == 1
        envs.resume_all()
        assert envs.num_envs == 2
        # oracle fan-out
        rp = envs.cand_real_pos(0, np.array([0.0]), np.array([1.0]))
        assert rp.shape == (1, 3)
        assert len(envs.cand_real_pos_batch([np.array([0.0])] * 2,
                                            [np.array([1.0])] * 2)) == 2
    finally:
        envs.close()


def test_async_step_api():
    envs = construct_geometric_envs(2, workers=True, seed=3, **ENV_KW)
    try:
        envs.reset()
        pos0, _ = envs.get_pos_ori()
        acts = [{"act": 4, "front_pos": pos0[i],
                 "ghost_pos": pos0[i] + np.array([0, 0, -1.0]),
                 "back_path": None, "tryout": True} for i in range(2)]
        envs.step_async(acts)
        assert len(envs.step_wait()) == 2
        pos1, _ = envs.get_pos_ori()
        assert not np.allclose(pos0, pos1)
    finally:
        envs.close()


def test_worker_crash_recovery_step():
    envs = _pool()
    try:
        envs.reset()
        envs.inject_worker_crash(1)
        res = envs.step_low_level([1, 1])
        assert len(res) == 2
        # the crashed slot ends its episode and says so; the pool lives
        assert res[1].done and res[1].info.get("crashed")
        assert not res[0].info.get("crashed")
        assert res[1].observation["rgb"].shape == (12, 16, 16, 3)
        # the respawned worker serves what follows
        envs.resume_all()
        assert len(envs.reset()) == 2
        assert envs.current_dist_to_goal().shape == (2,)
    finally:
        envs.close()


def test_worker_crash_recovery_async():
    envs = _pool()
    try:
        envs.reset()
        pos, _ = envs.get_pos_ori()
        envs.inject_worker_crash(0)
        envs.step_async([{"act": 0, "stop_pos": pos[i], "back_path": None}
                         for i in range(2)])
        res = envs.step_wait()
        assert res[0].done and res[0].info.get("crashed")
        assert res[1].done and not res[1].info.get("crashed")
    finally:
        envs.close()


def test_worker_crash_without_recovery_raises():
    envs = _pool(restart=False)
    try:
        envs.reset()
        envs.inject_worker_crash(0)
        with pytest.raises(RuntimeError, match="died"):
            envs.step_low_level([1, 1])
    finally:
        envs.close()


def test_worker_restart_budget_exhausted():
    envs = _pool(n=1, max_restarts=1)
    try:
        envs.reset()
        envs.inject_worker_crash(0)
        assert envs.step_low_level([1])[0].info.get("crashed")
        envs.inject_worker_crash(0)
        with pytest.raises(RuntimeError, match="restarts"):
            envs.step_low_level([1])
    finally:
        envs.close()


def test_worker_restart_budget_decays_after_successful_period():
    """The budget bounds the crash rate: after restart_decay_calls
    successful replies the slot's count resets."""
    envs = _pool(n=1, seed=600, max_restarts=1, restart_decay_calls=2)
    try:
        envs.reset()
        envs.inject_worker_crash(0)
        assert envs.step_low_level([1])[0].info.get("crashed")
        envs.resume_all()
        envs.reset()                        # healthy traffic decays the
        envs.step_low_level([1])            # count back to zero
        envs.inject_worker_crash(0)
        assert envs.step_low_level([1])[0].info.get("crashed")
    finally:
        envs.close()


def test_oracle_call_on_dead_worker_raises_but_respawns():
    envs = _pool()
    try:
        envs.reset()
        envs.inject_worker_crash(0)
        with pytest.raises(RuntimeError, match="respawned"):
            envs.current_dist_to_goal()
        # replies were drained on the error, so later calls line up
        envs.resume_all()
        obs = envs.reset()
        assert all(isinstance(o, dict) and "rgb" in o for o in obs)
        d = envs.current_dist_to_goal()
        assert d.shape == (2,) and d.dtype.kind == "f"
        assert np.isfinite(d).all()
    finally:
        envs.close()


def test_construct_envs_restart_passthrough():
    envs = construct_geometric_envs(2, workers=True, seed=5,
                                    restart_on_crash=True, **ENV_KW)
    try:
        assert envs._restart_on_crash
        envs.reset()
        envs.inject_worker_crash(0)
        assert envs.step_low_level([1, 1])[0].info.get("crashed")
    finally:
        envs.close()


# ---------------------------------------------------------------------------
# shared-memory observations (tests/test_shm_obs.py)
# ---------------------------------------------------------------------------

def _spec(mod=shmt):
    return mod.ObsSpec({"rgb": ((4, 16, 16, 3), np.uint8),
                        "depth": ((4, 8, 8, 1), np.float32)})


def _obs(rng):
    return {"rgb": rng.integers(0, 255, (4, 16, 16, 3), np.uint8),
            "depth": rng.random((4, 8, 8, 1)).astype(np.float32),
            "instruction": np.arange(5)}


def test_spec_layout_matches_jax():
    spec, jspec = _spec(), _spec(jshmt)
    assert all(off % 64 == 0 for off in spec.offsets.values())
    assert spec.nbytes >= 64 + 4 * 16 * 16 * 3 + 4 * 8 * 8 * 4
    assert (spec.offsets, spec.nbytes) == (jspec.offsets, jspec.nbytes)
    assert spec.fields == jspec.fields


def test_channel_roundtrip_and_staleness():
    spec = _spec()
    parent = shmt.ShmObsChannel(spec, create=True)
    worker = shmt.ShmObsChannel(spec, name=parent.name)
    try:
        rng = np.random.default_rng(0)
        obs = _obs(rng)
        seq = worker.write(obs)
        got = parent.read(seq)
        np.testing.assert_array_equal(got["rgb"], obs["rgb"])
        np.testing.assert_array_equal(got["depth"], obs["depth"])
        assert not got["rgb"].flags.writeable     # views are read-only
        # copies do not follow the next write
        copied = parent.read(seq, copy=True)
        seq2 = worker.write(_obs(rng))
        np.testing.assert_array_equal(copied["rgb"], obs["rgb"])
        with pytest.raises(RuntimeError, match="stale"):
            parent.read(seq)
        parent.read(seq2)
        bad = _obs(rng)
        bad["rgb"] = bad["rgb"][:2]
        with pytest.raises(ValueError, match="spec says"):
            worker.write(bad)
    finally:
        worker.close()
        parent.close()
    assert not _shm_exists(parent.name)


def test_encode_decode_result_matches_jax_tokens():
    spec, jspec = _spec(), _spec(jshmt)
    parent = shmt.ShmObsChannel(spec, create=True)
    worker = shmt.ShmObsChannel(spec, name=parent.name)
    jparent = jshmt.ShmObsChannel(jspec, create=True)
    jworker = jshmt.ShmObsChannel(jspec, name=jparent.name)
    try:
        rng = np.random.default_rng(1)
        obs = _obs(rng)
        # reset-style payload: [obs]; the same token as the JAX package's
        enc = shmt.encode_result(worker, [obs])
        jenc = jshmt.encode_result(jworker, [obs])
        assert enc[0][shmt.SHM_TOKEN] == jenc[0][jshmt.SHM_TOKEN] == 1
        assert shmt.SHM_TOKEN == jshmt.SHM_TOKEN
        dec = shmt.decode_result(parent, enc, copy=True)
        np.testing.assert_array_equal(dec[0]["rgb"], obs["rgb"])
        np.testing.assert_array_equal(dec[0]["instruction"],
                                      obs["instruction"])   # on the pipe
        # step-style payload: [StepResult]
        obs2 = _obs(rng)
        enc = shmt.encode_result(worker, [StepResult(obs2, True, {"k": 1})])
        dec = shmt.decode_result(parent, enc, copy=True)[0]
        assert dec.done and dec.info == {"k": 1}
        np.testing.assert_array_equal(dec.observation["depth"],
                                      obs2["depth"])
        arr = np.arange(3.0)
        assert shmt.encode_result(worker, arr) is arr
        with pytest.raises(RuntimeError, match="one observation"):
            shmt.encode_result(worker, [obs, obs2])
    finally:
        for c in (worker, parent, jworker, jparent):
            c.close()


def _roll(envs, steps=2):
    out = [envs.reset()]
    for _ in range(steps):
        res = envs.step_low_level([1] * envs.num_envs)
        out.append([(r.observation, r.done) for r in res])
    return out


def test_shm_pipe_equivalence():
    """The shm path equals the pickled pipe observation for observation,
    and both equal the JAX package's env on the same seeds."""
    pipe = construct_geometric_envs(2, seed=5, **SHM_KW)
    shm = construct_geometric_envs(2, seed=5, shm_obs=True, **SHM_KW)
    try:
        a, b = _roll(pipe), _roll(shm)
        for i, (oa, ob) in enumerate(zip(a[0], b[0])):
            want = JaxGeometricNavEnv(num_envs=1, seed=5000 + i,
                                      **SHM_KW).reset()[0]
            for k in ("rgb", "depth", "instruction"):
                np.testing.assert_array_equal(oa[k], ob[k])
                np.testing.assert_array_equal(ob[k], want[k])
        for ra, rb in zip(a[1:], b[1:]):
            for (oa, da), (ob, db) in zip(ra, rb):
                assert da == db
                np.testing.assert_array_equal(oa["rgb"], ob["rgb"])
                np.testing.assert_array_equal(oa["depth"], ob["depth"])
    finally:
        pipe.close()
        shm.close()


def test_zero_copy_views():
    envs = construct_geometric_envs(2, seed=9, shm_obs=True, shm_copy=False,
                                    **SHM_KW)
    try:
        obs = envs.reset()
        assert not obs[0]["rgb"].flags.writeable
        assert not obs[0]["depth"].flags.writeable
        frozen = obs[0]["rgb"].copy()
        # a view lives until the next command to its worker; the native
        # gather takes it before that
        batch = native.stack_arrays([o["rgb"] for o in obs])
        np.testing.assert_array_equal(batch[0], frozen)
        envs.step_low_level([1, 1])
        assert frozen.shape == obs[0]["rgb"].shape
    finally:
        envs.close()


def test_crash_recovery_with_shm_unlinks_the_dead_segment():
    envs = construct_geometric_envs(2, seed=3, shm_obs=True,
                                    restart_on_crash=True, **SHM_KW)
    try:
        envs.reset()
        before = _shm_names(envs)
        assert all(_shm_exists(n) for n in before)
        envs.inject_worker_crash(0)
        res = envs.step_low_level([1, 1])
        assert res[0].info.get("crashed") and res[0].done
        after = _shm_names(envs)
        # the crashed worker's segment is gone; the respawn has its own
        assert not _shm_exists(before[0]) and _shm_exists(after[0])
        assert after[0] != before[0] and after[1] == before[1]
        res = envs.step_low_level([1, 1])
        assert res[0].observation["rgb"].shape == (4, 16, 16, 3)
        assert not res[1].info.get("crashed")
    finally:
        envs.close()
    assert not any(_shm_exists(n) for n in before + after)


def test_native_stack_arrays_matches_np_stack_and_jax():
    rng = np.random.default_rng(2)
    arrays = [rng.integers(0, 255, (12, 24, 24, 3), np.uint8)
              for _ in range(5)]
    out = native.stack_arrays(arrays)
    np.testing.assert_array_equal(out, np.stack(arrays))
    np.testing.assert_array_equal(out, jnative.stack_arrays(arrays))
    dst = np.empty((5, 12, 24, 24, 3), np.uint8)
    native.stack_arrays(arrays, out=dst)
    np.testing.assert_array_equal(dst, np.stack(arrays))


def test_native_gather_copy_direct():
    assert native.get_io_lib() is not None   # make builds it when missing
    rng = np.random.default_rng(4)
    srcs = [np.ascontiguousarray(rng.random((7, 33)).astype(np.float32))
            for _ in range(3)]
    out = np.empty((3, 7, 33), np.float32)
    assert native.gather_copy(srcs, out)
    np.testing.assert_array_equal(out, np.stack(srcs))
    # above the library's 8 MB threshold the copy fans out over threads
    big = [rng.integers(0, 255, (3 << 20,), np.uint8) for _ in range(4)]
    out = np.empty((4, 3 << 20), np.uint8)
    assert native.gather_copy(big, out, nthreads=2)
    np.testing.assert_array_equal(out, np.stack(big))
    with pytest.raises(ValueError, match="layout"):
        native.gather_copy(srcs, np.empty((2, 7, 33), np.float32))
