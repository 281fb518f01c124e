"""Multi-process vectorized env pool (counterpart of
`etpnav_tpu/env/vector.py`).

habitat's VectorEnv worker infrastructure as `construct_envs` uses it
(common/env_utils.py:35-124): N worker processes, each owning one env,
behind the batched VectorNavEnv protocol, plus the ThreadedVectorEnv
debug fallback (`threaded=True`). Every per-step oracle call of the pool
is one round trip per worker.

Workers start from a forkserver by default, never by forking the
trainer: the trainer holds a CUDA context and, under `--pipeline-halves`,
a second thread that may hold a lock at the moment of a fork. The
factories travel by plain pickle (`GeometricEnvFactory`, the habitat
worker's `HabitatWorkerFactory`); a factory that pickle cannot move is
refused when the pool is built. A worker imports numpy and the env
modules only, never torch's CUDA side or the port's kernels.
"""

from __future__ import annotations

import contextlib
import importlib.machinery
import inspect
import multiprocessing as mp
import os
import pickle
import sys
import threading
from typing import Any, Callable, List, Sequence

import numpy as np

from etpnav_tpu_torch.env import shm_transport as shmt
from etpnav_tpu_torch.env.protocol import StepResult


def _worker_loop(conn, env_factory, shm_cfg=None):
    env = env_factory()
    chan = None
    if shm_cfg is not None:
        chan = shmt.ShmObsChannel(shm_cfg[1], name=shm_cfg[0])
    try:
        while True:
            try:
                cmd, payload = conn.recv()
            except EOFError:          # the parent is gone
                break
            if cmd == "close":
                conn.send(("ok", None))
                break
            if cmd == "die":
                # fault injection: exit hard like a crashing simulator
                # (no reply, no cleanup)
                os._exit(1)
            try:
                if cmd == "call":
                    name, args, kwargs = payload
                    res = getattr(env, name)(*args, **kwargs)
                elif cmd == "attr":
                    res = getattr(env, payload)
                else:
                    raise ValueError(cmd)
                if chan is not None:
                    res = shmt.encode_result(chan, res)
                conn.send(("ok", res))
            except Exception as e:   # noqa: BLE001 — surface to parent
                conn.send(("err", repr(e)))
    finally:
        if chan is not None:
            chan.close()
        conn.close()


_MAIN_LOCK = threading.Lock()
_WORKER_MAIN = "etpnav_tpu_torch.env.worker_main"


@contextlib.contextmanager
def _workers_skip_parent_main(factories):
    """While workers start, name `env/worker_main.py` as the parent's
    main module.

    A forkserver or spawn worker imports the parent's main module before
    it runs (CPython's forkserver never preloads it: it looks for a
    'main_path' key that its preparation data does not have). A training
    script imports torch at its top: ~1-2 s per worker, tens of seconds
    for a pool on a busy host. Skipped when a factory is defined in the
    main script itself, which the worker then needs."""
    main = sys.modules.get("__main__")
    if main is None or any(type(f).__module__ == "__main__"
                           for f in factories):
        yield
        return
    with _MAIN_LOCK:
        spec = getattr(main, "__spec__", None)
        main.__spec__ = importlib.machinery.ModuleSpec(_WORKER_MAIN, None)
        try:
            yield
        finally:
            main.__spec__ = spec


class ProcessVectorEnv:
    """Pool of single-env workers behind the batched VectorNavEnv API."""

    def __init__(self, env_factories: Sequence[Callable], *,
                 threaded: bool = False, context: str = "forkserver",
                 restart_on_crash: bool = False, max_restarts: int = 3,
                 restart_decay_calls: int = 200,
                 shm_obs_spec=None, shm_copy: bool = True):
        """context: "forkserver" (the default) or "spawn" start each
        worker, and each respawn, in a fresh process, so nothing the
        parent holds (a CUDA context, a lock of another thread) reaches
        it; the factories then travel by plain pickle. "fork" forks the
        parent and takes any callable; use it only before the parent
        touches the device or starts threads.

        restart_on_crash: a worker that dies mid-call is respawned from
        its factory; step/reset calls to it return a StepResult with
        done=True and info={'crashed': True}, so the trainer ends and
        drops that episode while the pool keeps serving. Oracle calls on
        a dead worker raise after the respawn. The budget bounds the
        crash rate, not lifetime crashes: a slot may respawn at most
        `max_restarts` times, and after `restart_decay_calls` successful
        replies since its last crash the count resets.

        shm_obs_spec: an `shm_transport.ObsSpec` routing the fixed-shape
        observation arrays through per-worker shared memory instead of
        the pickled pipe (control stays on the pipe). With
        shm_copy=False the parent gets read-only views valid only until
        the next command to that worker (the rollout stacks them at
        once); the default copies them out. Ignored in threaded mode."""
        self._n = len(env_factories)
        self._threaded = threaded
        self._live = list(range(self._n))
        self._factories = list(env_factories)
        self._context = context
        self._restart_on_crash = restart_on_crash
        self._max_restarts = max_restarts
        self._restart_decay_calls = restart_decay_calls
        self._restarts = [0] * self._n
        self._ok_calls = [0] * self._n   # successful replies since crash
        self._shm_spec = None if threaded else shm_obs_spec
        self._shm_copy = shm_copy
        self._shm_channels = [None] * self._n
        self._pending = None
        self._async_dead = set()
        if threaded:
            # ThreadedVectorEnv-style debug fallback: in-process envs
            self._envs = [f() for f in env_factories]
            return
        if context != "fork":
            for i, f in enumerate(self._factories):
                try:
                    pickle.dumps(f)
                except (pickle.PicklingError, AttributeError,
                        TypeError) as e:
                    raise TypeError(
                        f"env factory {i} ({f!r}) cannot travel by plain "
                        f"pickle to a {context!r} worker ({e}); pass a "
                        "picklable factory such as GeometricEnvFactory, "
                        "or context='fork' before the parent touches the "
                        "device") from e
            if context == "forkserver":
                # the server imports this module once; each worker forks
                # from it with numpy and the env modules already loaded
                mp.set_forkserver_preload([__name__])
        self._conns = [None] * self._n
        self._procs = [None] * self._n
        for i in range(self._n):
            self._spawn(i)

    def _spawn(self, i: int):
        ctx = mp.get_context(self._context)
        parent, child = ctx.Pipe()
        shm_cfg = None
        if self._shm_spec is not None:
            self._shm_channels[i] = shmt.ShmObsChannel(self._shm_spec,
                                                       create=True)
            shm_cfg = (self._shm_channels[i].name, self._shm_spec)
        p = ctx.Process(target=_worker_loop,
                        args=(child, self._factories[i], shm_cfg),
                        daemon=True)
        if self._context == "fork":
            p.start()
        else:
            with _workers_skip_parent_main([self._factories[i]]):
                p.start()
        child.close()
        self._conns[i] = parent
        self._procs[i] = p

    def _decode(self, i: int, res):
        chan = self._shm_channels[i]
        if chan is None:
            return res
        return shmt.decode_result(chan, res, copy=self._shm_copy)

    # ---- failure detection / elastic recovery ----

    def _restart_worker(self, i: int):
        self._ok_calls[i] = 0
        self._restarts[i] += 1
        if self._restarts[i] > self._max_restarts:
            raise RuntimeError(
                f"worker {i} exceeded {self._max_restarts} restarts")
        try:
            self._conns[i].close()
        except OSError:
            pass
        self._procs[i].terminate()
        self._procs[i].join(timeout=5)
        if self._shm_channels[i] is not None:
            # the dead worker's segment goes; the respawn gets a fresh one
            self._shm_channels[i].close()
            self._shm_channels[i] = None
        self._spawn(i)

    def _crash_step_result(self, i: int) -> List[StepResult]:
        """Respawn worker i and return an episode-ending result shaped
        like the worker's own step reply (a 1-element list); the fresh
        worker is reset, so the slot is usable at once."""
        self._restart_worker(i)
        obs = self._call_workers([i], "reset")[0][0]
        return [StepResult(obs, True, {"crashed": True})]

    def _crash_reset_result(self, i: int):
        self._restart_worker(i)
        return self._call_workers([i], "reset")[0]

    def inject_worker_crash(self, env_idx: int):
        """Fault injection: hard-kill the worker behind live slot
        env_idx. The next step/reset on it detects and recovers."""
        if self._threaded:
            raise RuntimeError("no workers to crash in threaded mode")
        self._conns[self._live[env_idx]].send(("die", None))

    # ---- fan-out plumbing ----

    def _call_workers(self, idxs: List[int], name: str, args_list=None,
                      kwargs_list=None, crash_result=None) -> List[Any]:
        """crash_result: optional (i) -> substitute value, which enables
        recovery for this call; without one a dead worker raises (after
        a respawn, if recovery is on)."""
        args_list = args_list or [()] * len(idxs)
        kwargs_list = kwargs_list or [{}] * len(idxs)
        if self._threaded:
            return [getattr(self._envs[i], name)(*a, **k)
                    for i, a, k in zip(idxs, args_list, kwargs_list)]
        dead = set()
        for i, a, k in zip(idxs, args_list, kwargs_list):
            try:
                self._conns[i].send(("call", (name, a, k)))
            except (BrokenPipeError, OSError):
                dead.add(i)
        # drain every surviving worker's reply before any error handling:
        # raising mid-loop would leave buffered replies that desync the
        # protocol for every later call
        replies = {}
        for i in idxs:
            if i in dead:
                continue
            try:
                replies[i] = self._conns[i].recv()
            except (EOFError, OSError):
                dead.add(i)
        if dead:
            if not self._restart_on_crash:
                raise RuntimeError(
                    f"workers {sorted(dead)} died during {name!r}")
            if crash_result is None:
                for i in sorted(dead):
                    self._restart_worker(i)
                raise RuntimeError(
                    f"workers {sorted(dead)} died during {name!r} "
                    "(respawned; no substitute value for this call — "
                    "reset before reuse)")
        out = []
        for i in idxs:
            if i in dead:
                out.append(crash_result(i))
                continue
            status, res = replies[i]
            if status == "err":
                raise RuntimeError(f"worker {i}: {res}")
            self._record_ok(i)
            out.append(self._decode(i, res))
        return out

    def _record_ok(self, i: int):
        self._ok_calls[i] += 1
        if (self._restarts[i]
                and self._ok_calls[i] >= self._restart_decay_calls):
            self._restarts[i] = 0

    # ---- VectorNavEnv protocol ----

    @property
    def num_envs(self) -> int:
        return len(self._live)

    def pause_at(self, idx: int):
        self._live.pop(idx)

    def resume_all(self):
        self._live = list(range(self._n))

    def reset(self):
        obs = self._call_workers(self._live, "reset",
                                 crash_result=self._crash_reset_result)
        return [o[0] for o in obs]

    def step(self, actions) -> List[StepResult]:
        res = self._call_workers(self._live, "step",
                                 [([a],) for a in actions],
                                 crash_result=self._crash_step_result)
        return [r[0] for r in res]

    def step_low_level(self, actions) -> List[StepResult]:
        res = self._call_workers(self._live, "step_low_level",
                                 [([a],) for a in actions],
                                 crash_result=self._crash_step_result)
        return [r[0] for r in res]

    def current_episodes(self):
        eps = self._call_workers(self._live, "current_episodes")
        return [e[0] for e in eps]

    def get_pos_ori(self):
        outs = self._call_workers(self._live, "get_pos_ori")
        return (np.concatenate([o[0] for o in outs]),
                np.concatenate([o[1] for o in outs]))

    def current_dist_to_goal(self) -> np.ndarray:
        return np.concatenate(self._call_workers(self._live,
                                                 "current_dist_to_goal"))

    def progress(self) -> np.ndarray:
        """Batched VLNOracleProgressSensor equivalent (sensors.py:116)."""
        return np.concatenate(self._call_workers(self._live, "progress"))

    def point_dist_to_goal(self, env_idx: int, pos) -> float:
        return self._call_workers([self._live[env_idx]],
                                  "point_dist_to_goal", [(0, pos)])[0]

    def point_dists_to_goal(self, env_idx: int, positions) -> np.ndarray:
        return self._call_workers([self._live[env_idx]],
                                  "point_dists_to_goal",
                                  [(0, positions)])[0]

    def cand_real_pos(self, env_idx: int, angles, distances) -> np.ndarray:
        return self._call_workers([self._live[env_idx]], "cand_real_pos",
                                  [(0, angles, distances)])[0]

    def cand_real_pos_batch(self, angles_list, distances_list
                            ) -> List[np.ndarray]:
        """One fan-out for every live env's candidate oracle (the
        reference's per-env call_at loop, ss_trainer_ETP.py:853-859)."""
        return self._call_workers(
            self._live, "cand_real_pos",
            [(0, a, d) for a, d in zip(angles_list, distances_list)])

    def ghost_dist_to_ref(self, env_idx: int, ghost_positions,
                          ref_path) -> int:
        return self._call_workers(
            [self._live[env_idx]], "ghost_dist_to_ref",
            [(0, ghost_positions, ref_path)])[0]

    def shortest_path_action(self, env_idx: int) -> int:
        return self._call_workers([self._live[env_idx]],
                                  "shortest_path_action", [(0,)])[0]

    # ---- async stepping ----

    def step_async(self, actions):
        if self._threaded:
            self._pending = [self._envs[i].step([a])[0]
                             for i, a in zip(self._live, actions)]
            return
        self._async_dead = set()
        for i, a in zip(self._live, actions):
            try:
                self._conns[i].send(("call", ("step", ([a],), {})))
            except (BrokenPipeError, OSError):
                self._async_dead.add(i)

    def step_wait(self) -> List[StepResult]:
        if self._threaded:
            out, self._pending = self._pending, None
            return out
        # drain every surviving worker's reply first (see _call_workers)
        replies = {}
        dead = set(self._async_dead)
        for i in self._live:
            if i in dead:
                continue
            try:
                replies[i] = self._conns[i].recv()
            except (EOFError, OSError):
                dead.add(i)
        out = []
        for i in self._live:
            if i in dead:
                if not self._restart_on_crash:
                    raise RuntimeError(f"worker {i} died during 'step'")
                out.append(self._crash_step_result(i)[0])
                continue
            status, res = replies[i]
            if status == "err":
                raise RuntimeError(f"worker {i}: {res}")
            self._record_ok(i)
            out.append(self._decode(i, res)[0])
        return out

    def close(self):
        """Stop every worker and unlink every shared-memory segment."""
        if self._threaded:
            return
        for c in self._conns:
            try:
                c.send(("close", None))
                c.recv()
            except (BrokenPipeError, EOFError, OSError):
                pass
        for p in self._procs:
            p.join(timeout=5)
            if p.is_alive():
                p.terminate()
                p.join(timeout=5)
        for i, ch in enumerate(self._shm_channels):
            if ch is not None:
                ch.close()
                self._shm_channels[i] = None


class GeometricEnvFactory:
    """A single-env factory that plain pickle moves (the worker target
    of a forkserver or spawn pool)."""

    def __init__(self, seed: int, env_kwargs: dict):
        self.seed = seed
        self.env_kwargs = env_kwargs

    def __call__(self):
        from etpnav_tpu_torch.env.geometric import GeometricNavEnv
        return GeometricNavEnv(num_envs=1, seed=self.seed,
                               **self.env_kwargs)


def geometric_obs_spec(env_kwargs: dict) -> shmt.ObsSpec:
    """ObsSpec of GeometricNavEnv's fixed-shape observation arrays (rgb
    and depth; the short instruction rides the pipe)."""
    from etpnav_tpu_torch.env.geometric import GeometricNavEnv
    sig = inspect.signature(GeometricNavEnv.__init__)

    def val(name):
        return env_kwargs.get(name, sig.parameters[name].default)

    v, s, d = val("num_views"), val("image_size"), val("depth_size")
    return shmt.ObsSpec({"rgb": ((v, s, s, 3), np.uint8),
                         "depth": ((v, d, d, 1), np.float32)})


def construct_geometric_envs(num_envs: int, *, workers: bool = True,
                             seed: int = 0, restart_on_crash: bool = False,
                             shm_obs: bool = False, shm_copy: bool = True,
                             **env_kwargs):
    """construct_envs for the geometric world: one worker per env slot
    with disjoint seeds (the scene sharding analogue)."""
    if not workers:
        from etpnav_tpu_torch.env.geometric import GeometricNavEnv
        return GeometricNavEnv(num_envs=num_envs, seed=seed, **env_kwargs)
    return ProcessVectorEnv(
        [GeometricEnvFactory(seed * 1000 + i, env_kwargs)
         for i in range(num_envs)],
        restart_on_crash=restart_on_crash,
        shm_obs_spec=geometric_obs_spec(env_kwargs) if shm_obs else None,
        shm_copy=shm_copy)
