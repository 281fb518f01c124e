"""Legacy DAgger trainers: the CMA low-level policy and the recurrent
VLN-BERT over waypoint candidates (counterpart of
`etpnav_tpu/training/dagger.py`).

Capability target: vlnce_baselines/dagger_trainer.py:187-629 — beta-
scheduled DAgger: collect rollouts with an expert/policy mixture, persist
(features, teacher-action) steps to an on-disk store, then run supervised
epochs over the store — plus the simulator-replay variant
(common/recollection_dataset.py:22). The reference's lmdb+msgpack capture
(fp16 through forward hooks, dagger_trainer.py:373-419) becomes a store
of the frozen encoders' features (the quantity its hooks captured),
written by the one trainer process.

The store's shards are numpy `.npz` files read with `allow_pickle=False`
(the JAX package writes msgpack); values are stored as there: float
arrays in fp16, every other array as it is.

One numpy generator per trainer, `np.random.default_rng(seed)`, feeds
both the beta-mixing draws of `collect` and the epoch permutations of
`update`, in the JAX package's call order, so one seed gives both
packages the same stream. Dropout (VLN-BERT's update) draws from the
trainer's `torch.Generator` on its device. The optimizer is Adam over the
whole policy (optax.adam: betas 0.9/0.999, eps 1e-8).

Shapes stay fixed as in the JAX package: `collect` and `evaluate` run
their device programs at the env pool's full B, finished envs riding as
padding rows on their last observation; `update` pads every batch to the
store-wide T and token width, the last batch with masked duplicate rows,
so each `update()` launches one shape (`shapes` records them).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Iterator, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from etpnav_tpu_torch.device import resolve_device
from etpnav_tpu_torch.models import cma
from etpnav_tpu_torch.models import rec_vlnbert as rvb
from etpnav_tpu_torch.models.cma import CMAConfig, CMAParams
from etpnav_tpu_torch.models.rec_vlnbert import RecVLNBertParams


# ---------------------------------------------------------------------------
# feature store (lmdb replacement)
# ---------------------------------------------------------------------------

class TrajectoryStore:
    """Sharded trajectory store: one `.npz` shard per flush, each holding
    its records' arrays under `<record>.<key>`. Float values are stored
    fp16 like the reference's fp16 lmdb records (dagger_trainer.py:
    388-419); every other array keeps its dtype."""

    def __init__(self, path: str, flush_every: int = 64):
        self.path = path
        os.makedirs(path, exist_ok=True)
        self.flush_every = flush_every
        self._pending: List[Dict[str, np.ndarray]] = []
        self._count = len(self.shard_files())

    def shard_files(self) -> List[str]:
        return sorted(
            os.path.join(self.path, f) for f in os.listdir(self.path)
            if f.endswith(".npz"))

    def append(self, traj: Dict[str, np.ndarray]):
        rec = {}
        for k, v in traj.items():
            v = np.asarray(v)
            rec[k] = v.astype(np.float16) if v.dtype.kind == "f" else v
        self._pending.append(rec)
        if len(self._pending) >= self.flush_every:
            self.flush()

    def flush(self):
        if not self._pending:
            return
        fname = os.path.join(self.path, f"shard{self._count:06d}.npz")
        arrays = {f"{i}.{k}": v for i, rec in enumerate(self._pending)
                  for k, v in rec.items()}
        with open(fname + ".tmp", "wb") as f:
            np.savez(f, **arrays)
        os.replace(fname + ".tmp", fname)
        self._count += 1
        self._pending = []

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        for fname in self.shard_files():
            recs: Dict[int, Dict[str, np.ndarray]] = {}
            with np.load(fname, allow_pickle=False) as z:
                for name in z.files:
                    i, k = name.split(".", 1)
                    recs.setdefault(int(i), {})[k] = z[name]
            for i in sorted(recs):
                yield recs[i]

    def __len__(self) -> int:
        return sum(1 for _ in self)


# ---------------------------------------------------------------------------
# trainers
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DaggerConfig:
    iterations: int = 3            # DAgger outer iterations
    episodes_per_iter: int = 8
    epochs: int = 2                # supervised epochs per iteration
    batch_size: int = 4
    lr: float = 2.5e-4
    p: float = 0.75                # beta = p ** iteration (dagger_trainer)
    max_steps: int = 60
    preload_size: int = 1024


def make_adam(params: torch.nn.Module, lr: float) -> torch.optim.Adam:
    """optax.adam(lr): betas 0.9/0.999, eps 1e-8 outside the root."""
    return torch.optim.Adam(params.parameters(), lr=lr, betas=(0.9, 0.999),
                            eps=1e-8)


def masked_nll(logits: torch.Tensor, teacher: torch.Tensor,
               step_mask: torch.Tensor) -> torch.Tensor:
    """(B, T, A) logits, (B, T) teacher actions and step mask -> the mean
    teacher-action cross-entropy over the live steps."""
    logp = F.log_softmax(logits, dim=-1)
    nll = -logp.gather(-1, teacher.long()[..., None])[..., 0]
    nll = torch.where(step_mask, nll, 0.0)
    return nll.sum() / torch.clamp_min(step_mask.sum(), 1)


def cma_sequence_nll(params: CMAParams, cfg: CMAConfig,
                     tokens: torch.Tensor, rgb: torch.Tensor,
                     dep: torch.Tensor, teacher: torch.Tensor,
                     step_mask: torch.Tensor) -> torch.Tensor:
    """Supervised CE over a batch of trajectories (B, T, ...): the
    recurrence over T as the online decision path."""
    instr, imask = cma.encode_instruction(params, cfg, tokens)
    state = cma.initial_state(cfg, teacher.shape[0], device=rgb.device)
    logits = []
    for t in range(teacher.shape[1]):
        lg, state = cma.cma_step(params, cfg, instr, imask, rgb[:, t],
                                 dep[:, t], state)
        logits.append(lg)
    return masked_nll(torch.stack(logits, dim=1), teacher, step_mask)


def adam_step(optimizer: torch.optim.Optimizer, loss_fn) -> torch.Tensor:
    """Loss, backward and one optimizer step; the detached loss."""
    optimizer.zero_grad(set_to_none=True)
    loss = loss_fn()
    loss.backward()
    optimizer.step()
    return loss.detach()


class _DaggerLoop:
    """What both trainers share: the outer loop, the epochs of the
    supervised update over the store, and the env pool's shutdown. A
    trainer provides `collect`, `update_batches` and `update_step`."""

    def _t(self, x, dtype=None) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x), dtype=dtype,
                               device=self.device)

    # ---- supervised update (dagger_trainer.py:421-533) ----

    def update(self, epochs: Optional[int] = None) -> float:
        epochs = epochs or self.dcfg.epochs
        trajs = list(self.store)
        if not trajs:
            return float("nan")
        losses = []
        self.shapes["update"] = set()
        for _ in range(epochs):
            order = self.rng.permutation(len(trajs))
            for batch in self.update_batches(trajs, order):
                losses.append(float(self.update_step(batch)))
        return float(np.mean(losses))

    def train(self) -> List[float]:
        """DAgger outer loop: beta = p ** iteration
        (dagger_trainer.py:535-629)."""
        losses = []
        for it in range(self.dcfg.iterations):
            beta = self.dcfg.p ** it
            self.collect(beta, self.dcfg.episodes_per_iter)
            losses.append(self.update())
        return losses

    def close(self):
        """Stop the env pool's worker processes, if it has any."""
        if hasattr(self.envs, "close"):
            self.envs.close()


def _live_rows(envs, live: List[int], results: list, trajs: list) -> None:
    """Pause the envs that finished this step (marking a crashed worker's
    trajectory, which the store then drops, as rollout and eval do) and
    drop them from `live` and `results`, in place."""
    done_local = [i for i, r in enumerate(results) if r.done]
    for i in done_local:
        if trajs is not None and results[i].info.get("crashed"):
            trajs[live[i]]["crashed"] = True
    for i in reversed(done_local):
        envs.pause_at(i)
        live.pop(i)
        results.pop(i)


class DaggerTrainer(_DaggerLoop):
    """beta-scheduled DAgger over the low-level action space (CMA).

    Runs on the GPU unless `device="cpu"` is passed."""

    def __init__(self, envs, cma_cfg: CMAConfig, dagger_cfg: DaggerConfig,
                 feature_fn, store_dir: str, seed: int = 0, device="cuda"):
        """feature_fn(obs_batch) -> (rgb_feat (B, Dr), dep_feat (B, Dd))
        numpy: typically the frozen CLIP/depth encoders pooled over the
        forward view (the reference captures these with forward hooks,
        dagger_trainer.py:255-266)."""
        self.envs = envs
        self.cfg = cma_cfg
        self.dcfg = dagger_cfg
        self.feature_fn = feature_fn
        self.device = resolve_device(device)
        self.store = TrajectoryStore(store_dir)
        self.params = cma.init_cma_params(cma_cfg, seed).to(self.device)
        self.optimizer = make_adam(self.params, dagger_cfg.lr)
        self.rng = np.random.default_rng(seed)
        self.shapes: Dict[str, set] = {"step": set(), "update": set()}

    # ---- collection (dagger_trainer.py:233-419) ----

    @torch.no_grad()
    def collect(self, beta: float, episodes: int):
        envs, cfg = self.envs, self.cfg
        collected = 0
        while collected < episodes:
            envs.resume_all()
            obs = envs.reset()
            B = envs.num_envs
            tokens = np.stack([o["instruction"] for o in obs])
            instr, imask = cma.encode_instruction(self.params, cfg,
                                                  self._t(tokens))
            state = cma.initial_state(cfg, B, device=self.device)
            trajs = [dict(tokens=tokens[i], rgb=[], dep=[], teacher=[])
                     for i in range(B)]
            # fixed B for the whole interval: finished envs keep their
            # last observation as a padding row (recurrent rows are
            # independent per sample, so live rows are unaffected)
            live = list(range(B))            # global env id per live slot
            obs_full = list(obs)             # last obs per GLOBAL env

            for _ in range(self.dcfg.max_steps):
                rgb_f, dep_f = self.feature_fn(obs_full)       # (B, D)
                teach_full = np.zeros(B, np.int64)
                for i, g in enumerate(live):
                    teach_full[g] = envs.shortest_path_action(i)
                self.shapes["step"].add((B,) + tuple(np.shape(rgb_f)[1:]))
                logits, state = cma.cma_step(
                    self.params, cfg, instr, imask,
                    self._t(rgb_f, torch.float32),
                    self._t(dep_f, torch.float32), state)
                probs = torch.softmax(logits, -1).cpu().numpy()
                acts_full = np.where(
                    self.rng.random(B) < beta, teach_full,
                    np.array([self.rng.choice(4, p=probs[g])
                              for g in range(B)]))
                for g in live:
                    t = trajs[g]
                    t["rgb"].append(rgb_f[g])
                    t["dep"].append(dep_f[g])
                    t["teacher"].append(int(teach_full[g]))
                results = envs.step_low_level(
                    [int(acts_full[g]) for g in live])
                _live_rows(envs, live, results, trajs)
                if envs.num_envs == 0:
                    break
                for i, r in enumerate(results):
                    obs_full[live[i]] = r.observation

            for t in trajs:
                if t["rgb"] and not t.get("crashed"):
                    self.store.append({
                        "tokens": t["tokens"],
                        "rgb": np.stack(t["rgb"]),
                        "dep": np.stack(t["dep"]),
                        "teacher": np.asarray(t["teacher"], np.int32),
                    })
                    collected += 1
        self.store.flush()

    def update_batches(self, trajs: list, order: np.ndarray) -> Iterator:
        """The padded numpy batches of one epoch in `order`: (tokens,
        rgb, depth, teacher, step mask), at the store-wide T. The last
        partial batch is padded to the full batch size with duplicate
        rows whose step masks are cleared."""
        B = self.dcfg.batch_size
        T = max(len(t["teacher"]) for t in trajs)
        for s in range(0, len(order), B):
            batch = [trajs[i] for i in order[s:s + B]]
            n_real = len(batch)
            batch = batch + [batch[-1]] * (B - n_real)
            tokens = np.stack([b["tokens"] for b in batch])
            rgb = np.zeros((B, T, batch[0]["rgb"].shape[-1]), np.float32)
            dep = np.zeros((B, T, batch[0]["dep"].shape[-1]), np.float32)
            teach = np.zeros((B, T), np.int32)
            mask = np.zeros((B, T), bool)
            for i, b in enumerate(batch):
                n = len(b["teacher"])
                rgb[i, :n] = b["rgb"]
                dep[i, :n] = b["dep"]
                teach[i, :n] = b["teacher"]
                mask[i, :n] = True
            mask[n_real:] = False            # padding rows carry no loss
            yield tokens, rgb, dep, teach, mask

    def update_step(self, batch) -> torch.Tensor:
        """One Adam step on a numpy batch of `update_batches`; the
        detached loss (on the device)."""
        self.shapes["update"].add(batch[1].shape + batch[0].shape[1:])
        args = [self._t(a) for a in batch]
        return adam_step(self.optimizer, lambda: cma_sequence_nll(
            self.params, self.cfg, *args))


class RecVLNBertDagger(_DaggerLoop):
    """DAgger over the waypoint-candidate action space, driving the
    recurrent VLN-BERT policy (models/rec_vlnbert.py). Runs on the GPU
    unless `device="cpu"` is passed.

    Capability target: the reference dagger_trainer's candidate-space
    path — mode='language' once, then per step mode='waypoint' candidates
    + mode='navigation' logits with an oracle candidate teacher
    (dagger_trainer.py:247-302, oracle via cand_real_pos + dist-to-goal,
    environments.py:121-143,241-260). Candidate slot 0 is STOP (the
    teacher picks it inside the stop-trigger radius, ss_trainer_ETP.py:283
    semantics); motion slots execute as act-4 teleport steps.

    candidate_fn(obs) -> dict with numpy arrays:
      rgb (B, K-1, rgb_dim), depth (B, K-1, depth_dim),
      ang (B, K-1, 4) [sin/cos heading, sin/cos elevation],
      angles (B, K-1) ccw radians, dists (B, K-1) meters,
      mask (B, K-1) valid slots
    — in production the waypoint predictor's NMS output; tests use a
    cheap geometric proposer.
    """

    STOP_TRIGGER_M = 1.5

    def __init__(self, envs, cfg: rvb.RecVLNBertConfig,
                 dagger_cfg: DaggerConfig, candidate_fn, store_dir: str,
                 seed: int = 0, device="cuda"):
        self.envs = envs
        self.cfg = cfg
        self.dcfg = dagger_cfg
        self.candidate_fn = candidate_fn
        self.device = resolve_device(device)
        self.store = TrajectoryStore(store_dir)
        self.params: RecVLNBertParams = rvb.init_params(cfg, seed).to(
            self.device)
        self.optimizer = make_adam(self.params, dagger_cfg.lr)
        self.rng = np.random.default_rng(seed)
        # the update's dropout draws, on the training device
        self.generator = torch.Generator(
            device=self.device).manual_seed(seed + 1)
        self.shapes: Dict[str, set] = {"nav": set(), "update": set()}

    @torch.no_grad()
    def _lang(self, tokens: np.ndarray):
        """(state, lang_feats, lang_mask) of an instruction batch."""
        lmask = self._t(tokens != self.cfg.pad_token_id)
        state, feats = rvb.encode_language(self.params, self.cfg,
                                           self._t(tokens).long(), lmask)
        return state, feats, lmask

    @torch.no_grad()
    def _nav(self, state, feats, lmask, rgb, dep, ang, cmask):
        """One inference-mode navigation decision on numpy candidates."""
        self.shapes["nav"].add(rgb.shape)
        f32 = torch.float32
        return rvb.nav_step(self.params, self.cfg, state, feats, lmask,
                            self._t(rgb, f32), self._t(dep, f32),
                            self._t(ang, f32), self._t(cmask))

    @staticmethod
    def _env_action(a: int, pos_i, tgt):
        """Candidate index -> env-layer action dict (act 0 stop / act 4
        teleport-to-candidate; environments.py:436-477 semantics)."""
        if a == 0:
            return {"act": 0, "stop_pos": pos_i, "back_path": None}
        return {"act": 4, "front_pos": pos_i, "ghost_pos": tgt,
                "back_path": None}

    def _assemble_slots(self, cand):
        """Prepend the STOP slot (zero features, always valid)."""
        B = cand["rgb"].shape[0]

        def z(a):
            return np.concatenate(
                [np.zeros((B, 1) + a.shape[2:], a.dtype), a], axis=1)

        rgb, dep, ang = z(cand["rgb"]), z(cand["depth"]), z(cand["ang"])
        mask = np.concatenate(
            [np.ones((B, 1), bool), cand["mask"]], axis=1)
        return rgb, dep, ang, mask

    def _teacher(self, cand):
        """Oracle candidate index per live env: STOP inside the trigger
        radius, STOP when no motion candidate is valid, else the
        candidate whose simulated endpoint is geodesically closest to the
        goal (dagger_trainer.py:210-230). Returns (teach (n,), all_pos:
        per-env (K, 3) simulated endpoints), so callers reuse the
        simulation. The candidates are simulated in one fan-out
        (cand_real_pos_batch) where the pool has it, and the goal
        distances are one oracle call per env."""
        envs = self.envs
        n = envs.num_envs
        cur = envs.current_dist_to_goal()
        if hasattr(envs, "cand_real_pos_batch"):
            all_pos = envs.cand_real_pos_batch(
                [cand["angles"][i] for i in range(n)],
                [cand["dists"][i] for i in range(n)])
        else:
            all_pos = [envs.cand_real_pos(i, cand["angles"][i],
                                          cand["dists"][i])
                       for i in range(n)]
        teach = np.zeros(n, np.int64)
        for i in range(n):
            if cur[i] < self.STOP_TRIGGER_M:
                continue                       # STOP slot 0
            valid = np.flatnonzero(cand["mask"][i])
            if valid.size == 0:
                continue                       # nowhere to go -> STOP
            dg = envs.point_dists_to_goal(i, all_pos[i][valid])
            teach[i] = 1 + valid[int(np.argmin(dg))]
        return teach, all_pos

    def collect(self, beta: float, episodes: int):
        envs = self.envs
        collected = 0
        while collected < episodes:
            envs.resume_all()
            obs = envs.reset()
            B = envs.num_envs
            tokens = np.stack([o["instruction"] for o in obs])
            state, feats, lmask = self._lang(tokens)
            trajs = [dict(tokens=tokens[i], rgb=[], dep=[], ang=[],
                          cmask=[], teacher=[]) for i in range(B)]
            # candidate extraction and the nav step run at fixed B the
            # whole interval; finished envs keep their last observation
            # as a padding row. Teacher and env queries are live-only
            # (the pool reindexes after pause_at).
            live = list(range(B))            # global env id per live slot
            obs_full = list(obs)             # last obs per GLOBAL env

            for _ in range(self.dcfg.max_steps):
                cand = self.candidate_fn(obs_full)             # (B, ...)
                rgb, dep, ang, cmask = self._assemble_slots(cand)
                cand_live = {
                    k: (v[np.asarray(live)] if isinstance(v, np.ndarray)
                        else [v[g] for g in live])
                    for k, v in cand.items()}
                teach_live, cand_pos = self._teacher(cand_live)
                logits, state = self._nav(state, feats, lmask, rgb, dep,
                                          ang, cmask)
                policy_act = logits.argmax(-1).cpu().numpy()
                mix = self.rng.random(B) < beta
                acts = [int(teach_live[i]) if mix[g]
                        else int(policy_act[g])
                        for i, g in enumerate(live)]
                for i, g in enumerate(live):
                    t = trajs[g]
                    t["rgb"].append(rgb[g])
                    t["dep"].append(dep[g])
                    t["ang"].append(ang[g])
                    t["cmask"].append(cmask[g])
                    t["teacher"].append(int(teach_live[i]))
                pos, _ = envs.get_pos_ori()
                env_actions = [
                    self._env_action(a, pos[i],
                                     cand_pos[i][a - 1] if a else None)
                    for i, a in enumerate(acts)]
                results = envs.step(env_actions)
                _live_rows(envs, live, results, trajs)
                if envs.num_envs == 0:
                    break
                for i, r in enumerate(results):
                    obs_full[live[i]] = r.observation

            for t in trajs:
                if t["teacher"] and not t.get("crashed"):
                    self.store.append({
                        "tokens": t["tokens"],
                        "rgb": np.stack(t["rgb"]),
                        "dep": np.stack(t["dep"]),
                        "ang": np.stack(t["ang"]),
                        "cmask": np.stack(t["cmask"]),
                        "teacher": np.asarray(t["teacher"], np.int32),
                    })
                    collected += 1
        self.store.flush()

    def update_batches(self, trajs: list, order: np.ndarray) -> Iterator:
        """The padded numpy batches of one epoch in `order`: (tokens,
        lang mask, rgb, depth, ang, cand mask, teacher, step mask), at the
        store-wide T and token width."""
        cfg, B = self.cfg, self.dcfg.batch_size
        T = max(len(t["teacher"]) for t in trajs)
        K = trajs[0]["rgb"].shape[1]
        Lmax = max(len(t["tokens"]) for t in trajs)
        for s in range(0, len(order), B):
            batch = [trajs[i] for i in order[s:s + B]]
            n_real = len(batch)
            batch = batch + [batch[-1]] * (B - n_real)
            tokens = np.full((B, Lmax), cfg.pad_token_id, np.int64)
            rgb = np.zeros((B, T, K, cfg.rgb_dim), np.float32)
            dep = np.zeros((B, T, K, cfg.depth_dim), np.float32)
            ang = np.zeros((B, T, K, cfg.angle_dim), np.float32)
            cmask = np.zeros((B, T, K), bool)
            teach = np.zeros((B, T), np.int32)
            smask = np.zeros((B, T), bool)
            for i, b in enumerate(batch):
                n = len(b["teacher"])
                tokens[i, :len(b["tokens"])] = b["tokens"]
                rgb[i, :n] = b["rgb"]
                dep[i, :n] = b["dep"]
                ang[i, :n] = b["ang"]
                cmask[i, :n] = b["cmask"]
                teach[i, :n] = b["teacher"]
                smask[i, :n] = True
            smask[n_real:] = False           # padding rows carry no loss
            # padded steps need >= 1 valid candidate slot for a finite
            # log-softmax (their loss rows are masked out anyway)
            cmask[:, :, 0] = True
            yield (tokens, tokens != cfg.pad_token_id, rgb, dep, ang, cmask,
                   teach, smask)

    def update_step(self, batch) -> torch.Tensor:
        """One Adam step on a numpy batch of `update_batches`; the
        detached loss (on the device)."""
        self.shapes["update"].add(batch[2].shape + batch[0].shape[1:])
        args = [self._t(a) for a in batch]
        return adam_step(self.optimizer, lambda: rvb.sequence_nll(
            self.params, self.cfg, *args, generator=self.generator,
            train=True))

    def evaluate(self, episodes: int,
                 success_distance: float = 3.0) -> dict:
        """Greedy-policy eval with SR/SPL/nDTW over env-side measures —
        the legacy path's eval mode (base_il_trainer.py:774-889 drives
        the same rollout with metric collection)."""
        from etpnav_tpu_torch.metrics import aggregate, episode_metrics
        envs = self.envs
        stats: dict = {}
        guard = 0
        while len(stats) < episodes and guard < 10 * episodes:
            guard += 1
            envs.resume_all()
            obs = envs.reset()
            B = envs.num_envs
            eps = envs.current_episodes()
            tokens = np.stack([o["instruction"] for o in obs])
            state, feats, lmask = self._lang(tokens)
            # fixed-B nav program, finished envs riding as padding rows
            # on their last observation (as in collect)
            live = list(range(B))
            obs_full = list(obs)
            for stepk in range(self.dcfg.max_steps):
                cand = self.candidate_fn(obs_full)             # (B, ...)
                rgb, dep, ang, cmask = self._assemble_slots(cand)
                logits, state = self._nav(state, feats, lmask, rgb, dep,
                                          ang, cmask)
                acts = logits.argmax(-1).cpu().numpy()
                if stepk == self.dcfg.max_steps - 1:
                    # forced stop at the step cap, so every episode is
                    # scored, not dropped (the main eval rollout does the
                    # same, rollout.py force_stop)
                    acts[:] = 0
                # simulate only the chosen candidate per moving env (the
                # teacher needs all endpoints; greedy eval does not)
                pos, _ = envs.get_pos_ori()
                env_actions = []
                for i, g in enumerate(live):
                    a = int(acts[g])
                    env_actions.append(self._env_action(
                        a, pos[i],
                        envs.cand_real_pos(
                            i, [cand["angles"][g][a - 1]],
                            [cand["dists"][g][a - 1]])[0] if a else None))
                results = envs.step(env_actions)
                for i, r in enumerate(results):
                    if not r.done or r.info.get("crashed"):
                        continue
                    info = r.info
                    ep = eps[live[i]]
                    stats[ep.episode_id] = episode_metrics(
                        info["position"]["position"],
                        info["position"]["distance"],
                        np.stack(ep.reference_path),
                        info["steps_taken"],
                        info["collisions"]["count"], success_distance)
                _live_rows(envs, live, results, None)
                if envs.num_envs == 0:
                    break
                for i, r in enumerate(results):
                    obs_full[live[i]] = r.observation
        return aggregate(stats)


class TeacherRecollectionSampler:
    """Simulator-replay alternative to the disk store
    (common/recollection_dataset.py:22-297): regenerates teacher
    trajectories on the fly, with no persistence."""

    def __init__(self, envs, feature_fn, max_steps: int = 60):
        self.envs = envs
        self.feature_fn = feature_fn
        self.max_steps = max_steps

    def __iter__(self):
        while True:
            self.envs.resume_all()
            obs = self.envs.reset()
            B = self.envs.num_envs
            trajs = [dict(tokens=o["instruction"], rgb=[], dep=[],
                          teacher=[]) for o in obs]
            # feature extraction stays at fixed B (as in the collect
            # loops); finished envs ride as padding rows
            live = list(range(B))
            obs_full = list(obs)
            for _ in range(self.max_steps):
                rgb_f, dep_f = self.feature_fn(obs_full)       # (B, D)
                teach = [self.envs.shortest_path_action(i)
                         for i in range(self.envs.num_envs)]
                for i, g in enumerate(live):
                    t = trajs[g]
                    t["rgb"].append(rgb_f[g])
                    t["dep"].append(dep_f[g])
                    t["teacher"].append(teach[i])
                results = self.envs.step_low_level(teach)
                _live_rows(self.envs, live, results, None)
                if self.envs.num_envs == 0:
                    break
                for i, r in enumerate(results):
                    obs_full[live[i]] = r.observation
            for t in trajs:
                if t["rgb"]:
                    yield {
                        "tokens": np.asarray(t["tokens"]),
                        "rgb": np.stack(t["rgb"]),
                        "dep": np.stack(t["dep"]),
                        "teacher": np.asarray(t["teacher"], np.int32),
                    }
