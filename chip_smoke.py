#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`etpnav_tpu_torch`) on one GPU.

Usage (from the repository root, on a machine with a CUDA GPU and the
CUDA toolkit):

    python3 chip_smoke.py

Phases, each reported on its own lines:
  1. environment: torch/CUDA versions, the card's name and power limit,
     whether PyYAML, transformers and tensorboard are installed;
  2. build: every CUDA kernel of the port (seven sources: K-ATT with
     K-ATT-CHEAP, K-ATT-BWD, K-NMS, K-GN, K-PRENORM, K-BLOCK, K-MOE), from the
     sources in the checkout, one nvcc per source, all started together;
  3. every kernel against its plain PyTorch version on the card, at the
     serving path's shapes, in fp32 and bf16, with its time, the plain
     version's, the PyTorch library call's where there is one, and the
     card's bound for the same work, and the kernels' device time alone,
     `kernel_ms`, from torch.profiler: K-ATT (bf16 on tensor cores, fp32
     on CUDA cores) beside SDPA; K-NMS's map and candidate slots bit for
     bit against its plain version (`heatmap_nms_plain` +
     `extract_candidates`) at B = 8, 1, 7 and in crafted cases (a peak on
     a wrap row, underflowed probabilities, ties), its kernel_ms beside
     the launch floor (a one-element elementwise op); K-GN at every GroupNorm shape
     of the fused depth trunk at B = 96 (recorded from one fused trunk
     pass on the card; two launches bit-equal; the device time summed
     over one perceive's 54 launches); the bf16 weight rounding of
     K-PRENORM and K-BLOCK bit for bit against `.to(torch.bfloat16)`;
     K-PRENORM at the CLIP shape (96, 50, 768) beside the port's unfused
     CLIP attention half-block; the bf16 GEMM of K-PRENORM and K-BLOCK
     (wgmma fed by TMA) alone at N = 2304, K = 768 and M = 4800, 640,
     10240, 12800 against its plain version, its kernel_ms beside
     `torch.matmul` of the same shape (and at M = 4800 each tile
     configuration);
     K-ATT with attention dropout 0.1 at the learn step's shapes, and its
     p_drop = 0 launch with the row log-sum-exp bit for bit against the
     serving launch;
  3e. DeepSeek-V2's encoder kernels (`dsv2_phase`): K-ATT at head width
     192 with a causal bias at MLA's shape (1, 16, 200, 192) against its
     plain version, beside SDPA; K-MOE (`csrc/moe_gemm.cu`) at
     DeepSeek-V2-Lite's widths, 16 held experts of 64, the 1200 routings
     of a 200-token encode, gate/up and down against their plain
     versions, beside `torch._grouped_mm` (where this PyTorch has it)
     and a loop of one cuBLAS product per expert; the encoder at its
     published widths and 3 layers (1 dense, 2 expert layers), bf16 on
     the card against fp32 plain versions on the CPU, and its CUDA
     graph's replay against the eager encoder;
  3d. the bounded barrier wait of csrc/dense.cuh: a child process
     (`--trap-child`) launches the bf16 GEMM built with one mbarrier
     arrival withheld (ETP_TEST_WITHHOLD_ARRIVE, built beside phase 2);
     it must exit with a launch error whose fault record names the
     barrier (full[0], parity 0), and this process's context stays
     clean;
  3c. K-ATT-BWD against its plain version at the learn step's four
     attention shapes (text, pano, cross and graph self-attention at
     G = 96, B*T = 160), fp32 and bf16, with and without dropout 0.1,
     d(bias) for the graph self-attention, two launches bit-equal; K-ATT +
     K-ATT-BWD beside SDPA forward + backward, K-ATT-BWD beside SDPA's
     backward alone;
  4. the serving slice: `NavServer(r2r_config(), Agent(device="cuda"),
     max_batch=8)` from seeded random weights keeps 8 sessions live until
     at least 40 steps are served; every launch count must be exactly
     what the served programs make (16 K-ATT per perceive, 8 per
     navigation scoring, 9 per instruction; 1 K-NMS per perceive; no K-GN
     or K-PRENORM) and no plain version may be called; the ops per
     eager perceive, beside the same perceive with the candidate slots
     taken by the `extract_candidates` chain: fewer by exactly that
     chain's ops, counted by the dispatcher (torch.profiler's device ops
     beside them);
  4b. the same with the fused perception configuration
     (`DepthEncoderConfig.use_fused_gn`, `ClipConfig.use_fused_block`):
     54 K-GN and 11 K-PRENORM launches per perceive, K-ATT 5 per perceive;
     then perceive at B = 8, default and fused configuration in turns;
     every served perceive replays the whole perceive's CUDA graph, which
     warmup() captured (its warm-up run captured the depth trunk's graph,
     its capture ran the trunk eagerly into it: no served batch replays
     the depth graph);
  4c. the depth trunk as CUDA graphs (`Agent`, `ops/cuda_graph.py`), in
     the default and the fused configuration: at (96, 128, 128, 1) the
     capture's output and each replay bit-equal to the eager
     `encode_depth`, and again after new weights are copied into the
     parameters in place; (12, 128, 128, 1) captures a second graph; the
     agent's counters exact; K-GN 54 launches per replay (fused); the
     agent's eager perceive (the trunk by graph) equal to the module's
     all-eager one, with the launch calls of each from torch.profiler
     and their times;
  4d. the whole perceive as one CUDA graph (`Agent.perceive`) at R2R
     width, B = 8, default configuration: the capture's output, each
     replay, and a replay after new weights are copied in place, bit-equal
     on every output key to the agent's eager perceive (the largest
     difference of each key logged where one is not); the agent's
     counters exact, the gate declining under torch.profiler, the tracer
     and a generator; the port's launch counters per perceive eager and
     replayed, the launch calls of each from torch.profiler, and the
     wall ms of each between CUDA events and in turns;
  5. slice parity: `perceive` + `score_navigation` at full R2R width in
     fp32 on the card (kernels) against the CPU (plain versions);
  5b. the same for the fused configuration;
  7. IL training: `FinetuneTrainer(r2r_config(), GeometricNavEnv(8),
     device="cuda")` trains 2 iterations (rollout + bucketed learn step);
     exact launch counts (the rollout's programs as in phase 4, and 19
     K-ATT + 19 K-ATT-BWD per learn step), no plain call, a finite loss,
     trained parameters moved and the frozen towers did not; every
     rollout perceive eager (the waypoint augmentation's generator), its
     depth trunk captured once and replayed after; the learn
     step p50 at (T20, G64) and (T20, G96), the peak memory, and one
     profiled learn step;
  7b. the learn step's loss and every planner gradient at full R2R width
     in fp32 with dropout off, card (kernels) against CPU (plain
     versions), on 2 envs x 3 steps of the recorded interval; then the
     same step in bf16 on the card (tensor-core K-ATT and K-ATT-BWD)
     against the fp32 one, launches exact;
  8. K-BLOCK (the post-norm attention sub-block, `ops/fused_block.py`) on
     the model's own layers: the attention block of each of the 9
     text-encoder layers on the hidden states `forward_txt` feeds it (8
     instructions, L = 80) and the `visn_self_att` block of each of the 4
     cross-modal layers on the graph states `forward_navigation` feeds it
     (G = 96, mask + sprel bias), in the stack's dtype and in fp32, and
     alone at (160, 64), (64, 200), the ragged (7, 83) and (16, 200) with
     a bias per (query, key) read where it lies; exact launch
     counts, each launch against its plain version and against the port's
     unfused `self_attention_block`, times beside the card's bound and
     the bf16 time split by kernel;
  8b. the two experiment tools `tools.exp_attn_layout.main()` and
     `tools.exp_attn_pack.main()` at their CLIP shape: every variant
     within its tolerance, exact launch counts (K-ATT, K-ATT with the
     head-leading output, K-ATT-CHEAP) and no plain call; then K-ATT with
     `out_layout="head"` and K-ATT-CHEAP against their plain versions;
  9. the entry points at r2r_config() width, each with every count at 0
     before it and read after, exact launch counts and no plain call:
     (a) seeded full-width files in the released layouts (pretrain
     planner, waypoint predictor, openai CLIP as a TorchScript archive,
     DD-PPO depth, the DDP-wrapped fine-tune policy), written from the
     port's modules by this script's own exporters, converted back
     through `convert_cli` and `convert_full_policy`, every tensor
     exact; (b) `run_config(..., run_type="serve",
     serve_nonblocking=True, device="cuda")` with MODEL.pretrained_path
     = the planner file, 8 HTTP sessions in lockstep rounds, then the
     same sessions through an in-process NavServer on the runner's
     agent: equal actions, both step p50s and batch counts, for
     `nav_use_bf16` False and True, then the in-process step with the
     navigation stack in fp32 and bf16 in turns; (c) `run_config` trains one iteration (K-ATT-BWD), evaluates
     and runs inference (fused configuration: K-GN, K-PRENORM) on
     GeometricNavEnv episodes from its checkpoint, then the
     checkpoint-folder eval loop;
  10. pretraining at r2r_config() width (batch 32, T = 8, 12 views + 5
     candidates, 48 graph slots), each stage with every count at 0
     before it and read after, exact launch counts (19 K-ATT and 19
     K-ATT-BWD per step of any task) and no plain call: `run_config(
     trainer="Pretrain", run_type="train")` takes 8 mlm + sap steps at
     1 : 1, validating and saving model_step_N every 4; again with
     PRETRAIN.resume, 4 steps more; a trainer with all four tasks (3
     object tokens, image_prob_size 1000) takes one mrc and one og step
     and validates; `run_config(run_type="train")` with
     MODEL.pretrained_path at the last checkpoint warm-starts the
     fine-tune planner (word embeddings and SAP head equal to the
     checkpoint's) and takes one IL iteration. Then each task's step
     p50, the peak memory and one profiled step per task; K-ATT (dropout
     0.1, lse) and K-ATT-BWD (dropout 0.1) against their plain versions
     at every pretraining attention shape, with device times beside the
     bound and SDPA's; K-ATT-BWD's key limit at every pretraining shape
     for R2R and RxR;
  11. the IL trainer's feed at r2r_config() width, each stage with every
     count at 0 before it and read after, exact launch counts and no
     plain call: (a) `run_config(run_type="train", workers=True,
     pipeline_halves=2)` with RESTART_CRASHED_WORKERS, SHM_OBSERVATIONS
     and every IL switch on (agg_dense_device, depth_transport_uint16,
     remat, remat_nav), 8 envs in 2 pools of 4 forkserver workers, 2
     iterations, one worker killed mid-rollout and respawned; (b) rollout
     seconds per interval in turns A B C C B A (A in-process
     GeometricNavEnv(8), B 8 workers, C 2 pools of 4 in threads) after
     one warm interval each, and the device's busy share of one profiled
     interval of each; (c) the learn step's loss and planner gradients
     with IL.agg_dense_device on against off (fp32, dropout off), then
     its p50 at (T20, G64) and (T20, G96) off and on in turns, with
     `indexing_backward_kernel` launches and ms; (d) the gradients with
     IL.remat_nav and IL.remat against the memoryful step's at dropout
     0.1 from one generator state, then p50, peak memory and K-ATT per
     step (19 -> 27 -> 29) in turns; (e) perceive with uint16 depth
     against the dequantized and the fp32 depth, the upload's bytes
     halved;
  12. the legacy DAgger trainer: K-ATT (dropout 0 and 0.1) and K-ATT-BWD
     against their plain versions at the recurrent VLN-BERT's fp32 shapes
     with its -1e9 mask bias, (Lq, Lk) = (80, 80), (7, 79) and (7, 7) at
     B = 8, beside SDPA and the bound (measured right after phase 3c, as
     is phase 13's K-ATT at the extractor's shape: after phase 11 the
     profiler has returned no kernel record in some runs); then
     `run_config` of
     configs/dagger_r2r.yaml (full R2R width; only the counts of
     DAGGER_CUTS are cut, and printed) on GeometricNavEnv(8), each stage
     with every count at 0 before it and read after, exact launch counts
     and no plain call: train DAGGER.policy rec_vlnbert, train cma, eval
     rec_vlnbert; K-ATT per nav step and K-ATT + K-ATT-BWD per update
     batch against the formula, the update's p50 at T = 60 and its peak
     memory, collect s per iteration, the eval's SR / SPL; one nav_step
     and one sequence_nll with its gradients, kernels against plain
     versions on the card;
  13. the learning demo, warm against cold and the offline extractor at
     r2r_config() width, each run with every count at 0 before it and
     read after: (a) `tools.learning_demo.main` with 8 envs to iteration
     2 with an 8-episode held-out eval at 0 and 2, then a second session
     in the same directory that prints `resumed_at` 2 and runs to 4, one
     checkpoint left after each; a finite IL loss; launches exact (the
     rollout's and the eval's programs as in phase 4, and 19 K-ATT + 19
     K-ATT-BWD per learn step), reported per iteration; (b)
     `tools.warm_vs_cold.main` cut to 2 pretraining steps and 2
     iterations per arm: 19 K-ATT-BWD per pretraining and per IL step,
     one K-NMS per perceive, no plain call, both arms' lines and the
     summary line; (c) `FeatureExtractor` over 8 panoramas x 36 views
     with a seeded 40-class class_proj, default (12 K-ATT per call) and
     fused configuration (11 K-PRENORM, 1 K-ATT, 54 K-GN per call), fp32
     and bf16: the features through the kernels against the same call on
     the plain versions on the card, then in bf16 ms per panorama and
     the peak memory; and K-ATT alone at the extractor's shape q/k/v
     (288, 12, 50, 64) beside its plain version, SDPA and the bound;
  14. distribution and the eval videos at r2r_config() width: (b) and (c)
     in one world of two gloo ranks sharing the card (torch.multiprocessing
     spawns them, each child killed at its time limit; the kernels are
     built before): (b) dp 2, each rank's learn step on its half of phase
     7's recorded B = 8 interval (fp32, dropout off) against one process
     on all 8: the global loss, every planner parameter after AdamW, and
     19 K-ATT + 19 K-ATT-BWD per rank per step; the learn-step p50 of dp
     2 against dp 1 in turns (two ranks on one card, not a scaling
     number); (c) mp 2 with dropout on, a pretraining SAP and MLM step
     (the vocabulary split in two) at the config's precision (bf16
     planner) and in fp32, each against one-process trainers stepping
     beside it in the same rank from the same seeds (the loss, every
     gathered gradient, the whole state after; bf16 held against fp32
     as phase 7b holds it, fp32 at LEARN_REL_TOL), and one bf16
     fine-tune iteration (mp rank 0 rolls out and broadcasts the record)
     against one process's learn step on that record; the replicated
     parameters bit-equal on both ranks; the first K-ATT and K-ATT-BWD
     launch of mp rank 1 (head base 6 of 12) in each precision captured
     and held against the plain versions; K-ATT's dropout
     bits at head base 6 read off the kernel against the global mask's
     slice; (d) `torchrun --nproc_per_node 2 -m etpnav_tpu_torch.run`
     with MESH dp 2 and backend gloo trains 2 iterations, then `run_config
     (run_type="eval", video=True)` evaluates 2 episodes from its
     checkpoint and the videos are read back (mp4 through
     cv2.VideoCapture, or the PNG directory); (a) a one-rank NCCL world:
     all-reduce, sync_max, all_gather_object;
  6. one JSON line with every kernel's numbers, then the card line, then
     `{"ok": true, "device": {...}}` as the last line.

Any failure raises, so the script exits non-zero and prints no result;
it does the same when no CUDA device is present. `--soak-gemm N` runs
only the GEMM soak at N launches (for a run under compute-sanitizer);
`--trap-child LIB` is phase 3d's child; phase 14's ranks import this file
and run `dist_child`.
"""

from __future__ import annotations

import collections
import contextlib
import copy
import dataclasses
import functools
import json
import os
import statistics
import socket
import subprocess
import sys
import tempfile
import threading
import time
import warnings

import numpy as np
import torch

# H100 SXM peaks (NVIDIA data sheet, dense): bytes/s and FLOP/s by type
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
# Tolerances, kernel against plain version on the same card:
# - fp32: 2e-5 absolute on outputs of magnitude <= ~3; only the order of
#   the fp32 sums differs;
# - bf16: 2e-2 absolute (about four bf16 ulps at magnitude 1): the kernel
#   rounds p to bf16 at a running max (online softmax over key tiles) and
#   the plain version at the row's global max, and both round the output.
# K-GN and K-PRENORM in bf16: two bf16 ulps at the largest output
# magnitude (0.0625 for outputs in [4, 8)). Kernel and plain version round
# at the same points, but their fp32 sums (statistics, K = 768 products)
# run in another order, so a value next to a rounding tie may land one
# ulp apart; the residual keeps outputs near the input's magnitude.
BF16_ULPS = 2
# card (fp32, kernels) against CPU (fp32, plain versions), full R2R
# width: max |diff| / max |reference| per output. fp32 sums in another
# order through 12 CLIP blocks, the ResNet-50 trunk and 9+2+4 BERT layers.
SLICE_REL_TOL = 1e-4


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Mean device time of fn() over `iters` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


#: (seconds into the run, µs from a profile window's first host op to its
#: first kernel) of every kernel_ms window: the host and device clocks of
#: torch.profiler as the run ages
PROFILER_SKEW: list = []


def kernel_ms(fn, iters: int = 20, tries: int = 8) -> float:
    """Device time per call of the kernels fn() launches, from
    torch.profiler's CUDA kernel events over `iters` calls: the kernels'
    own time, without the host cost of the wrapper around them. Now and
    then the profiler hands back no device event at all, only the host's
    ops and CUPTI's 'Activity Buffer Request' (on the H100: once in ~150
    profiles early in a run; late in a run, after phase 11, in every
    window of a call in 3 of 4 runs). Such a window is logged and
    profiled again with host time padded around the calls, doubling from
    50 ms: the profiler drops device records that fall outside its
    window, which a drift between the host's and the device's clocks
    would do; the log says which pad brought the records back."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    pad = 0.0
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            time.sleep(pad)
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
            time.sleep(pad)
        total = sum(e.self_device_time_total for e in prof.key_averages()
                    if e.device_type == torch.autograd.DeviceType.CUDA)
        if total > 0:
            ev = prof.events()
            starts = {d: min((e.time_range.start for e in ev
                              if e.device_type == d), default=None)
                      for d in (torch.autograd.DeviceType.CPU,
                                torch.autograd.DeviceType.CUDA)}
            if None not in starts.values():
                PROFILER_SKEW.append(
                    (round(time.perf_counter() - T0, 1),
                     starts[torch.autograd.DeviceType.CUDA]
                     - starts[torch.autograd.DeviceType.CPU]))
            if pad:
                log(f"kernel_ms: device records back with {pad:.2f} s of "
                    "host time around the calls")
            return total / 1e3 / iters
        ev = prof.events()
        log(f"kernel_ms: an empty window (pad {pad:.2f} s): {len(ev)} "
            f"events, by device "
            f"{dict(collections.Counter(str(e.device_type) for e in ev))}, "
            f"device time {sum(e.device_time_total for e in ev)}, keys "
            f"{sorted({e.key for e in ev})[:8]}")
        pad = 0.05 if pad == 0.0 else 2 * pad
    raise AssertionError(f"kernel_ms: the profiler saw no device time in "
                         f"{tries} windows")


def skew_summary() -> dict:
    """PROFILER_SKEW in ten slices of the run: each slice's seconds and
    its least and largest µs."""
    if not PROFILER_SKEW:
        return {}
    n = len(PROFILER_SKEW)
    out = {}
    for i in range(10):
        part = PROFILER_SKEW[i * n // 10:(i + 1) * n // 10]
        if part:
            us = [u for _, u in part]
            out[f"{part[0][0]}-{part[-1][0]} s"] = [min(us), max(us)]
    return out


def kernel_split(fn, iters: int = 20) -> list:
    """(kernel name, device ms per call, launches per call) of each kernel
    fn() launches, from torch.profiler, longest first."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    ev = [e for e in prof.key_averages()
          if e.device_type == torch.autograd.DeviceType.CUDA
          and e.self_device_time_total > 0]
    return sorted(((e.key, e.self_device_time_total / 1e3 / iters,
                    e.count / iters) for e in ev), key=lambda r: -r[1])


def bound_ms(nbytes: int, flops: float, dtype) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def attention_cases(dev):
    """(name, q, k, v, bias) at the serving path's shapes (r2r_config,
    max_batch=8: 96 CLIP images; G up to 96 graph slots; 80 text
    tokens)."""
    g = torch.Generator(device=dev).manual_seed(0)

    def rn(*shape):
        return torch.randn(*shape, generator=g, device=dev)

    def natural(B, L, H=12, hd=64):
        # the projection output (B, L, H*hd) viewed as (B, H, L, hd)
        return rn(B, L, H * hd).view(B, L, H, hd).transpose(1, 2)

    cases = []
    # CLIP blocks 1-11: self-attention over 50 tokens, natural layout
    cases.append(("clip_natural", natural(96, 50), natural(96, 50),
                  natural(96, 50), None))
    # CLIP last block: the cls row only, as the main path passes it (the
    # (B, 1, D) query projection and the (B, 50, D) key/value projections
    # viewed as (B, H, L, hd))
    cases.append(("clip_cls_row", natural(96, 1), natural(96, 50),
                  natural(96, 50), None))
    # the same shapes in contiguous head-leading (B, H, L, hd) tensors
    cases.append(("cls_row_head_leading", rn(96, 12, 1, 64),
                  rn(96, 12, 50, 64), rn(96, 12, 50, 64), None))
    # graph self-attention at G=96: padding mask + sprel bias (B,1,G,G)
    mask = torch.ones(8, 96, dtype=torch.bool, device=dev)
    mask[:, 60:] = False
    sprel = rn(8, 96, 96).abs() * -0.5
    cases.append(("nav_self_g96", natural(8, 96), natural(8, 96),
                  natural(8, 96),
                  ((~mask).float() * -10000.0)[:, None, None, :]
                  + sprel[:, None]))
    # cross-attention into the text: 96 graph slots over 80 tokens
    tmask = torch.ones(8, 80, dtype=torch.bool, device=dev)
    tmask[:, 30:] = False
    cases.append(("nav_cross_96x80", natural(8, 96), natural(8, 80),
                  natural(8, 80),
                  ((~tmask).float() * -10000.0)[:, None, None, :]))
    # waypoint TRM: 12 views, the (1,1,12,12) neighbour mask broadcast
    nb = torch.full((12, 12), -10000.0, device=dev)
    for i in range(12):
        for j in (i - 1, i, i + 1):
            nb[i, j % 12] = 0.0
    cases.append(("waypoint_12", natural(8, 12), natural(8, 12),
                  natural(8, 12), nb[None, None]))
    # the RxR text encoder's length: 200 tokens, a padding bias
    rmask = torch.ones(1, 200, dtype=torch.bool, device=dev)
    rmask[:, 150:] = False
    cases.append(("rxr_text_200", natural(1, 200), natural(1, 200),
                  natural(1, 200),
                  ((~rmask).float() * -10000.0)[:, None, None, :]))
    # every key of every row masked with -10000
    cases.append(("all_masked", natural(2, 16), natural(2, 16),
                  natural(2, 16),
                  torch.full((2, 1, 16, 16), -10000.0, device=dev)))
    return cases


def attention_work(q, k, v, bias):
    B, H, Lq, hd = q.shape
    Lk = k.shape[2]
    isz = q.element_size()
    nbytes = isz * (2 * B * H * Lq * hd + 2 * B * H * Lk * hd)
    if bias is not None:
        nbytes += bias.numel() * 4
    return nbytes, 4.0 * B * H * Lq * Lk * hd


def attention_row(card: str, name: str, q32, k32, v32, bias,
                  dtype) -> dict:
    """K-ATT against its plain version on (q, k, v, bias) cast to `dtype`
    (raises past TOL), then its ms, kernel_ms, the plain version's ms,
    SDPA's ms and kernel_ms, and the card's bound for the same work."""
    import torch.nn.functional as F

    from etpnav_tpu_torch.ops.fused_attention import (
        attention_fwd,
        attention_plain,
    )
    q, k, v = (t.to(dtype) for t in (q32, k32, v32))
    scale = 1.0 / np.sqrt(q.shape[-1])
    got = attention_fwd(q, k, v, bias, scale)
    want = attention_plain(q, k, v, bias, scale)
    torch.cuda.synchronize()
    assert torch.isfinite(got.float()).all(), f"{name}: not finite"
    err = (got.float() - want.float()).abs().max().item()
    if err > TOL[dtype]:
        raise AssertionError(f"K-ATT {name} {dtype}: max abs err "
                             f"{err} > {TOL[dtype]}")
    ms = cuda_ms(lambda: attention_fwd(q, k, v, bias, scale))
    k_ms = kernel_ms(lambda: attention_fwd(q, k, v, bias, scale))
    plain_ms = cuda_ms(lambda: attention_plain(q, k, v, bias, scale))
    mask = None if bias is None else bias.to(dtype)

    def sdpa():
        return F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, scale=scale)

    lib_ms, lib_k_ms = cuda_ms(sdpa), kernel_ms(sdpa)
    nbytes, flops = attention_work(q, k, v, bias)
    b_ms, b_by = bound_ms(nbytes, flops, dtype)
    key = f"{name}/{str(dtype).split('.')[-1]}"
    row = {"shape": [list(q.shape), list(k.shape)],
           "max_abs_err": err, "ms": ms, "kernel_ms": k_ms,
           "plain_ms": plain_ms, "library_ms": lib_ms,
           "library_kernel_ms": lib_k_ms, "bound_ms": b_ms,
           "bound_by": b_by}
    log(f"K-ATT {key:28s} q{tuple(q.shape)} k{tuple(k.shape)} "
        f"err={err:.3g} ms={ms:.4f} kernel_ms={k_ms:.4f} "
        f"plain_ms={plain_ms:.4f} sdpa_ms={lib_ms:.4f} "
        f"sdpa_kernel_ms={lib_k_ms:.4f} bound_ms={b_ms:.4f} "
        f"({b_by}) [{card}]")
    return row


def check_attention(card: str) -> dict:
    rows = {}
    for name, q32, k32, v32, bias in attention_cases(torch.device("cuda")):
        for dtype in (torch.float32, torch.bfloat16):
            rows[f"{name}/{str(dtype).split('.')[-1]}"] = attention_row(
                card, name, q32, k32, v32, bias, dtype)
    return rows


def check_misaligned_refused() -> None:
    """A bf16 view whose rows are not 16-byte aligned (its base 2 bytes
    past a row start) is refused by the entry points of K-ATT, K-ATT-CHEAP
    and K-ATT-BWD, which launch nothing; the wrappers raise ValueError."""
    from etpnav_tpu_torch.ops import fused_attention as fa
    dev = torch.device("cuda")
    B, H, L, hd = 2, 2, 5, 64
    x = torch.randn(B, L, H * hd + 8, device=dev).to(torch.bfloat16)
    ok = x[..., :H * hd].view(B, L, H, hd).transpose(1, 2)
    bad = x[..., 1:H * hd + 1].view(B, L, H, hd).transpose(1, 2)
    lse = torch.zeros(B, H, L, device=dev)
    counters = (fa.attention_fwd_launches, fa.attention_cheap_launches,
                fa.attention_bwd_launches)
    before = [c.value for c in counters]
    for name, fn in (
            ("attention_fwd", lambda: fa.attention_fwd(bad, ok, ok, None,
                                                       0.125)),
            ("attention_cheap", lambda: fa.attention_cheap(ok, bad, ok,
                                                           0.125)),
            ("attention_bwd", lambda: fa.attention_bwd(
                ok, ok, ok, None, ok, lse, bad, 0.125))):
        try:
            fn()
        except ValueError as e:
            if "16-byte" not in str(e):
                raise
        else:
            raise AssertionError(f"{name}: a misaligned bf16 view was "
                                 "launched")
    torch.cuda.synchronize()
    if [c.value for c in counters] != before:
        raise AssertionError("a refused attention call counted a launch")
    log("K-ATT, K-ATT-CHEAP, K-ATT-BWD: misaligned bf16 views refused "
        "with no launch")


def learn_attention_cases(dev, G: int = 96, BT: int = 160, B: int = 8):
    """(name, q, k, v, bias) of the learn step's four attentions at
    r2r_config (B = 8 envs, T = 20 steps: B*T = 160 replay rows; 80 text
    tokens, 17 pano tokens, G graph slots): the text encoder, the pano
    encoder, the navigation cross-attention into the text and the graph
    self-attention with the sprel bias, whose gradient the learn step
    takes."""
    g = torch.Generator(device=dev).manual_seed(5)

    def natural(n, L, H=12, hd=64):
        x = torch.randn(n, L, H * hd, generator=g, device=dev) * 0.5
        return x.view(n, L, H, hd).transpose(1, 2)

    def pad_bias(n, L, keep):
        mask = torch.arange(L, device=dev)[None] < keep
        return ((~mask).float() * -10000.0).expand(n, L)[:, None, None, :]

    sprel = torch.rand(BT, G, G, generator=g, device=dev) * -2.0
    graph_bias = (pad_bias(BT, G, G * 2 // 3) + sprel[:, None]).contiguous()
    return [
        ("text", natural(B, 80), natural(B, 80), natural(B, 80),
         pad_bias(B, 80, 30)),
        ("pano", natural(BT, 17), natural(BT, 17), natural(BT, 17),
         pad_bias(BT, 17, 11)),
        (f"cross_g{G}", natural(BT, G), natural(BT, 80), natural(BT, 80),
         pad_bias(BT, 80, 30)),
        (f"graph_g{G}", natural(BT, G), natural(BT, G), natural(BT, G),
         graph_bias),
    ]


def check_attention_dropout(card: str) -> dict:
    """K-ATT with attention dropout 0.1 against its plain version (the same
    Philox bits) at the learn step's shapes, and the launch the learn step
    makes at p_drop = 0 (row lse requested) bit for bit against the serving
    launch (no lse). Times with dropout and the lse: the kernel, the plain
    version, SDPA with the same float mask and dropout rate, the bound."""
    import torch.nn.functional as F

    from etpnav_tpu_torch.ops.fused_attention import (
        attention_fwd,
        attention_plain,
        draw_seed_offset,
    )
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(11)
    rows = {}
    for name, q32, k32, v32, bias in learn_attention_cases(dev):
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = (t.to(dtype) for t in (q32, k32, v32))
            scale = 0.125
            serve_out = attention_fwd(q, k, v, bias, scale)
            train_out, lse = attention_fwd(q, k, v, bias, scale,
                                           return_lse=True)
            torch.cuda.synchronize()
            if not torch.equal(serve_out, train_out):
                raise AssertionError(f"K-ATT {name} {dtype}: p_drop=0 with "
                                     "lse differs from the serving launch")
            _, lse_want = attention_plain(q, k, v, bias, scale,
                                          return_lse=True)
            lse_err = (lse - lse_want).abs().max().item()
            if lse_err > 1e-4:
                raise AssertionError(f"K-ATT {name} {dtype}: lse err "
                                     f"{lse_err}")
            so = draw_seed_offset(gen, dev)
            got = attention_fwd(q, k, v, bias, scale, 0.1, so)
            want = attention_plain(q, k, v, bias, scale, 0.1, so)
            torch.cuda.synchronize()
            assert torch.isfinite(got.float()).all(), f"{name}: not finite"
            err = (got.float() - want.float()).abs().max().item()
            if err > TOL[dtype]:
                raise AssertionError(f"K-ATT dropout {name} {dtype}: max abs"
                                     f" err {err} > {TOL[dtype]}")
            def ours():
                return attention_fwd(q, k, v, bias, scale, 0.1, so,
                                     return_lse=True)

            ms, k_ms = cuda_ms(ours), kernel_ms(ours)
            plain_ms = cuda_ms(lambda: attention_plain(
                q, k, v, bias, scale, 0.1, so, return_lse=True), iters=5,
                warmup=1)
            mask = bias.to(dtype)

            def sdpa():
                return F.scaled_dot_product_attention(
                    q, k, v, attn_mask=mask, dropout_p=0.1, scale=scale)

            lib_ms, lib_k_ms = cuda_ms(sdpa), kernel_ms(sdpa)
            nbytes, flops = attention_work(q, k, v, bias)
            b_ms, b_by = bound_ms(nbytes + 4 * lse.numel(), flops, dtype)
            key = f"{name}/{str(dtype).split('.')[-1]}"
            rows[key] = {"shape": [list(q.shape), list(k.shape)],
                         "max_abs_err": err, "lse_err": lse_err, "ms": ms,
                         "kernel_ms": k_ms, "plain_ms": plain_ms,
                         "library_ms": lib_ms, "library_kernel_ms": lib_k_ms,
                         "bound_ms": b_ms, "bound_by": b_by}
            log(f"K-ATT dropout 0.1 {key:22s} q{tuple(q.shape)} "
                f"k{tuple(k.shape)} err={err:.3g} lse_err={lse_err:.3g} "
                f"ms={ms:.4f} kernel_ms={k_ms:.4f} (with lse) "
                f"plain_ms={plain_ms:.4f} sdpa_ms={lib_ms:.4f} "
                f"sdpa_kernel_ms={lib_k_ms:.4f} bound_ms={b_ms:.4f} "
                f"({b_by}); p_drop=0 bitwise = serving [{card}]")
    return rows


def bwd_tol(want: torch.Tensor, dtype) -> float:
    """Kernel against plain backward on the card: fp32 results differ only
    in the order of their fp32 sums (up to Lq or Lk products of O(1)
    terms), 1e-5 of the largest magnitude; bf16 gradients are the same
    fp32 values rounded once, so two bf16 ulps of the largest."""
    if dtype == torch.bfloat16 and want.dtype == torch.bfloat16:
        return bf16_tol(want)
    return 1e-5 * want.float().abs().max().item() + 1e-6


def attention_bwd_work(q, k, bias, dropout: bool, dbias: bool):
    B, H, Lq, hd = q.shape
    Lk = k.shape[2]
    isz = q.element_size()
    # read q, o, dO and k, v; write dq and dk, dv; read lse; the bias
    # (its stored elements) read once; dbias written once (fp32)
    nbytes = isz * (3 * B * H * Lq * hd + 2 * B * H * Lk * hd
                    + B * H * Lq * hd + 2 * B * H * Lk * hd)
    nbytes += 4 * B * H * Lq
    if bias is not None:
        nbytes += 4 * bias.numel()
    if dbias:
        nbytes += 4 * B * Lq * Lk
    # five products of B*H*Lq*Lk*hd multiply-adds each
    return nbytes, 5 * 2.0 * B * H * Lq * Lk * hd


def check_attention_bwd(card: str, G: int = 96) -> dict:
    """K-ATT-BWD against its plain version on the card at the learn step's
    four attention shapes, fp32 and bf16, with and without dropout 0.1;
    d(bias) where the learn step takes it (graph self-attention). A second
    launch on the same inputs must give bit-equal gradients (d(bias) is
    summed over the heads in a fixed order). Times: the kernel (CUDA
    events around wrapper calls, and its device time from the profiler),
    the plain version, the bound, SDPA's backward alone on a retained
    forward (torch.autograd.grad), and K-ATT + K-ATT-BWD (forward +
    backward through AttentionFn) beside SDPA forward + backward with the
    same float mask and dropout rate."""
    import torch.nn.functional as F

    from etpnav_tpu_torch.ops.fused_attention import (
        AttentionFn,
        attention_bwd,
        attention_bwd_plain,
        attention_fwd,
        draw_seed_offset,
    )
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(12)
    rows = {}
    for name, q32, k32, v32, bias in learn_attention_cases(dev, G=G):
        dbias = name.startswith("graph")
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = (t.to(dtype) for t in (q32, k32, v32))
            scale = 0.125
            dout = (torch.randn(q.shape, generator=gen, device=dev)
                    .to(dtype))
            for p_drop in (0.0, 0.1):
                so = draw_seed_offset(gen, dev) if p_drop else None
                out, lse = attention_fwd(q, k, v, bias, scale, p_drop, so,
                                         return_lse=True)
                args = (q, k, v, bias, out, lse, dout, scale, p_drop, so,
                        dbias)
                got = attention_bwd(*args)
                again = attention_bwd(*args)
                want = attention_bwd_plain(*args)
                torch.cuda.synchronize()
                for gname, a, b in zip(("dq", "dk", "dv", "dbias"), got,
                                       again):
                    if b is not None and not torch.equal(a, b):
                        raise AssertionError(
                            f"K-ATT-BWD {name} {dtype} p_drop={p_drop} "
                            f"{gname}: two launches differ")
                errs = {}
                for gname, a, b in zip(("dq", "dk", "dv", "dbias"), got,
                                       want):
                    if b is None:
                        continue
                    assert torch.isfinite(a.float()).all(), (name, gname)
                    err = (a.float() - b.float()).abs().max().item()
                    tol = bwd_tol(b, dtype)
                    if err > tol:
                        raise AssertionError(
                            f"K-ATT-BWD {name} {dtype} p_drop={p_drop} "
                            f"{gname}: max abs err {err} > {tol}")
                    errs[gname] = err
                ms = cuda_ms(lambda: attention_bwd(*args), iters=20)
                k_ms = kernel_ms(lambda: attention_bwd(*args))
                plain_ms = cuda_ms(lambda: attention_bwd_plain(*args),
                                   iters=5, warmup=1)
                qg, kg, vg = (t.detach().clone().requires_grad_()
                              for t in (q, k, v))
                bg = bias.detach().clone().requires_grad_(dbias)

                def ours():
                    o = AttentionFn.apply(qg, kg, vg, bg, scale, p_drop, so)
                    o.backward(dout)

                mask = bg.expand(q.shape[0], 1, q.shape[2], k.shape[2])

                def sdpa():
                    o = F.scaled_dot_product_attention(
                        qg, kg, vg, attn_mask=mask.to(dtype),
                        dropout_p=p_drop, scale=scale)
                    o.backward(dout)

                pair_ms = cuda_ms(ours, iters=10)
                pair_k_ms = kernel_ms(ours, iters=10)
                lib_ms = cuda_ms(sdpa, iters=10)
                lib_k_ms = kernel_ms(sdpa, iters=10)
                # SDPA's backward alone, on one retained forward
                leaves = (qg, kg, vg) + ((bg,) if dbias else ())
                o_ret = F.scaled_dot_product_attention(
                    qg, kg, vg, attn_mask=mask.to(dtype), dropout_p=p_drop,
                    scale=scale)

                def sdpa_bwd():
                    return torch.autograd.grad(o_ret, leaves, dout,
                                               retain_graph=True)

                lib_bwd_ms = cuda_ms(sdpa_bwd, iters=10)
                lib_bwd_k_ms = kernel_ms(sdpa_bwd, iters=10)
                del o_ret
                nbytes, flops = attention_bwd_work(q, k, bias, bool(p_drop),
                                                   dbias)
                b_ms, b_by = bound_ms(nbytes, flops, dtype)
                key = (f"{name}/{str(dtype).split('.')[-1]}"
                       f"/p{p_drop}{'/dbias' if dbias else ''}")
                rows[key] = {"shape": [list(q.shape), list(k.shape)],
                             "max_abs_err": max(errs.values()),
                             "errs": errs, "ms": ms, "kernel_ms": k_ms,
                             "plain_ms": plain_ms, "bound_ms": b_ms,
                             "bound_by": b_by, "fwd_bwd_ms": pair_ms,
                             "fwd_bwd_kernel_ms": pair_k_ms,
                             "library_ms": lib_ms,
                             "library_kernel_ms": lib_k_ms,
                             "library_bwd_ms": lib_bwd_ms,
                             "library_bwd_kernel_ms": lib_bwd_k_ms}
                log(f"K-ATT-BWD {key:30s} q{tuple(q.shape)} "
                    f"k{tuple(k.shape)} errs={json.dumps(errs)} "
                    f"ms={ms:.4f} kernel_ms={k_ms:.4f} "
                    f"plain_ms={plain_ms:.4f} bound_ms={b_ms:.4f} ({b_by}) "
                    f"fwd+bwd ms={pair_ms:.4f} (kernels {pair_k_ms:.4f}) "
                    f"sdpa fwd+bwd ms={lib_ms:.4f} (kernels {lib_k_ms:.4f}) "
                    f"sdpa bwd ms={lib_bwd_ms:.4f} sdpa bwd kernel_ms="
                    f"{lib_bwd_k_ms:.4f}; bitwise equal twice [{card}]")
    return rows


def nms_cases(dev) -> list:
    """(name, logits) of K-NMS's phase-3 checks: random logits at the
    serving batch and two ragged ones, then the crafted cases of
    tests/test_torch_nms_slots.py (a peak on a wrap row, probabilities
    that underflow to 0 with fewer than K valid slots, exact ties)."""
    g = torch.Generator(device=dev).manual_seed(1)
    cases = [(f"B{B}", torch.randn(B, 120, 12, generator=g, device=dev) * 3)
             for B in (8, 1, 7)]
    wrap = torch.randn(2, 120, 12, generator=g, device=dev) * 0.1
    wrap[:, 119, 0] = 9.0
    wrap[1, 0, 9] = 8.0
    under = torch.full((3, 120, 12), -1000.0, device=dev)
    under[0, 50, 3] = under[1, 10, 0] = under[1, 90, 11] = 0.0
    under[2, 0, 0] = 0.0
    ties = torch.zeros(2, 120, 12, device=dev)
    ties[1, 30:40] = 1.0
    return cases + [("wrap_row_peak", wrap), ("underflow", under),
                    ("ties", ties)]


def check_nms(card: str) -> dict:
    """K-NMS's map and slots bit for bit against the plain version
    (`heatmap_nms_plain` + `extract_candidates`) on the card; times at the
    random cases beside the launch floor (a one-element elementwise op)
    (the exact compare holds by construction: the kernel and the plain
    version sum the softmax exactly, in 64-bit fixed point)."""
    from etpnav_tpu_torch.ops.fused_nms import (
        heatmap_candidates_plain,
        heatmap_nms_fused,
    )
    one = torch.zeros(1, device="cuda")
    floor_ms = kernel_ms(lambda: one.add_(1.0))
    rows = {}
    for name, logits in nms_cases("cuda"):
        B = logits.shape[0]
        got = heatmap_nms_fused(logits, 5, (7.0, 5.0))
        want = heatmap_candidates_plain(logits, 5, (7.0, 5.0))
        torch.cuda.synchronize()
        for part, gt, wt in zip(("map", "angle_idx", "dist_idx", "valid"),
                                got, want):
            if not torch.equal(gt, wt):
                raise AssertionError(f"K-NMS {name}: {part} differs from "
                                     "the plain version")
        if name.startswith("B") and (got[0] > 0).sum(dim=(1, 2)).ne(5).any():
            raise AssertionError(f"K-NMS {name}: not 5 peaks per row")
        row = {"max_abs_err": (got[0] - want[0]).abs().max().item(),
               "valid_slots": int(got[3].sum())}
        if name.startswith("B"):
            row["ms"] = cuda_ms(lambda: heatmap_nms_fused(logits, 5,
                                                          (7.0, 5.0)))
            row["kernel_ms"] = kernel_ms(lambda: heatmap_nms_fused(
                logits, 5, (7.0, 5.0)))
            row["plain_ms"] = cuda_ms(lambda: heatmap_candidates_plain(
                logits, 5, (7.0, 5.0)))
            N0, N, K = 120 * 12, 122 * 12, 5
            # logits read, the map and the slots written once
            nbytes = 4 * B * (N0 + N) + B * K * (8 + 8 + 1)
            # softmax (max, exp, sum, divide) + 5 rounds of compare + mask
            flops = B * (4 * N0 + 5 * 6 * N)
            row["bound_ms"], row["bound_by"] = bound_ms(nbytes, flops,
                                                        torch.float32)
            row["library_ms"] = None
            row["floor_kernel_ms"] = floor_ms
        rows[name] = row
        times = ("" if "ms" not in row else
                 f" ms={row['ms']:.4f} kernel_ms={row['kernel_ms']:.4f} "
                 f"(launch floor {floor_ms:.4f}) plain_ms="
                 f"{row['plain_ms']:.4f} bound_ms={row['bound_ms']:.6f} "
                 f"({row['bound_by']})")
        log(f"K-NMS {name} ({B},120,12) fp32: map and slots bit-equal, "
            f"{row['valid_slots']} valid slots{times} [{card}]")
    return rows


def check_gemm(card: str) -> dict:
    """The bf16 GEMM of K-PRENORM and K-BLOCK (`csrc/dense.cuh`, wgmma fed
    by TMA) alone at the q/k/v shape (N = 2304, K = 768) and the M of
    CLIP (4800), the text layer (640) and K-BLOCK's (160, 64) and
    (64, 200): against its plain version (two bf16 ulps at the largest
    output, fp32 sums in another order), its kernel_ms beside one
    `torch.matmul` of the same shape (a yardstick the port never calls);
    then the soak of `soak_gemm`."""
    from etpnav_tpu_torch.ops.fused_prenorm import gemm_bf16, gemm_bf16_plain
    g = torch.Generator(device="cuda").manual_seed(6)
    N, K = 2304, 768
    w = (torch.randn(N, K, generator=g, device="cuda") * 0.03).bfloat16()
    bias = torch.randn(N, generator=g, device="cuda") * 0.1
    rows = {}
    for M in (4800, 640, 10240, 12800):
        a = torch.randn(M, K, generator=g, device="cuda").bfloat16()
        got = gemm_bf16(a, w, bias)
        want = gemm_bf16_plain(a, w, bias)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        tol = bf16_tol(want)
        if err > tol:
            raise AssertionError(f"GEMM M={M}: max abs err {err} > {tol}")
        k_ms = kernel_ms(lambda: gemm_bf16(a, w, bias))
        lib_ms = kernel_ms(lambda: torch.matmul(a, w.t()))
        flops = 2.0 * M * N * K
        row = {"max_abs_err": err, "tol": tol, "kernel_ms": k_ms,
               "matmul_kernel_ms": lib_ms, "ratio": k_ms / lib_ms,
               "tflops": flops / k_ms / 1e9,
               "matmul_tflops": flops / lib_ms / 1e9,
               "bound_ms": bound_ms(2 * (M * K + N * K + M * N),
                                    flops, torch.bfloat16)[0]}
        rows[f"M{M}"] = row
        log(f"GEMM bf16 ({M},{K})x({K},{N}) err={err:.3g} (tol {tol:.3g}) "
            f"kernel_ms={k_ms:.4f} ({row['tflops']:.0f} TFLOP/s) "
            f"torch.matmul kernel_ms={lib_ms:.4f} "
            f"({row['matmul_tflops']:.0f} TFLOP/s), {row['ratio']:.2f}x; "
            f"bound_ms={row['bound_ms']:.4f} [{card}]")
    rows["soak"] = soak_gemm(card)
    return rows


#: (M, N, K) of the GEMM soak: each of the three tile configurations
#: (128 x 128, 64 x 128, 64 x 64), M ragged against every tile height
GEMM_SOAK_SHAPES = ((4801, 2304, 768), (83, 768, 768), (200, 192, 128))
GEMM_SOAK_LAUNCHES = 30000
GEMM_SOAK_LIMIT_S = 60.0


def soak_gemm(card: str, launches: int = GEMM_SOAK_LAUNCHES,
              limit_s: float = GEMM_SOAK_LIMIT_S) -> dict:
    """The GEMM's mbarrier / TMA ring run long, under a watchdog:
    `launches` back-to-back launches spread over the shapes of
    GEMM_SOAK_SHAPES (one per tile configuration, ragged M), every 100th
    launch's output (and the last) held to the first launch's, bit for
    bit, and that one to the plain version. A barrier wait that does not
    end traps after csrc/dense.cuh's kMbarTimeoutNs: the launch error is
    reported with the fault record that names the barrier. A launch that
    never finishes all the same makes the host's polling of an event run
    past `limit_s`: the script then reports it and exits non-zero at
    once, since a hung kernel cannot be cancelled from the host."""
    from etpnav_tpu_torch.ops.cuda_build import dense_fault_report
    from etpnav_tpu_torch.ops.fused_prenorm import gemm_bf16, gemm_bf16_plain
    g = torch.Generator(device="cuda").manual_seed(7)
    cases = []
    for M, N, K in GEMM_SOAK_SHAPES:
        a = torch.randn(M, K, generator=g, device="cuda").bfloat16()
        w = (torch.randn(N, K, generator=g, device="cuda") * 0.03).bfloat16()
        bias = torch.randn(N, generator=g, device="cuda") * 0.1
        first = gemm_bf16(a, w, bias)
        want = gemm_bf16_plain(a, w, bias)
        cases.append((a, w, bias, first, want))
    n_each = launches // len(cases)
    differ = torch.zeros(len(cases), dtype=torch.int64, device="cuda")
    t0 = time.perf_counter()
    for i in range(n_each):
        for j, (a, w, bias, first, _) in enumerate(cases):
            out = gemm_bf16(a, w, bias)
            if i % 100 == 99 or i == n_each - 1:
                differ[j] += (out != first).sum()
    done = torch.cuda.Event()
    done.record()
    while True:
        try:
            if done.query():
                break
        except RuntimeError as e:
            print(f"GEMM soak: launch error {e!r}; barrier fault record: "
                  f"{dense_fault_report()} [{card}]", flush=True)
            os._exit(1)
        if time.perf_counter() - t0 > limit_s:
            print(f"GEMM soak: {launches} launches not finished "
                  f"after {limit_s:.0f} s: the ring hangs "
                  f"[{card}]", flush=True)
            os._exit(1)
        time.sleep(0.01)
    seconds = time.perf_counter() - t0
    for (M, N, K), (_, _, _, first, want), n_diff in zip(
            GEMM_SOAK_SHAPES, cases, differ.tolist()):
        err = (first.float() - want.float()).abs().max().item()
        if err > bf16_tol(want):
            raise AssertionError(f"GEMM soak ({M},{N},{K}): err {err}")
        if n_diff:
            raise AssertionError(f"GEMM soak ({M},{N},{K}): {n_diff} "
                                 "elements differ from the first launch")
    log(f"GEMM soak: {n_each * len(cases)} launches over "
        f"{len(cases)} tile configurations {list(GEMM_SOAK_SHAPES)} in "
        f"{seconds:.2f} s, no hang, outputs unchanged [{card}]")
    return {"launches": n_each * len(cases), "seconds": seconds,
            "shapes": [list(x) for x in GEMM_SOAK_SHAPES]}


#: the define under which csrc/dense.cuh's producer withholds its first
#: arrival on full[0] in block 0 (a test-only broken ring)
TRAP_DEFINE = "ETP_TEST_WITHHOLD_ARRIVE"
# the trapped child's time limit: its build is done, its launch traps
# after kMbarTimeoutNs (4 s)
TRAP_LIMIT_S = 120
TRAP_EXIT = 3
TRAP_WANT = "timed out in mbar_wait on full[0], parity 0"


def start_trap_build(tmp: str) -> subprocess.Popen:
    """nvcc of csrc/prenorm_attention.cu (which includes csrc/dense.cuh)
    with TRAP_DEFINE into `tmp`, started beside the main build."""
    from etpnav_tpu_torch.ops import cuda_build
    out = os.path.join(tmp, "libprenorm_attention_trap.so")
    proc = subprocess.Popen(
        [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, f"-D{TRAP_DEFINE}",
         "-o", out, os.path.join(cuda_build.CSRC_DIR,
                                 "prenorm_attention.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    proc.lib_path = out
    return proc


def trap_child(lib_path: str) -> None:
    """`chip_smoke.py --trap-child LIB`: K-PRENORM's library built with
    TRAP_DEFINE stands in for the real one; one launch of its GEMM must
    end in a launch error, after which the barrier fault record is
    printed. Exits TRAP_EXIT then, 0 if the launch finished."""
    import ctypes

    from etpnav_tpu_torch.ops import cuda_build, fused_prenorm
    lib = ctypes.CDLL(lib_path)
    fused_prenorm._bind(lib)
    cuda_build._libs["prenorm_attention"] = lib
    g = torch.Generator(device="cuda").manual_seed(8)
    a = torch.randn(640, 768, generator=g, device="cuda").bfloat16()
    w = torch.randn(2304, 768, generator=g, device="cuda").bfloat16()
    bias = torch.zeros(2304, device="cuda")
    t0 = time.perf_counter()
    try:
        fused_prenorm.gemm_bf16(a, w, bias)
        torch.cuda.synchronize()
    except RuntimeError as e:
        msg = " ".join(str(e).split())
        print(f"trap child: launch error after "
              f"{time.perf_counter() - t0:.1f} s: {msg[:200]}", flush=True)
        print(f"trap child: fault record: {cuda_build.dense_fault_report()}",
              flush=True)
        os._exit(TRAP_EXIT)
    print("trap child: the launch finished", flush=True)
    os._exit(0)


def check_barrier_trap(card: str, proc: subprocess.Popen) -> dict:
    """The bounded barrier wait of csrc/dense.cuh: a child process launches
    the GEMM built with one arrival withheld (`trap_child`); it must exit
    with a launch error whose fault record names the barrier it waited
    on (block 0's consumers on full[0], parity 0), while this process's
    own CUDA context stays clean."""
    out, _ = proc.communicate()
    if proc.returncode != 0:
        raise AssertionError(f"nvcc -D{TRAP_DEFINE} failed:\n{out}")
    t0 = time.perf_counter()
    child = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--trap-child",
         proc.lib_path], capture_output=True, text=True,
        timeout=TRAP_LIMIT_S)
    seconds = time.perf_counter() - t0
    lines = [ln for ln in child.stdout.splitlines()
             if ln.startswith("trap child:")]
    if child.returncode != TRAP_EXIT or not any(TRAP_WANT in ln
                                                for ln in lines):
        raise AssertionError(
            f"barrier trap: child rc {child.returncode}, stdout "
            f"{child.stdout[-2000:]!r}, stderr {child.stderr[-2000:]!r}")
    x = torch.arange(4, device="cuda", dtype=torch.float32)
    if (x + 1).sum().item() != 10.0:
        raise AssertionError("barrier trap: the parent's context is spoiled")
    for ln in lines:
        log(f"{ln} [{card}]")
    log(f"barrier trap: the child (rc {child.returncode}) named its "
        f"barrier in {seconds:.1f} s; this process's context is clean "
        f"[{card}]")
    return {"rc": child.returncode, "seconds": seconds, "lines": lines}


def soak_main(launches: int) -> int:
    """`chip_smoke.py --soak-gemm N`: build K-PRENORM's library alone and
    run `soak_gemm` at N launches, for a run under compute-sanitizer;
    prints the result as one JSON line."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run",
              file=sys.stderr)
        return 2
    from etpnav_tpu_torch.ops import cuda_build
    card = card_line()
    secs = cuda_build.build_all(["prenorm_attention"])
    log(f"build: prenorm_attention in {secs:.2f} s")
    res = soak_gemm(card, launches, limit_s=3000.0)
    print(json.dumps({"soak_gemm": res, "card": card}), flush=True)
    return 0


def bf16_tol(want: torch.Tensor) -> float:
    top = want.float().abs().max().item()
    return BF16_ULPS * 2.0 ** (np.floor(np.log2(max(top, 1e-30))) - 7)


def fused_config(cfg):
    """`cfg` with the fused perception switches on."""
    return dataclasses.replace(
        cfg, clip=dataclasses.replace(cfg.clip, use_fused_block=True),
        depth=dataclasses.replace(cfg.depth, use_fused_gn=True))


def trace_gn_calls(cfg, batch: int) -> collections.Counter:
    """The K-GN calls of one fused depth-trunk pass over `batch` images on
    the card: (shape, groups, relu, residual?) -> count. The weights are
    zeros; only shapes are recorded, and every call's input must be
    channels_last, the layout K-GN takes."""
    from etpnav_tpu_torch.models import depth_resnet
    dcfg = fused_config(cfg).depth
    params = depth_resnet.DepthParams(dcfg).cuda().requires_grad_(False)
    calls = collections.Counter()
    orig = depth_resnet.group_norm_fused

    def record(p, x, groups, eps=1e-5, relu=False, residual=None):
        if not x.is_contiguous(memory_format=torch.channels_last):
            raise AssertionError(f"K-GN input {tuple(x.shape)} strides "
                                 f"{x.stride()} is not channels_last")
        calls[(tuple(x.shape), groups, relu, residual is not None)] += 1
        return orig(p, x, groups, eps, relu, residual)

    depth_resnet.group_norm_fused = record
    try:
        with torch.inference_mode():
            depth_resnet.encode_depth(
                params, dcfg,
                torch.zeros(batch, dcfg.input_size, dcfg.input_size, 1,
                            device="cuda"))
    finally:
        depth_resnet.group_norm_fused = orig
    return calls


def check_group_norm(card: str, calls: collections.Counter) -> dict:
    import torch.nn.functional as F

    from etpnav_tpu_torch.models.depth_resnet import GroupNorm
    from etpnav_tpu_torch.ops.fused_groupnorm import (
        group_norm_fused,
        group_norm_plain,
    )
    g = torch.Generator(device="cuda").manual_seed(2)
    rows = {}
    for (shape, G, relu, has_res), count in sorted(calls.items()):
        B, C, H, W = shape
        p = GroupNorm(C).cuda().requires_grad_(False)
        p.weight.copy_(1.0 + 0.1 * torch.randn(C, generator=g,
                                                device="cuda"))
        p.bias.copy_(0.1 * torch.randn(C, generator=g, device="cuda"))
        x32 = torch.randn(shape, generator=g, device="cuda").to(
            memory_format=torch.channels_last)
        r32 = torch.randn(shape, generator=g, device="cuda").to(
            memory_format=torch.channels_last) if has_res else None
        for dtype in (torch.float32, torch.bfloat16):
            x = x32.to(dtype)
            res = None if r32 is None else r32.to(dtype)
            got = group_norm_fused(p, x, G, relu=relu, residual=res)
            want = group_norm_plain(p, x, G, relu=relu, residual=res)
            torch.cuda.synchronize()
            assert got.stride() == x.stride(), "K-GN: output strides"
            assert torch.isfinite(got.float()).all(), "K-GN: not finite"
            err = (got.float() - want.float()).abs().max().item()
            tol = TOL[dtype] if dtype == torch.float32 else bf16_tol(want)
            name = (f"{C}x{H}x{W}g{G}{'+res' if has_res else ''}"
                    f"{'+relu' if relu else ''} cl/"
                    f"{str(dtype).split('.')[-1]}")
            if err > tol:
                raise AssertionError(f"K-GN {name}: max abs err {err} > "
                                     f"{tol}")
            again = group_norm_fused(p, x, G, relu=relu, residual=res)
            if not torch.equal(again, got):
                raise AssertionError(f"K-GN {name}: two launches differ")
            ms = cuda_ms(lambda: group_norm_fused(p, x, G, relu=relu,
                                                  residual=res))
            k_ms = kernel_ms(lambda: group_norm_fused(p, x, G, relu=relu,
                                                      residual=res))
            plain_ms = cuda_ms(lambda: group_norm_plain(p, x, G, relu=relu,
                                                        residual=res))
            w, b = p.weight.to(dtype), p.bias.to(dtype)
            lib_ms = cuda_ms(lambda: F.group_norm(x, G, w, b, 1e-5))
            # bytes: x and the residual read once, the output written
            # once; operations: ~8 fp32 ops per element on CUDA cores
            nbytes = x.numel() * x.element_size() * (3 if has_res else 2)
            b_ms, b_by = bound_ms(nbytes, 8.0 * x.numel(), torch.float32)
            rows[name] = {"shape": list(shape), "per_perceive": count,
                          "max_abs_err": err, "tol": tol, "ms": ms,
                          "kernel_ms": k_ms, "plain_ms": plain_ms,
                          "library_ms": lib_ms, "bound_ms": b_ms,
                          "bound_by": b_by}
            log(f"K-GN {name:32s} x{count:<2d} err={err:.3g} (tol {tol:.3g})"
                f" ms={ms:.4f} kernel_ms={k_ms:.4f} plain_ms={plain_ms:.4f} "
                f"group_norm_ms={lib_ms:.4f} (GN only, no ReLU/residual) "
                f"bound_ms={b_ms:.4f} ({b_by}) [{card}]")
    for dtype in ("float32", "bfloat16"):
        sel = [r for k, r in rows.items() if k.endswith(dtype)]
        log(f"K-GN {dtype}: {sum(r['per_perceive'] for r in sel)} launches "
            f"per fused perceive (B=96), weighted sums: kernel_ms "
            f"{sum(r['kernel_ms'] * r['per_perceive'] for r in sel):.4f} "
            f"ms={sum(r['ms'] * r['per_perceive'] for r in sel):.4f} "
            f"bound_ms={sum(r['bound_ms'] * r['per_perceive'] for r in sel):.4f}"
            f" [{card}]")
    return rows


def check_round_bf16(card: str) -> None:
    """The bf16 chains' weight rounding (`round_bf16_kernel`) against
    `.to(torch.bfloat16)`, bit for bit, on CLIP-width weights with exact
    rounding ties."""
    from etpnav_tpu_torch.ops.fused_prenorm import round_bf16
    g = torch.Generator(device="cuda").manual_seed(5)
    w = torch.randn(4 * 768, 768, generator=g, device="cuda")
    u = w.view(torch.int32)
    u[:768] = (u[:768] & -65536) | 0x8000
    got, want = round_bf16(w), w.to(torch.bfloat16)
    torch.cuda.synchronize()
    if not torch.equal(got.view(torch.int16), want.view(torch.int16)):
        raise AssertionError("round_bf16: differs from .to(torch.bfloat16)")
    log(f"round_bf16 (3072,768): bit-equal to .to(torch.bfloat16) [{card}]")


def check_prenorm(card: str, cfg) -> dict:
    from etpnav_tpu_torch.ops.attention import MHA, mha
    from etpnav_tpu_torch.ops.basic import LayerNorm, init_weights
    from etpnav_tpu_torch.ops.fused_prenorm import (
        prenorm_attention,
        prenorm_attention_plain,
    )
    c = cfg.clip
    D, H, eps = c.width, c.heads, c.layer_norm_eps
    L = (c.image_size // c.patch_size) ** 2 + 1
    B = 8 * 12                          # max_batch sessions x 12 views
    gen = torch.Generator().manual_seed(3)
    ln, attn = LayerNorm(D), MHA(D)
    init_weights(attn, gen)
    with torch.no_grad():
        ln.weight.copy_(1.0 + 0.1 * torch.randn(D, generator=gen))
        ln.bias.copy_(0.1 * torch.randn(D, generator=gen))
        for lin in (attn.q, attn.k, attn.v, attn.o):
            lin.bias.copy_(0.1 * torch.randn(D, generator=gen))
    ln, attn = ln.cuda().requires_grad_(False), attn.cuda().requires_grad_(
        False)
    g = torch.Generator(device="cuda").manual_seed(4)
    x32 = torch.randn(B, L, D, generator=g, device="cuda")
    rows = {}
    for dtype in (torch.float32, torch.bfloat16):
        x = x32.to(dtype)
        with torch.inference_mode():
            got = prenorm_attention(x, ln, attn, H, eps)
            want = prenorm_attention_plain(x, ln, attn, H, eps)
            torch.cuda.synchronize()
            assert torch.isfinite(got.float()).all(), "K-PRENORM: not finite"
            err = (got.float() - want.float()).abs().max().item()
            tol = TOL[dtype] if dtype == torch.float32 else bf16_tol(want)
            if err > tol:
                raise AssertionError(f"K-PRENORM {dtype}: max abs err {err}"
                                     f" > {tol}")

            def unfused():
                a = ln(x, eps)
                return x + mha(attn, a, a, H)

            ms = cuda_ms(lambda: prenorm_attention(x, ln, attn, H, eps),
                         iters=20)
            k_ms = kernel_ms(lambda: prenorm_attention(x, ln, attn, H, eps))
            plain_ms = cuda_ms(lambda: prenorm_attention_plain(
                x, ln, attn, H, eps), iters=20)
            unfused_ms = cuda_ms(unfused, iters=20)
            unfused_k_ms = kernel_ms(unfused)
            split = kernel_split(
                lambda: prenorm_attention(x, ln, attn, H, eps))
            # yardstick for the chain's q/k/v GEMM: one cuBLAS product of
            # the same shape in x's dtype
            a2 = x.reshape(-1, D)
            w3 = torch.cat([attn.q.weight, attn.k.weight,
                            attn.v.weight]).to(dtype)
            qkv_lib_k_ms = kernel_ms(lambda: torch.mm(a2, w3.t()))
        M, hd = B * L, D // H
        nbytes = 2 * x.numel() * x.element_size() + 4 * D * D * 4
        flops = 2.0 * M * D * 4 * D + 4.0 * B * H * L * L * hd
        b_ms, b_by = bound_ms(nbytes, flops, dtype)
        key = str(dtype).split(".")[-1]
        rows[key] = {"shape": [B, L, D], "max_abs_err": err, "tol": tol,
                     "ms": ms, "kernel_ms": k_ms, "plain_ms": plain_ms,
                     "unfused_half_block_ms": unfused_ms,
                     "unfused_half_block_kernel_ms": unfused_k_ms,
                     "library_qkv_gemm_kernel_ms": qkv_lib_k_ms,
                     "library_ms": None, "bound_ms": b_ms, "bound_by": b_by}
        log(f"K-PRENORM ({B},{L},{D}) {key} err={err:.3g} (tol {tol:.3g}) "
            f"ms={ms:.4f} kernel_ms={k_ms:.4f} plain_ms={plain_ms:.4f} "
            f"unfused_half_block_ms={unfused_ms:.4f} (kernel_ms "
            f"{unfused_k_ms:.4f}) bound_ms={b_ms:.4f} ({b_by}) [{card}]")
        for name, k, n in split:
            log(f"  K-PRENORM {key} {k:.4f} ms x{n:g} {name[:100]}")
        log(f"  cuBLAS torch.mm ({B * L},{D})x({D},{3 * D}) {key} kernel_ms "
            f"{qkv_lib_k_ms:.4f} (the q/k/v GEMM's yardstick)")
        rows[key]["kernel_split"] = [[name[:60], k] for name, k, _ in split]
    return rows


# ---------------------------------------------------------------------------
# phase 4: the serving slice
# ---------------------------------------------------------------------------

def timed(fn, sink: list):
    def wrapper(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        torch.cuda.synchronize()
        sink.append((time.perf_counter() - t0) * 1e3)
        return out
    return wrapper


GRAPH_COUNTERS = ("perceive_graph_replays", "perceive_eager_calls",
                  "perceive_graph_captures", "depth_graph_replays",
                  "depth_eager_calls", "depth_graph_captures")


def eager_perceive_of(agent):
    """`agent.perceive` as its gate runs it where it declines the graph
    (a generator, the tracer, the profiler): eager, the depth trunk by
    its own graph; counted in `perceive_eager_calls`."""
    @torch.inference_mode()
    def run(rgb, dep):
        return agent._perceive_graphs.eager(agent._t(rgb), agent._t(dep))
    return run


def serve(card: str, cfg, params, counters) -> dict:
    from etpnav_tpu_torch.serving import NavServer
    from etpnav_tpu_torch.training.agent import Agent

    agent = Agent(cfg, params, device="cuda")
    server = NavServer(cfg, agent, max_batch=8, max_wait_ms=20.0)
    try:
        t0 = time.perf_counter()
        n_prog = server.warmup()
        torch.cuda.synchronize()
        log(f"slice: warmup ran {n_prog} programs in "
            f"{time.perf_counter() - t0:.2f} s [{card}]")
        perceive_ms, nav_ms, batch_ms, step_ms = [], [], [], []
        agent.perceive = timed(agent.perceive, perceive_ms)
        agent.score_navigation = timed(agent.score_navigation, nav_ms)
        server._process = timed(server._process, batch_ms)

        # enough steps that every session meets the max_traj_len
        # force-stop and is replaced (the contract asks for >= 40)
        target = 8 * cfg.il.max_traj_len + 8
        lock = threading.Lock()
        state = {"served": 0, "sessions": 0, "errors": []}
        H, Hd = cfg.clip.image_size, cfg.depth.input_size
        ori = np.array([0.0, 0.0, 0.0, 1.0])
        for c in counters.values():
            c.reset()

        def client(seed: int) -> None:
            rng = np.random.default_rng(seed)
            try:
                while True:
                    with lock:
                        if state["served"] >= target:
                            return
                        state["sessions"] += 1
                    sid = server.create_session(
                        rng.integers(1, cfg.planner.vocab_size, 40))
                    pos = np.zeros(3)
                    while True:
                        rgb = rng.integers(0, 256, (12, H, H, 3), np.uint8)
                        dep = rng.random((12, Hd, Hd, 1), np.float32)
                        t = time.perf_counter()
                        res = server.step(sid, rgb, dep, pos, ori,
                                          timeout=300)
                        step_ms.append((time.perf_counter() - t) * 1e3)
                        act = res["action"]
                        assert act["act"] in (0, 4), act
                        assert np.isfinite(res["stop_prob"])
                        assert res["num_nodes"] >= 1
                        if act["act"] == 4:
                            assert np.asarray(act["ghost_pos"]).shape == (3,)
                            pos = np.asarray(act["ghost_pos"], np.float64)
                        with lock:
                            state["served"] += 1
                            stop = state["served"] >= target
                        if res["done"] or stop:
                            break
                    server.close_session(sid)
            except Exception as e:           # reported by the main thread
                state["errors"].append(repr(e))

        threads = [threading.Thread(target=client, args=(100 + i,))
                   for i in range(8)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        wall = time.perf_counter() - t0
        if any(t.is_alive() for t in threads):
            raise AssertionError("slice: a client thread did not finish")
        if state["errors"]:
            raise AssertionError(f"slice: client errors {state['errors']}")
        # the main path's launches and times end here: read them before
        # the profiler calls the programs again, unwrapped
        counts = {name: c.value for name, c in counters.items()}
        stats = server.stats()
        del agent.perceive, agent.score_navigation, server._process
        ops = profile_step(card, agent, cfg)
    finally:
        server.shutdown()
    if stats["steps_served"] < target:
        raise AssertionError(f"slice: {stats['steps_served']} steps served")
    # warmup() captured the whole perceive's graph, whose warm-up run
    # captured the depth trunk's and whose capture ran the trunk eagerly
    # into it; every served perceive replayed the perceive graph alone
    graphs = {k: stats[k] for k in GRAPH_COUNTERS}
    if graphs != {"perceive_graph_replays": len(perceive_ms),
                  "perceive_eager_calls": 0, "perceive_graph_captures": 1,
                  "depth_graph_replays": 0, "depth_eager_calls": 1,
                  "depth_graph_captures": 1}:
        raise AssertionError(f"slice: graph counters {graphs} for "
                             f"{len(perceive_ms)} perceive calls")
    res = {"steps": stats["steps_served"], "batches": stats["batches"],
           "sessions": state["sessions"],
           "mean_occupancy": stats["mean_occupancy"], "wall_s": wall,
           "perceive_p50_ms": statistics.median(perceive_ms),
           "score_navigation_p50_ms": statistics.median(nav_ms),
           "batch_p50_ms": statistics.median(batch_ms),
           "client_step_p50_ms": statistics.median(step_ms),
           "perceive_calls": len(perceive_ms),
           "navigation_calls": len(nav_ms), "counts": counts, **ops}
    log(f"slice: {json.dumps(res)} [{card}]")
    return res


def device_ops(fn, reps: int = 1) -> int:
    """Device ops (kernels and copies) per call of fn, from torch.profiler:
    `reps` calls profiled together, the count divided by reps and
    rounded. A window's count moves by a few events with the process's
    earlier profiles (on the card perceive read 2395-2402 within one
    run), so no exact check reads it."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return round(sum(e.count for e in prof.key_averages()
                     if e.device_type == torch.autograd.DeviceType.CUDA
                     and e.self_device_time_total > 0) / reps)


def dispatched_ops(fn) -> int:
    """The operators one call of fn dispatches through PyTorch's
    dispatcher (each a device op or a view; the port's own kernels
    allocate their outputs there): a deterministic count, where
    torch.profiler's count of a window's device events moves by a few
    events with the process's earlier profiles."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Count.n += 1
            return func(*args, **(kwargs or {}))

    with Count():
        fn()
    return Count.n


def perceive_ops(card: str, agent, rgb, dep) -> dict:
    """Ops per eager perceive with K-NMS writing the candidate slots,
    against the same perceive with the slots taken by the
    `extract_candidates` chain from K-NMS's map (the earlier path), and
    that chain's own ops: the first must be the second less the third,
    counted exactly by the dispatcher; the device ops of each from
    torch.profiler beside them. Eager: a replay of the perceive graph
    dispatches its copies alone and would not see the chain patched in."""
    from etpnav_tpu_torch.models import waypoint
    from etpnav_tpu_torch.ops.nms import extract_candidates
    fused = waypoint.heatmap_nms_fused

    def with_chain(logits, k, sigma):
        nms_map = fused(logits, k, sigma)[0]
        return (nms_map,) + tuple(extract_candidates(nms_map[:, 1:-1], k))

    nms_map = torch.rand(8, 122, 12, device=agent.device)
    eager = eager_perceive_of(agent)

    def perceive():
        eager(rgb, dep)

    def chain():
        extract_candidates(nms_map[:, 1:-1], 5)

    counts = {}
    for name, fn in (("perceive", perceive), ("chain", chain)):
        counts[name] = (dispatched_ops(fn), device_ops(fn, reps=3))
    waypoint.heatmap_nms_fused = with_chain
    try:
        counts["perceive_with_chain"] = (dispatched_ops(perceive),
                                         device_ops(perceive, reps=3))
    finally:
        waypoint.heatmap_nms_fused = fused
    (ops, dev), (ops_chain, dev_chain), (chain_ops, dev_chain_alone) = (
        counts[k] for k in ("perceive", "perceive_with_chain", "chain"))
    log(f"ops per perceive (dispatched / device): {ops} / {dev} with "
        f"K-NMS's slots, {ops_chain} / {dev_chain} with the "
        f"extract_candidates chain ({chain_ops} / {dev_chain_alone} ops) "
        f"[{card}]")
    if ops_chain - ops != chain_ops:
        raise AssertionError(f"perceive: {ops} dispatched ops, {ops_chain} "
                             f"with the chain of {chain_ops}")
    return {"perceive_ops": dev, "perceive_ops_with_chain": dev_chain,
            "chain_ops": dev_chain_alone, "perceive_dispatched": ops,
            "perceive_dispatched_with_chain": ops_chain,
            "chain_dispatched": chain_ops}


def profile_step(card: str, agent, cfg) -> dict:
    """Device time by kernel for one perceive (B=8) and one navigation
    scoring (B=8, G=64), from torch.profiler; then `perceive_ops`."""
    from torch.profiler import ProfilerActivity, profile
    rng = np.random.default_rng(3)
    H, Hd, D = cfg.clip.image_size, cfg.depth.input_size, cfg.planner.hidden_size
    rgb = rng.integers(0, 256, (8, 12, H, H, 3), np.uint8)
    dep = rng.random((8, 12, Hd, Hd, 1), np.float32)
    G, L = 64, cfg.il.max_text_len
    gmap = {"img_fts": rng.standard_normal((8, G, D)).astype(np.float32),
            "step_ids": rng.integers(0, 20, (8, G)),
            "pos_fts": rng.standard_normal((8, G, 7)).astype(np.float32),
            "mask": np.arange(G)[None].repeat(8, 0) < 40,
            "visited": np.zeros((8, G), bool),
            "pair_dists": rng.random((8, G, G)).astype(np.float32)}
    txt = rng.standard_normal((8, L, D)).astype(np.float32)
    tmask = np.arange(L)[None].repeat(8, 0) < 30
    for name, fn in (("perceive", lambda: agent.perceive(rgb, dep)),
                     ("score_navigation",
                      lambda: agent.score_navigation(txt, tmask, gmap))):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        # device-side entries only (kernels and copies); the CPU-side
        # aten:: entries repeat the time of the kernels they launched
        ev = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and e.self_device_time_total > 0]
        dev_ms = sum(e.self_device_time_total for e in ev) / 1e3
        top = sorted(ev, key=lambda e: -e.self_device_time_total)[:10]
        log(f"profile {name}: wall {wall_ms:.2f} ms (profiled), device "
            f"busy {dev_ms:.2f} ms ({100 * dev_ms / wall_ms:.1f}%), "
            f"{sum(e.count for e in ev)} device ops [{card}]")
        for e in top:
            log(f"  {e.self_device_time_total / 1e3:8.3f} ms "
                f"x{e.count:<5d} {e.key[:90]}")
    return perceive_ops(card, agent, rgb, dep)


# ---------------------------------------------------------------------------
# phase 5: card (kernels) against CPU (plain versions), fp32
# ---------------------------------------------------------------------------

def slice_parity(card: str, cfg, params, counters) -> dict:
    from etpnav_tpu_torch.training.agent import Agent
    cpu = Agent(cfg, copy.deepcopy(params).cpu(), device="cpu")
    gpu = Agent(cfg, params, device="cuda")
    rng = np.random.default_rng(7)
    H, Hd = cfg.clip.image_size, cfg.depth.input_size
    rgb = rng.integers(0, 256, (1, 12, H, H, 3), np.uint8)
    dep = rng.random((1, 12, Hd, Hd, 1), np.float32)
    ids = np.zeros((1, cfg.il.max_text_len), np.int64)
    ids[0, :10] = rng.integers(1, cfg.planner.vocab_size, 10)
    tmask = ids != 0
    G, D = 16, cfg.planner.hidden_size
    gmap = {"img_fts": rng.standard_normal((1, G, D)).astype(np.float32),
            "step_ids": rng.integers(0, 20, (1, G)),
            "pos_fts": rng.standard_normal((1, G, 7)).astype(np.float32),
            "mask": np.arange(G)[None] < 9,
            "visited": (np.arange(G)[None] >= 1) & (np.arange(G)[None] < 4),
            "pair_dists": rng.random((1, G, G)).astype(np.float32)}
    per_call = {}
    outs = {}
    for name, agent in (("cpu", cpu), ("gpu", gpu)):
        before = {k: c.value for k, c in counters.items()}
        txt = agent.encode_text(ids, tmask)
        mid = {k: c.value for k, c in counters.items()}
        wp = agent.perceive(rgb, dep)
        mid2 = {k: c.value for k, c in counters.items()}
        nav = agent.score_navigation(txt, tmask, gmap)
        after = {k: c.value for k, c in counters.items()}
        outs[name] = {"txt": txt, "heatmap": wp["heatmap"],
                      "pano_embeds": wp["pano_embeds"],
                      "cand_valid": wp["cand_valid"],
                      "cand_img_idx": wp["cand_img_idx"],
                      "global_logits": nav["global_logits"]}
        if name == "gpu":
            torch.cuda.synchronize()
            per_call = {k: {"encode_text": mid[k] - before[k],
                            "perceive": mid2[k] - mid[k],
                            "score_navigation": after[k] - mid2[k]}
                        for k in counters}
    errs = {}
    for key in ("txt", "heatmap", "pano_embeds", "global_logits"):
        a = outs["cpu"][key].float()
        b = outs["gpu"][key].float().cpu()
        fin = torch.isfinite(a)
        if not torch.equal(fin, torch.isfinite(b)):
            raise AssertionError(f"parity {key}: -inf slots differ")
        rel = ((a[fin] - b[fin]).abs().max() /
               a[fin].abs().max().clamp_min(1e-12)).item()
        errs[key] = rel
        if rel > SLICE_REL_TOL:
            raise AssertionError(f"parity {key}: rel err {rel} > "
                                 f"{SLICE_REL_TOL}")
    for key in ("cand_valid", "cand_img_idx"):
        if not torch.equal(outs["cpu"][key], outs["gpu"][key].cpu()):
            raise AssertionError(f"parity {key}: candidate slots differ")
    res = {"rel_err": errs, "launches_per_call": per_call}
    log(f"parity (fp32, B=1, card vs CPU): {json.dumps(res)} [{card}]")
    return res


# ---------------------------------------------------------------------------
# phase 7: the IL training step
# ---------------------------------------------------------------------------

# K-ATT and K-ATT-BWD launches per learn step at r2r_config: 9 text +
# 2 pano + 4 x (cross + graph self-attention)
LEARN_ATTENTIONS = 19


def geometric_envs(cfg, n: int, seed: int):
    from etpnav_tpu_torch.env.geometric import GeometricNavEnv
    return GeometricNavEnv(
        n, seed=seed, vocab_size=cfg.planner.vocab_size,
        max_instr_len=cfg.il.max_text_len, image_size=cfg.clip.image_size,
        depth_size=cfg.depth.input_size, pad_id=cfg.planner.pad_token_id)


_CALLS_LOCK = threading.Lock()


def counted(fn, calls: collections.Counter, name: str):
    """fn, counting its calls in `calls[name]` (from any thread: the
    pipelined rollout calls the agent's programs from two)."""
    def wrapper(*a, **kw):
        with _CALLS_LOCK:
            calls[name] += 1
        return fn(*a, **kw)
    return wrapper


def train_phase(card: str, cfg, counters) -> dict:
    """`FinetuneTrainer(r2r_config(), GeometricNavEnv(8), device="cuda")`
    trains 2 iterations (rollout + bucketed learn step). Exact launch
    counts, no plain call, a finite loss, trained parameters moved and
    the frozen towers did not; then the learn-step p50 at (T20, G64) and
    (T20, G96), the peak memory, and one profiled learn step."""
    from etpnav_tpu_torch.training.finetune import (
        FinetuneTrainer,
        learn_step,
        slice_record,
    )
    t0 = time.perf_counter()
    tr = FinetuneTrainer(cfg, geometric_envs(cfg, 8, seed=0), seed=0,
                         device="cuda")
    log(f"train: trainer at r2r_config in {time.perf_counter() - t0:.1f} s "
        f"[{card}]")
    planner = tr.params.planner
    before = {n: p.detach().clone() for n, p in planner.named_parameters()}
    frozen = {n: p.detach().clone() for n, p in tr.params.named_parameters()
              if not n.startswith("planner.")}
    calls = collections.Counter()
    records = []
    agent, engine = tr.agent, tr.engine
    agent.perceive = counted(agent.perceive, calls, "perceive")
    agent.score_navigation = counted(agent.score_navigation, calls,
                                     "navigation")
    agent.encode_text = counted(agent.encode_text, calls, "text")
    run = engine.run

    def recording_run(*a, **kw):
        rec = run(*a, **kw)
        records.append(rec)
        return rec
    engine.run = recording_run
    for c in counters.values():
        c.reset()
    iters = 2
    logs = tr.train(iters)
    torch.cuda.synchronize()
    counts = {name: c.value for name, c in counters.items()}
    del agent.perceive, agent.score_navigation, agent.encode_text, engine.run
    # the rollout's programs launch what serving's do (PER_CALL); each
    # learn step LEARN_ATTENTIONS K-ATT and K-ATT-BWD
    per = PER_CALL["default"]
    want = {k: sum(per[prog].get(k, 0) * calls[prog] for prog in per)
            for k in counts}
    want["attention_fwd"] += LEARN_ATTENTIONS * iters
    want["attention_bwd"] += LEARN_ATTENTIONS * iters
    if counts != want:
        raise AssertionError(f"train: launches {counts} != {want} for "
                             f"{dict(calls)} and {iters} learn steps")
    if not np.isfinite(tr.logs["IL_loss"]).all():
        raise AssertionError(f"train: loss {tr.logs['IL_loss']}")
    # the rollout's waypoint augmentation passes a generator, so every
    # perceive ran eagerly: the first captured the depth trunk's graph at
    # the rollout's one shape, every later one replayed it
    graphs = [sum(tr.logs[k]) for k in GRAPH_COUNTERS]
    if graphs != [0, calls["perceive"], 0, calls["perceive"] - 1, 0, 1]:
        raise AssertionError(f"train: {GRAPH_COUNTERS} {graphs} for "
                             f"{calls['perceive']} perceive calls")
    moved = still = 0
    for n, p in planner.named_parameters():
        if not torch.equal(p, before[n]):
            moved += 1
        elif p.grad is not None and p.grad.abs().max() > 0:
            raise AssertionError(f"train: {n} has a gradient but did not "
                                 "move")
        else:
            still += 1
    for n, p in tr.params.named_parameters():
        if n in frozen and not torch.equal(p, frozen[n]):
            raise AssertionError(f"train: frozen {n} moved")
    log(f"train: {iters} iterations, loss {tr.logs['IL_loss']}, rollout s "
        f"{tr.logs['rollout_s']}, learn s {tr.logs['learn_s']}, buckets "
        f"{tr.bucket_counts}; launches exact {counts} for {dict(calls)}; "
        f"{moved} planner tensors moved, {still} without gradient did not, "
        f"{len(frozen)} frozen tower tensors unchanged [{card}]")

    # learn-step p50 at the two largest train buckets, from the last
    # recorded interval (full T = 20, G = 96; sliced to G = 64, where a
    # teacher label past slot 64 is ignored: the timing needs the shape)
    rec = records[-1]
    times = {}
    peak = {}
    for T, G in ((20, 64), (20, 96)):
        cut = slice_record(rec, T, G)
        cut = dataclasses.replace(cut, teacher=np.where(
            cut.teacher < G, cut.teacher, -100).astype(np.int32))
        batch = tr.batch(cut)
        float(learn_step(planner, tr.optimizer, cfg, batch, tr.generator))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ms = []
        for _ in range(6):
            t1 = time.perf_counter()
            float(learn_step(planner, tr.optimizer, cfg, batch,
                             tr.generator))
            ms.append((time.perf_counter() - t1) * 1e3)
        times[f"T{T}_G{G}"] = {"p50_ms": statistics.median(ms),
                               "min_ms": min(ms), "n": len(ms)}
        peak[f"T{T}_G{G}"] = torch.cuda.max_memory_allocated() / 2 ** 30
    prof = profile_learn_step(card, tr, batch)
    res = {"loss": tr.logs["IL_loss"], "rollout_s": tr.logs["rollout_s"],
           "learn_s": tr.logs["learn_s"],
           "buckets": {f"T{t}_G{g}": n for (t, g), n
                       in tr.bucket_counts.items()},
           "calls": dict(calls), "counts": counts,
           "learn_step": times, "peak_gib": peak, "profile": prof,
           "record_demand": {"T": int(rec.step_valid.any(0).sum()),
                             "G": int(rec.gmap_mask.sum(-1).max())}}
    log(f"train: {json.dumps(res)} [{card}]")
    return res, tr, rec


def profile_learn_step(card: str, tr, batch) -> dict:
    """Device time by kernel of one learn step, from torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    from etpnav_tpu_torch.training.finetune import learn_step
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        float(learn_step(tr.params.planner, tr.optimizer, tr.cfg, batch,
                         tr.generator))
        wall_ms = (time.perf_counter() - t0) * 1e3
    # the optimizer's profiler range ("Optimizer.step#AdamW.step") shows
    # on the device timeline too, spanning kernels counted on their own
    ev = [e for e in prof.key_averages()
          if e.device_type == torch.autograd.DeviceType.CUDA
          and e.self_device_time_total > 0
          and not e.key.startswith("Optimizer.")]
    dev_ms = sum(e.self_device_time_total for e in ev) / 1e3
    top = sorted(ev, key=lambda e: -e.self_device_time_total)[:12]
    log(f"profile learn step (T20, G96): wall {wall_ms:.2f} ms (profiled), "
        f"device busy {dev_ms:.2f} ms ({100 * dev_ms / wall_ms:.1f}%), "
        f"{sum(e.count for e in ev)} device ops [{card}]")
    for e in top:
        log(f"  {e.self_device_time_total / 1e3:8.3f} ms "
            f"x{e.count:<5d} {e.key[:90]}")
    # the attention kernels' own share, wherever they rank
    attn = {e.key[e.key.find("attention_"):].split("(")[0]:
            [e.self_device_time_total / 1e3, e.count]
            for e in ev if "attention_" in e.key}
    log(f"  attention kernels of the step: {json.dumps(attn)}")
    return {"wall_ms": wall_ms, "device_ms": dev_ms,
            "device_ops": sum(e.count for e in ev),
            "top": [[e.key[:60], e.self_device_time_total / 1e3, e.count]
                    for e in top[:6]], "attention": attn}


# K-BLOCK against the port's unfused `self_attention_block` (cuBLAS GEMMs,
# K-ATT, LayerNorm) on the card. fp32: both fp32, the sums in another
# order and the softmax divided at another point. bf16: the unfused block
# also rounds the dense layers' biases, the output projection and x + h to
# bf16 before the LayerNorm, where K-BLOCK (the TPU kernel's rounding
# points) keeps them fp32: four bf16 ulps at the largest output.
BLOCK_UNFUSED_ULPS = 4


# card (fp32, kernels) against CPU (fp32, plain versions): the learn
# step's loss and every planner gradient, max |diff| <= LEARN_REL_TOL *
# max |CPU gradient| + 1e-6 per tensor. fp32 sums in another order
# through the forward and backward of 9 + 2 + 4 BERT layers at full
# width, the aggregation scatter and the AdamW-free gradient itself.
LEARN_REL_TOL = 2e-4
# the same step in bf16 (the stacks' activations, so every attention runs
# K-ATT's and K-ATT-BWD's tensor-core kernels) against fp32 on the card,
# beside the same bf16 step with the attention's plain versions on the
# card. Per tensor whose gradient norm is at least BF16_LIVE of the
# largest: ||g_bf16 - g_fp32|| / ||g_fp32|| <= BF16_GRAD_L2. A max-norm
# bound relative to each tensor's largest gradient does not hold for the
# bf16 model itself: with random weights some LayerNorms see nearly
# constant rows, so their backward cancels and bf16 moves single elements
# of the tensors behind them (the SAP head's dense1) by 40-60% of their
# largest, with the plain versions as with the kernels. The L2 ratio of
# the bf16 step, kernels or plain, is ~0.15 per tensor and ~0.1 overall;
# a kernel fault such as dK written to the wrong head puts the affected
# tensors above 1. The kernels' overall ratio must also stay within
# BF16_VS_PLAIN times the plain versions' (only their sum order and p's
# running-max rounding point differ). Tensors below BF16_LIVE carry
# rounding noise (the key projections' biases, whose exact gradient is 0).
BF16_GRAD_L2 = 0.3
BF16_LIVE = 1e-2
BF16_VS_PLAIN = 1.5
# the bf16 loss against the fp32 one: a mean of cross entropies over
# logits that carry bf16 roundings (2^-9 relative each); seen up to 1.2e-3
BF16_LOSS_REL = 5e-3


def learn_parity(card: str, cfg, cfg32, tr, rec, counters) -> dict:
    """Phase 7b: compute_il_loss and its gradients at full R2R width in
    fp32 with dropout off, on the card (kernels) and on the CPU (plain
    versions), for 2 envs x 3 steps of the recorded interval; then the
    same step on the card in bf16 (`cfg`) against the card's fp32 one."""
    from etpnav_tpu_torch.training.finetune import (
        compute_il_loss,
        record_to_batch,
        slice_record,
    )
    small = slice_record(rec, 3, 32)
    small = dataclasses.replace(small, **{
        f.name: getattr(small, f.name)[:2]
        for f in dataclasses.fields(small)})
    gpu_planner = tr.params.planner
    cpu_planner = copy.deepcopy(gpu_planner).cpu()
    out = {}
    for name, pl, dev, step_cfg in (("cpu", cpu_planner, "cpu", cfg32),
                                    ("gpu", gpu_planner, "cuda", cfg32),
                                    ("gpu_bf16", gpu_planner, "cuda", cfg),
                                    ("gpu_bf16_plain", gpu_planner, "cuda",
                                     cfg)):
        if name == "gpu_bf16_plain":
            restore = attention_on_plain_versions()
        pl.zero_grad(set_to_none=True)
        before = {k: c.value for k, c in counters.items()}
        loss = compute_il_loss(pl, step_cfg, record_to_batch(small, dev))
        loss.backward()
        if dev == "cuda":
            torch.cuda.synchronize()
        launches = {k: c.value - before[k] for k, c in counters.items()}
        out[name] = (loss.item(), {n: p.grad.detach().cpu()
                                   for n, p in pl.named_parameters()
                                   if p.grad is not None}, launches)
        if name == "gpu_bf16_plain":
            restore()
    want_l = {k: 0 for k in counters}
    want_l["attention_fwd"] = want_l["attention_bwd"] = LEARN_ATTENTIONS
    for name in ("gpu", "gpu_bf16"):
        if out[name][2] != want_l:
            raise AssertionError(f"learn parity: {name} launches "
                                 f"{out[name][2]} != {want_l}")
    want_p = {k: 0 for k in counters}
    want_p["attention_plain"] = want_p["attention_bwd_plain"] = \
        LEARN_ATTENTIONS
    if out["gpu_bf16_plain"][2] != want_p:
        raise AssertionError(f"learn parity: plain bf16 step launches "
                             f"{out['gpu_bf16_plain'][2]} != {want_p}")
    l_cpu, g_cpu, _ = out["cpu"]
    l_gpu, g_gpu, _ = out["gpu"]
    loss_rel = abs(l_gpu - l_cpu) / max(abs(l_cpu), 1e-12)
    if loss_rel > LEARN_REL_TOL:
        raise AssertionError(f"learn parity: loss {l_gpu} vs {l_cpu}")
    if set(g_cpu) != set(g_gpu):
        raise AssertionError("learn parity: gradient sets differ")
    # the share of its tolerance each tensor uses, and the relative error
    # of the tensors whose gradient is not zero in exact arithmetic (the
    # key projections' biases add a per-row constant to the logits, which
    # the softmax cancels: their gradients are rounding noise ~1e-7)
    share, rel = (-1.0, ""), (-1.0, "")
    for n, gc in g_cpu.items():
        top = gc.abs().max().item()
        err = (g_gpu[n] - gc).abs().max().item()
        tol = LEARN_REL_TOL * top + 1e-6
        if err > tol:
            raise AssertionError(f"learn parity: grad {n} err {err} "
                                 f"(max |g| {top})")
        share = max(share, (err / tol, n))
        if top > 1e-4:
            rel = max(rel, (err / top, n))
    res = {"loss_cpu": l_cpu, "loss_gpu": l_gpu, "loss_rel": loss_rel,
           "grad_tensors": len(g_cpu), "worst_tol_share": share[0],
           "worst_tol_share_grad": share[1], "worst_grad_rel": rel[0],
           "worst_grad": rel[1], "launches": out["gpu"][2]}
    log(f"learn parity (fp32, 2 envs x 3 steps, card vs CPU): "
        f"{json.dumps(res)} [{card}]")
    res["bf16"] = bf16_learn_parity(card, out["gpu"], out["gpu_bf16"],
                                    out["gpu_bf16_plain"])
    return res


def attention_on_plain_versions():
    """Send K-ATT's and K-ATT-BWD's wrappers to their plain versions, on
    the card's tensors too; returns the function that undoes it."""
    from etpnav_tpu_torch.ops import fused_attention as fa
    fwd, bwd = fa.attention_fwd, fa.attention_bwd
    fa.attention_fwd, fa.attention_bwd = fa.attention_plain, \
        fa.attention_bwd_plain

    def restore():
        fa.attention_fwd, fa.attention_bwd = fwd, bwd
    return restore


def bf16_learn_parity(card: str, fp32, bf16, bf16_plain) -> dict:
    """The bf16 learn step's loss and gradients, with the kernels and with
    the plain versions, against the fp32 step, all on the card (phase
    7b)."""
    (l32, g32, _), (l16, g16, launches), (lp, gp, _) = fp32, bf16, bf16_plain
    if not set(g32) == set(g16) == set(gp):
        raise AssertionError("bf16 learn parity: gradient sets differ")
    norms = {n: g.norm().item() for n, g in g32.items()}
    live = [n for n in g32 if norms[n] >= BF16_LIVE * max(norms.values())]
    ref = sum(norms[n] ** 2 for n in g32) ** 0.5

    def l2(g):
        for n in g:
            if not torch.isfinite(g[n]).all():
                raise AssertionError(f"bf16 learn parity: grad {n} not "
                                     "finite")
        per = {n: ((g[n] - g32[n]).norm() / norms[n]).item() for n in live}
        total = sum(((g[n] - g32[n]) ** 2).sum().item()
                    for n in g32) ** 0.5 / ref
        return per, total

    per, total = l2(g16)
    per_p, total_p = l2(gp)
    worst = sorted(per, key=per.get)[-3:]
    res = {"loss_fp32": l32, "loss_bf16": l16, "loss_bf16_plain": lp,
           "loss_rel": abs(l16 - l32) / max(abs(l32), 1e-12),
           "grad_tensors": len(g32), "live_tensors": len(live),
           "worst_l2_rel": {n: per[n] for n in worst},
           "worst_l2_rel_plain": max(per_p.values()),
           "total_l2_rel": total, "total_l2_rel_plain": total_p,
           "launches": launches}
    log(f"learn parity (bf16 vs fp32, both on the card; tensor-core "
        f"attention, and its plain versions): {json.dumps(res)} [{card}]")
    if (per[worst[-1]] > BF16_GRAD_L2 or res["loss_rel"] > BF16_LOSS_REL
            or total > BF16_VS_PLAIN * total_p):
        raise AssertionError(f"bf16 learn parity: {res}")
    return res


# ---------------------------------------------------------------------------
# phase 8: K-BLOCK on the model's own layers
# ---------------------------------------------------------------------------

def block_tol(want: torch.Tensor, dtype) -> float:
    """K-BLOCK against its plain version on the card: fp32 1e-5 of the
    largest output + 1e-5 (LayerNorm outputs up to ~5; the fp32 sums of
    768 products run in another order); bf16 two ulps of the largest
    (both round at the same points; a value next to a tie may land one
    ulp apart, and an ulp of q/k/v or ctx moves the output by about one)."""
    if dtype == torch.bfloat16:
        return bf16_tol(want)
    return 1e-5 * want.float().abs().max().item() + 1e-5


def record_blocks(cfg, planner_p) -> list:
    """(name, AttentionBlock, x, bias, eps) of the attention block of each
    text-encoder layer (8 instructions of L = 80 tokens, `forward_txt`)
    and of each cross-modal layer's graph self-attention (G = 96 slots,
    `forward_navigation`), on the inputs the unfused stacks feed them, in
    the stacks' dtype."""
    from etpnav_tpu_torch.models import bert_core, planner
    pc = cfg.planner
    rng = np.random.default_rng(21)
    B, L, G, D = 8, cfg.il.max_text_len, 96, pc.hidden_size
    lengths = rng.integers(10, L + 1, (B, 1))
    ids = np.where(np.arange(L)[None] < lengths,
                   rng.integers(1, pc.vocab_size, (B, L)), pc.pad_token_id)
    dev = torch.device("cuda")
    ids_t = torch.from_numpy(ids).to(dev)
    tmask = torch.from_numpy(np.arange(L)[None] < lengths).to(dev)
    gmask = torch.arange(G, device=dev)[None].expand(B, G) < 66
    calls = []

    def recorder(tag, orig):
        def rec(params, x, num_heads, bias, eps, **kw):
            n = sum(c[0].startswith(tag) for c in calls)
            calls.append((f"{tag}{n}", params, x.clone(), bias, eps))
            return orig(params, x, num_heads, bias, eps, **kw)
        return rec

    orig_txt, orig_nav = (bert_core.self_attention_block,
                          planner.self_attention_block)
    bert_core.self_attention_block = recorder("text", orig_txt)
    planner.self_attention_block = recorder("graph", orig_nav)
    try:
        txt = planner.forward_txt(planner_p, pc, ids_t, tmask)
        planner.forward_navigation(
            planner_p, pc, txt, tmask,
            torch.from_numpy(rng.standard_normal((B, G, D)).astype(
                np.float32)).to(dev),
            torch.from_numpy(rng.integers(0, 20, (B, G))).to(dev),
            torch.from_numpy(rng.standard_normal((B, G, 7)).astype(
                np.float32)).to(dev),
            gmask, torch.zeros(B, G, dtype=torch.bool, device=dev),
            torch.from_numpy((rng.random((B, G, G)) * 10).astype(
                np.float32)).to(dev))
    finally:
        bert_core.self_attention_block = orig_txt
        planner.self_attention_block = orig_nav
    n_txt = sum(c[0].startswith("text") for c in calls)
    if n_txt != pc.num_l_layers or len(calls) - n_txt != pc.num_x_layers:
        raise AssertionError(f"K-BLOCK: recorded {[c[0] for c in calls]}")
    return calls


def block_work(x: torch.Tensor, bias) -> tuple:
    """Bytes (x read and the output written once, the fp32 weights, biases
    and LN parameters read once, the bias's stored elements) and FLOP
    (2*M*D*4D for the projections + 4*B*L^2*D for q.k and p.v)."""
    Bx, L, D = x.shape
    nbytes = (2 * x.numel() * x.element_size() + 4 * (4 * D * D + 6 * D)
              + (0 if bias is None else 4 * bias.numel()))
    return nbytes, 2.0 * Bx * L * D * 4 * D + 4.0 * Bx * L * L * D


def check_block(card: str, cfg, planner_p, counters) -> tuple:
    """Phase 8: K-BLOCK on the 9 text-encoder and 4 graph self-attention
    blocks of `r2r_config` (stack dtype and fp32) and alone at the TPU
    note's (160, 64) and (64, 200), the ragged (7, 83), and (16, 200) with
    a bias per (query, key) too large to stage. The launches run first with every
    count at 0 and are read before anything else runs; then each is held
    to its plain version and to the port's unfused block, and one case per
    shape and dtype is timed."""
    from etpnav_tpu_torch.ops.attention import self_attention_block
    from etpnav_tpu_torch.ops.fused_block import (
        attention_block,
        attention_block_plain,
    )
    pc = cfg.planner
    H = pc.num_heads
    cases = []
    for name, p, x, bias, eps in record_blocks(cfg, planner_p):
        for dtype in dict.fromkeys((x.dtype, torch.float32)):
            cases.append((name, p, x.to(dtype), bias, eps))
    g = torch.Generator(device="cuda").manual_seed(22)
    p0 = planner_p.lang_encoder[0].attention
    for Bx, L in ((160, 64), (64, 200), (7, 83)):
        x32 = torch.randn(Bx, L, pc.hidden_size, generator=g, device="cuda")
        keep = torch.randint(L // 3, L + 1, (Bx, 1), generator=g,
                             device="cuda")
        bias = ((torch.arange(L, device="cuda")[None] >= keep).float()
                * -10000.0)[:, None, None, :]
        for dtype in (torch.bfloat16, torch.float32):
            cases.append((f"alone_{Bx}x{L}", p0, x32.to(dtype), bias,
                          pc.lang_layer_norm_eps))
    # a bias per (query, key) too large to stage: read where it lies
    x32 = torch.randn(16, 200, pc.hidden_size, generator=g, device="cuda")
    bias = torch.randn(16, 1, 200, 200, generator=g, device="cuda")
    for dtype in (torch.bfloat16, torch.float32):
        cases.append(("alone_16x200_full_bias", p0, x32.to(dtype), bias,
                      pc.lang_layer_norm_eps))
    for c in counters.values():
        c.reset()
    outs = [attention_block(x, p, bias, H, eps)
            for _, p, x, bias, eps in cases]
    torch.cuda.synchronize()
    counts = {k: c.value for k, c in counters.items()}
    want = {k: 0 for k in counters}
    want["attention_block"] = len(cases)
    if counts != want:
        raise AssertionError(f"K-BLOCK: launches {counts} != {want}")
    rows, timed = {}, set()
    for got, (name, p, x, bias, eps) in zip(outs, cases):
        dtype = x.dtype
        want_p = attention_block_plain(x, p, bias, H, eps)
        unfused = self_attention_block(p, x, H, bias, eps)
        torch.cuda.synchronize()
        assert torch.isfinite(got.float()).all(), f"K-BLOCK {name}: finite"
        err = (got.float() - want_p.float()).abs().max().item()
        tol = block_tol(want_p, dtype)
        err_u = (got.float() - unfused.float()).abs().max().item()
        tol_u = (BLOCK_UNFUSED_ULPS / BF16_ULPS * bf16_tol(unfused)
                 if dtype == torch.bfloat16 else
                 5 * block_tol(unfused, dtype))
        key = f"{name}/{str(dtype).split('.')[-1]}"
        if err > tol or err_u > tol_u:
            raise AssertionError(f"K-BLOCK {key}: err {err} (tol {tol}), "
                                 f"against unfused {err_u} (tol {tol_u})")
        row = {"shape": list(x.shape), "eps": eps, "max_abs_err": err,
               "tol": tol, "unfused_err": err_u, "unfused_tol": tol_u}
        shape_key = (name.rstrip("0123456789"), dtype)
        if shape_key not in timed:
            timed.add(shape_key)
            row["ms"] = cuda_ms(lambda: attention_block(x, p, bias, H, eps),
                                iters=20)
            row["plain_ms"] = cuda_ms(lambda: attention_block_plain(
                x, p, bias, H, eps), iters=5, warmup=1)
            row["kernel_ms"] = kernel_ms(
                lambda: attention_block(x, p, bias, H, eps))
            row["unfused_block_ms"] = cuda_ms(
                lambda: self_attention_block(p, x, H, bias, eps), iters=20)
            row["unfused_block_kernel_ms"] = kernel_ms(
                lambda: self_attention_block(p, x, H, bias, eps))
            if dtype == torch.bfloat16:
                row["kernel_split"] = [[n[:60], k] for n, k, _ in kernel_split(
                    lambda: attention_block(x, p, bias, H, eps))]
            row["library_ms"] = None
            row["bound_ms"], row["bound_by"] = bound_ms(
                *block_work(x, bias), dtype)
        rows[key] = row
        times = ("" if "ms" not in row else
                 f" ms={row['ms']:.4f} kernel_ms={row['kernel_ms']:.4f} "
                 f"plain_ms={row['plain_ms']:.4f} "
                 f"unfused_block_ms={row['unfused_block_ms']:.4f} (kernel_ms "
                 f"{row['unfused_block_kernel_ms']:.4f}) "
                 f"bound_ms={row['bound_ms']:.4f} ({row['bound_by']})")
        log(f"K-BLOCK {key:22s} x{tuple(x.shape)} err={err:.3g} (tol "
            f"{tol:.3g}) vs unfused {err_u:.3g} (tol {tol_u:.3g}){times} "
            f"[{card}]")
        for name, k in row.get("kernel_split", []):
            log(f"  K-BLOCK {key} {k:.4f} ms {name}")
    log(f"K-BLOCK: {counts['attention_block']} launches, exact; no plain "
        f"call [{card}]")
    return rows, counts


# ---------------------------------------------------------------------------
# phase 8b: the two experiment tools
# ---------------------------------------------------------------------------

TOOL_ITERS = 100


def run_tools(card: str, counters) -> dict:
    """`tools.exp_attn_layout.main()` and `tools.exp_attn_pack.main()` at
    their CLIP shape, each with every count at 0 before and read after:
    each variant launches 1 + 4 * iters times (a checked call, then 4
    chained runs); layout's blhd K-ATT, its xla_t and bdims K-ATT with the
    head-leading output; pack's v_base K-ATT, its v_p1bf K-ATT-CHEAP (its
    packed variants have no card counterpart and are not run)."""
    from etpnav_tpu_torch.tools import exp_attn_layout, exp_attn_pack
    n = 1 + 4 * TOOL_ITERS
    tools = {"exp_attn_layout": (exp_attn_layout, {
                 "attention_fwd": n, "attention_fwd_head_out": 2 * n}),
             "exp_attn_pack": (exp_attn_pack, {
                 "attention_fwd": n, "attention_cheap": n})}
    res = {}
    for name, (mod, launches) in tools.items():
        for c in counters.values():
            c.reset()
        out = mod.main(iters=TOOL_ITERS)
        torch.cuda.synchronize()
        counts = {k: c.value for k, c in counters.items()}
        want = {k: launches.get(k, 0) for k in counters}
        if counts != want:
            raise AssertionError(f"{name}: launches {counts} != {want}")
        for v, r in out["variants"].items():
            if not r["max_err"] <= r["tol"]:
                raise AssertionError(f"{name} {v}: {r}")
        res[name] = {"result": out,
                     "launches": {k: v for k, v in counts.items() if v}}
        log(f"tool {name}: {json.dumps(out)}; launches exact "
            f"{json.dumps(launches)}, no plain call [{card}]")
    return res


def check_head_out_and_cheap(card: str) -> dict:
    """K-ATT with `out_layout="head"` (T1) on the natural-layout inputs and
    K-ATT-CHEAP (T2) on head-leading ones, at the tools' shape, against
    their plain versions; times beside the bound and SDPA on the same
    operands: T1's function, and T2's up to its rounding points, since
    softmax(x - 10) is softmax(x)."""
    import torch.nn.functional as F

    from etpnav_tpu_torch.ops.fused_attention import (
        attention_cheap,
        attention_cheap_plain,
        attention_fwd,
        attention_plain,
    )
    g = torch.Generator(device="cuda").manual_seed(23)
    B, H, L, hd = 384, 12, 50, 64
    scale = 1.0 / np.sqrt(hd)
    nat = [torch.randn(B, L, H, hd, generator=g, device="cuda").transpose(
        1, 2) for _ in range(3)]
    rows = {}
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v = (t.to(dtype) for t in nat)
        got = attention_fwd(q, k, v, None, scale, out_layout="head")
        want = attention_plain(q, k, v, None, scale, out_layout="head")
        torch.cuda.synchronize()
        if not (got.is_contiguous() and want.is_contiguous()):
            raise AssertionError("K-ATT head-out: output not head-leading")
        err = (got.float() - want.float()).abs().max().item()
        if err > TOL[dtype]:
            raise AssertionError(f"K-ATT head-out {dtype}: err {err}")
        key = f"head_out/{str(dtype).split('.')[-1]}"
        nbytes, flops = attention_work(q, k, v, None)
        b_ms, b_by = bound_ms(nbytes, flops, dtype)
        def ours():
            return attention_fwd(q, k, v, None, scale, out_layout="head")

        def sdpa():
            return F.scaled_dot_product_attention(q, k, v, scale=scale)

        rows[key] = {
            "shape": [B, H, L, hd], "max_abs_err": err,
            "ms": cuda_ms(ours), "kernel_ms": kernel_ms(ours),
            "plain_ms": cuda_ms(lambda: attention_plain(
                q, k, v, None, scale, out_layout="head"), iters=10),
            "library_ms": cuda_ms(sdpa), "library_kernel_ms": kernel_ms(sdpa),
            "bound_ms": b_ms, "bound_by": b_by}
    q, k, v = (t.to(torch.bfloat16).contiguous() for t in nat)
    got = attention_cheap(q, k, v, scale)
    want = attention_cheap_plain(q, k, v, scale)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    tol = bf16_tol(want)
    if err > tol:
        raise AssertionError(f"K-ATT-CHEAP: err {err} > {tol}")
    nbytes, flops = attention_work(q, k, v, None)
    b_ms, b_by = bound_ms(nbytes, flops, torch.bfloat16)
    def cheap():
        return attention_cheap(q, k, v, scale)

    def sdpa():
        return F.scaled_dot_product_attention(q, k, v, scale=scale)

    rows["cheap/bfloat16"] = {
        "shape": [B, H, L, hd], "max_abs_err": err, "tol": tol,
        "ms": cuda_ms(cheap), "kernel_ms": kernel_ms(cheap),
        "plain_ms": cuda_ms(lambda: attention_cheap_plain(q, k, v, scale),
                            iters=10),
        "library_ms": cuda_ms(sdpa), "library_kernel_ms": kernel_ms(sdpa),
        "bound_ms": b_ms, "bound_by": b_by}
    for key, r in rows.items():
        lib = ("none" if r["library_ms"] is None
               else f"{r['library_ms']:.4f}")
        log(f"{key:18s} (B,H,L,hd)={tuple(r['shape'])} "
            f"err={r['max_abs_err']:.3g} ms={r['ms']:.4f} "
            f"kernel_ms={r['kernel_ms']:.4f} plain_ms={r['plain_ms']:.4f} "
            f"sdpa_ms={lib} sdpa_kernel_ms={r['library_kernel_ms']:.4f} "
            f"bound_ms={r['bound_ms']:.4f} ({r['bound_by']}) [{card}]")
    return rows


# ---------------------------------------------------------------------------
# phase 9: the entry points (released checkpoints, run_config, HTTP)
# ---------------------------------------------------------------------------

# steps each HTTP / in-process session takes in phase 9b (fewer where the
# agent stops first), in lockstep rounds of all live sessions
RUNNER_STEPS = 5
RUNNER_SESSIONS = 8
# |stop_prob| over HTTP against in-process on the same weights: the gmap
# bucket of a batch follows its largest graph, so the navigation GEMMs of
# one session may run at another M in the two runs (other cuBLAS sum
# orders); the actions themselves must be equal
STOP_PROB_TOL = 1e-4


def _bert_names(out: dict, key: str, block, self_name: str = "self"
                ) -> None:
    """An `AttentionBlock` under BertSelfAttention / BertSelfOutput names:
    `key.self.*` (`key.att.*` in BertXAttention) and `key.output.*`."""
    self_key = f"{key}.{self_name}"
    for ours, theirs in (("q", "query"), ("k", "key"), ("v", "value")):
        lin = getattr(block.attn, ours)
        out[f"{self_key}.{theirs}.weight"] = lin.weight
        out[f"{self_key}.{theirs}.bias"] = lin.bias
    out[f"{key}.output.dense.weight"] = block.out.dense.weight
    out[f"{key}.output.dense.bias"] = block.out.dense.bias
    out[f"{key}.output.LayerNorm.weight"] = block.out.ln.weight
    out[f"{key}.output.LayerNorm.bias"] = block.out.ln.bias


def _pair(out: dict, key: str, m) -> None:
    out[f"{key}.weight"] = m.weight
    out[f"{key}.bias"] = m.bias


def _ffn_names(out: dict, inter: str, output: str, ffn) -> None:
    _pair(out, f"{inter}.dense", ffn.intermediate)
    _pair(out, f"{output}.dense", ffn.output.dense)
    _pair(out, f"{output}.LayerNorm", ffn.output.ln)


def export_planner(p) -> dict:
    """The port's `PlannerParams` under GlocalTextPathNavCMT's names
    (vilmodel_cmt.py:663-750), independent of `models/convert.py`."""
    out = {}
    e = p.embeddings
    for name in ("word_embeddings", "position_embeddings",
                 "token_type_embeddings"):
        out[f"embeddings.{name}.weight"] = getattr(e, name)
    _pair(out, "embeddings.LayerNorm", e.ln)
    for i, layer in enumerate(p.lang_encoder):
        key = f"lang_encoder.layer.{i}"
        _bert_names(out, f"{key}.attention", layer.attention)
        _ffn_names(out, f"{key}.intermediate", f"{key}.output", layer.ffn)
    ie = p.img_embeddings
    for ours, theirs in (("img_linear", "img_linear"),
                         ("img_ln", "img_layer_norm"),
                         ("dep_linear", "dep_linear"),
                         ("dep_ln", "dep_layer_norm"),
                         ("loc_linear", "loc_linear"),
                         ("loc_ln", "loc_layer_norm"), ("ln", "layer_norm")):
        _pair(out, f"img_embeddings.{theirs}", getattr(ie, ours))
    out["img_embeddings.nav_type_embedding.weight"] = ie.nav_type_embedding
    for i, layer in enumerate(ie.pano_encoder.layers):
        key = f"img_embeddings.pano_encoder.layers.{i}"
        a = layer.attn
        out[f"{key}.self_attn.in_proj_weight"] = torch.cat(
            [a.q.weight, a.k.weight, a.v.weight])
        out[f"{key}.self_attn.in_proj_bias"] = torch.cat(
            [a.q.bias, a.k.bias, a.v.bias])
        _pair(out, f"{key}.self_attn.out_proj", a.o)
        for name in ("norm1", "norm2", "linear1", "linear2"):
            _pair(out, f"{key}.{name}", getattr(layer, name))
    _pair(out, "img_embeddings.pano_encoder.norm", ie.pano_encoder.final_ln)
    ge = p.global_encoder
    _pair(out, "global_encoder.gmap_pos_embeddings.0",
          ge.gmap_pos_embeddings.dense)
    _pair(out, "global_encoder.gmap_pos_embeddings.1",
          ge.gmap_pos_embeddings.ln)
    out["global_encoder.gmap_step_embeddings.weight"] = \
        ge.gmap_step_embeddings
    for i, layer in enumerate(ge.encoder):
        key = f"global_encoder.encoder.x_layers.{i}"
        _bert_names(out, f"{key}.visual_attention", layer.visual_attention,
                    "att")
        _bert_names(out, f"{key}.visn_self_att", layer.visn_self_att)
        _ffn_names(out, f"{key}.visn_inter", f"{key}.visn_output",
                   layer.visn_ffn)
    _pair(out, "global_encoder.sprel_linear", ge.sprel_linear)
    _pair(out, "global_sap_head.net.0", p.global_sap_head.dense1)
    _pair(out, "global_sap_head.net.2", p.global_sap_head.ln)
    _pair(out, "global_sap_head.net.4", p.global_sap_head.dense2)
    return {k: v.detach().clone() for k, v in out.items()}


def export_waypoint(w) -> dict:
    """`WaypointParams` under BinaryDistPredictor_TRM's names
    (TRM_net.py:9-60)."""
    out = {}
    _pair(out, "visual_fc_depth.1", w.visual_fc_depth)
    for i, layer in enumerate(w.waypoint_trm):
        key = f"waypoint_TRM.bert.encoder.layer.{i}"
        _bert_names(out, f"{key}.attention", layer.attention)
        _ffn_names(out, f"{key}.intermediate", f"{key}.output", layer.ffn)
    _pair(out, "vis_classifier.0", w.vis_classifier.dense1)
    _pair(out, "vis_classifier.2", w.vis_classifier.dense2)
    return {k: v.detach().clone() for k, v in out.items()}


def export_clip(c, cfg) -> dict:
    """`ClipParams` under openai CLIP's `visual.*` names: the patch matrix
    (ps*ps*3, width) in (ps, ps, 3) order back to the conv's (width, 3,
    ps, ps) kernel, q/k/v packed into in_proj."""
    ps, w = cfg.patch_size, cfg.width
    out = {"conv1.weight": c.patch_embed.reshape(ps, ps, 3, w).permute(
               3, 2, 0, 1),
           "class_embedding": c.class_embedding,
           "positional_embedding": c.positional_embedding,
           "proj": c.proj}
    _pair(out, "ln_pre", c.ln_pre)
    _pair(out, "ln_post", c.ln_post)
    for i, b in enumerate(c.blocks):
        key = f"transformer.resblocks.{i}"
        a = b.attn
        out[f"{key}.attn.in_proj_weight"] = torch.cat(
            [a.q.weight, a.k.weight, a.v.weight])
        out[f"{key}.attn.in_proj_bias"] = torch.cat(
            [a.q.bias, a.k.bias, a.v.bias])
        _pair(out, f"{key}.attn.out_proj", a.o)
        _pair(out, f"{key}.ln_1", b.ln_1)
        _pair(out, f"{key}.ln_2", b.ln_2)
        _pair(out, f"{key}.mlp.c_fc", b.mlp_fc)
        _pair(out, f"{key}.mlp.c_proj", b.mlp_proj)
    return {f"visual.{k}": v.detach().contiguous().clone()
            for k, v in out.items()}


def export_depth(d) -> dict:
    """`DepthParams` under habitat's ResNetEncoder names after the
    resnet_encoders.py:40-47 surgery (`backbone.*`, `compression.*`;
    GroupNorms at convs.{1,4,7})."""
    out = {"backbone.conv1.weight": d.stem_conv.weight,
           "compression.0.weight": d.compression_conv.weight}
    _pair(out, "backbone.bn1", d.stem_gn)
    _pair(out, "compression.1", d.compression_gn)
    for li in range(1, 5):
        for bi, blk in enumerate(getattr(d, f"layer{li}")):
            key = f"backbone.layer{li}.{bi}"
            for j, conv, gn in ((0, "conv1", "gn1"), (3, "conv2", "gn2"),
                                (6, "conv3", "gn3")):
                out[f"{key}.convs.{j}.weight"] = getattr(blk, conv).weight
                _pair(out, f"{key}.convs.{j + 1}", getattr(blk, gn))
            if hasattr(blk, "down_conv"):
                out[f"{key}.downsample.0.weight"] = blk.down_conv.weight
                _pair(out, f"{key}.downsample.1", blk.down_gn)
    return {k: v.detach().clone() for k, v in out.items()}


class _Archive(torch.nn.Module):
    def forward(self, x):
        return x


def save_torchscript(sd: dict, path: str) -> None:
    """`sd` as a TorchScript archive, as openai CLIP's `ViT-B-32.pt`."""
    root = _Archive()
    for name, t in sd.items():
        *mods, leaf = name.split(".")
        m = root
        for part in mods:
            if not hasattr(m, part):
                m.add_module(part, torch.nn.Module())
            m = getattr(m, part)
        m.register_parameter(leaf, torch.nn.Parameter(t, requires_grad=False))
    torch.jit.trace(root, torch.zeros(1)).save(path)


def check_equal(name: str, got: dict, want: dict) -> int:
    if list(got) != list(want):
        raise AssertionError(f"{name}: keys differ: "
                             f"{sorted(set(got) ^ set(want))[:8]}")
    for k, v in want.items():
        if not torch.equal(got[k].cpu(), v.cpu()):
            raise AssertionError(f"{name}: {k} differs")
    return len(want)


def released_files(card: str, params, cfg, tmp: str) -> dict:
    """Phase 9a: seeded full-width files in the released layouts, written
    by the exporters above from the port's modules; each converted back
    through `convert_cli` (the CLI's key surgery and checkpoint) or
    `convert_full_policy`, every tensor checked exactly against the
    module it was exported from."""
    from etpnav_tpu_torch import convert_cli
    from etpnav_tpu_torch.models import clip_vit, depth_resnet, planner
    from etpnav_tpu_torch.models.convert import (
        convert_full_policy,
        load_jax_tree,
    )
    from etpnav_tpu_torch.training.checkpoints import load_checkpoint
    t0 = time.perf_counter()
    pl = export_planner(params.planner)
    dep = export_depth(params.depth)
    files = {
        # released pretrain layout: backbone under 'bert.', SAP head at
        # the top level, a pretrain head the converter ignores
        "planner": {**{(k if k.startswith("global_sap_head.")
                        else f"bert.{k}"): v for k, v in pl.items()},
                    "mlm_head.predictions.bias":
                        torch.zeros(cfg.planner.vocab_size)},
        "waypoint": {"predictor": {f"module.{k}": v for k, v in
                                   export_waypoint(params.waypoint).items()}},
        "clip": export_clip(params.clip, cfg.clip),
        "depth": {"state_dict": {
            f"actor_critic.net.visual_encoder.{k}": v
            for k, v in dep.items()}},
    }
    paths = {}
    for kind, sd in files.items():
        paths[kind] = os.path.join(tmp, f"released_{kind}.pt")
        if kind == "clip":
            save_torchscript(sd, paths[kind])
        else:
            torch.save(sd, paths[kind])
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        ts = torch.load(paths["clip"], map_location="cpu",
                        weights_only=False)
    ts_path = (f"torch.load -> {type(ts).__name__}"
               + (" (dispatched to torch.jit.load)"
                  if any("TorchScript" in str(w.message) for w in caught)
                  else ""))
    del ts
    n = 0
    for kind in files:
        out = os.path.join(tmp, f"converted_{kind}.pt")
        convert_cli.main(["--kind", kind, "--torch-ckpt", paths[kind],
                          "--out", out])
        n += check_equal(f"convert_cli {kind}", load_checkpoint(out),
                         getattr(params, kind).state_dict())
        os.remove(out)
    # released fine-tune layout (ss_trainer_ETP.py:74-83,211-212): the
    # DDP-wrapped planner and the frozen encoders the policy owns
    policy = {"state_dict": {
        **{f"net.module.vln_bert.{k}": v for k, v in pl.items()},
        **{f"net.depth_encoder.visual_encoder.{k}": v
           for k, v in dep.items()},
        **{f"net.rgb_encoder.model.{k}": v
           for k, v in files["clip"].items()}}, "iteration": 12000}
    policy_path = os.path.join(tmp, "released_policy.pth")
    torch.save(policy, policy_path)
    trees = convert_full_policy(torch.load(policy_path, map_location="cpu"),
                                planner_cfg=cfg.planner, clip_cfg=cfg.clip,
                                depth_cfg=cfg.depth)
    os.remove(policy_path)
    for kind, cls, sub in (("planner", planner.PlannerParams, cfg.planner),
                           ("clip", clip_vit.ClipParams, cfg.clip),
                           ("depth", depth_resnet.DepthParams, cfg.depth)):
        module = cls(sub)
        load_jax_tree(module, trees[kind], kind)
        n += check_equal(f"convert_full_policy {kind}", module.state_dict(),
                         getattr(params, kind).state_dict())
    for kind in ("waypoint", "clip", "depth"):
        os.remove(paths[kind])
    res = {"tensors_exact": n, "torchscript": ts_path,
           "seconds": time.perf_counter() - t0}
    log(f"runner 9a: released layouts (pretrain planner, waypoint, openai "
        f"CLIP TorchScript, DD-PPO depth, fine-tune policy) at r2r width: "
        f"{json.dumps(res)} [{card}]")
    return {"planner_path": paths["planner"], **res}


@contextlib.contextmanager
def program_calls():
    """Counts calls of the agent's three programs for every `Agent` (the
    runner builds its own), by wrapping the class's methods."""
    from etpnav_tpu_torch.training.agent import Agent
    calls = collections.Counter()
    saved = {}
    for attr, name in (("perceive", "perceive"),
                       ("score_navigation", "navigation"),
                       ("encode_text", "text")):
        saved[attr] = Agent.__dict__[attr]
        setattr(Agent, attr, counted(saved[attr], calls, name))
    try:
        yield calls
    finally:
        for attr, fn in saved.items():
            setattr(Agent, attr, fn)


def runner_counts(name: str, counters, calls, per: dict,
                  learn_steps: int = 0) -> dict:
    """The launch counts since the counters' reset, exactly what the
    program calls (and learn steps) make: plain versions count 0."""
    counts = {k: c.value for k, c in counters.items()}
    want = {k: sum(per[p].get(k, 0) * calls[p] for p in per)
            for k in counters}
    want["attention_fwd"] += LEARN_ATTENTIONS * learn_steps
    want["attention_bwd"] += LEARN_ATTENTIONS * learn_steps
    if counts != want:
        raise AssertionError(f"runner {name}: launches {counts} != {want} "
                             f"for {dict(calls)}, {learn_steps} learn steps")
    return {k: v for k, v in counts.items() if v}


def drive_sessions(client, cfg, seed: int = 500) -> list:
    """RUNNER_SESSIONS sessions through `client` (an HTTP client or a
    NavServer) in lockstep rounds: each round steps every live session
    concurrently, one thread each, and waits for all. Observations come
    from one seeded stream per session; a session moves to the ghost its
    action picks."""
    H, Hd = cfg.clip.image_size, cfg.depth.input_size
    ori = np.array([0.0, 0.0, 0.0, 1.0])
    sessions = []
    for i in range(RUNNER_SESSIONS):
        rng = np.random.default_rng(seed + i)
        sid = client.create_session(rng.integers(1, cfg.planner.vocab_size,
                                                 40))
        sessions.append({"sid": sid, "rng": rng, "pos": np.zeros(3),
                         "results": [], "ms": [], "done": False})

    def one(s, errors):
        try:
            rgb = s["rng"].integers(0, 256, (12, H, H, 3), np.uint8)
            dep = s["rng"].random((12, Hd, Hd, 1), np.float32)
            t = time.perf_counter()
            res = client.step(s["sid"], rgb, dep, s["pos"], ori)
            s["ms"].append((time.perf_counter() - t) * 1e3)
            s["results"].append(res)
            if res["action"]["act"] == 4:
                s["pos"] = np.asarray(res["action"]["ghost_pos"], np.float64)
            s["done"] = res["done"]
        except Exception as e:           # reported by the main thread
            errors.append(repr(e))

    for _ in range(RUNNER_STEPS):
        live = [s for s in sessions if not s["done"]]
        if not live:
            break
        errors = []
        threads = [threading.Thread(target=one, args=(s, errors))
                   for s in live]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        if any(t.is_alive() for t in threads) or errors:
            raise AssertionError(f"runner sessions: {errors or 'hung'}")
    for s in sessions:
        client.close_session(s["sid"])
    return sessions


def same_action(a: dict, b: dict) -> bool:
    if a.keys() != b.keys():
        return False
    for k in a:
        x, y = a[k], b[k]
        if k == "back_path":
            if (x is None) != (y is None) or len(x or []) != len(y or []):
                return False
            if any(v != w or not np.array_equal(p, q)
                   for (v, p), (w, q) in zip(x or [], y or [])):
                return False
        elif isinstance(x, np.ndarray) or isinstance(y, np.ndarray):
            if not np.array_equal(np.asarray(x), np.asarray(y)):
                return False
        elif x != y:
            return False
    return True


def nav_dtype_turns(card: str, cfg, agent, rounds: int = 2) -> dict:
    """The in-process serving step with the navigation stack in fp32
    (serving's default) and in bf16 (PLANNER.nav_use_bf16), on the same
    weights, in turns (A B B A, `rounds` times): RUNNER_SESSIONS sessions
    x RUNNER_STEPS lockstep rounds per turn; host clock per step."""
    from etpnav_tpu_torch.serving import NavServer
    from etpnav_tpu_torch.training.agent import Agent
    cfgs = {"fp32": cfg, "bf16": dataclasses.replace(
        cfg, planner=dataclasses.replace(cfg.planner, nav_use_bf16=True))}
    servers = {"fp32": NavServer(cfgs["fp32"], agent, max_batch=8),
               "bf16": NavServer(cfgs["bf16"], Agent(
                   cfgs["bf16"], agent.params, device=agent.device),
                   max_batch=8)}
    ms = {k: [] for k in servers}
    try:
        for server in servers.values():
            server.warmup()
        for _ in range(rounds):
            for k in ("fp32", "bf16", "bf16", "fp32"):
                ms[k] += [m for s in drive_sessions(servers[k], cfg, 700)
                          for m in s["ms"]]
    finally:
        for server in servers.values():
            server.shutdown()
    res = {k: {"step_p50_ms": statistics.median(v), "min_ms": min(v),
               "n": len(v)} for k, v in ms.items()}
    log(f"runner 9b nav dtype in turns (in-process, 8 sessions): "
        f"{json.dumps(res)} [{card}]")
    return res


def http_vs_in_process(card: str, cfg, planner_path: str, counters,
                       nav_use_bf16) -> dict:
    """Phase 9b: `run_config(..., run_type="serve", serve_nonblocking=True,
    device="cuda")` with MODEL.pretrained_path = the released planner
    file; RUNNER_SESSIONS HTTP clients, then the same sessions through an
    in-process NavServer on the runner's agent. Equal actions step for
    step, the step p50 of both, exact launch counts."""
    from etpnav_tpu_torch.run import run_config
    from etpnav_tpu_torch.serving import NavServer
    from etpnav_tpu_torch.serving_http import HttpNavClient
    run_cfg = dataclasses.replace(cfg, pretrained_path=planner_path,
                                  planner=dataclasses.replace(
                                      cfg.planner, nav_use_bf16=nav_use_bf16))
    for c in counters.values():
        c.reset()
    with program_calls() as calls:
        httpd, nav = run_config(run_cfg, run_type="serve",
                                serve_nonblocking=True, device="cuda",
                                host="127.0.0.1", port=0)
        try:
            nav.warmup()
            url = f"http://127.0.0.1:{httpd.server_address[1]}"
            before = calls["perceive"]
            over_http = drive_sessions(HttpNavClient(url), cfg)
            http_batches = calls["perceive"] - before
        finally:
            httpd.shutdown()
            httpd.server_close()
            nav.shutdown()
        local = NavServer(nav.cfg, nav.agent, max_batch=8)
        try:
            before = calls["perceive"]
            in_process = drive_sessions(local, cfg)
            local_batches = calls["perceive"] - before
        finally:
            local.shutdown()
        turns = (nav_dtype_turns(card, nav.cfg, nav.agent)
                 if nav_use_bf16 is None else None)
        torch.cuda.synchronize()
    counts = runner_counts(f"serve nav_bf16={nav_use_bf16}", counters,
                           calls, PER_CALL["default"])
    steps = worst = 0
    for a, b in zip(over_http, in_process):
        if len(a["results"]) != len(b["results"]):
            raise AssertionError("runner serve: episode lengths differ")
        for x, y in zip(a["results"], b["results"]):
            if not (same_action(x["action"], y["action"])
                    and x["done"] == y["done"]
                    and x["num_nodes"] == y["num_nodes"]
                    and x["num_ghosts"] == y["num_ghosts"]):
                raise AssertionError(f"runner serve: HTTP {x} != "
                                     f"in-process {y}")
            worst = max(worst, abs(x["stop_prob"] - y["stop_prob"]))
            steps += 1
    if worst > STOP_PROB_TOL:
        raise AssertionError(f"runner serve: stop_prob differs by {worst}")
    res = {"nav_use_bf16": bool(nav.cfg.planner.nav_use_bf16),
           "sessions": len(over_http), "steps": steps,
           "stops": sum(s["done"] for s in over_http),
           "max_stop_prob_diff": worst,
           "http_step_p50_ms": statistics.median(
               m for s in over_http for m in s["ms"]),
           "in_process_step_p50_ms": statistics.median(
               m for s in in_process for m in s["ms"]),
           "http_batches": http_batches, "in_process_batches": local_batches,
           "nav_dtype_turns": turns, "calls": dict(calls),
           "launches": counts}
    log(f"runner 9b serve: {json.dumps(res)} [{card}]")
    return res


def runner_training(card: str, cfg, counters, tmp: str) -> dict:
    """Phase 9c: `run_config` trains one iteration (writes its
    checkpoint), evaluates and runs inference on GeometricNavEnv episodes
    from it (inference in the fused configuration, set as YAML sets it),
    then the checkpoint-folder eval loop; exact launch counts for each."""
    from etpnav_tpu_torch.config_yaml import config_from_dict
    from etpnav_tpu_torch.run import run_config
    ck = os.path.join(tmp, "checkpoints")
    n_eps = 8
    cfg = dataclasses.replace(
        cfg, il=dataclasses.replace(cfg.il, iters=1, log_every=1000),
        results_dir=os.path.join(tmp, "results"))
    fused = config_from_dict({"BASE": "r2r",
                              "CLIP": {"use_fused_block": True},
                              "DEPTH": {"use_fused_gn": True}})
    preds = os.path.join(tmp, "predictions.json")
    loop_cfg = dataclasses.replace(cfg, eval=dataclasses.replace(
        cfg.eval, ckpt_path_dir=ck))
    ckpt = os.path.join(ck, "ckpt_iter1.pt")
    runs = (("train", cfg, {"run_type": "train"}, "default", 1),
            ("eval", cfg, {"run_type": "eval", "ckpt": ckpt,
                           "episode_count": n_eps}, "default", 0),
            ("inference (fused)", fused,
             {"run_type": "inference", "ckpt": ckpt,
              "episode_count": n_eps, "predictions_file": preds},
             "fused", 0),
            ("eval loop", loop_cfg, {"run_type": "eval",
                                     "episode_count": n_eps}, "default", 0))
    res = {}
    for name, run_cfg, opts, per, learn in runs:
        for c in counters.values():
            c.reset()
        t0 = time.perf_counter()
        with program_calls() as calls:
            out = run_config(run_cfg, device="cuda", ckpt_dir=ck, **opts)
            torch.cuda.synchronize()
        counts = runner_counts(name, counters, calls, PER_CALL[per], learn)
        res[name] = {"seconds": time.perf_counter() - t0,
                     "calls": dict(calls), "launches": counts}
        if name == "train":
            if sorted(os.listdir(ck)) != ["ckpt_iter1.pt"] or not \
                    np.isfinite(out["IL_loss"]):
                raise AssertionError(f"runner train: {os.listdir(ck)}, "
                                     f"{out}")
            res[name]["IL_loss"] = out["IL_loss"]
        elif name == "eval":
            if out.get("n_episodes", 0) < n_eps:
                raise AssertionError(f"runner eval: {out}")
            res[name]["stats"] = out
        elif name.startswith("inference"):
            with open(preds) as f:
                written = json.load(f)
            if len(written) < n_eps or set(written) != set(out):
                raise AssertionError(f"runner inference: {len(written)} "
                                     "predictions")
            res[name]["episodes"] = len(written)
        else:
            if list(out) != [ckpt] or not os.path.exists(os.path.join(
                    cfg.results_dir, "stats_ckpt_1_val_unseen.json")):
                raise AssertionError(f"runner eval loop: {list(out)}")
            res[name]["stats"] = out[ckpt]
    if not (res["train"]["launches"].get("attention_bwd")
            and res["inference (fused)"]["launches"].get("group_norm_fused")
            and res["inference (fused)"]["launches"].get(
                "prenorm_attention")):
        raise AssertionError(f"runner: a kernel did not launch: {res}")
    log(f"runner 9c train/eval/inference/eval loop: {json.dumps(res)} "
        f"[{card}]")
    return res


def runner_phase(card: str, cfg, host_params, counters) -> dict:
    """Phase 9 at r2r_config() width, in a temporary directory."""
    with tempfile.TemporaryDirectory(prefix="etpnav_runner_") as tmp:
        files = released_files(card, host_params, cfg, tmp)
        serve = {str(bf16): http_vs_in_process(
                     card, cfg, files["planner_path"], counters, bf16)
                 for bf16 in (None, True)}
        torch.cuda.empty_cache()
        train = runner_training(card, cfg, counters, tmp)
    total = collections.Counter()
    for r in [*serve.values(), *train.values()]:
        total.update(r["launches"])
    return {"files": files, "serve": serve, "train": train,
            "launches": dict(total)}


# ---------------------------------------------------------------------------
# phase 10: pretraining and the warm start into fine-tuning
# ---------------------------------------------------------------------------

# steps of the runner's first pretraining run (mlm + sap at 1 : 1, with
# validation and a checkpoint every PRETRAIN_VALID), and of its resumed run
PRETRAIN_STEPS = 8
PRETRAIN_RESUMED = 4
PRETRAIN_VALID = 4
# object tokens per step of the MRC / OG configuration
PRETRAIN_OBJS = 3
# timed steps per task (after one untimed)
PRETRAIN_TIMED = 5


def pretrain_attentions(p) -> int:
    """K-ATT launches of one forward of any pretraining task, and K-ATT-BWD
    launches of its backward, as the code runs them: the text layers, the
    pano layers (over B*T panoramas for MLM and SAP, the final step's for
    MRC and OG), then two per cross-modal layer (graph into text + graph
    self for SAP; text into graph + text self for MLM; local into text +
    local self for MRC and OG)."""
    return p.num_l_layers + p.num_pano_layers + 2 * p.num_x_layers


@contextlib.contextmanager
def pretrain_calls():
    """Counts `PretrainTrainer.train_step` calls by task and the forwards
    of `validate` by task, for every trainer (the runner builds its own),
    by wrapping the class's methods; the trainers built go in a list."""
    from etpnav_tpu_torch.training.pretrain import PretrainTrainer
    steps, val = collections.Counter(), collections.Counter()
    trainers = []
    saved = {a: PretrainTrainer.__dict__[a]
             for a in ("__init__", "train_step", "validate")}

    def init(self, *a, **kw):
        saved["__init__"](self, *a, **kw)
        trainers.append(self)

    def train_step(self, task, batch):
        steps[task] += 1
        return saved["train_step"](self, task, batch)

    def validate(self, n_batches=4):
        tasks = self.cfg.pretrain.tasks
        for t in ("mlm", "sap", "mrc", "og"):
            if t in ("mlm", "sap") or t in tasks:
                val[t] += n_batches
        return saved["validate"](self, n_batches)

    PretrainTrainer.__init__ = init
    PretrainTrainer.train_step = train_step
    PretrainTrainer.validate = validate
    try:
        yield steps, val, trainers
    finally:
        for a, fn in saved.items():
            setattr(PretrainTrainer, a, fn)


def pretrain_counts(name: str, p, counters, steps, val) -> dict:
    """The launch counts since the counters' reset: pretrain_attentions
    K-ATT per forward (training steps and validation batches) and
    K-ATT-BWD per training step; every other counter 0."""
    n = pretrain_attentions(p)
    counts = {k: c.value for k, c in counters.items()}
    want = {k: 0 for k in counters}
    want["attention_fwd"] = n * (sum(steps.values()) + sum(val.values()))
    want["attention_bwd"] = n * sum(steps.values())
    if counts != want or not want["attention_bwd"]:
        raise AssertionError(f"pretrain {name}: launches {counts} != {want} "
                             f"for steps {dict(steps)}, validation "
                             f"{dict(val)}")
    return {k: v for k, v in counts.items() if v}


def time_pretrain_task(card: str, tr, task: str, batch_size: int) -> dict:
    """The train step p50 of `task` on one sampled batch (host clock
    around a synchronised step), the host's batch sampling and copy time,
    and the peak memory of the timed steps."""
    t0 = time.perf_counter()
    host = tr.sampler.sample_batch(batch_size, task)
    sample_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    batch = tr._put(host)
    sync()
    put_ms = (time.perf_counter() - t0) * 1e3
    float(tr.train_step(task, batch))
    sync()
    reset_peak()
    ms = []
    for _ in range(PRETRAIN_TIMED):
        t0 = time.perf_counter()
        loss = float(tr.train_step(task, batch))
        ms.append((time.perf_counter() - t0) * 1e3)
    if not np.isfinite(loss):
        raise AssertionError(f"pretrain {task}: loss {loss}")
    res = {"p50_ms": statistics.median(ms), "min_ms": min(ms),
           "n": len(ms), "sample_ms": sample_ms, "put_ms": put_ms,
           "peak_gib": peak_gib(), "loss": loss}
    log(f"pretrain step {task}: {json.dumps(res)} [{card}]")
    return res


def sync() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def reset_peak() -> None:
    if torch.cuda.is_available():
        torch.cuda.reset_peak_memory_stats()


def free_cache() -> None:
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def peak_gib() -> float:
    return (torch.cuda.max_memory_allocated() / 2 ** 30
            if torch.cuda.is_available() else 0.0)


def profile_pretrain_step(card: str, tr, task: str, batch) -> dict:
    """Device time of one profiled training step of `task`: the device's
    busy share of the step's wall time, the longest kernels, and the
    attention kernels' launches and device time."""
    from torch.profiler import ProfilerActivity, profile
    float(tr.train_step(task, batch))
    sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        float(tr.train_step(task, batch))
        wall_ms = (time.perf_counter() - t0) * 1e3
    ev = [e for e in prof.key_averages()
          if e.device_type == torch.autograd.DeviceType.CUDA
          and e.self_device_time_total > 0
          and not e.key.startswith("Optimizer.")]
    dev_ms = sum(e.self_device_time_total for e in ev) / 1e3
    top = sorted(ev, key=lambda e: -e.self_device_time_total)[:10]
    attn = {}
    for e in ev:
        if "attention_" in e.key:
            k = e.key[e.key.find("attention_"):].split("(")[0].split("<")[0]
            a = attn.setdefault(k, [0.0, 0])
            a[0] += e.self_device_time_total / 1e3
            a[1] += e.count
    log(f"profile pretrain step {task}: wall {wall_ms:.2f} ms (profiled), "
        f"device busy {dev_ms:.2f} ms ({100 * dev_ms / wall_ms:.1f}%), "
        f"{sum(e.count for e in ev)} device ops [{card}]")
    for e in top:
        log(f"  {e.self_device_time_total / 1e3:8.3f} ms "
            f"x{e.count:<5d} {e.key[:90]}")
    log(f"  attention kernels of the step (ms, launches): "
        f"{json.dumps(attn)}")
    return {"wall_ms": wall_ms, "device_ms": dev_ms,
            "busy_share": dev_ms / wall_ms,
            "device_ops": sum(e.count for e in ev),
            "top": [[e.key[:60], e.self_device_time_total / 1e3, e.count]
                    for e in top[:6]], "attention": attn}


def pretrain_phase(card: str, base, counters, tmp: str,
                   device: str = "cuda", profile: bool = True) -> dict:
    """Phase 10 at `base`'s width (r2r_config on the card), each stage with
    every count at 0 before it and read after, exact launch counts and no
    plain call:
    (a) `run_config(trainer="Pretrain", run_type="train")`: mlm + sap at
        1 : 1 for PRETRAIN_STEPS steps, validating and saving
        model_step_N every PRETRAIN_VALID;
    (b) the same with PRETRAIN.resume: resumes at the newest checkpoint
        and takes PRETRAIN_RESUMED steps more;
    (c) a trainer with all four tasks, PRETRAIN_OBJS object tokens and
        image_prob_size 1000 takes one mrc and one og step and validates;
    (d) `run_config(run_type="train")` of the fine-tune trainer with
        MODEL.pretrained_path at (b)'s last checkpoint: the warm start
        (word embeddings equal to the checkpoint's) and one IL iteration;
    then each task's step p50, the peak memory and one profiled step."""
    from etpnav_tpu_torch.run import run_config
    from etpnav_tpu_torch.training import checkpoints
    from etpnav_tpu_torch.training.finetune import FinetuneTrainer
    from etpnav_tpu_torch.training.pretrain import (
        PretrainTrainer,
        pretrain_shapes,
    )
    p = base.planner
    ck = os.path.join(tmp, "pretrain")
    bs = base.pretrain.batch_size
    cfg = dataclasses.replace(
        base, checkpoint_folder=ck, pretrain=dataclasses.replace(
            base.pretrain, num_train_steps=PRETRAIN_STEPS,
            valid_steps=PRETRAIN_VALID, warmup_steps=PRETRAIN_STEPS,
            tasks=("mlm", "sap"), task_ratios=(1.0, 1.0)))
    res = {"shapes": dataclasses.asdict(pretrain_shapes(cfg)),
           "batch_size": bs}
    # (a) and (b)
    stages = (("train", cfg),
              ("resume", dataclasses.replace(cfg, pretrain=dataclasses.replace(
                  cfg.pretrain, resume=True,
                  num_train_steps=PRETRAIN_STEPS + PRETRAIN_RESUMED))))
    for name, c in stages:
        for cnt in counters.values():
            cnt.reset()
        t0 = time.perf_counter()
        with pretrain_calls() as (steps, val, trainers):
            logs = run_config(c, trainer="Pretrain", run_type="train",
                              device=device)
            sync()
        launches = pretrain_counts(name, p, counters, steps, val)
        tr = trainers[-1]
        res[name] = {"seconds": time.perf_counter() - t0, "logs": logs,
                     "steps": dict(steps), "validation": dict(val),
                     "launches": launches, "step": tr.step}
        if not all(np.isfinite(v) for v in logs.values()):
            raise AssertionError(f"pretrain {name}: {logs}")
        log(f"pretrain runner {name}: {json.dumps(res[name])} [{card}]")
    want_files = [f"model_step_{s}.pt" for s in range(
        PRETRAIN_VALID, PRETRAIN_STEPS + PRETRAIN_RESUMED + 1,
        PRETRAIN_VALID)]
    got_files = sorted(os.listdir(ck), key=lambda f: int(f[11:-3]))
    if (got_files != want_files
            or res["resume"]["step"] != PRETRAIN_STEPS + PRETRAIN_RESUMED
            or sum(res["resume"]["steps"].values()) != PRETRAIN_RESUMED):
        raise AssertionError(f"pretrain resume: files {got_files}, "
                             f"{res['resume']}")
    # the resumed trainer's step p50 for mlm and sap, then one profiled
    # step each
    times, prof = {}, {}
    for task in ("mlm", "sap"):
        times[task] = time_pretrain_task(card, tr, task, bs)
        if profile:
            prof[task] = profile_pretrain_step(
                card, tr, task, tr._put(tr.sampler.sample_batch(bs, task)))
    del tr, trainers
    free_cache()

    # (c) mrc and og
    cfg4 = dataclasses.replace(
        cfg, planner=dataclasses.replace(p, num_nav_types=3),
        pretrain=dataclasses.replace(
            cfg.pretrain, tasks=("mlm", "sap", "mrc", "og"),
            task_ratios=(1.0, 1.0, 1.0, 1.0), image_prob_size=1000,
            num_objs=PRETRAIN_OBJS))
    for cnt in counters.values():
        cnt.reset()
    t0 = time.perf_counter()
    with pretrain_calls() as (steps, val, _):
        tr4 = PretrainTrainer(cfg4, pretrain_shapes(cfg4), seed=cfg4.seed,
                              device=device)
        losses = {t: float(tr4.train_step(t, tr4._put(
            tr4.sampler.sample_batch(bs, t)))) for t in ("mrc", "og")}
        acc = tr4.validate(n_batches=1)
        sync()
    launches = pretrain_counts("mrc/og", p, counters, steps, val)
    if not all(np.isfinite(v) for v in [*losses.values(), *acc.values()]):
        raise AssertionError(f"pretrain mrc/og: {losses} {acc}")
    res["mrc_og"] = {"seconds": time.perf_counter() - t0, "loss": losses,
                     "validation": acc, "launches": launches}
    log(f"pretrain mrc/og: {json.dumps(res['mrc_og'])} [{card}]")
    for task in ("mrc", "og"):
        times[task] = time_pretrain_task(card, tr4, task, bs)
        if profile:
            prof[task] = profile_pretrain_step(
                card, tr4, task, tr4._put(tr4.sampler.sample_batch(bs, task)))
    del tr4
    free_cache()

    # (d) the warm start and one IL iteration through the runner
    last = os.path.join(ck, want_files[-1])
    pre = checkpoints.load_checkpoint(last, map_location="cpu")["params"]
    ft = dataclasses.replace(
        base, pretrained_path=last,
        il=dataclasses.replace(base.il, iters=1, log_every=1000))
    loaded = {}
    orig = FinetuneTrainer.load_pretrained

    def load_pretrained(self, path):
        orig(self, path)
        loaded["word"] = self.params.planner.embeddings.word_embeddings \
            .detach().cpu().clone()
        loaded["sap"] = self.params.planner.global_sap_head.dense2.weight \
            .detach().cpu().clone()

    for cnt in counters.values():
        cnt.reset()
    t0 = time.perf_counter()
    FinetuneTrainer.load_pretrained = load_pretrained
    try:
        with program_calls() as calls:
            out = run_config(ft, run_type="train", device=device,
                             ckpt_dir=os.path.join(tmp, "finetune"))
            sync()
    finally:
        FinetuneTrainer.load_pretrained = orig
    launches = runner_counts("warm start", counters, calls,
                             PER_CALL["default"], 1)
    if not (torch.equal(loaded.get("word"),
                        pre["embeddings.word_embeddings"])
            and torch.equal(loaded["sap"],
                            pre["global_sap_head.dense2.weight"])
            and np.isfinite(out["IL_loss"])):
        raise AssertionError(f"warm start: the fine-tune planner does not "
                             f"start from {last}, or loss {out}")
    res["warm_start"] = {"seconds": time.perf_counter() - t0,
                         "IL_loss": out["IL_loss"], "calls": dict(calls),
                         "launches": launches}
    log(f"pretrain warm start + 1 IL iteration: "
        f"{json.dumps(res['warm_start'])}; word embeddings and SAP head "
        f"equal to {os.path.basename(last)} [{card}]")
    res["step"] = times
    res["profile"] = prof
    total = collections.Counter()
    for k in ("train", "resume", "mrc_og", "warm_start"):
        total.update(res[k]["launches"])
    res["launches"] = dict(total)
    res["per_step_attentions"] = pretrain_attentions(p)
    return res


def pretrain_attention_cases(dev, cfg, G: int = 48, T: int = 8):
    """(name, dtype, q, k, v, bias, dbias) of every attention a pretraining
    step runs at `cfg`'s width (B = batch_size, T steps, 17 pano tokens,
    G = 48 graph slots, the text at max_txt_len; MRC / OG with
    PRETRAIN_OBJS object tokens more): bf16 where the stack runs bf16, fp32
    for MLM's text-into-graph layers, as the model runs them."""
    g = torch.Generator(device=dev).manual_seed(21)
    B, L = cfg.pretrain.batch_size, cfg.planner.max_txt_len
    P = 17
    H, hd = cfg.planner.num_heads, cfg.planner.head_dim

    def natural(n, Lx, dtype):
        x = torch.randn(n, Lx, H * hd, generator=g, device=dev) * 0.5
        return x.to(dtype).view(n, Lx, H, hd).transpose(1, 2)

    def pad_bias(n, Lx, keep):
        mask = torch.arange(Lx, device=dev)[None] < keep
        return ((~mask).float() * -10000.0).expand(n, Lx)[:, None, None, :]

    sprel = torch.rand(B, G, G, generator=g, device=dev) * -2.0
    graph_bias = (pad_bias(B, G, G * 2 // 3) + sprel[:, None]).contiguous()
    bf, f32 = torch.bfloat16, torch.float32
    Po = P + PRETRAIN_OBJS
    specs = [("text", bf, B, L, L, pad_bias(B, L, L // 2), False),
             ("pano", bf, B * T, P, P, pad_bias(B * T, P, 13), False),
             ("sap_cross", bf, B, G, L, pad_bias(B, L, L // 2), False),
             ("sap_graph", bf, B, G, G, graph_bias, True),
             ("mlm_l2v_cross", f32, B, L, G, pad_bias(B, G, G * 2 // 3),
              False),
             ("mlm_lang_self", f32, B, L, L, pad_bias(B, L, L // 2), False),
             ("local_pano", bf, B, Po, Po, pad_bias(B, Po, 16), False),
             ("local_cross", bf, B, Po + 1, L, pad_bias(B, L, L // 2),
              False),
             ("local_self", bf, B, Po + 1, Po + 1, pad_bias(B, Po + 1, 17),
              False)]
    return [(name, dt, natural(n, Lq, dt), natural(n, Lk, dt),
             natural(n, Lk, dt), bias, db)
            for name, dt, n, Lq, Lk, bias, db in specs]


def check_pretrain_attention(card: str, cfg) -> dict:
    """K-ATT with dropout 0.1 and the row lse, and K-ATT-BWD with dropout
    0.1, against their plain versions at every attention shape of a
    pretraining step; each kernel's device time beside the card's bound
    and SDPA's device time for the same work (forward with dropout;
    forward + backward beside K-ATT + K-ATT-BWD through AttentionFn)."""
    import torch.nn.functional as F

    from etpnav_tpu_torch.ops.fused_attention import (
        AttentionFn,
        attention_bwd,
        attention_bwd_plain,
        attention_fwd,
        attention_plain,
        draw_seed_offset,
    )
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(22)
    rows = {}
    scale = 0.125
    for name, dtype, q, k, v, bias, dbias in pretrain_attention_cases(
            dev, cfg):
        so = draw_seed_offset(gen, dev)
        out, lse = attention_fwd(q, k, v, bias, scale, 0.1, so,
                                 return_lse=True)
        want, _ = attention_plain(q, k, v, bias, scale, 0.1, so,
                                  return_lse=True)
        err = (out.float() - want.float()).abs().max().item()
        if not err <= TOL[dtype]:
            raise AssertionError(f"K-ATT pretrain {name}: err {err}")
        dout = torch.randn(q.shape, generator=gen, device=dev).to(dtype)
        args = (q, k, v, bias, out, lse, dout, scale, 0.1, so, dbias)
        got = attention_bwd(*args)
        ref = attention_bwd_plain(*args)
        berrs = {}
        for gname, a, b in zip(("dq", "dk", "dv", "dbias"), got, ref):
            if b is None:
                continue
            e = (a.float() - b.float()).abs().max().item()
            if not e <= bwd_tol(b, dtype):
                raise AssertionError(f"K-ATT-BWD pretrain {name} {gname}: "
                                     f"err {e}")
            berrs[gname] = e
        fwd_k = kernel_ms(lambda: attention_fwd(q, k, v, bias, scale, 0.1,
                                                so, return_lse=True))
        mask = bias.to(dtype)
        sdpa_fwd_k = kernel_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, dropout_p=0.1, scale=scale))
        bwd_k = kernel_ms(lambda: attention_bwd(*args))
        qg, kg, vg = (t.detach().clone().requires_grad_() for t in (q, k, v))
        bg = bias.detach().clone().requires_grad_(dbias)

        def ours():
            AttentionFn.apply(qg, kg, vg, bg, scale, 0.1, so).backward(dout)

        maskg = bg.expand(q.shape[0], 1, q.shape[2], k.shape[2])

        def sdpa():
            F.scaled_dot_product_attention(
                qg, kg, vg, attn_mask=maskg.to(dtype), dropout_p=0.1,
                scale=scale).backward(dout)

        pair_k = kernel_ms(ours, iters=10)
        sdpa_pair_k = kernel_ms(sdpa, iters=10)
        nb, fl = attention_work(q, k, v, bias)
        f_bound, f_by = bound_ms(nb + 4 * lse.numel(), fl, dtype)
        nb, fl = attention_bwd_work(q, k, bias, True, dbias)
        b_bound, b_by = bound_ms(nb, fl, dtype)
        key = f"{name}/{str(dtype).split('.')[-1]}"
        rows[key] = {"q": list(q.shape), "k": list(k.shape),
                     "fwd_err": err, "bwd_errs": berrs,
                     "fwd_kernel_ms": fwd_k, "fwd_bound_ms": f_bound,
                     "fwd_bound_by": f_by, "sdpa_fwd_kernel_ms": sdpa_fwd_k,
                     "bwd_kernel_ms": bwd_k, "bwd_bound_ms": b_bound,
                     "bwd_bound_by": b_by, "fwd_bwd_kernel_ms": pair_k,
                     "sdpa_fwd_bwd_kernel_ms": sdpa_pair_k}
        log(f"pretrain attention {key:24s} q{tuple(q.shape)} "
            f"k{tuple(k.shape)} K-ATT(p0.1, lse) {fwd_k:.4f} ms (bound "
            f"{f_bound:.4f}, {f_by}; sdpa {sdpa_fwd_k:.4f}) K-ATT-BWD "
            f"{bwd_k:.4f} ms (bound {b_bound:.4f}, {b_by}) fwd+bwd "
            f"{pair_k:.4f} ms (sdpa {sdpa_pair_k:.4f}); errs fwd {err:.3g} "
            f"bwd {json.dumps(berrs)} [{card}]")
    return rows


def check_bwd_key_limits(card: str, cfgs: dict) -> dict:
    """K-ATT-BWD's key limit (`etp_attention_bwd_max_lk`) at every
    (dtype, Lq, Lk, d(bias)) of a pretraining step, for each config
    (`cfgs`: name -> ExperimentConfig). Raises where an R2R shape is over
    its limit (the wrapper would raise in training); reports the rest."""
    from etpnav_tpu_torch.ops import cuda_build
    lib = cuda_build.load("attention_bwd")
    out = {}
    for cname, c in cfgs.items():
        L, G, P = c.planner.max_txt_len, 48, 17
        bf, f32 = 1, 0
        shapes = [("text", bf, L, L, 0), ("pano", bf, P, P, 0),
                  ("sap_cross", bf, G, L, 0), ("sap_graph", bf, G, G, 1),
                  ("mlm_l2v_cross", f32, L, G, 0),
                  ("mlm_lang_self", f32, L, L, 0),
                  ("local_cross", bf, P + PRETRAIN_OBJS + 1, L, 0),
                  ("local_self", bf, P + PRETRAIN_OBJS + 1,
                   P + PRETRAIN_OBJS + 1, 0)]
        rows = {}
        for name, dt, lq, lk, db in shapes:
            lim = lib.etp_attention_bwd_max_lk(dt, lq, db)
            rows[name] = {"Lq": lq, "Lk": lk, "dtype": "bf16" if dt else
                          "fp32", "dbias": bool(db), "max_lk": lim,
                          "fits": lk <= lim}
        out[cname] = rows
        bad = [n for n, r in rows.items() if not r["fits"]]
        log(f"K-ATT-BWD key limits, pretraining at {cname}: "
            f"{json.dumps(rows)}; over the limit: {bad or 'none'} [{card}]")
        if cname == "r2r" and bad:
            raise AssertionError(f"K-ATT-BWD: R2R pretraining shapes {bad} "
                                 "exceed the kernel's key limit")
    return out


# ---------------------------------------------------------------------------
# phase 11: the IL trainer's feed (env workers, pipelined rollout, switches)
# ---------------------------------------------------------------------------

# envs of phase 11's pools, and the training iterations of stage (a)
FEED_ENVS = 8
FEED_ITERS = 2
# stage (a) kills worker 0 of the pool that makes the pools' CRASH_AT-th
# step call, before that call
CRASH_AT = 3
# rounds of stage (c)'s and (d)'s turns (each round runs every variant
# twice, forward and back); stage (b) runs A B C C B A once
LEARN_ROUNDS = 2
# stage (c), IL.agg_dense_device on the card: the dense matrix against
# the one built on the CPU from the same record (the same products of one
# nonzero term each, the ghost shares scattered to distinct places):
# AGG_W_ATOL; the aggregation itself, dense against sparse, on random
# tokens: max |diff| <= AGG_SUM_REL * max |x| (fp32 sums of at most P + M
# terms in another order); the learn step's loss (AGG_LOSS_REL) and every
# planner gradient, fp32, dropout off: per tensor whose norm is at least
# AGG_LIVE of the largest, ||g_on - g_off|| <= AGG_GRAD_L2 * ||g_off||,
# and for every tensor max |diff| <= AGG_DENSE_REL * max |g_off| + 1e-6.
# Mostly the gradients agree to ~1e-6; but the SAP head's ReLU sees
# 160 x 96 x 768 pre-activations, and one within rounding of zero
# (9.9e-8) took the other branch on one of four recorded intervals (an
# NVIDIA H100 80GB HBM3 at 700 W): the gradients then differed by 2.5e-4
# in L2 and by 1.2e-3 of the largest element of the SAP head's dense1. A fault in W (an entry at
# the wrong token or slot, a share lost) moves the aggregation and the
# loss far past their bounds.
AGG_W_ATOL = 1e-7
AGG_SUM_REL = 1e-6
AGG_LOSS_REL = 1e-6
AGG_LIVE = 1e-2
AGG_GRAD_L2 = 1e-3
AGG_DENSE_REL = 1e-2
# stage (d): the checkpointed steps against the memoryful one at dropout
# 0.1 from the same generator state, bf16 stacks: max |diff| <=
# REMAT_REL * max |g| + 1e-7 per tensor. The recompute is the same ops on
# the same inputs with the same draws; a recompute with new dropout
# masks moves gradients by a large fraction of their largest (0.7 of it
# at tiny_config on the CPU)
REMAT_REL = 1e-3
# stage (e): perceive with uint16 depth against the same perceive on the
# host-dequantized depth (q / 65535 in fp32; the device multiplies by
# 1/65535 instead, 1 ulp apart) and against the fp32 depth it quantizes
# (tests/test_depth_transport.py's bound), fp32 model
U16_DEQUANT_TOL = 1e-5
U16_FP32_TOL = 5e-3


def env_kwargs(cfg) -> dict:
    return dict(vocab_size=cfg.planner.vocab_size,
                max_instr_len=cfg.il.max_text_len,
                image_size=cfg.clip.image_size,
                depth_size=cfg.depth.input_size,
                pad_id=cfg.planner.pad_token_id)


def feed_counts(name: str, counters, calls, learn_fwd: int = 0,
                learn_bwd: int = 0) -> dict:
    """The launch counts since the counters' reset, exactly what the
    program calls of the default configuration and the learn steps'
    attention calls make; plain versions count 0."""
    per = PER_CALL["default"]
    counts = {k: c.value for k, c in counters.items()}
    want = {k: sum(per[p].get(k, 0) * calls[p] for p in per)
            for k in counters}
    want["attention_fwd"] += learn_fwd
    want["attention_bwd"] += learn_bwd
    if counts != want:
        raise AssertionError(f"feed {name}: launches {counts} != {want} "
                             f"for {dict(calls)}, learn {learn_fwd} K-ATT "
                             f"+ {learn_bwd} K-ATT-BWD")
    return {k: v for k, v in counts.items() if v}


def learn_attentions(cfg, G: int, recompute: bool = True) -> int:
    """K-ATT launches of one learn step: 9 text + 2 pano + 4 x (cross +
    graph self) at r2r_config (K-ATT-BWD's count), plus, with
    `recompute`, the recompute of the pano encoder (IL.remat) and of the
    navigation layers (IL.remat_nav at G >= remat_nav_min_gmap)."""
    p, il = cfg.planner, cfg.il
    n = p.num_l_layers + p.num_pano_layers + 2 * p.num_x_layers
    if not recompute:
        return n
    if il.remat:
        n += p.num_pano_layers
    if il.remat_nav and G >= il.remat_nav_min_gmap:
        n += 2 * p.num_x_layers
    return n


@contextlib.contextmanager
def crash_and_learn_spies():
    """Stage (a)'s instruments, at class and module level (the runner
    builds its own pools and trainer): the pools' CRASH_AT-th step call
    first kills worker 0 of its pool (`inject_worker_crash`), every
    crashed-and-respawned slot is counted, and every learn step's graph
    bucket is recorded."""
    from etpnav_tpu_torch.env.vector import ProcessVectorEnv
    from etpnav_tpu_torch.training import finetune
    step, learn = ProcessVectorEnv.step, finetune.learn_step
    lock = threading.Lock()
    seen = {"steps": 0, "injected": 0, "crashed": 0, "restarts": 0,
            "shm_pools": set(), "pools": set(), "learn_G": []}

    def spy_step(self, actions):
        with lock:
            seen["steps"] += 1
            seen["pools"].add(id(self))
            if self._shm_spec is not None:
                seen["shm_pools"].add(id(self))
            inject = seen["steps"] == CRASH_AT
        if inject:
            self.inject_worker_crash(0)
        res = step(self, actions)
        with lock:
            seen["injected"] += inject
            seen["crashed"] += sum(bool(r.info.get("crashed")) for r in res)
            seen["restarts"] = max(seen["restarts"], sum(self._restarts))
        return res

    def spy_learn(planner, optimizer, cfg_, batch, *rest):
        seen["learn_G"].append(int(batch["gmap_mask"].shape[2]))
        return learn(planner, optimizer, cfg_, batch, *rest)

    ProcessVectorEnv.step, finetune.learn_step = spy_step, spy_learn
    try:
        yield seen
    finally:
        ProcessVectorEnv.step, finetune.learn_step = step, learn


def feed_training(card: str, counters, tmp: str, device: str,
                  base: str = "r2r") -> dict:
    """Stage (a): `run_config(run_type="train", workers=True,
    pipeline_halves=2)` from a YAML-style dict with
    RESTART_CRASHED_WORKERS, SHM_OBSERVATIONS and every IL switch on:
    FEED_ENVS envs in 2 pools of worker processes, FEED_ITERS iterations,
    worker 0 of one pool killed mid-rollout and respawned; a finite loss,
    exact launch counts, every worker stopped at the end."""
    import multiprocessing

    from etpnav_tpu_torch.config_yaml import config_from_dict
    from etpnav_tpu_torch.run import run_config
    cfg = config_from_dict({
        "BASE": base, "RESTART_CRASHED_WORKERS": True,
        "SHM_OBSERVATIONS": True,
        "IL": {"iters": FEED_ITERS, "log_every": 1000,
               "agg_dense_device": True, "depth_transport_uint16": True,
               "remat": True, "remat_nav": True}})
    for c in counters.values():
        c.reset()
    t0 = time.perf_counter()
    with program_calls() as calls, crash_and_learn_spies() as seen:
        logs = run_config(cfg, run_type="train", device=device,
                          workers=True, pipeline_halves=2,
                          num_envs=FEED_ENVS,
                          ckpt_dir=os.path.join(tmp, "feed_ckpt"))
        sync()
    secs = time.perf_counter() - t0
    fwd = sum(learn_attentions(cfg, G) for G in seen["learn_G"])
    bwd = sum(learn_attentions(cfg, G, recompute=False)
              for G in seen["learn_G"])
    counts = feed_counts("(a) runner", counters, calls, fwd, bwd)
    left = multiprocessing.active_children()
    res = {"seconds": secs, "IL_loss": logs["IL_loss"],
           "rollout_s": logs["rollout_s"], "learn_s": logs["learn_s"],
           "learn_G": seen["learn_G"], "calls": dict(calls),
           "launches": counts, "pools": len(seen["pools"]),
           "shm_pools": len(seen["shm_pools"]),
           "crash_injected": seen["injected"],
           "crashed_results": seen["crashed"],
           "restarts": seen["restarts"], "workers_left": len(left)}
    if not (np.isfinite(logs["IL_loss"]) and len(seen["learn_G"]) == FEED_ITERS
            and seen["injected"] == 1 and seen["crashed"] >= 1
            and seen["restarts"] >= 1 and res["pools"] == 2
            and res["shm_pools"] == 2 and not left):
        raise AssertionError(f"feed (a): {res}")
    log(f"feed (a) runner --workers --pipeline-halves 2: {json.dumps(res)} "
        f"[{card}]")
    return res


def profiled_busy(fn, host_ops: bool = True):
    """(fn's result, wall ms, device ms, the profiler's device events) of
    one profiled call; without `host_ops` the profiler records the
    device's activity only (a rollout interval's ~60,000 host ops cost
    tens of seconds to collect)."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CUDA]
    if host_ops:
        acts.append(ProfilerActivity.CPU)
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        out = fn()
        sync()
        wall_ms = (time.perf_counter() - t0) * 1e3
    ev = [e for e in prof.key_averages()
          if e.device_type == torch.autograd.DeviceType.CUDA
          and e.self_device_time_total > 0
          and not e.key.startswith("Optimizer.")]
    dev_ms = sum(e.self_device_time_total for e in ev) / 1e3
    return out, wall_ms, dev_ms, ev


def rollout_three_ways(card: str, cfg, agent, counters, device: str,
                       profile: bool = True) -> tuple:
    """Stage (b): rollout seconds per training interval (teacher-forced,
    FEED_ENVS envs, T = max_traj_len), three ways in turns A B C C B A:
    A in-process GeometricNavEnv(FEED_ENVS); B one pool of FEED_ENVS
    worker processes (`--workers`, shm observations); C two pools of
    FEED_ENVS / 2 in two threads (`--workers --pipeline-halves 2`). Then
    the device's busy share of one profiled interval of each. Exact
    launch counts over the stage."""
    from etpnav_tpu_torch.env.geometric import GeometricNavEnv
    from etpnav_tpu_torch.env.vector import construct_geometric_envs
    from etpnav_tpu_torch.training.pipeline import PipelinedRollout
    from etpnav_tpu_torch.training.rollout import RolloutEngine
    kw = env_kwargs(cfg)
    half = FEED_ENVS // 2
    t0 = time.perf_counter()
    pools = {"A": GeometricNavEnv(FEED_ENVS, seed=21, **kw),
             "B": construct_geometric_envs(FEED_ENVS, seed=22,
                                           restart_on_crash=True,
                                           shm_obs=True, **kw),
             "C0": construct_geometric_envs(half, seed=23,
                                            restart_on_crash=True,
                                            shm_obs=True, **kw),
             "C1": construct_geometric_envs(half, seed=24,
                                            restart_on_crash=True,
                                            shm_obs=True, **kw)}
    try:
        engines = {
            "A": RolloutEngine(cfg, agent, pools["A"], seed=0),
            "B": RolloutEngine(cfg, agent, pools["B"], seed=0),
            "C": PipelinedRollout([
                RolloutEngine(cfg, agent, pools["C0"], seed=0),
                RolloutEngine(cfg, agent, pools["C1"], seed=1)])}
        timing = {"pools_s": time.perf_counter() - t0}
        for c in counters.values():
            c.reset()
        secs = {k: [] for k in engines}
        steps = {k: [] for k in engines}
        recs = {}
        with program_calls() as calls:
            # each worker pool's first reset (the workers' first touches),
            # then one untimed interval each
            for k in ("B", "C0", "C1"):
                t1 = time.perf_counter()
                pools[k].reset()
                timing[f"first_reset_{k}_s"] = time.perf_counter() - t1
            for k in "ABC":
                t1 = time.perf_counter()
                engines[k].run("train", sample_ratio=1.0)
                sync()
                timing[f"warm_{k}_s"] = time.perf_counter() - t1
            for k in "ABCCBA":
                sync()
                t0 = time.perf_counter()
                rec = engines[k].run("train", sample_ratio=1.0)
                sync()
                secs[k].append(time.perf_counter() - t0)
                steps[k].append(int(rec.step_valid.any(0).sum()))
                recs[k] = rec
            busy = {}
            if profile:
                for k in "ABC":
                    t1 = time.perf_counter()
                    rec, wall, dev, ev = profiled_busy(
                        lambda: engines[k].run("train", sample_ratio=1.0),
                        host_ops=False)
                    timing[f"profiled_{k}_s"] = time.perf_counter() - t1
                    busy[k] = {"wall_ms": wall, "device_ms": dev,
                               "busy_share": dev / wall,
                               "device_ops": sum(e.count for e in ev),
                               "steps": int(rec.step_valid.any(0).sum())}
        counts = feed_counts("(b) rollout", counters, calls)
    finally:
        for p in pools.values():
            if hasattr(p, "close"):
                p.close()
    res = {k: {"seconds": v, "median_s": statistics.median(v),
               "steps": steps[k]} for k, v in secs.items()}
    res["busy"] = busy
    res["timing"] = timing
    res["calls"] = dict(calls)
    res["launches"] = counts
    log(f"feed (b) rollout s per interval, A in-process / B workers / C "
        f"workers + 2 halves, in turns A B C C B A: {json.dumps(res)} "
        f"[{card}]")
    return res, recs["A"]


def learn_batch(tr_batch, rec, T: int, G: int):
    from etpnav_tpu_torch.training.finetune import slice_record
    cut = slice_record(rec, T, G)
    cut = dataclasses.replace(cut, teacher=np.where(
        cut.teacher < G, cut.teacher, -100).astype(np.int32))
    return tr_batch(cut)


def loss_and_grads(planner, cfg, batch, generator=None) -> tuple:
    from etpnav_tpu_torch.training.finetune import compute_il_loss
    for p in planner.parameters():
        p.grad = None
    loss = compute_il_loss(planner, cfg, batch, generator)
    loss.backward()
    grads = {n: p.grad.detach().clone() for n, p in planner.named_parameters()
             if p.grad is not None}
    for p in planner.parameters():
        p.grad = None
    return loss.detach().item(), grads


def grad_gap(got: dict, want: dict, rel: float, floor: float,
             l2_rel: float = None, live: float = 0.0) -> dict:
    """Worst per-tensor |got - want| against rel * max |want| + floor,
    and with `l2_rel`, ||got - want|| against l2_rel * ||want|| for each
    tensor whose norm is at least `live` of the largest; raises past
    either."""
    if set(got) != set(want):
        raise AssertionError(f"gradient sets differ: "
                             f"{sorted(set(got) ^ set(want))[:5]}")
    top = max(w.norm().item() for w in want.values())
    worst, share, name, worst_l2, name_l2 = 0.0, 0.0, None, 0.0, None
    for n, w in want.items():
        d = got[n] - w
        err = d.abs().max().item()
        tol = rel * w.abs().max().item() + floor
        if err > tol:
            raise AssertionError(f"gradient {n}: {err:.3g} > {tol:.3g}")
        worst = max(worst, err)
        if err / tol > share:
            share, name = err / tol, n
        norm = w.norm().item()
        if l2_rel is not None and norm >= live * top:
            r = d.norm().item() / norm
            if r > l2_rel:
                raise AssertionError(f"gradient {n}: L2 {r:.3g} > {l2_rel}")
            if r > worst_l2:
                worst_l2, name_l2 = r, n
    out = {"max_abs_diff": worst, "worst_tol_share": share,
           "worst_tensor": name, "tensors": len(want)}
    if l2_rel is not None:
        out.update(worst_l2_rel=worst_l2, worst_l2_tensor=name_l2)
    return out


def index_backward(ev) -> dict:
    hit = [e for e in ev if "indexing_backward" in e.key]
    return {"launches": sum(e.count for e in hit),
            "ms": sum(e.self_device_time_total for e in hit) / 1e3}


def learn_turns(name: str, variants: dict, planner, optimizer, generator,
                counters, profile: bool) -> dict:
    """Each variant's learn-step p50 in turns (forward and back, rounds
    LEARN_ROUNDS), its peak memory, exact K-ATT / K-ATT-BWD per step, and
    one profiled step. variants: name -> (cfg, batch, K-ATT per step,
    K-ATT-BWD per step)."""
    from etpnav_tpu_torch.training.finetune import learn_step
    order = list(variants) + list(variants)[::-1]
    ms = {k: [] for k in variants}
    res = {}
    for k, (c, b, fwd, bwd) in variants.items():
        float(learn_step(planner, optimizer, c, b, generator))  # warm
        sync()
        free_cache()
        reset_peak()
        for ctr in counters.values():
            ctr.reset()
        float(learn_step(planner, optimizer, c, b, generator))
        sync()
        got = {n: ctr.value for n, ctr in counters.items() if ctr.value}
        want = {"attention_fwd": fwd, "attention_bwd": bwd}
        if got != want:
            raise AssertionError(f"{name} {k}: launches per learn step "
                                 f"{got} != {want}")
        res[k] = {"peak_gib": peak_gib(), "launches_per_step": got}
    for _ in range(LEARN_ROUNDS):
        for k in order:
            c, b, *_ = variants[k]
            sync()
            t0 = time.perf_counter()
            float(learn_step(planner, optimizer, c, b, generator))
            ms[k].append((time.perf_counter() - t0) * 1e3)
    for k, (c, b, *_) in variants.items():
        res[k].update(p50_ms=statistics.median(ms[k]), min_ms=min(ms[k]),
                      n=len(ms[k]))
        if profile:
            _, wall, dev, ev = profiled_busy(
                lambda: float(learn_step(planner, optimizer, c, b,
                                         generator)))
            res[k].update(profiled_wall_ms=wall, device_ms=dev,
                          busy_share=dev / wall,
                          device_ops=sum(e.count for e in ev),
                          index_backward=index_backward(ev))
    return res


def learn_switches(card: str, cfg, cfg32, planner, tr_batch, rec, counters,
                   device: str, profile: bool = True) -> dict:
    """Stages (c) and (d) on the interval stage (b) recorded in process
    (B = FEED_ENVS, T = 20, G = 96 at r2r_config):
    (c) IL.agg_dense_device: the loss and every planner gradient on
        against off in fp32 with dropout off (AGG_DENSE_REL); then the
        learn step's p50 at (T20, G64) and (T20, G96), off and on in
        turns, with device ms and `indexing_backward_kernel` launches and
        ms from one profiled step of each;
    (d) IL.remat_nav and IL.remat at (T20, G96): the gradients of each
        checkpointed step against the memoryful step's at dropout 0.1
        from the same generator state (REMAT_REL); then p50, peak memory
        and K-ATT per step (19 -> 27 -> 29 at r2r_config) in turns."""
    from etpnav_tpu_torch.training.finetune import (
        aggregate_tokens,
        dense_w_from_sparse,
        make_il_optimizer,
        record_to_batch,
    )
    T = rec.step_valid.shape[1]
    G = rec.gmap_mask.shape[2]
    il = lambda c, **kw: dataclasses.replace(  # noqa: E731
        c, il=dataclasses.replace(c.il, **kw))
    b_full = learn_batch(tr_batch, rec, T, G)
    # the agent keeps its planner frozen; the optimizer opens it
    optimizer = make_il_optimizer(cfg, planner)
    # (c) the matrix against the CPU's, the aggregation dense against
    # sparse, then the loss and gradients, fp32, dropout off
    P = rec.vp_rgb.shape[2]
    cpu_batch = record_to_batch(dataclasses.replace(
        rec, teacher=np.where(rec.teacher < G, rec.teacher, -100)), "cpu")
    w_err = (dense_w_from_sparse(b_full, P).cpu()
             - dense_w_from_sparse(cpu_batch, P)).abs().max().item()
    tokens = torch.randn(rec.step_valid.shape[0], T * P, 768,
                         generator=torch.Generator(device).manual_seed(3),
                         device=device)
    with torch.no_grad():
        agg_s = aggregate_tokens(b_full, tokens)
        agg_d = aggregate_tokens(b_full, tokens, dense=True)
    agg_rel = ((agg_d - agg_s).abs().max() / agg_s.abs().max()).item()
    loss_off, g_off = loss_and_grads(planner, cfg32, b_full)
    loss_on, g_on = loss_and_grads(planner, il(cfg32,
                                               agg_dense_device=True),
                                   b_full)
    gap_c = grad_gap(g_on, g_off, AGG_DENSE_REL, 1e-6, AGG_GRAD_L2,
                     AGG_LIVE)
    gap_c.update(loss_rel=abs(loss_on - loss_off) / abs(loss_off),
                 w_max_abs_diff_vs_cpu=w_err, aggregation_rel=agg_rel)
    if not (w_err <= AGG_W_ATOL and agg_rel <= AGG_SUM_REL
            and gap_c["loss_rel"] <= AGG_LOSS_REL):
        raise AssertionError(f"feed (c): {gap_c}")
    log(f"feed (c) agg_dense_device on vs off, fp32, dropout off, "
        f"(T{T}, G{G}): loss {loss_off:.6f} / {loss_on:.6f}, "
        f"{json.dumps(gap_c)} [{card}]")
    del g_on, g_off
    free_cache()
    generator = torch.Generator(device=device).manual_seed(5)
    n = learn_attentions(cfg, G)
    variants = {}
    for Gb in sorted({min(64, G), G}):
        b = learn_batch(tr_batch, rec, T, Gb)
        for on in (False, True):
            variants[f"T{T}_G{Gb}/agg_dense_{'on' if on else 'off'}"] = (
                il(cfg, agg_dense_device=on), b, n, n)
    res_c = learn_turns("(c)", variants, planner, optimizer, generator,
                        counters, profile)
    log(f"feed (c) learn step, agg_dense_device off / on in turns: "
        f"{json.dumps(res_c)} [{card}]")
    del variants
    free_cache()
    # (d) gradients at dropout 0.1 from one generator state, bf16 stacks
    cfgs = {"memoryful": cfg,
            "remat_nav": il(cfg, remat_nav=True),
            "remat_nav+remat": il(cfg, remat_nav=True, remat=True)}
    g = torch.Generator(device=device).manual_seed(7)
    state = g.get_state()
    grads = {}
    for k, c in list(cfgs.items()) + [("memoryful again", cfg)]:
        g.set_state(state)
        loss, grads[k] = loss_and_grads(planner, c, b_full, g)
        grads[k + "/loss"] = loss
    gap_d = {"noise_floor": grad_gap(grads["memoryful again"],
                                     grads["memoryful"], REMAT_REL, 1e-7)}
    for k in ("remat_nav", "remat_nav+remat"):
        gap_d[k] = grad_gap(grads[k], grads["memoryful"], REMAT_REL, 1e-7)
        gap_d[k]["loss"] = grads[k + "/loss"]
    log(f"feed (d) checkpointed vs memoryful gradients, dropout 0.1, same "
        f"generator state, (T{T}, G{G}): {json.dumps(gap_d)} [{card}]")
    del grads
    free_cache()
    bwd = learn_attentions(cfg, G, recompute=False)
    variants = {k: (c, b_full, learn_attentions(c, G), bwd)
                for k, c in cfgs.items()}
    res_d = learn_turns("(d)", variants, planner, optimizer, generator,
                        counters, profile)
    log(f"feed (d) learn step (T{T}, G{G}), remat off / remat_nav / "
        f"remat_nav + remat in turns: {json.dumps(res_d)} [{card}]")
    return {"agg_dense": {"grads": gap_c, "turns": res_c},
            "remat": {"grads": gap_d, "turns": res_d}}


def uint16_depth(card: str, cfg32, params, counters, device: str) -> dict:
    """Stage (e): perceive (fp32 model, B = FEED_ENVS) with uint16 depth
    against the host-dequantized depth (U16_DEQUANT_TOL) and against the
    fp32 depth it quantizes (U16_FP32_TOL); the depth tensor that crosses
    to the device is uint16 with half the fp32 bytes; the two uploads
    timed; exact launch counts."""
    from etpnav_tpu_torch.training.agent import Agent
    agent = Agent(cfg32, params, device=device)
    rng = np.random.default_rng(13)
    H, Hd = cfg32.clip.image_size, cfg32.depth.input_size
    rgb = rng.integers(0, 256, (FEED_ENVS, 12, H, H, 3), np.uint8)
    depth = rng.random((FEED_ENVS, 12, Hd, Hd, 1), np.float32)
    q = (np.clip(depth, 0.0, 1.0) * 65535.0 + 0.5).astype(np.uint16)
    moved = []
    to_dev = agent._t

    def spy(x):
        t = to_dev(x)
        moved.append((str(t.dtype), t.numel() * t.element_size()))
        return t
    agent._t = spy
    keys = ("pano_embeds", "avg_pano_embeds", "dep_fts", "heatmap")
    for c in counters.values():
        c.reset()
    calls = collections.Counter()
    out = {}
    for name, d in (("uint16", q), ("dequantized", q / np.float32(65535.0)),
                    ("fp32", depth)):
        moved.clear()
        w = agent.perceive(rgb, d)
        calls["perceive"] += 1
        out[name] = {k: w[k].float().cpu() for k in keys}
        out[name + "/moved"] = list(moved)
    del agent._t
    counts = feed_counts("(e) uint16 depth", counters, calls)
    gaps = {}
    for ref, tol in (("dequantized", U16_DEQUANT_TOL),
                     ("fp32", U16_FP32_TOL)):
        gaps[ref] = {k: (out["uint16"][k] - out[ref][k]).abs().max().item()
                     for k in keys}
        bad = {k: v for k, v in gaps[ref].items() if not v <= tol}
        if bad:
            raise AssertionError(f"feed (e): uint16 vs {ref} {bad} > {tol}")
    dep_u16 = [m for m in out["uint16/moved"] if m[0] == "torch.uint16"]
    dep_f32 = [m for m in out["fp32/moved"] if m[1] == depth.nbytes]
    if not (len(dep_u16) == 1 and dep_f32
            and dep_u16[0][1] * 2 == dep_f32[0][1] == depth.nbytes):
        raise AssertionError(f"feed (e): uploads {out['uint16/moved']} / "
                             f"{out['fp32/moved']}")
    up = {}
    if device == "cuda":
        for name, a in (("uint16", q), ("fp32", depth)):
            t = torch.from_numpy(a)
            up[name + "_upload_ms"] = cuda_ms(lambda: t.to(device),
                                              iters=20, warmup=3)
    res = {"max_abs_diff": gaps, "depth_bytes": {"uint16": dep_u16[0][1],
                                                 "fp32": depth.nbytes},
           **up, "launches": counts}
    log(f"feed (e) uint16 depth: {json.dumps(res)} [{card}]")
    return res


def feed_phase(card: str, cfg, host_params, counters, tmp: str,
               device: str = "cuda", profile: bool = True,
               base: str = "r2r") -> dict:
    """Phase 11 at `cfg`'s width (r2r_config on the card; `base` names
    its preset for the runner) with seeded weights, each stage with every
    count at 0 before it and read after: (a) `feed_training`, (b)
    `rollout_three_ways`, (c) and (d) `learn_switches`, (e)
    `uint16_depth`."""
    from etpnav_tpu_torch.training.agent import Agent
    from etpnav_tpu_torch.training.finetune import record_to_batch
    cfg32 = dataclasses.replace(cfg, planner=dataclasses.replace(
        cfg.planner, use_bf16=False))
    t0 = time.perf_counter()
    res = {"a": feed_training(card, counters, tmp, device, base)}
    log(f"feed (a) done at {time.perf_counter() - t0:.0f} s of phase 11")
    free_cache()
    agent = Agent(cfg, copy.deepcopy(host_params), device=device)
    res["b"], rec = rollout_three_ways(card, cfg, agent, counters, device,
                                       profile)
    log(f"feed (b) done at {time.perf_counter() - t0:.0f} s of phase 11")
    res.update(learn_switches(
        card, cfg, cfg32, agent.params.planner,
        lambda r: record_to_batch(r, device), rec, counters, device,
        profile))
    log(f"feed (c, d) done at {time.perf_counter() - t0:.0f} s of phase 11")
    del agent, rec
    free_cache()
    res["e"] = uint16_depth(card, cfg32, copy.deepcopy(host_params),
                            counters, device)
    # the launches of the runner's training, the three rollouts and the
    # uint16 perceives (the learn-step measurements report theirs per step)
    total = collections.Counter()
    for stage in ("a", "b", "e"):
        total.update(res[stage]["launches"])
    res["launches"] = dict(total)
    res["seconds"] = time.perf_counter() - t0
    log(f"phase 11 (the IL trainer's feed): {res['seconds']:.0f} s, "
        f"launches {json.dumps(res['launches'])} [{card}]")
    return res


# ---------------------------------------------------------------------------

# the design of the bf16 attention kernels
# ---------------------------------------------------------------------------
# phase 12: the legacy DAgger trainer at R2R width
# ---------------------------------------------------------------------------

DAGGER_YAML = "configs/dagger_r2r.yaml"
# the counts cut for one chip call (the yaml's: iterations 10,
# episodes_per_iter 128, epochs 4, max_steps 60); the widths, the batch
# size, the policies and the rest of the yaml stay as they are
DAGGER_CUTS = {"iterations": 1, "episodes_per_iter": 8, "epochs": 1,
               "max_steps": 10}
DAGGER_ENVS = 8
DAGGER_EVAL_EPISODES = 8
# the update timed at the yaml's own T = max_steps = 60
DAGGER_TIMED_T = 60
DAGGER_TIMED = 3
# card, kernels against plain versions, fp32, the same weights and batch:
# nav_step's valid logits and new state, and sequence_nll's loss, max
# |diff| <= DAGGER_REL_TOL * max |plain| (fp32 sums in another order
# through 9 + 4 BERT layers of 768); sequence_nll's gradients per tensor
# as phase 7b's, LEARN_REL_TOL * max |plain gradient| + 1e-6, over the
# recurrence of T steps
DAGGER_REL_TOL = 1e-4


def dagger_config(opts: dict):
    """configs/dagger_r2r.yaml with `opts` ({"DAGGER.key": value}) laid
    over it, as `run --exp-config ... DAGGER.key=value` loads it (PyYAML;
    phase 1 reports it)."""
    from etpnav_tpu_torch import config_yaml
    return config_yaml.load_config(DAGGER_YAML, dict(opts))


def dagger_attentions(cfg) -> dict:
    """K-ATT launches per call of each program of the DAgger path at
    `cfg`, as the code runs them: the recurrent VLN-BERT's language stack
    and its nav step (a cross- and a self-attention per LXRT layer; the
    depths from DAGGER, else the planner's); CLIP (its blocks and the cls
    row) per encode_image_uint8; the waypoint TRM per encode_panorama,
    beside CLIP's."""
    d, p = cfg.dagger, cfg.planner
    la = d.la_layers if d.la_layers > 0 else p.num_l_layers
    vl = d.vl_layers if d.vl_layers > 0 else p.num_x_layers
    return {"language": la, "nav": 2 * vl, "clip": cfg.clip.layers,
            "waypoint": cfg.waypoint.num_layers}


@contextlib.contextmanager
def dagger_calls():
    """Counts the DAgger path's program calls (the recurrent VLN-BERT's
    encode_language / nav_step / sequence_nll with its T, CLIP's
    encode_image_uint8, encode_panorama) by wrapping them in their
    modules, and collects the trainers the runner builds and the seconds
    of each collect and update step."""
    from etpnav_tpu_torch.models import clip_vit
    from etpnav_tpu_torch.models import rec_vlnbert as rvb
    from etpnav_tpu_torch.training import agent as agent_mod
    from etpnav_tpu_torch.training import dagger
    calls, seq_t, trainers = collections.Counter(), [], []
    times = {"collect_s": [], "update_ms": []}
    saved = [(rvb, "encode_language"), (rvb, "nav_step"),
             (rvb, "sequence_nll"), (clip_vit, "encode_image_uint8"),
             (agent_mod, "encode_panorama")]
    saved = [(m, a, getattr(m, a)) for m, a in saved]
    methods = [(c, a, c.__dict__[a]) for c in (dagger.RecVLNBertDagger,
                                               dagger.DaggerTrainer)
               for a in ("__init__", "collect", "update_step")]

    def seq(*a, **kw):
        seq_t.append(a[8].shape[1])               # teacher (B, T)
        return saved[2][2](*a, **kw)

    def wrap(cls, attr, fn):
        def init(self, *a, **kw):
            fn(self, *a, **kw)
            trainers.append(self)

        def timed(self, *a, **kw):
            sync()
            t0 = time.perf_counter()
            out = fn(self, *a, **kw)
            if attr == "update_step":
                float(out)
                times["update_ms"].append((time.perf_counter() - t0) * 1e3)
            else:
                sync()
                times["collect_s"].append(time.perf_counter() - t0)
            return out
        return init if attr == "__init__" else timed

    names = ("language", "nav", "sequence", "clip", "panorama")
    for (m, a, fn), n in zip(saved, names):
        setattr(m, a, seq if n == "sequence" else counted(fn, calls, n))
    for c, a, fn in methods:
        setattr(c, a, wrap(c, a, fn))
    try:
        yield calls, seq_t, trainers, times
    finally:
        for m, a, fn in saved:
            setattr(m, a, fn)
        for c, a, fn in methods:
            setattr(c, a, fn)


def dagger_bwd(per: dict, T: int) -> int:
    """K-ATT-BWD launches of one sequence_nll backward over T steps: every
    attention of the language stack and of the T nav steps but one, the
    last step's last self-attention, whose output reaches only the final
    state, which no loss term reads (the logits are its raw scores,
    taken beside the kernel)."""
    return per["language"] + per["nav"] * T - 1


def dagger_counts(name: str, counters, calls, seq_t, per: dict) -> dict:
    """The launch counts since the counters' reset, exactly what the
    DAgger path's calls make: K-ATT per program call, K-ATT-BWD
    `dagger_bwd(per, T)` per sequence_nll (every one is backpropagated),
    K-NMS per encode_panorama; plain versions and the other kernels 0."""
    counts = {k: c.value for k, c in counters.items()}
    want = {k: 0 for k in counters}
    want["attention_fwd"] = (
        per["language"] * calls["language"] + per["nav"] * calls["nav"]
        + per["clip"] * calls["clip"]
        + per["waypoint"] * calls["panorama"])
    want["attention_bwd"] = sum(dagger_bwd(per, t) for t in seq_t)
    want["heatmap_nms_fused"] = calls["panorama"]
    if counts != want:
        raise AssertionError(f"DAgger {name}: launches {counts} != {want} "
                             f"for {dict(calls)}, sequence T {seq_t}")
    return {k: v for k, v in counts.items() if v}


def dagger_parity(card: str, tr, batch) -> dict:
    """One nav_step and one sequence_nll with its gradients on the
    trainer's weights (R2R width, fp32) and a stored batch, kernels
    against their plain versions on the card, dropout off."""
    from etpnav_tpu_torch.models import rec_vlnbert as rvb
    cfg = tr.cfg
    args = [tr._t(a) for a in batch]
    tokens, lmask, rgb, dep, ang, cmask = args[:6]

    def run_once():
        with torch.no_grad():
            state, feats = rvb.encode_language(tr.params, cfg, tokens, lmask)
            logits, new = rvb.nav_step(tr.params, cfg, state, feats, lmask,
                                       rgb[:, 0], dep[:, 0], ang[:, 0],
                                       cmask[:, 0])
        tr.params.zero_grad(set_to_none=True)
        loss = rvb.sequence_nll(tr.params, cfg, *args, train=False)
        loss.backward()
        grads = {n: p.grad.detach().clone()
                 for n, p in tr.params.named_parameters()
                 if p.grad is not None}
        tr.params.zero_grad(set_to_none=True)
        return logits, new, loss.detach(), grads

    got = run_once()
    restore = attention_on_plain_versions()
    try:
        want = run_once()
    finally:
        restore()
    valid = cmask[:, 0]
    res = {}
    for key, a, b in (("logits", got[0][valid], want[0][valid]),
                      ("state", got[1], want[1]), ("loss", got[2], want[2])):
        err = (a - b).abs().max().item()
        tol = DAGGER_REL_TOL * b.abs().max().item()
        if not torch.isfinite(a).all() or err > tol:
            raise AssertionError(f"DAgger parity {key}: {err:.3g} > "
                                 f"{tol:.3g}")
        res[key] = {"max_abs_diff": err, "tol": tol}
    if not torch.equal(got[0][~valid], want[0][~valid]):
        raise AssertionError("DAgger parity: masked logits differ")
    res["grads"] = grad_gap(got[3], want[3], LEARN_REL_TOL, 1e-6)
    log(f"DAgger parity (T {batch[2].shape[1]}, B {batch[0].shape[0]}, "
        f"kernels vs plain on the card, fp32): {json.dumps(res)} [{card}]")
    return res


def dagger_attention_cases(dev, B: int = 8):
    """(name, q, k, v, bias) of the recurrent VLN-BERT's attentions at R2R
    width (12 heads of 64, fp32, B = DAGGER.batch_size): the language
    stack over 80 tokens; the nav step's cross-attention of the 7 rows
    [state; STOP; 5 candidates] into the 79 language keys after slot 0;
    its self-attention over those 7 rows. The head-shared bias is
    rec_vlnbert's: 0 or NEG_INF = -1e9 per key, instructions of ragged
    length and candidate slots masked at random (the state row is always
    valid)."""
    from etpnav_tpu_torch.models.rec_vlnbert import mask_bias
    g = torch.Generator(device=dev).manual_seed(31)

    def natural(L, H=12, hd=64):
        x = torch.randn(B, L, H * hd, generator=g, device=dev) * 0.5
        return x.view(B, L, H, hd).transpose(1, 2)

    lens = torch.randint(8, 81, (B,), generator=g, device=dev)
    lmask = torch.arange(80, device=dev)[None] < lens[:, None]
    smask = torch.rand(B, 7, generator=g, device=dev) < 0.7
    smask[:, :2] = True                   # the state row and STOP
    return [("lang_80", natural(80), natural(80), natural(80),
             mask_bias(lmask)),
            ("nav_cross_7x79", natural(7), natural(79), natural(79),
             mask_bias(lmask[:, 1:])),
            ("nav_self_7x7", natural(7), natural(7), natural(7),
             mask_bias(smask))]


def check_dagger_attention(card: str, device: str = "cuda") -> dict:
    """K-ATT (dropout 0 and 0.1) and K-ATT-BWD (dropout 0 and 0.1, no
    d(bias)) at the DAgger path's shapes (`dagger_attention_cases`),
    against their plain versions on the card: fp32 outputs at TOL, the
    gradients at `bwd_tol`; rows and keys that are not tile multiples
    and the -1e9 bias in the row max. Times: the kernels (CUDA events and
    device time), the plain versions, the bound, SDPA forward and SDPA's
    backward alone with the same float mask and dropout rate."""
    import torch.nn.functional as F

    from etpnav_tpu_torch.ops.fused_attention import (
        attention_bwd,
        attention_bwd_plain,
        attention_fwd,
        attention_plain,
        draw_seed_offset,
    )
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(32)
    dtype = torch.float32
    rows = {}
    for name, q, k, v, bias in dagger_attention_cases(dev):
        scale = 0.125
        dout = torch.randn(q.shape, generator=gen, device=dev)
        mask = bias.expand(q.shape[0], 1, q.shape[2], k.shape[2])
        for p_drop in (0.0, 0.1):
            so = draw_seed_offset(gen, dev) if p_drop else None
            out, lse = attention_fwd(q, k, v, bias, scale, p_drop, so,
                                     return_lse=True)
            want, lse_want = attention_plain(q, k, v, bias, scale, p_drop,
                                             so, return_lse=True)
            args = (q, k, v, bias, out, lse, dout, scale, p_drop, so,
                    False)
            got_g = attention_bwd(*args)
            want_g = attention_bwd_plain(*args)
            torch.cuda.synchronize()
            errs = {"out": (out - want).abs().max().item(),
                    "lse": (lse - lse_want).abs().max().item()}
            if not torch.isfinite(out).all() or errs["out"] > TOL[dtype] \
                    or errs["lse"] > 1e-4:
                raise AssertionError(f"K-ATT {name} p_drop={p_drop}: "
                                     f"{errs}")
            for gname, a, b in zip(("dq", "dk", "dv"), got_g, want_g):
                err = (a - b).abs().max().item()
                if not torch.isfinite(a).all() or err > bwd_tol(b, dtype):
                    raise AssertionError(
                        f"K-ATT-BWD {name} p_drop={p_drop} {gname}: max "
                        f"abs err {err} > {bwd_tol(b, dtype)}")
                errs[gname] = err

            def fwd():
                return attention_fwd(q, k, v, bias, scale, p_drop, so,
                                     return_lse=True)

            def bwd():
                return attention_bwd(*args)

            def sdpa():
                return F.scaled_dot_product_attention(
                    q, k, v, attn_mask=mask, dropout_p=p_drop, scale=scale)

            leaves = tuple(t.detach().clone().requires_grad_()
                           for t in (q, k, v))
            o_ret = F.scaled_dot_product_attention(
                *leaves, attn_mask=mask, dropout_p=p_drop, scale=scale)

            def sdpa_bwd():
                return torch.autograd.grad(o_ret, leaves, dout,
                                           retain_graph=True)

            nbytes, flops = attention_work(q, k, v, bias)
            f_bound = bound_ms(nbytes + 4 * lse.numel(), flops, dtype)
            nbytes, flops = attention_bwd_work(q, k, bias, bool(p_drop),
                                               False)
            b_bound = bound_ms(nbytes, flops, dtype)
            key = f"{name}/float32/p{p_drop}"
            rows[key] = {
                "shape": [list(q.shape), list(k.shape)],
                "max_abs_err": max(errs.values()), "errs": errs,
                "fwd": {"ms": cuda_ms(fwd), "kernel_ms": kernel_ms(fwd),
                        "plain_ms": cuda_ms(lambda: attention_plain(
                            q, k, v, bias, scale, p_drop, so,
                            return_lse=True), iters=10, warmup=2),
                        "library_ms": cuda_ms(sdpa),
                        "library_kernel_ms": kernel_ms(sdpa),
                        "bound_ms": f_bound[0], "bound_by": f_bound[1]},
                "bwd": {"ms": cuda_ms(bwd, iters=20),
                        "kernel_ms": kernel_ms(bwd),
                        "plain_ms": cuda_ms(lambda: attention_bwd_plain(
                            *args), iters=10, warmup=2),
                        "library_ms": cuda_ms(sdpa_bwd, iters=20),
                        "library_kernel_ms": kernel_ms(sdpa_bwd),
                        "bound_ms": b_bound[0], "bound_by": b_bound[1]}}
            del o_ret
            log(f"K-ATT + K-ATT-BWD DAgger {key:26s} q{tuple(q.shape)} "
                f"k{tuple(k.shape)} errs={json.dumps(errs)} "
                f"{json.dumps({d: rows[key][d] for d in ('fwd', 'bwd')})} "
                f"[{card}]")
    return rows


def dagger_phase(card: str, counters, tmp: str, device: str = "cuda",
                 base=None) -> dict:
    """Phase 12: `run --exp-config configs/dagger_r2r.yaml --trainer
    DAgger` at the yaml's full R2R width (BASE r2r) on GeometricNavEnv
    (8 envs), each stage with every count at 0 before it and read after,
    exact launch counts and no plain call: (a) train, DAGGER.policy
    rec_vlnbert; (b) train, DAGGER.policy cma; (c) eval of rec_vlnbert
    (forced stop at the step cap). Only the counts of DAGGER_CUTS are cut.
    Then on (a)'s trainer: K-ATT per nav step and K-ATT + K-ATT-BWD per
    update batch against the formula, the update step's p50 at T = 60
    and its peak memory, and one nav step and one sequence_nll with its
    gradients, kernels against plain versions. `base` (a config) replaces
    the yaml, for a rehearsal on the CPU."""
    from etpnav_tpu_torch.run import run_config
    t_phase = time.perf_counter()
    opts = {f"DAGGER.{k}": v for k, v in DAGGER_CUTS.items()}
    log(f"DAgger: {DAGGER_YAML} with the counts cut to {json.dumps(opts)}; "
        f"{DAGGER_ENVS} envs, {DAGGER_EVAL_EPISODES} eval episodes")
    res = {"cuts": DAGGER_CUTS, "launches": collections.Counter()}
    for stage, policy, run_type in (("train_rec_vlnbert", "rec_vlnbert",
                                     "train"),
                                    ("train_cma", "cma", "train"),
                                    ("eval_rec_vlnbert", "rec_vlnbert",
                                     "eval")):
        o = {**opts, "DAGGER.policy": policy,
             "DAGGER.store_dir": os.path.join(tmp, stage)}
        if base is None:
            cfg = dagger_config(o)
        else:
            cfg = dataclasses.replace(base, dagger=dataclasses.replace(
                base.dagger, **{k.split(".")[1]: v for k, v in o.items()}))
        for cnt in counters.values():
            cnt.reset()
        reset_peak()
        t0 = time.perf_counter()
        with dagger_calls() as (calls, seq_t, trainers, times):
            out = run_config(cfg, trainer="DAgger", run_type=run_type,
                             device=device, num_envs=DAGGER_ENVS,
                             episode_count=DAGGER_EVAL_EPISODES)
            sync()
        launches = dagger_counts(stage, counters, calls, seq_t,
                                 dagger_attentions(cfg))
        res["launches"].update(launches)
        if run_type == "train":
            ok = len(out) == DAGGER_CUTS["iterations"] and all(
                np.isfinite(out))
        else:
            ok = out and all(np.isfinite(out[k]) for k in
                             ("success", "spl", "ndtw"))
        if not ok:
            raise AssertionError(f"DAgger {stage}: {out}")
        row = {"seconds": time.perf_counter() - t0, "result": out,
               "calls": dict(calls), "sequence_T": seq_t,
               "launches": launches, "collect_s": times["collect_s"],
               "update_ms": times["update_ms"], "peak_gib": peak_gib()}
        res[stage] = row
        log(f"DAgger {stage}: {json.dumps(row)} [{card}]")
        if stage == "train_rec_vlnbert":
            tr = trainers[-1]
    # per-call launch counts and the update's p50 at T = 60, on (a)'s
    # trainer and its store
    trajs = list(tr.store)
    long = dict(trajs[0])
    reps = -(-DAGGER_TIMED_T // len(long["teacher"]))
    for k in ("rgb", "dep", "ang", "cmask", "teacher"):
        long[k] = np.concatenate([long[k]] * reps)[:DAGGER_TIMED_T]
    order = np.arange(len(trajs) + 1)
    batch = next(tr.update_batches(trajs + [long], order))
    T = batch[2].shape[1]
    per = {"language": tr.cfg.la_layers, "nav": 2 * tr.cfg.vl_layers}
    state, feats, lmask = tr._lang(batch[0])
    sync()
    for cnt in counters.values():
        cnt.reset()
    tr._nav(state, feats, lmask, *(b[:, 0] for b in batch[2:6]))
    sync()
    nav_counts = {k: c.value for k, c in counters.items() if c.value}
    if nav_counts != {"attention_fwd": per["nav"]}:
        raise AssertionError(f"DAgger nav step: launches {nav_counts}")
    ms = []
    reset_peak()
    for _ in range(1 + DAGGER_TIMED):
        for cnt in counters.values():
            cnt.reset()
        sync()
        t0 = time.perf_counter()
        loss = float(tr.update_step(batch))
        ms.append((time.perf_counter() - t0) * 1e3)
        upd = {k: c.value for k, c in counters.items() if c.value}
        n, nb = per["language"] + per["nav"] * T, dagger_bwd(per, T)
        if upd != {"attention_fwd": n, "attention_bwd": nb}:
            raise AssertionError(f"DAgger update batch (T {T}): launches "
                                 f"{upd}, want {n} + {nb}")
        if not np.isfinite(loss):
            raise AssertionError(f"DAgger update loss {loss}")
    res["update"] = {"T": T, "B": batch[0].shape[0],
                     "p50_ms": statistics.median(ms[1:]),
                     "ms": ms[1:], "first_ms": ms[0],
                     "peak_gib": peak_gib(), "loss": loss,
                     "launches_per_batch": upd,
                     "launches_per_nav_step": nav_counts}
    log(f"DAgger update batch at T {T}, B {batch[0].shape[0]}: "
        f"{json.dumps(res['update'])}; {per['nav']} K-ATT per nav step, "
        f"{n} K-ATT = {per['language']} + {per['nav']} x {T} and {nb} "
        f"K-ATT-BWD (the last step's last self-attention reaches no loss) "
        f"per update batch [{card}]")
    res["parity"] = dagger_parity(card, tr, next(tr.update_batches(
        trajs, np.arange(len(trajs)))))
    res["launches"] = dict(res["launches"])
    res["seconds"] = time.perf_counter() - t_phase
    return res


# ---------------------------------------------------------------------------
# phase 13: the learning demo, warm against cold, the offline extractor
# ---------------------------------------------------------------------------

# the demo's two sessions in one checkpoint directory: the first to
# iteration 2, the second resumed to 4; 8 envs, an 8-episode held-out
# eval every 2 iterations (and at iteration 0): short, to keep the whole
# run near half its time limit
DEMO_ITERS = (2, 4)
DEMO_ENVS = 8
DEMO_EVAL_EPISODES = 8
# warm against cold, cut to 2 pretraining steps and 2 IL iterations per
# arm (one 4-episode held-out eval each); the rest at the tool's defaults
WVC_ARGS = ["--pretrain-steps", "2", "--iters", "2", "--eval-every", "2",
            "--eval-episodes", "4"]
WVC_PRETRAIN, WVC_IL = 2, 2 * 2
# the extractor: 8 panoramas of 36 views and 40 zero-shot classes
EXTRACT_PANOS, EXTRACT_VIEWS, EXTRACT_CLASSES = 8, 36, 40
EXTRACT_TIMED = 5
# launches per extractor call: CLIP's 11 blocks and the cls row (K-ATT),
# or under the fused configuration K-PRENORM for blocks 1-11, the cls row
# on K-ATT and one K-GN per GroupNorm of the depth trunk
EXTRACT_PER_CALL = {
    "default": {"attention_fwd": 12},
    "fused": {"attention_fwd": 1, "prenorm_attention": 11,
              "group_norm_fused": 54},
}
# kernels against plain versions, both on the card, per output (the CLIP
# features with the class logits, the depth means): in fp32 max |diff| <=
# SLICE_REL_TOL * max |plain| (fp32 sums in another order through 12 CLIP
# blocks and the ResNet-50 trunk); in bf16 ||diff|| / ||plain|| <=
# EXTRACT_BF16_L2 (K-ATT rounds p at a running max, K-GN's and
# K-PRENORM's fp32 sums run in another order and move values at bf16
# rounding ties, which 12 blocks and 54 GroupNorms carry on)
EXTRACT_BF16_L2 = 2e-2


@contextlib.contextmanager
def agent_calls():
    """Counts the calls of every `Agent`'s three programs (perceive,
    score_navigation, encode_text) by wrapping the class's methods."""
    from etpnav_tpu_torch.training.agent import Agent
    calls = collections.Counter()
    names = {"perceive": "perceive", "score_navigation": "navigation",
             "encode_text": "text"}
    saved = {a: Agent.__dict__[a] for a in names}
    for a, fn in saved.items():
        setattr(Agent, a, counted(fn, calls, names[a]))
    try:
        yield calls
    finally:
        for a, fn in saved.items():
            setattr(Agent, a, fn)


def read_counts(counters) -> dict:
    return {k: c.value for k, c in counters.items()}


def demo_phase(card: str, counters, tmp: str, device: str = "cuda",
               config: str = "r2r") -> dict:
    """Phase 13 (a) and (b): `learning_demo.main` at `config` width in two
    sessions in one directory, then `warm_vs_cold.main` cut to WVC_ARGS;
    each run with every count at 0 before it and read after."""
    from etpnav_tpu_torch.tools import learning_demo, warm_vs_cold
    from etpnav_tpu_torch.tools.pretrain_synth import pretrain_setup
    res = {}
    ckpt = os.path.join(tmp, "conv")
    per = PER_CALL["default"]
    start = 0
    for session, iters in enumerate(DEMO_ITERS, 1):
        argv = ["--iters", str(iters), "--eval-every", str(DEMO_ITERS[0]),
                "--eval-episodes", str(DEMO_EVAL_EPISODES), "--num-envs",
                str(DEMO_ENVS), "--ckpt-dir", ckpt, "--device", device,
                "--config", config]
        for c in counters.values():
            c.reset()
        reset_peak()
        t0 = time.perf_counter()
        with agent_calls() as calls:
            lines = learning_demo.main(argv, emit=lambda s: log(f"demo: {s}"))
            sync()
        seconds = time.perf_counter() - t0
        counts = read_counts(counters)
        learn = iters - start
        want = {k: sum(per[prog].get(k, 0) * calls[prog] for prog in per)
                for k in counts}
        want["attention_fwd"] += LEARN_ATTENTIONS * learn
        want["attention_bwd"] += LEARN_ATTENTIONS * learn
        if counts != want:
            raise AssertionError(f"demo session {session}: launches "
                                 f"{counts} != {want} for {dict(calls)} "
                                 f"and {learn} learn steps")
        head = lines[0]
        if (session == 1 and head.get("iter") != 0) or (
                session == 2 and head != {"resumed_at": start}):
            raise AssertionError(f"demo session {session}: first line "
                                 f"{head}")
        evals = [d for d in lines if "IL_loss" in d]
        if ([d["iter"] for d in evals] != [iters]
                or not np.isfinite(evals[0]["IL_loss"])
                or evals[0]["n_episodes"] != DEMO_EVAL_EPISODES):
            raise AssertionError(f"demo session {session}: evals {evals}")
        left = sorted(os.listdir(ckpt))
        if left != [f"ckpt_iter{iters}.pt"]:
            raise AssertionError(f"demo session {session}: checkpoints "
                                 f"{left}")
        res[f"session{session}"] = {
            "argv": argv, "seconds": seconds, "calls": dict(calls),
            "learn_steps": learn, "launches": counts,
            "launches_per_iteration": {k: v / learn for k, v in
                                       counts.items() if v},
            "eval": evals[0], "checkpoints": left, "peak_gib": peak_gib()}
        log(f"demo session {session} ({config}, {DEMO_ENVS} envs): "
            f"{json.dumps(res[f'session{session}'])} [{card}]")
        start = iters
    free_cache()

    for c in counters.values():
        c.reset()
    reset_peak()
    lines = []
    argv = WVC_ARGS + ["--device", device] + (
        ["--tiny"] if config == "tiny" else [])
    t0 = time.perf_counter()

    def emit(s):
        lines.append(json.loads(s))
        log(f"warm_vs_cold: {s}")
    with agent_calls() as calls:
        last = warm_vs_cold.main(argv, emit=emit)
        sync()
    counts = read_counts(counters)
    p = pretrain_setup(config, WVC_PRETRAIN, 16)[0].planner
    n_bwd = pretrain_attentions(p) * WVC_PRETRAIN + LEARN_ATTENTIONS * WVC_IL
    arms = [(d["arm"], d["iter"]) for d in lines if "arm" in d]
    plain = {k: v for k, v in counts.items() if "plain" in k and v}
    if (counts["attention_bwd"] != n_bwd or plain
            or counts["attention_fwd"] == 0
            or counts["heatmap_nms_fused"] != calls["perceive"]
            or arms != [("cold", 2), ("warm", 2)]
            or lines[-1] != last
            or set(last["summary"]) != {"cold", "warm", "delta_IL_loss"}
            or not all(np.isfinite(last["summary"][a]["IL_loss"])
                       for a in ("cold", "warm"))):
        raise AssertionError(f"warm_vs_cold: launches {counts} (K-ATT-BWD "
                             f"want {n_bwd}), calls {dict(calls)}, lines "
                             f"{lines}")
    res["warm_vs_cold"] = {"argv": argv,
                           "seconds": time.perf_counter() - t0,
                           "launches": counts, "calls": dict(calls),
                           "lines": lines, "peak_gib": peak_gib()}
    log(f"warm_vs_cold ({config}): {json.dumps(res['warm_vs_cold'])} "
        f"[{card}]")
    free_cache()
    return res


def extract_attention_row(card: str) -> dict:
    """K-ATT at the extractor's CLIP shape, q/k/v (288, 12, 50, 64) in
    the natural layout (8 panoramas x 36 views), bf16, against its plain
    version, beside SDPA and the bound."""
    g = torch.Generator(device="cuda").manual_seed(13)
    B = EXTRACT_PANOS * EXTRACT_VIEWS
    q, k, v = (torch.randn(B, 50, 768, generator=g, device="cuda")
               .view(B, 50, 12, 64).transpose(1, 2) for _ in range(3))
    return attention_row(card, "extract_natural", q, k, v, None,
                         torch.bfloat16)


@contextlib.contextmanager
def extract_on_plain_versions():
    """K-ATT's, K-GN's and K-PRENORM's wrappers sent to their plain
    versions, on the card's tensors too, as the towers call them."""
    from etpnav_tpu_torch.models import clip_vit, depth_resnet
    from etpnav_tpu_torch.ops import fused_groupnorm, fused_prenorm
    restore = attention_on_plain_versions()
    gn, pre = depth_resnet.group_norm_fused, clip_vit.prenorm_attention
    depth_resnet.group_norm_fused = fused_groupnorm.group_norm_plain
    clip_vit.prenorm_attention = fused_prenorm.prenorm_attention_plain
    try:
        yield
    finally:
        restore()
        depth_resnet.group_norm_fused, clip_vit.prenorm_attention = gn, pre


def extract_phase(card: str, params, counters, device: str = "cuda",
                  base=None) -> dict:
    """Phase 13 (c): `FeatureExtractor` at `base` (r2r_config()) width
    over EXTRACT_PANOS panoramas of EXTRACT_VIEWS views with a seeded
    EXTRACT_CLASSES-class class_proj, in the default and the fused
    configuration, fp32 and bf16: exact launches per call, the features
    through the kernels against the same call on the plain versions on
    the card, and in bf16 ms per panorama and the peak memory. `params`
    (AgentParams) has its towers moved to `device`."""
    from etpnav_tpu_torch.config import r2r_config
    from etpnav_tpu_torch.data.feature_pipeline import FeatureExtractor
    cfg = base if base is not None else r2r_config()
    rng = np.random.default_rng(13)
    H, Hd = cfg.clip.image_size, cfg.depth.input_size
    rgb = rng.integers(0, 256, (EXTRACT_PANOS, EXTRACT_VIEWS, H, H, 3),
                       np.uint8)
    dep = rng.random((EXTRACT_PANOS, EXTRACT_VIEWS, Hd, Hd, 1), np.float32)
    proj = rng.standard_normal((EXTRACT_CLASSES, cfg.clip.output_dim)
                               ).astype(np.float32)
    plain_of = {"attention_fwd": "attention_plain",
                "group_norm_fused": "group_norm_plain",
                "prenorm_attention": "prenorm_attention_plain"}
    res = {}
    for name, c in (("default", cfg), ("fused", fused_config(cfg))):
        for dtype in (torch.float32, torch.bfloat16):
            key = f"{name}/{str(dtype).split('.')[-1]}"
            ex = FeatureExtractor(c, params, batch_panos=EXTRACT_PANOS,
                                  class_proj=proj, device=device,
                                  dtype=dtype)
            for cnt in counters.values():
                cnt.reset()
            got = ex(rgb, dep)
            sync()
            counts = read_counts(counters)
            want = {k: EXTRACT_PER_CALL[name].get(k, 0) for k in counters}
            if counts != want:
                raise AssertionError(f"extract {key}: launches {counts} != "
                                     f"{want}")
            for cnt in counters.values():
                cnt.reset()
            with extract_on_plain_versions():
                ref = ex(rgb, dep)
                sync()
            plain = read_counts(counters)
            want_p = {k: 0 for k in counters}
            for k, n in EXTRACT_PER_CALL[name].items():
                want_p[plain_of[k]] = n
            if plain != want_p:
                raise AssertionError(f"extract {key}: plain calls {plain} "
                                     f"!= {want_p}")
            errs = {}
            for out, g, r in zip(("rgb", "depth"), got, ref):
                if g.shape != r.shape or not np.isfinite(g).all():
                    raise AssertionError(f"extract {key} {out}: "
                                         f"{g.shape} {r.shape}")
                if dtype == torch.float32:
                    err = np.abs(g - r).max() / np.abs(r).max()
                    tol = SLICE_REL_TOL
                else:
                    err = np.linalg.norm(g - r) / np.linalg.norm(r)
                    tol = EXTRACT_BF16_L2
                if not err <= tol:
                    raise AssertionError(f"extract {key} {out}: error "
                                         f"{err} > {tol}")
                errs[out] = {"err": float(err), "tol": tol}
            row = {"rgb_shape": list(got[0].shape),
                   "depth_shape": list(got[1].shape),
                   "launches_per_call": counts, "vs_plain": errs}
            if dtype == torch.bfloat16:
                reset_peak()
                dev_rgb = torch.from_numpy(rgb).to(device)
                dev_dep = torch.from_numpy(dep).to(device)
                ms, ms_dev = [], []
                for _ in range(1 + EXTRACT_TIMED):
                    sync()
                    t0 = time.perf_counter()
                    ex(rgb, dep)
                    ms.append((time.perf_counter() - t0) * 1e3)
                    t0 = time.perf_counter()
                    ex.encode(dev_rgb, dev_dep)
                    sync()
                    ms_dev.append((time.perf_counter() - t0) * 1e3)
                row.update({
                    "ms_per_pano": statistics.median(ms[1:]) / EXTRACT_PANOS,
                    "ms_per_pano_on_device":
                        statistics.median(ms_dev[1:]) / EXTRACT_PANOS,
                    "peak_gib": peak_gib()})
                del dev_rgb, dev_dep
            res[key] = row
            log(f"extract {key} ({EXTRACT_PANOS} panoramas x "
                f"{EXTRACT_VIEWS} views, {EXTRACT_CLASSES} classes): "
                f"{json.dumps(row)} [{card}]")
            del ex
    free_cache()
    return res


# ---------------------------------------------------------------------------
# phase 14: distribution (parallel/mesh.py) and the eval videos
# ---------------------------------------------------------------------------

#: the head base of mp rank 1 at R2R width (12 heads over mp 2)
HEAD_BASE = 6
#: each spawned world's children are killed after this many seconds
DIST_LIMIT_S = 300
#: learn steps per turn of the dp 2 / dp 1 timing (A B B A)
DIST_TURN_STEPS = 3
DIST_PRETRAIN_BATCH = 8
DIST_MP_ENVS = 4
#: the runner under torchrun: 2 ranks x 4 envs, 2 iterations; then 2
#: eval episodes with videos
TORCHRUN_ENVS, TORCHRUN_ITERS, VIDEO_EPISODES = 4, 2, 2
#: two AdamW moves at IL.lr = 1e-5: a near-zero gradient summed in
#: another order may take either sign
DIST_PARAM_ATOL = 2e-5
#: two pretraining steps' worth of the optimizer's largest move (lr 5e-5
#: in warmup): a near-zero gradient may take either sign
DIST_PRETRAIN_ATOL = 1e-4


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(rank: int, target, world: int, address: str, threads: int,
               args: tuple) -> None:
    torch.set_num_threads(threads)
    target(rank, world, address, *args)


def spawn_ranks(target, world: int, args: tuple, limit: float,
                threads: int) -> None:
    """target(rank, world, address, *args) in `world` fresh processes
    (torch.multiprocessing, spawn), `address` the "localhost:PORT" that
    `init_distributed` takes. A child that fails fails the call and
    torch.multiprocessing ends its peers; past `limit` seconds every child
    still running is killed and the call raises."""
    ctx = torch.multiprocessing.start_processes(
        _rank_main, args=(target, world, f"localhost:{free_port()}",
                          threads, tuple(args)),
        nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + limit
    try:
        while not ctx.join(timeout=max(0.0, deadline - time.monotonic())):
            if time.monotonic() >= deadline:
                raise AssertionError(f"{target.__name__}: ranks still "
                                     f"running after {limit:.0f} s; killed")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join()


def dist_counters(device: str = "cuda") -> dict:
    """The counters of the kernels on phase 14's path; on the CPU (a
    rehearsal) the plain versions' calls under the kernels' names."""
    from etpnav_tpu_torch.ops import fused_attention as fa
    from etpnav_tpu_torch.ops import fused_nms
    if device == "cpu":
        return {"attention_fwd": fa.attention_plain_calls,
                "attention_bwd": fa.attention_bwd_plain_calls,
                "heatmap_nms_fused": fused_nms.heatmap_nms_plain_calls}
    return {"attention_fwd": fa.attention_fwd_launches,
            "attention_plain": fa.attention_plain_calls,
            "attention_bwd": fa.attention_bwd_launches,
            "attention_bwd_plain": fa.attention_bwd_plain_calls,
            "heatmap_nms_fused": fused_nms.heatmap_nms_launches,
            "heatmap_nms_plain": fused_nms.heatmap_nms_plain_calls}


def read_reset(counters: dict) -> dict:
    """Every count, read after a synchronize, then set to 0."""
    sync()
    out = {k: c.value for k, c in counters.items()}
    for c in counters.values():
        c.reset()
    return out


def rows_of(rec, lo: int, hi: int):
    """Rows lo..hi-1 of a recorded interval."""
    return dataclasses.replace(rec, **{
        f.name: getattr(rec, f.name)[lo:hi]
        for f in dataclasses.fields(rec)})


def replicas_equal(mesh, module) -> int:
    """Global mp index 0's replicated parameters broadcast over the mp
    group; raises unless this rank's are bit-equal. Returns their
    number."""
    import torch.distributed as dist
    ps = [p.detach() for p in module.parameters() if not hasattr(p, "tp")]
    flat = torch.cat([p.reshape(-1) for p in ps])
    theirs = flat.clone()
    dist.broadcast(theirs, mesh.mp_src, group=mesh.mp_group)
    if not torch.equal(flat, theirs):
        raise AssertionError(f"mp rank {mesh.mp_index}: replicated "
                             "parameters differ from mp rank 0's")
    return len(ps)


def _dist_dp2(mesh, inp, device, counters) -> dict:
    """(b) dp 2: each rank learns on its half of the recorded interval
    (dropout off); then the learn step in turns, dp 2 (both ranks) and
    dp 1 (rank 0 alone on all rows)."""
    import torch.distributed as dist

    from etpnav_tpu_torch.models.planner import PlannerParams
    from etpnav_tpu_torch.training import finetune as ft
    cfg = inp["cfg"]
    planner = PlannerParams(cfg.planner)
    planner.load_state_dict({k[len("planner."):]: v for k, v
                             in inp["agent"].items()
                             if k.startswith("planner.")})
    planner.to(device)
    opt = ft.make_il_optimizer(cfg, planner)
    rec = inp["rec"]
    half = rec.step_valid.shape[0] // 2
    mine = ft.bucket_record(rows_of(rec, half * mesh.rank,
                                    half * (mesh.rank + 1)), cfg.il)
    whole = ft.bucket_record(rec, cfg.il)       # both ranks: the sync
    batch = ft.record_to_batch(mine, device)
    read_reset(counters)
    loss = float(ft.learn_step(planner, opt, cfg, batch, None, mesh))
    res = {"loss": loss, "counts": read_reset(counters),
           "valid": int(mine.step_valid.sum()),
           "bucket": list(mine.step_valid.shape[1:]) + [
               mine.gmap_mask.shape[2]]}
    if mesh.rank == 0:
        res["planner"] = {k: v.to("cpu", copy=True) for k, v
                          in planner.state_dict().items()}
    whole_batch = ft.record_to_batch(whole, device)
    times = {"dp2": [], "dp1": []}
    for turn in ("dp2", "dp1", "dp1", "dp2"):
        dist.barrier()
        if turn == "dp1" and mesh.rank != 0:
            continue
        for _ in range(DIST_TURN_STEPS):
            sync()
            t0 = time.perf_counter()
            if turn == "dp2":
                float(ft.learn_step(planner, opt, cfg, batch, None, mesh))
            else:
                float(ft.learn_step(planner, opt, cfg, whole_batch))
            sync()
            times[turn].append((time.perf_counter() - t0) * 1e3)
    dist.barrier()
    res["times_ms"] = times
    read_reset(counters)
    return res


def _grad_dists(params, refs: dict) -> dict:
    """||g - g_ref|| / ||g_ref|| over every gradient of `params` against
    each one-process module of `refs`, by name; the split gradients are
    gathered whole once (a collective over the mp group)."""
    from etpnav_tpu_torch.parallel import mesh as M
    num = dict.fromkeys(refs, 0.0)
    den = dict.fromkeys(refs, 0.0)
    ref_params = {k: dict(m.named_parameters()) for k, m in refs.items()}
    for name, p in params.named_parameters():
        if any((p.grad is None) != (r[name].grad is None)
               for r in ref_params.values()):
            raise AssertionError(f"mp 2: {name} has a gradient on one side")
        if p.grad is None:
            continue
        spec = getattr(p, "tp", None)
        g = (M.gather_tensor(p.grad, spec) if spec is not None
             else p.grad).double()
        for k, r in ref_params.items():
            w = r[name].grad.double()
            num[k] += float((g - w).pow(2).sum())
            den[k] += float(w.pow(2).sum())
    return {k: (num[k] / den[k]) ** 0.5 for k in refs}


def check_bf16_step(what: str, loss: float, one: dict,
                    grad_rel: dict = None, one_grad_rel: float = None):
    """(c) at bf16 is held as phase 7b holds the bf16 learn step: at R2R
    width with random weights, some LayerNorms see nearly constant rows
    and blow a single bf16 rounding up, so an mp rank's bf16 step and one
    process's bf16 step (which differ only in the order of fp32 sums)
    part by about as much as either parts from fp32 (on the H100 the mp
    SAP loss parted from one process's bf16 loss by rel 1.1e-3). So each
    is held against one process's fp32 step:
    the loss within BF16_LOSS_REL, and the gathered gradients' relative
    L2 distance from fp32 within a factor BF16_VS_PLAIN of one process's
    bf16 step's, both ways (an fp32 path in place of the bf16 one would
    come out near 0)."""
    rel = abs(loss - one["fp32"]) / abs(one["fp32"])
    if rel > BF16_LOSS_REL:
        raise AssertionError(f"{what}: bf16 loss {loss} vs one process's "
                             f"fp32 {one['fp32']} (rel {rel})")
    if grad_rel is None:
        return
    ratio = grad_rel["fp32"] / one_grad_rel
    if not 1 / BF16_VS_PLAIN <= ratio <= BF16_VS_PLAIN:
        raise AssertionError(f"{what}: gradients {grad_rel['fp32']} from "
                             f"one process's fp32 (relative L2), one "
                             f"process's bf16 {one_grad_rel}")


def _dist_mp2(mesh, inp, device, counters) -> dict:
    """(c) mp 2, dropout on: a pretraining SAP and MLM step at R2R width
    (the vocabulary split in two) at the config's own precision (bf16
    planner) and in fp32, each held against one-process trainers in this
    rank stepping beside it from the same seeds (loss, every gathered
    gradient, the whole state after); one fine-tune iteration at the
    config's precision with the record broadcast; the first K-ATT and
    K-ATT-BWD launch of mp rank 1 (heads 6..11) with dropout in each
    precision captured and held against the plain versions."""
    from etpnav_tpu_torch.ops import fused_attention as fa
    from etpnav_tpu_torch.parallel import mesh as M
    from etpnav_tpu_torch.training.agent import AgentParams
    from etpnav_tpu_torch.training.finetune import FinetuneTrainer
    from etpnav_tpu_torch.training.pretrain import PretrainTrainer
    cfg = inp["cfg_mp"]
    cfgs = {"bf16": cfg, "fp32": inp["cfg"]}
    head_base = cfg.planner.num_heads // 2
    captured = {}
    fwd, bwd = fa.attention_fwd, fa.attention_bwd

    def capture(name, fn, seed_at):
        # the first launch of this rank's heads with dropout on, per dtype
        def wrapper(*a, **kw):
            key = (name, a[0].dtype)
            if (key not in captured and kw.get("head_base") == head_base
                    and a[seed_at] is not None):
                captured[key] = ([t.clone() if torch.is_tensor(t) else t
                                  for t in a], dict(kw))
            return fn(*a, **kw)
        return wrapper
    res = {}
    for prec, c in cfgs.items():
        tr = PretrainTrainer(c, inp["shapes"], seed=0, device=device,
                             mesh=mesh)
        # one process in bf16 and in fp32, from the same seeds
        refs = {k: PretrainTrainer(rc, inp["shapes"], seed=0, device=device)
                for k, rc in cfgs.items() if prec == "bf16" or k == prec}
        steps = {}
        for task in ("sap", "mlm"):
            batch = tr._put(tr.sampler.sample_batch(DIST_PRETRAIN_BATCH,
                                                    task))
            ref_batches = {k: r._put(r.sampler.sample_batch(
                DIST_PRETRAIN_BATCH, task)) for k, r in refs.items()}
            fa.attention_fwd = capture("attention_fwd", fwd, 6)
            fa.attention_bwd = capture("attention_bwd", bwd, 9)
            try:
                read_reset(counters)
                loss = float(tr.train_step(task, batch))
                counts = read_reset(counters)
            finally:
                fa.attention_fwd, fa.attention_bwd = fwd, bwd
            ref_loss = {k: float(r.train_step(task, ref_batches[k]))
                        for k, r in refs.items()}
            read_reset(counters)
            steps[task] = {
                "loss": loss, "one_process_loss": ref_loss,
                "grad_rel_l2": _grad_dists(tr.params, {
                    k: r.params for k, r in refs.items()}),
                "counts": counts}
            if prec == "bf16":
                steps[task]["one_bf16_grad_rel_l2"] = _grad_dists(
                    refs["bf16"].params, {"fp32": refs["fp32"].params})
        whole = M.full_state_dict(tr.params)
        sfx = "" if prec == "bf16" else "_fp32"
        res["pretrain" + sfx] = steps
        res["pretrain_param_worst" + sfx] = max(
            float((whole[n] - t).abs().max())
            for n, t in refs[prec].params.state_dict().items())
        res["pretrain_replicated" + sfx] = replicas_equal(mesh, tr.params)
        del tr, refs, whole
    # the captured launches, kernels against plain versions
    if mesh.mp_index == 1:
        for dtype, sfx in ((torch.bfloat16, ""), (torch.float32, "_fp32")):
            for name, plain in (("attention_fwd", fa.attention_plain),
                                ("attention_bwd", fa.attention_bwd_plain)):
                if (name, dtype) not in captured:
                    raise AssertionError(f"mp 2: no {dtype} {name} launch "
                                         f"at head base {head_base} with "
                                         "dropout captured")
                a, kw = captured[name, dtype]
                got = (fwd if name == "attention_fwd" else bwd)(*a, **kw)
                want = plain(*a, **kw)
                pairs = [(got, want)] if torch.is_tensor(got) else [
                    (g, w) for g, w in zip(got, want) if g is not None]

                def tol(w):
                    return (TOL[dtype] if name == "attention_fwd"
                            else bwd_tol(w, dtype))
                res[name + sfx] = {
                    "shape": list(a[0].shape), "dtype": str(dtype),
                    "head_base": kw["head_base"],
                    "heads_total": kw["heads_total"],
                    "max_abs_err": max(float((g.float() - w.float()).abs()
                                             .max()) for g, w in pairs),
                    "tol_share": max(float((g.float() - w.float()).abs()
                                           .max()) / tol(w)
                                     for g, w in pairs)}
        read_reset(counters)
    # one fine-tune iteration: mp rank 0 rolls out, its peer receives
    params = AgentParams(cfg)
    params.load_state_dict(inp["agent"])
    ft = FinetuneTrainer(cfg, geometric_envs(cfg, DIST_MP_ENVS, seed=0),
                         params=params, seed=0, device=device, mesh=mesh)
    seen = []
    broadcast = ft.mesh.broadcast_mp

    def keep(rec):
        rec = broadcast(rec)
        seen.append(rec)
        return rec
    ft.mesh.broadcast_mp = keep
    read_reset(counters)
    logs = ft.train(1)
    res["finetune"] = {"loss": logs["IL_loss"],
                       "counts": read_reset(counters),
                       "replicated": replicas_equal(mesh, ft.train_planner),
                       "digest": record_digest(seen[0])}
    if mesh.mp_index == 0:
        res["finetune"]["rec"] = seen[0]
    ft.close()
    return res


def record_digest(rec) -> str:
    import hashlib
    h = hashlib.sha1()
    for f in dataclasses.fields(rec):
        h.update(np.ascontiguousarray(getattr(rec, f.name)).tobytes())
    return h.hexdigest()


def dist_child(rank: int, world: int, address: str, in_path: str,
               out_dir: str, device: str) -> None:
    """One rank of phase 14's two-rank gloo world (both ranks on the
    parent's card, the backend named): (b) then (c)."""
    from etpnav_tpu_torch.parallel import mesh as M
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    M.init_distributed(address, world, rank, device=device, backend="gloo")
    inp = torch.load(in_path, map_location="cpu", weights_only=False,
                     mmap=True)
    counters = dist_counters(device)
    out = {"dp2": _dist_dp2(M.make_mesh(2, 1), inp, device, counters)}
    out["mp2"] = _dist_mp2(M.make_mesh(1, 2), inp, device, counters)
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    M.barrier()
    M.shutdown()


def check_head_base_bits(card: str, device: str = "cuda") -> dict:
    """K-ATT's dropout bits at head base 6 of 12, read off the kernel: with
    q = k = 0 every probability is 1 / Lk, and with v the identity over
    Lk = hd = 64 keys, out[b, h, q, d] is nonzero iff key d of row q is
    kept. They must equal the global mask's slice, bit for bit."""
    from etpnav_tpu_torch.ops import fused_attention as fa
    B, Hl, Lq, L = 4, 6, 40, 64
    so = torch.tensor([0x2468ACE013579BDF, 0x0F0F1234], dtype=torch.int64,
                      device=device)
    want = fa.dropout_keep_mask(so, B, 2 * Hl, Lq, L, 0.1)[:, HEAD_BASE:]
    res = {}
    for dt in (torch.float32, torch.bfloat16):
        q = torch.zeros(B, Hl, Lq, 64, dtype=dt, device=device)
        v = torch.eye(L, dtype=dt, device=device).expand(B, Hl, L, L)
        out = fa.attention_fwd(q, q[:, :, :1].expand(B, Hl, L, 64)
                               .contiguous(), v.contiguous(), None, 1.0,
                               0.1, so, head_base=HEAD_BASE,
                               heads_total=2 * Hl)
        got = out > 0
        plain = fa.dropout_keep_mask(so, B, Hl, Lq, L, 0.1,
                                     head_base=HEAD_BASE,
                                     heads_total=2 * Hl)
        if not (torch.equal(got, want) and torch.equal(plain, want)):
            raise AssertionError(f"head base {dt}: the kernel's dropout bits "
                                 "differ from the global mask's slice")
        res[str(dt).split(".")[-1]] = {"bits": int(want.numel()),
                                       "kept": int(want.sum())}
    log(f"14c K-ATT dropout bits at head base {HEAD_BASE} of "
        f"{2 * Hl}: equal to the global mask's slice {json.dumps(res)} "
        f"[{card}]")
    return res


def torchrun_train(card: str, yaml_path: str, ckdir: str, device: str,
                   backend: str) -> dict:
    """(d) `torchrun --nproc_per_node 2 -m etpnav_tpu_torch.run` with
    MESH dp 2 and the named backend; the whole process group is killed
    at DIST_LIMIT_S."""
    import signal
    cmd = [sys.executable, "-m", "torch.distributed.run",
           "--nproc_per_node", "2", "--master_port", str(free_port()),
           "-m", "etpnav_tpu_torch.run", "--exp-config", yaml_path,
           "--device", device, "--num-envs", str(TORCHRUN_ENVS),
           "--ckpt-dir", ckdir, "MESH.dp=2", f"MESH.backend={backend}"]
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            start_new_session=True,
                            cwd=os.path.dirname(os.path.abspath(__file__)))
    try:
        out, _ = proc.communicate(timeout=DIST_LIMIT_S)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise AssertionError(f"torchrun: still running after {DIST_LIMIT_S}"
                             " s; killed") from None
    secs = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"torchrun exited {proc.returncode}:\n"
                             f"{out[-4000:]}")
    done = [ln for ln in out.splitlines() if "train done:" in ln]
    if len(done) != 2:
        raise AssertionError(f"torchrun: {len(done)} ranks finished:\n"
                             f"{out[-4000:]}")
    ckpts = sorted(os.listdir(ckdir))
    log(f"14d torchrun --nproc_per_node 2 (MESH dp 2, {backend}, "
        f"{device}): {TORCHRUN_ITERS} iterations in {secs:.1f} s, "
        f"checkpoints {ckpts}; " + "; ".join(d.split("INFO:")[-1].strip()
                                             for d in done) + f" [{card}]")
    return {"seconds": secs, "checkpoints": ckpts}


def read_video(path: str) -> dict:
    """Frames of a written episode video: an mp4 through cv2.VideoCapture,
    or the PNG directory written where cv2 has no mp4 codec."""
    import cv2
    if os.path.isdir(path):
        frames = [cv2.imread(os.path.join(path, f))
                  for f in sorted(os.listdir(path))]
        kind = "png"
    else:
        cap = cv2.VideoCapture(path)
        frames = []
        ok, f = cap.read()
        while ok:
            frames.append(f)
            ok, f = cap.read()
        cap.release()
        kind = "mp4"
    if not frames or any(f is None or f.ndim != 3 for f in frames):
        raise AssertionError(f"video {path}: no readable frames")
    return {"kind": kind, "frames": len(frames),
            "shape": list(frames[0].shape)}


def dist_phase(card: str, cfg, host_params, rec, counters, tmp: str,
               device: str = "cuda", base: str = "r2r") -> dict:
    """Phase 14 at r2r_config() width: (b) dp 2 and (c) mp 2 in one
    two-rank gloo world on this card, against this process's one-process
    references; the head base read off the kernel; (d) the runner under
    torchrun, then eval with videos; (a) a one-rank NCCL world. `base`
    is the YAML preset of (d) (`tiny` to rehearse on the CPU)."""
    from etpnav_tpu_torch.config_yaml import config_from_dict
    from etpnav_tpu_torch.models.planner import PlannerParams
    from etpnav_tpu_torch.parallel import mesh as M
    from etpnav_tpu_torch.run import run_config
    from etpnav_tpu_torch.training import finetune as ft
    from etpnav_tpu_torch.training.pretrain import pretrain_shapes
    t14 = time.perf_counter()
    cfg32 = dataclasses.replace(cfg, planner=dataclasses.replace(
        cfg.planner, use_bf16=False))
    shapes = pretrain_shapes(cfg32)
    in_path = os.path.join(tmp, "in.pt")
    torch.save({"cfg": cfg32, "cfg_mp": cfg, "agent": host_params.state_dict(),
                "rec": rec, "shapes": shapes}, in_path)
    spawn_ranks(dist_child, 2, (in_path, tmp, device), DIST_LIMIT_S,
                threads=4)
    world_s = time.perf_counter() - t14
    ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                        weights_only=False) for r in range(2)]

    def planner0(pcfg=cfg32.planner):
        p = PlannerParams(pcfg)
        p.load_state_dict({k[len("planner."):]: v for k, v
                           in host_params.state_dict().items()
                           if k.startswith("planner.")})
        return p.to(device)

    # (b) against one process learning on all 8
    planner = planner0()
    opt = ft.make_il_optimizer(cfg32, planner)
    whole = ft.bucket_record(rec, cfg32.il)
    loss1 = float(ft.learn_step(planner, opt, cfg32,
                                ft.record_to_batch(whole, device)))
    dp = [r["dp2"] for r in ranks]
    per_step = {"attention_fwd": LEARN_ATTENTIONS,
                "attention_bwd": LEARN_ATTENTIONS}
    for r, d in enumerate(dp):
        if abs(d["loss"] - loss1) > LEARN_REL_TOL * abs(loss1):
            raise AssertionError(f"dp 2 rank {r}: loss {d['loss']} != one "
                                 f"process {loss1}")
        if {k: v for k, v in d["counts"].items() if v} != per_step:
            raise AssertionError(f"dp 2 rank {r}: launches {d['counts']} "
                                 f"per step != {per_step}")
    worst = 0.0
    for name, p in planner.state_dict().items():
        err = float((dp[0]["planner"][name].to(device) - p).abs().max())
        worst = max(worst, err)
        if err > DIST_PARAM_ATOL:
            raise AssertionError(f"dp 2: {name} differs from one process "
                                 f"by {err}")
    tm = {k: statistics.median(v) for k, v in dp[0]["times_ms"].items()}
    log(f"14b dp 2 (two gloo ranks sharing one card): global loss "
        f"{dp[0]['loss']:.6f} vs one process {loss1:.6f}, valid steps per "
        f"rank {[d['valid'] for d in dp]}, bucket {dp[0]['bucket']}, "
        f"planner after AdamW worst |diff| {worst:.3g}; launches per rank "
        f"per step {[d['counts'] for d in dp]} [{card}]")
    log(f"14b learn-step p50 in turns A B B A ({DIST_TURN_STEPS} steps "
        f"each, fp32, B 4 per rank): dp 2 {tm['dp2']:.1f} ms (two ranks "
        f"sharing one card through gloo, not a scaling number), dp 1 "
        f"{tm['dp1']:.1f} ms (B 8, one process) [{card}]")
    del planner, opt

    # (c) against one process: the same seeds, so the same dropout draws
    mp = [r["mp2"] for r in ranks]
    for r, m in enumerate(mp):
        for task, got in m["pretrain"].items():
            check_bf16_step(f"mp 2 rank {r} {task}", got["loss"],
                            got["one_process_loss"], got["grad_rel_l2"],
                            got["one_bf16_grad_rel_l2"]["fp32"])
        for task, got in m["pretrain_fp32"].items():
            w = got["one_process_loss"]["fp32"]
            if (abs(got["loss"] - w) > LEARN_REL_TOL * abs(w)
                    or got["grad_rel_l2"]["fp32"] > LEARN_REL_TOL):
                raise AssertionError(f"mp 2 rank {r} {task} fp32: loss "
                                     f"{got['loss']} vs one process {w}, "
                                     f"gradients {got['grad_rel_l2']} "
                                     "from one process's (relative L2)")
        for sfx in ("", "_fp32"):
            for task, got in m["pretrain" + sfx].items():
                if {k: v for k, v in got["counts"].items() if v} != \
                        per_step:
                    raise AssertionError(f"mp 2 rank {r} {task}{sfx}: "
                                         f"launches {got['counts']} != "
                                         f"{per_step}")
            if m["pretrain_param_worst" + sfx] > DIST_PRETRAIN_ATOL:
                raise AssertionError(f"mp 2 rank {r}{sfx}: the state "
                                     "after two steps differs from one "
                                     "process's by "
                                     f"{m['pretrain_param_worst' + sfx]}")
    frec = mp[0]["finetune"]["rec"]
    if mp[1]["finetune"]["digest"] != record_digest(frec):
        raise AssertionError("mp 2: the peer learned on another record")
    floss = {}
    for name, c in (("bf16", cfg), ("fp32", cfg32)):
        planner = planner0(c.planner)
        gen = torch.Generator(device=device).manual_seed(1)
        floss[name] = float(ft.learn_step(
            planner, ft.make_il_optimizer(c, planner), c,
            ft.record_to_batch(ft.bucket_record(frec, c.il), device), gen))
    for r, m in enumerate(mp):
        check_bf16_step(f"mp 2 rank {r} fine-tune", m["finetune"]["loss"],
                        floss)
        if m["finetune"]["counts"]["attention_bwd"] != LEARN_ATTENTIONS:
            raise AssertionError(f"mp 2 rank {r} fine-tune: "
                                 f"{m['finetune']['counts']}")
    heads = {k: mp[1][k] for k in ("attention_fwd", "attention_bwd",
                                   "attention_fwd_fp32",
                                   "attention_bwd_fp32")}
    for k, h in heads.items():
        if h["tol_share"] > 1.0:
            raise AssertionError(f"mp 2 {k} at head base: {h}")
    pre = [{f"{t}{sfx}": {k: v for k, v in d.items() if k != "counts"}
            for sfx in ("", "_fp32") for t, d in m["pretrain" + sfx].items()}
           for m in mp]
    log(f"14c mp 2 (two gloo ranks sharing one card, vocab "
        f"{cfg.planner.vocab_size} split in two, dropout on, bf16 planner"
        f" and fp32): pretrain steps against one process stepping beside "
        f"each rank {json.dumps(pre)}; state after both steps worst |diff| "
        f"bf16 {[m['pretrain_param_worst'] for m in mp]}, fp32 "
        f"{[m['pretrain_param_worst_fp32'] for m in mp]}; fine-tune (bf16) "
        f"loss {[m['finetune']['loss'] for m in mp]} vs one process on the "
        f"broadcast record {json.dumps(floss)}; replicated tensors bit-equal on "
        f"both ranks ({mp[1]['pretrain_replicated']} pretrain bf16, "
        f"{mp[1]['pretrain_replicated_fp32']} fp32, "
        f"{mp[1]['finetune']['replicated']} fine-tune); launches per step "
        f"{[[m['pretrain'][t]['counts'] for t in m['pretrain']] for m in mp]}"
        f", fine-tune {[m['finetune']['counts'] for m in mp]}; captured at "
        f"mp rank 1's head base: {json.dumps(heads)} [{card}]")
    bits = check_head_base_bits(card, device)

    # (d) the runner under torchrun, then eval with videos on one process
    yaml_path = os.path.join(tmp, "dist.yaml")
    with open(yaml_path, "w") as f:
        f.write(f"BASE: {base}\nIL: {{iters: {TORCHRUN_ITERS}, log_every: "
                f"{TORCHRUN_ITERS}, batch_size: {TORCHRUN_ENVS}}}\n")
    ckdir = os.path.join(tmp, "ck")
    tr_res = torchrun_train(card, yaml_path, ckdir, f"{device}:0"
                            if device == "cuda" else device, "gloo")
    vdir = os.path.join(tmp, "video")
    vcfg = config_from_dict({"BASE": base, "VIDEO_DIR": vdir})
    for c in counters.values():
        c.reset()
    t0 = time.perf_counter()
    stats = run_config(vcfg, run_type="eval", video=True, device=device,
                       ckpt=os.path.join(ckdir, f"ckpt_iter"
                                         f"{TORCHRUN_ITERS}.pt"),
                       episode_count=VIDEO_EPISODES,
                       num_envs=VIDEO_EPISODES)
    sync()
    vcounts = {k: c.value for k, c in counters.items() if c.value}
    vsecs = time.perf_counter() - t0
    if not (vcounts.get("attention_fwd") and vcounts.get(
            "heatmap_nms_fused")) or any(k.endswith("plain")
                                         for k in vcounts):
        raise AssertionError(f"eval --video: launches {vcounts}")
    files = sorted(os.listdir(vdir))
    if len(files) != stats["n_episodes"] or not files:
        raise AssertionError(f"eval --video: {files} for {stats}")
    videos = {f: read_video(os.path.join(vdir, f)) for f in files}
    log(f"14d eval --video ({VIDEO_EPISODES} episodes, one process) in "
        f"{vsecs:.1f} s: wrote {json.dumps(videos)} "
        f"({'mp4 through cv2.VideoCapture' if all(v['kind'] == 'mp4' for v in videos.values()) else 'a PNG directory'});"
        f" launches {vcounts}; SPL {stats['spl']:.4f} [{card}]")

    # (a) a one-rank NCCL world
    nccl = None
    if device == "cuda":
        import torch.distributed as dist
        M.init_distributed(f"localhost:{free_port()}", 1, 0,
                           device="cuda:0")
        try:
            t = torch.arange(4.0, device="cuda")
            dist.all_reduce(t)
            nccl = {"backend": dist.get_backend(),
                    "all_reduce": t.tolist(),
                    "sync_max": M.sync_max((3, 5)),
                    "all_gather_object": M.all_gather_object({"rank": 0})}
        finally:
            M.shutdown()
        if (nccl["backend"] != "nccl" or nccl["sync_max"] != [3, 5]
                or nccl["all_gather_object"] != [{"rank": 0}]):
            raise AssertionError(f"nccl one-rank world: {nccl}")
        log(f"14a one-rank NCCL world on cuda:0: {json.dumps(nccl)} "
            f"[{card}]")
    res = {"dp2": {"loss": dp[0]["loss"], "one_process_loss": loss1,
                   "counts_per_rank_step": [d["counts"] for d in dp],
                   "p50_ms": tm, "param_worst_abs_diff": worst},
           "mp2": {"pretrain": [m["pretrain"] for m in mp],
                   "pretrain_fp32": [m["pretrain_fp32"] for m in mp],
                   "pretrain_param_worst": [m["pretrain_param_worst"]
                                            for m in mp],
                   "pretrain_param_worst_fp32": [
                       m["pretrain_param_worst_fp32"] for m in mp],
                   "finetune_loss": [m["finetune"]["loss"] for m in mp],
                   "finetune_one_process": floss,
                   "finetune_counts": [m["finetune"]["counts"] for m in mp],
                   "head_base": heads},
           "bits": bits, "torchrun": tr_res, "videos": videos,
           "video_launches": vcounts, "nccl": nccl,
           "world_s": world_s, "seconds": time.perf_counter() - t14}
    log(f"phase 14: {json.dumps(res)} [{card}]")
    return res


TC_DESIGN = "tensor cores (mma.sync)"

# launches per call of each served program: K-ATT 16 per perceive (11
# CLIP blocks, the cls row, 2 waypoint, 2 pano), 8 per navigation scoring
# (4 cross, 4 graph self), 9 per instruction; K-NMS 1 per perceive. The
# fused configuration moves CLIP blocks 1-11 to K-PRENORM and adds one
# K-GN per GroupNorm of the depth trunk.
PER_CALL = {
    "default": {"perceive": {"attention_fwd": 16, "heatmap_nms_fused": 1},
                "navigation": {"attention_fwd": 8},
                "text": {"attention_fwd": 9}},
    "fused": {"perceive": {"attention_fwd": 5, "heatmap_nms_fused": 1,
                           "group_norm_fused": 54, "prenorm_attention": 11},
              "navigation": {"attention_fwd": 8},
              "text": {"attention_fwd": 9}},
}


def check_counts(name: str, res: dict) -> None:
    """Every launch count of a serving run is exactly what its program
    calls make; plain versions and unlisted kernels count 0."""
    per = PER_CALL[name]
    calls = {"perceive": res["perceive_calls"],
             "navigation": res["navigation_calls"], "text": res["sessions"]}
    want = {k: sum(per[prog].get(k, 0) * n for prog, n in calls.items())
            for k in res["counts"]}
    if res["counts"] != want:
        raise AssertionError(f"slice {name}: launches {res['counts']} != "
                             f"{want} for {calls}")
    log(f"slice {name}: launch counts exact for {calls}")


def host_ms(fns: dict, rounds: int = 8) -> dict:
    """p50 / min ms of each synchronised call of `fns`, in turns (A B B
    A)."""
    times = {k: [] for k in fns}
    order = list(fns) + list(fns)[::-1]
    for _ in range(rounds):
        for k in order:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fns[k]()
            torch.cuda.synchronize()
            times[k].append((time.perf_counter() - t0) * 1e3)
    return {k: {"p50_ms": statistics.median(v), "min_ms": min(v),
                "n": len(v)} for k, v in times.items()}


def perceive_ab(card: str, cfgs: dict, params, rounds: int = 8) -> dict:
    """perceive at B = 8 (96 images) for each configuration, in turns
    (A B B A), the same observations; host clock around synchronised
    calls."""
    from etpnav_tpu_torch.training.agent import Agent
    agents = {k: Agent(c, params, device="cuda") for k, c in cfgs.items()}
    rng = np.random.default_rng(9)
    c = next(iter(cfgs.values()))
    H, Hd = c.clip.image_size, c.depth.input_size
    rgb = rng.integers(0, 256, (8, 12, H, H, 3), np.uint8)
    dep = rng.random((8, 12, Hd, Hd, 1), np.float32)
    for a in agents.values():
        a.perceive(rgb, dep)
    res = host_ms({k: functools.partial(a.perceive, rgb, dep)
                   for k, a in agents.items()}, rounds)
    log(f"perceive A/B (B=8, in turns): {json.dumps(res)} [{card}]")
    return res


# ---------------------------------------------------------------------------
# phase 4c: the depth trunk of Agent.perceive as CUDA graphs
# ---------------------------------------------------------------------------

def launch_calls(fn) -> dict:
    """The CUDA launch calls one call of fn makes, from torch.profiler's
    host-side runtime events: kernel launches (cudaLaunchKernel, its
    variants, cuLaunchKernel) and graph launches (cudaGraphLaunch)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {"kernel": 0, "graph": 0}
    for e in prof.key_averages():
        if "LaunchKernel" in e.key:
            out["kernel"] += e.count
        elif "GraphLaunch" in e.key:
            out["graph"] += e.count
    return out


def depth_graph_phase(card: str, cfg, host_params) -> dict:
    """Phase 4c: `Agent.perceive`'s depth trunk as CUDA graph replays, in
    the default and the fused configuration. At (96, Hd, Hd, 1) the
    capture's output and every replay equal the eager `encode_depth` bit
    for bit; after new weights are copied into the parameters in place,
    the replay equals eager with the new weights; (12, Hd, Hd, 1)
    captures a second graph; the agent's counters read every capture and
    replay; under `use_fused_gn` K-GN's launch counter rises by 54 per
    replay and by 54 at a capture (the warm-up's launches; the capture
    launches nothing). Then the agent's eager perceive (the path its gate
    takes under a generator, the tracer or the profiler: the trunk by
    graph) against the module's all-eager perceive: equal outputs, the
    launch calls of each (torch.profiler) and their times. The whole
    perceive's own graph is phase 4d's."""
    from etpnav_tpu_torch.models import depth_resnet
    from etpnav_tpu_torch.ops import fused_groupnorm
    from etpnav_tpu_torch.training import agent as agent_mod
    gn = fused_groupnorm.group_norm_launches
    params = copy.deepcopy(host_params)
    gen = torch.Generator().manual_seed(17)
    H, Hd = cfg.clip.image_size, cfg.depth.input_size
    rgb = torch.randint(0, 256, (8, 12, H, H, 3), generator=gen,
                        dtype=torch.uint8).cuda()
    dep = torch.rand(8, 12, Hd, Hd, 1, generator=gen).cuda()
    d96 = dep.reshape(96, Hd, Hd, 1)
    d12 = torch.rand(12, Hd, Hd, 1, generator=gen).cuda()
    res = {}
    for name, c in (("default", cfg), ("fused", fused_config(cfg))):
        agent = agent_mod.Agent(c, params, device="cuda")
        dtype = agent_mod._dtype(c)
        per_gn = PER_CALL[name]["perceive"].get("group_norm_fused", 0)

        @torch.inference_mode()
        def eager(d):
            return depth_resnet.encode_depth(agent.params.depth, c.depth, d,
                                             dtype=dtype)

        @torch.inference_mode()
        def graphed(d):
            return agent._depth_trunk(d)

        def expect(stats: dict, what: str) -> None:
            if agent.depth_graph_stats() != stats:
                raise AssertionError(f"depth graph {name} {what}: "
                                     f"{agent.depth_graph_stats()} != "
                                     f"{stats}")

        def same(got, want, what: str) -> None:
            if got.shape != want.shape or got.stride() != want.stride() \
                    or not torch.equal(got, want):
                raise AssertionError(f"depth graph {name} {what}: not bit "
                                     "equal to the eager trunk")

        want = eager(d96)
        n0 = gn.value
        outs = [graphed(d96)]
        sync()
        n1 = gn.value
        outs += [graphed(d96) for _ in range(3)]
        sync()
        n2 = gn.value
        expect({"depth_graph_replays": 3, "depth_eager_calls": 0,
                "depth_graph_captures": 1}, "at B = 96")
        for i, got in enumerate(outs):
            same(got, want, f"call {i} at B = 96")
        if (n1 - n0, n2 - n1) != (per_gn, 3 * per_gn):
            raise AssertionError(f"depth graph {name}: K-GN launches "
                                 f"{n1 - n0} at the capture, {n2 - n1} in "
                                 f"3 replays, want {per_gn}, {3 * per_gn}")
        with torch.no_grad():
            for t in agent.params.depth.parameters():
                t.mul_(torch.rand(t.shape, generator=gen).to(t) + 0.5)
        want_new = eager(d96)
        if torch.equal(want_new, want):
            raise AssertionError(f"depth graph {name}: new weights left "
                                 "the trunk's output as it was")
        same(graphed(d96), want_new, "after new weights in place")
        want12 = eager(d12)
        for i in range(2):
            same(graphed(d12), want12, f"call {i} at B = 12")
        expect({"depth_graph_replays": 5, "depth_eager_calls": 0,
                "depth_graph_captures": 2}, "after B = 12")

        # a whole perceive: the agent's eager one (trunk by graph)
        # against the module's (eager trunk), bit for bit, their launch
        # calls and times
        @torch.inference_mode()
        def eager_perceive():
            return agent_mod.perceive(agent.params, c, rgb, dep)

        agent_eager = eager_perceive_of(agent)

        def trunk_graph_perceive():
            return agent_eager(rgb, dep)

        got, ref = trunk_graph_perceive(), eager_perceive()
        for k in ref:
            if not torch.equal(got[k], ref[k]):
                raise AssertionError(f"depth graph {name}: perceive's {k} "
                                     "differs from the eager perceive")
        launches = {"perceive_eager": launch_calls(eager_perceive),
                    "perceive_trunk_graph": launch_calls(
                        trunk_graph_perceive),
                    "trunk_eager": launch_calls(lambda: eager(d96)),
                    "trunk_graph": launch_calls(lambda: graphed(d96))}
        if launches["trunk_graph"]["graph"] != 1 or \
                launches["perceive_trunk_graph"]["graph"] != 1:
            raise AssertionError(f"depth graph {name}: graph launches "
                                 f"{launches}")
        times = host_ms({"perceive_eager": eager_perceive,
                         "perceive_trunk_graph": trunk_graph_perceive,
                         "trunk_eager": lambda: eager(d96),
                         "trunk_graph": lambda: graphed(d96)})
        res[name] = {"launches": launches, "times": times,
                     "stats": agent.depth_graph_stats(),
                     "gn_per_replay": (n2 - n1) // 3}
        log(f"depth graph {name}: {json.dumps(res[name])} [{card}]")
        del agent, outs, got, ref
        torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------
# phase 4d: the whole Agent.perceive as one CUDA graph
# ---------------------------------------------------------------------------

def perceive_graph_phase(card: str, cfg, host_params, counters) -> dict:
    """Phase 4d: `Agent.perceive` (R2R width, B = 8, the default
    configuration) as the replay of one CUDA graph. The capture's output,
    three replays and a replay after new weights are copied into every
    parameter in place equal the agent's eager perceive on every output
    key, bit for bit (a key that is not: its largest difference logged,
    then raised); under torch.profiler, with the tracer on and with a
    generator the gate runs eagerly; the agent's counters are exact
    throughout. Then the port's launch counters per perceive, eager and
    replayed (equal: a replay counts what the capture recorded), the
    launch calls of each from torch.profiler, and the ms of each: 30
    calls between CUDA events on inputs already on the card, and the
    agent's call on host arrays in turns (A B B A)."""
    from etpnav_tpu_torch.training import agent as agent_mod
    from etpnav_tpu_torch.utils import logging as tracing
    params = copy.deepcopy(host_params)
    gen = torch.Generator().manual_seed(23)
    H, Hd = cfg.clip.image_size, cfg.depth.input_size
    rgb = torch.randint(0, 256, (8, 12, H, H, 3), generator=gen,
                        dtype=torch.uint8).cuda()
    dep = torch.rand(8, 12, Hd, Hd, 1, generator=gen).cuda()
    agent = agent_mod.Agent(cfg, params, device="cuda")
    eager = eager_perceive_of(agent)
    calls = collections.Counter()

    def expect(what: str) -> None:
        got = {**agent.perceive_graph_stats(), **agent.depth_graph_stats()}
        want = {"perceive_graph_replays": calls["replay"],
                "perceive_eager_calls": calls["eager"],
                "perceive_graph_captures": 1,
                # the first eager call captured the trunk's graph; the
                # capture's warm-up run replayed it, the capture itself
                # ran the trunk eagerly into the perceive graph
                "depth_graph_replays": calls["eager"],
                "depth_eager_calls": 1, "depth_graph_captures": 1}
        if got != want:
            raise AssertionError(f"perceive graph {what}: counters {got} != "
                                 f"{want}")

    def same(got: dict, want: dict, what: str) -> None:
        diff = {}
        for k in want:
            a, b = got[k], want[k]
            if (a.shape != b.shape or a.dtype != b.dtype
                    or not torch.equal(a, b)):
                diff[k] = ((a.double() - b.double()).abs().max().item()
                           if a.shape == b.shape else "shape")
        if list(got) != list(want) or diff:
            log(f"perceive graph {what}: keys {list(got)}; largest "
                f"difference from eager per key {diff} [{card}]")
            raise AssertionError(f"perceive graph {what}: not bit equal to "
                                 f"the eager perceive on {sorted(diff)}")

    want = eager(rgb, dep)
    calls["eager"] += 1
    outs = [agent.perceive(rgb, dep)]                 # the capture
    outs += [agent.perceive(rgb, dep) for _ in range(3)]
    calls["replay"] += 3
    sync()
    expect("after the capture and 3 replays")
    for i, got in enumerate(outs):
        same(got, want, f"call {i}")
    with torch.no_grad():
        for t in agent.params.parameters():
            t.mul_(1.0 + 0.05 * torch.randn(t.shape, generator=gen).to(t))
    want_new = eager(rgb, dep)
    calls["eager"] += 1
    if torch.equal(want_new["pano_embeds"], want["pano_embeds"]):
        raise AssertionError("perceive graph: new weights left the pano "
                             "embeddings as they were")
    same(agent.perceive(rgb, dep), want_new, "after new weights in place")
    calls["replay"] += 1
    # the gate: each of these runs eagerly
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]):
        same(agent.perceive(rgb, dep), want_new, "under the profiler")
    tracing.enable()
    try:
        same(agent.perceive(rgb, dep), want_new, "with the tracer on")
    finally:
        tracing.disable()
    agent.perceive(rgb, dep, torch.Generator(device="cuda").manual_seed(1))
    calls["eager"] += 3
    sync()
    expect("after the gate's three eager calls")

    def per_call(fn) -> dict:
        sync()
        before = {k: c.value for k, c in counters.items()}
        fn()
        sync()
        return {k: c.value - before[k] for k, c in counters.items()
                if c.value != before[k]}

    @torch.inference_mode()
    def replay():
        return agent._perceive_graphs(rgb, dep)

    port = {"eager": per_call(lambda: eager(rgb, dep)),
            "replay": per_call(replay)}
    want_port = PER_CALL["default"]["perceive"]
    if port["eager"] != want_port or port["replay"] != want_port:
        raise AssertionError(f"perceive graph: the port's launches per call "
                             f"{port}, want {want_port} each")
    launches = {"eager": launch_calls(lambda: eager(rgb, dep)),
                "replay": launch_calls(replay)}
    if launches["replay"] != {"kernel": 0, "graph": 1}:
        raise AssertionError(f"perceive graph: a replay's launch calls "
                             f"{launches['replay']}")
    ms = {"eager": cuda_ms(lambda: eager(rgb, dep), iters=30, warmup=3),
          "replay": cuda_ms(replay, iters=30, warmup=3)}
    rgb_h, dep_h = rgb.cpu().numpy(), dep.cpu().numpy()
    turns = host_ms({"eager": lambda: eager(rgb_h, dep_h),
                     "replay": lambda: agent.perceive(rgb_h, dep_h)})
    res = {"port_launches": port, "launch_calls": launches,
           "cuda_event_ms": ms, "host_ms_in_turns": turns,
           "stats": {**agent.perceive_graph_stats(),
                     **agent.depth_graph_stats()}}
    log(f"perceive graph: replays bit-equal to eager on every key; "
        f"{json.dumps(res)} [{card}]")
    del agent, outs, want, want_new
    torch.cuda.empty_cache()
    return res


def launch_counters() -> dict:
    """The port's launch and plain-call counters, by kernel name."""
    from etpnav_tpu_torch.ops import (
        fused_attention,
        fused_block,
        fused_groupnorm,
        fused_nms,
        fused_prenorm,
    )
    return {"attention_fwd": fused_attention.attention_fwd_launches,
            "attention_plain": fused_attention.attention_plain_calls,
            "heatmap_nms_fused": fused_nms.heatmap_nms_launches,
            "heatmap_nms_plain": fused_nms.heatmap_nms_plain_calls,
            "group_norm_fused": fused_groupnorm.group_norm_launches,
            "group_norm_plain": fused_groupnorm.group_norm_plain_calls,
            "prenorm_attention":
                fused_prenorm.prenorm_attention_launches,
            "prenorm_attention_plain":
                fused_prenorm.prenorm_attention_plain_calls,
            "attention_bwd": fused_attention.attention_bwd_launches,
            "attention_bwd_plain":
                fused_attention.attention_bwd_plain_calls,
            "attention_fwd_head_out":
                fused_attention.attention_fwd_head_out_launches,
            "attention_cheap": fused_attention.attention_cheap_launches,
            "attention_cheap_plain":
                fused_attention.attention_cheap_plain_calls,
            "attention_block": fused_block.attention_block_launches,
            "attention_block_plain":
                fused_block.attention_block_plain_calls}


T0 = time.perf_counter()


# ---------------------------------------------------------------------------
# phase 3e: DeepSeek-V2's encoder kernels
# ---------------------------------------------------------------------------

def moe_case(dev, T: int = 200, D: int = 2048, I: int = 1408,
             n_experts: int = 64, held: int = 16, k: int = 6,
             seed: int = 11) -> dict:
    """One expert layer's K-MOE operands at DeepSeek-V2-Lite's widths:
    the T*k routings of random router scores, sorted by held expert as
    `dsv2_text.moe` sorts them, and bf16 weights of the held experts."""
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(T, D, generator=g, device=dev).bfloat16()
    scores = torch.rand(T, n_experts, generator=g, device=dev).softmax(-1)
    tw, ti = torch.topk(scores, k, dim=-1, sorted=False)
    lut = torch.full((n_experts,), held, dtype=torch.long, device=dev)
    lut[:held] = torch.arange(held, device=dev)
    local = lut[ti].reshape(-1)
    order = torch.argsort(local, stable=True)
    cnt = torch.bincount(local, minlength=held + 1)
    offsets = torch.cat([cnt.new_zeros(1), cnt[:held].cumsum(0)]).to(
        torch.int32)
    return {"x": x[order // k].contiguous(), "offsets": offsets,
            "row_w": tw.reshape(-1)[order].contiguous(),
            "dest": order.to(torch.int32), "n_dest": T * k,
            "w_gu": (torch.randn(held, 2 * I, D, generator=g, device=dev)
                     * 0.02).bfloat16(),
            "w_d": (torch.randn(held, D, I, generator=g, device=dev)
                    * 0.02).bfloat16(),
            "rows": int(cnt[:held].sum()),
            "groups": int((cnt[:held] > 0).sum())}


def moe_work(c: dict, gate_up: bool) -> tuple:
    """(bytes, FLOPs) of one K-MOE launch: each held expert with rows reads
    its weights once, the rows are read and the outputs written once."""
    held, n, K = (c["w_gu"].shape if gate_up else c["w_d"].shape)
    rows, groups = c["rows"], c["groups"]
    nbytes = groups * n * K * 2 + rows * K * 2 + rows * (
        n // 2 * 2 if gate_up else n * 4)
    return nbytes, 2.0 * rows * n * K


def grouped_mm_ms(a, w, offsets):
    """kernel_ms of `torch._grouped_mm` over the same groups, or None
    where this PyTorch lacks it or refuses the shapes (a yardstick the
    port never calls)."""
    fn = getattr(torch, "_grouped_mm", None)
    if fn is None:
        return None
    b = w.transpose(1, 2)                      # (E, K, N)
    offs = offsets[1:].contiguous()
    R = int(offsets[-1])
    try:
        fn(a[:R], b, offs=offs)
        torch.cuda.synchronize()
        return kernel_ms(lambda: fn(a[:R], b, offs=offs))
    except (RuntimeError, TypeError, ValueError) as e:
        log(f"torch._grouped_mm refused: {str(e)[:200]}")
        return None


def dsv2_phase(card: str) -> dict:
    """Phase 3e (see the module docstring)."""
    from etpnav_tpu_torch.ops import moe_gemm
    from etpnav_tpu_torch.ops.fused_attention import attention_fwd
    dev = torch.device("cuda")
    rows = {}
    # K-ATT at MLA's width: q, k (1, 16, 200, 192), v zero-padded from
    # 128, a causal bias
    g = torch.Generator(device=dev).manual_seed(12)
    L, H = 200, 16

    def natural(hd):
        return torch.randn(1, L, H, hd, generator=g, device=dev)

    q, k = natural(192), natural(192)
    v = torch.nn.functional.pad(natural(128), (0, 64))
    causal = torch.full((L, L), float("-inf"), device=dev).triu(1)[None]
    rows["katt_192"] = attention_row(
        card, "mla_causal_200", q.transpose(1, 2), k.transpose(1, 2),
        v.transpose(1, 2), causal, torch.bfloat16)
    out = attention_fwd(q.transpose(1, 2).bfloat16(),
                        k.transpose(1, 2).bfloat16(),
                        v.transpose(1, 2).bfloat16(), causal, 0.1147)
    if out[..., 128:].abs().max().item() != 0.0:
        raise AssertionError("K-ATT 192: the zero-padded v gave nonzero "
                             "output columns")
    # K-MOE
    c = moe_case(dev)
    n0 = (moe_gemm.moe_gate_up_launches.value,
          moe_gemm.moe_down_launches.value)
    h = moe_gemm.moe_gate_up(c["x"], c["w_gu"], c["offsets"])
    h_want = moe_gemm.moe_gate_up_plain(c["x"], c["w_gu"], c["offsets"])
    y = moe_gemm.moe_down(h_want, c["w_d"], c["offsets"], c["row_w"],
                          c["dest"], c["n_dest"])
    y_want = moe_gemm.moe_down_plain(h_want, c["w_d"], c["offsets"],
                                     c["row_w"], c["dest"], c["n_dest"])
    torch.cuda.synchronize()
    R = c["rows"]
    err_h = (h[:R].float() - h_want[:R].float()).abs().max().item()
    tol_h = bf16_tol(h_want[:R])
    err_y = (y - y_want).abs().max().item()
    tol_y = 1e-4 * y_want.abs().max().item()
    if err_h > tol_h or err_y > tol_y or not torch.isfinite(y).all():
        raise AssertionError(f"K-MOE: gate/up err {err_h} (tol {tol_h}), "
                             f"down err {err_y} (tol {tol_y})")
    if y[torch.tensor(sorted(set(range(c["n_dest"]))
                             - set(c["dest"][:R].tolist())),
                      dtype=torch.long, device=dev)].abs().max() != 0:
        raise AssertionError("K-MOE down: a routing to another card's "
                             "expert got a nonzero row")
    if (moe_gemm.moe_gate_up_launches.value - n0[0],
            moe_gemm.moe_down_launches.value - n0[1]) != (1, 1):
        raise AssertionError("K-MOE: launch counters")
    off = c["offsets"].tolist()

    def cublas_loop(a, w):
        for e in range(len(off) - 1):
            if off[e + 1] > off[e]:
                torch.mm(a[off[e]:off[e + 1]], w[e].t())
    for name, gate_up in (("moe_gate_up", True), ("moe_down", False)):
        if gate_up:
            def run():
                return moe_gemm.moe_gate_up(c["x"], c["w_gu"], c["offsets"])

            def plain():
                return moe_gemm.moe_gate_up_plain(c["x"], c["w_gu"],
                                                  c["offsets"])
            a, w = c["x"], c["w_gu"]
        else:
            def run():
                return moe_gemm.moe_down(h_want, c["w_d"], c["offsets"],
                                         c["row_w"], c["dest"], c["n_dest"])

            def plain():
                return moe_gemm.moe_down_plain(h_want, c["w_d"], c["offsets"],
                                               c["row_w"], c["dest"],
                                               c["n_dest"])
            a, w = h_want, c["w_d"]
        nbytes, flops = moe_work(c, gate_up)
        b_ms, b_by = bound_ms(nbytes, flops, torch.bfloat16)
        ms, k_ms = cuda_ms(run, iters=20), kernel_ms(run)
        plain_ms = cuda_ms(plain, iters=3, warmup=1)
        loop_ms = kernel_ms(lambda: cublas_loop(a, w))
        gmm_ms = grouped_mm_ms(a, w, c["offsets"])
        rows[name] = {"rows": R, "groups": c["groups"], "ms": ms,
                      "kernel_ms": k_ms, "plain_ms": plain_ms,
                      "cublas_loop_kernel_ms": loop_ms,
                      "grouped_mm_kernel_ms": gmm_ms, "bound_ms": b_ms,
                      "bound_by": b_by, "roofline": b_ms / k_ms,
                      "max_abs_err": err_h if gate_up else err_y}
        log(f"K-MOE {name}: {R} rows over {c['groups']} experts, "
            f"w {tuple(w.shape)} err={rows[name]['max_abs_err']:.3g} "
            f"ms={ms:.4f} kernel_ms={k_ms:.4f} plain_ms={plain_ms:.4f} "
            f"cublas_loop_kernel_ms={loop_ms:.4f} grouped_mm_kernel_ms="
            f"{gmm_ms} bound_ms={b_ms:.4f} ({b_by}, "
            f"{100 * b_ms / k_ms:.1f}% of it) [{card}]")
    rows["encoder_3_layers"] = dsv2_encoder_parity(card)
    return rows


def dsv2_encoder_parity(card: str) -> dict:
    """The encoder at DeepSeek-V2-Lite's widths and 3 layers (the dense
    one and two expert layers, 16 of 64 experts held), seeded random
    weights: the card's bf16 text memory of a 200-token instruction
    against the fp32 plain versions on the CPU (relative L2 over the
    valid tokens; bf16 through three layers reads ~1e-2); the agent's
    replay of the encoder's CUDA graph against its eager run (the
    tracer's path), and the time of an encode by each."""
    from etpnav_tpu_torch.config import rxr_dsv2lite_config
    from etpnav_tpu_torch.models import dsv2_text
    from etpnav_tpu_torch.ops import moe_gemm
    from etpnav_tpu_torch.training.agent import Agent, init_agent_params
    from etpnav_tpu_torch.utils import logging as tracing
    cfg = rxr_dsv2lite_config()
    cfg = dataclasses.replace(cfg, text_llm=dataclasses.replace(
        cfg.text_llm, num_layers=3))
    cfg32 = dataclasses.replace(cfg, planner=dataclasses.replace(
        cfg.planner, use_bf16=False))
    params = init_agent_params(cfg, seed=3)
    rng = np.random.default_rng(3)
    ids = np.zeros((1, 200), np.int64)
    ids[0, :150] = rng.integers(1, 102400, 150)
    mask = ids != 0
    want = dsv2_text.encode(params.text_llm, cfg32, torch.from_numpy(ids),
                            torch.from_numpy(mask))
    agent = Agent(cfg, params, device="cuda")
    n0 = moe_gemm.moe_gate_up_launches.value
    got = agent.encode_text(ids, mask).cpu()      # captures the graph
    torch.cuda.synchronize()
    m = torch.from_numpy(mask[0])
    rel = ((got[0][m] - want[0][m]).norm() / want[0][m].norm()).item()
    launches = moe_gemm.moe_gate_up_launches.value - n0
    # the graph's replay against the eager encoder (the tracer's path)
    replay = agent.encode_text(ids, mask).cpu()
    tracing.enable()
    try:
        eager = agent.encode_text(ids, mask).cpu()
    finally:
        tracing.disable()
    graph_rel = ((replay - eager).norm() / eager.norm()).item()
    ms = cuda_ms(lambda: agent.encode_text(ids, mask), iters=10, warmup=2)
    x = torch.stack([torch.from_numpy(ids), torch.from_numpy(mask).long()]
                    ).cuda()
    with torch.inference_mode():
        eager_ms = cuda_ms(lambda: agent._encode_llm(x), iters=10, warmup=2)
    replays = agent._text_graphs.replays
    stats = agent.text_stats()
    log(f"DeepSeek-V2 encoder, 3 layers at published widths: bf16 card vs "
        f"fp32 CPU rel L2 {rel:.4g}; K-MOE gate/up launches {launches}; "
        f"graph replay vs eager rel L2 {graph_rel:.3g}; {ms:.2f} ms an "
        f"encode by graph, {eager_ms:.2f} ms eager ({replays} replays); "
        f"{stats} [{card}]")
    if launches != 2 or not rel < 0.05 or not graph_rel < 1e-3 \
            or replays < 13:
        raise AssertionError(f"encoder parity: rel {rel}, K-MOE launches "
                             f"{launches}, graph rel {graph_rel}, "
                             f"{replays} replays")
    del agent
    torch.cuda.empty_cache()
    return {"rel_l2": rel, "ms": ms, "eager_ms": eager_ms,
            "graph_rel_l2": graph_rel, "stats": stats}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run",
              file=sys.stderr)
        return 2
    from etpnav_tpu_torch.config import r2r_config, rxr_config
    from etpnav_tpu_torch.ops import cuda_build
    from etpnav_tpu_torch.training.agent import init_agent_params

    # phase 1
    n_cards = torch.cuda.device_count()
    if n_cards != 1:
        raise AssertionError(f"chip_smoke runs on one card; {n_cards} "
                             "are visible")
    card = card_line()
    log(f"env: python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}")
    log(f"card: {card}")
    import importlib.util
    log("packages: " + ", ".join(
        f"{m} {'yes' if importlib.util.find_spec(m) else 'no'}"
        for m in ("yaml", "transformers", "tensorboard")))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # phase 2 (with the test-only build of phase 3d beside it)
    trap_tmp = tempfile.TemporaryDirectory(prefix="etpnav_trap_")
    trap_build = start_trap_build(trap_tmp.name)
    secs = cuda_build.build_all()
    log(f"build: {len(cuda_build.SOURCES)} kernels in {secs:.2f} s")
    for name, rep in cuda_build.PTXAS_REPORTS.items():
        for line in rep.splitlines():
            if "registers" in line or "spill" in line:
                log(f"ptxas {name}: {line.strip()}")

    # phase 3
    cfg = r2r_config()
    att_rows = check_attention(card)
    check_misaligned_refused()
    drop_rows = check_attention_dropout(card)
    # phase 3c
    bwd_rows = check_attention_bwd(card)
    # the attention kernels at phase 12's and 13's shapes, measured here:
    # after phase 11, torch.profiler has handed back no kernel record at
    # all in some runs
    dag_rows = check_dagger_attention(card)
    ext_att = extract_attention_row(card)
    log(f"phase 3c done at {time.perf_counter() - T0:.0f} s")
    nms_rows = check_nms(card)
    gn_calls = trace_gn_calls(cfg, batch=8 * 12)
    log(f"K-GN calls of one fused trunk pass at B=96: "
        f"{sum(gn_calls.values())} over {len(gn_calls)} shapes")
    if sum(gn_calls.values()) != PER_CALL["fused"]["perceive"][
            "group_norm_fused"]:
        raise AssertionError(f"K-GN: {sum(gn_calls.values())} calls per "
                             "trunk pass")
    gn_rows = check_group_norm(card, gn_calls)
    check_round_bf16(card)
    pre_rows = check_prenorm(card, cfg)
    gemm_rows = check_gemm(card)
    # phase 3e
    dsv2_rows = dsv2_phase(card)
    # phase 3d
    trap = check_barrier_trap(card, trap_build)
    trap_tmp.cleanup()

    counters = launch_counters()
    log(f"phase 3 done at {time.perf_counter() - T0:.0f} s")
    # phase 4
    t0 = time.perf_counter()
    params = init_agent_params(cfg, seed=0)
    log(f"slice: random R2R weights in {time.perf_counter() - t0:.1f} s")
    host_params = copy.deepcopy(params)
    res = serve(card, cfg, params, counters)
    check_counts("default", res)
    # phase 4b
    fcfg = fused_config(cfg)
    res_f = serve(card, fcfg, params, counters)
    check_counts("fused", res_f)
    ab = perceive_ab(card, {"default": cfg, "fused": fcfg}, params)
    del params
    torch.cuda.empty_cache()
    log(f"phase 4b done at {time.perf_counter() - T0:.0f} s")
    # phase 4c
    depth_graph = depth_graph_phase(card, cfg, host_params)
    log(f"phase 4c done at {time.perf_counter() - T0:.0f} s")
    # phase 4d
    perceive_graph = perceive_graph_phase(card, cfg, host_params, counters)
    log(f"phase 4d done at {time.perf_counter() - T0:.0f} s")
    # phase 5
    cfg32 = r2r_config(planner=dataclasses.replace(cfg.planner,
                                                  use_bf16=False))
    slice_parity(card, cfg32, host_params, counters)
    # phase 5b
    par_f = slice_parity(card, fused_config(cfg32), host_params, counters)
    got = {k: par_f["launches_per_call"][k]["perceive"] for k in counters}
    want = {k: PER_CALL["fused"]["perceive"].get(k, 0) for k in counters}
    if got != want:
        raise AssertionError(f"parity fused: perceive launches {got} != "
                             f"{want}")
    log(f"phase 5b done at {time.perf_counter() - T0:.0f} s")
    # phase 7
    train_res, trainer, rec = train_phase(card, cfg, counters)
    log(f"phase 7 done at {time.perf_counter() - T0:.0f} s")
    # phase 7b
    learn_par = learn_parity(card, cfg, cfg32, trainer, rec, counters)
    del trainer
    torch.cuda.empty_cache()
    log(f"phase 7b done at {time.perf_counter() - T0:.0f} s")
    # phase 8
    with torch.inference_mode():
        block_rows, block_counts = check_block(
            card, cfg, host_params.planner.to("cuda"), counters)
    log(f"phase 8 done at {time.perf_counter() - T0:.0f} s")
    # phase 8b
    tool_res = run_tools(card, counters)
    t12_rows = check_head_out_and_cheap(card)
    log(f"phase 8b done at {time.perf_counter() - T0:.0f} s")
    # phase 9
    runner = runner_phase(card, cfg, host_params.cpu(), counters)
    run_launches = runner["launches"]
    log(f"phase 9 done at {time.perf_counter() - T0:.0f} s")
    # phase 10
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="etpnav_pretrain_") as tmp:
        pt_res = pretrain_phase(card, cfg, counters, tmp)
    torch.cuda.empty_cache()
    pt_rows = check_pretrain_attention(card, cfg)
    check_bwd_key_limits(card, {"r2r": cfg, "rxr": rxr_config()})
    log(f"phase 10 done at {time.perf_counter() - T0:.0f} s")
    # phase 11
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="etpnav_feed_") as tmp:
        feed = feed_phase(card, cfg, host_params, counters, tmp)
    torch.cuda.empty_cache()
    log(f"phase 11 done at {time.perf_counter() - T0:.0f} s")
    # phase 12
    with tempfile.TemporaryDirectory(prefix="etpnav_dagger_") as tmp:
        dag = dagger_phase(card, counters, tmp)
    torch.cuda.empty_cache()
    log(f"phase 12 done at {time.perf_counter() - T0:.0f} s")
    # phase 13
    t13 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="etpnav_demo_") as tmp:
        demo = demo_phase(card, counters, tmp)
    ext_rows = extract_phase(card, copy.deepcopy(host_params), counters)
    demo["seconds"] = time.perf_counter() - t13
    log(f"phase 13 done at {time.perf_counter() - T0:.0f} s")
    # phase 14
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="etpnav_dist_") as tmp:
        dist = dist_phase(card, cfg, host_params, rec, counters, tmp)
    log(f"phase 14 done at {time.perf_counter() - T0:.0f} s")

    # phase 6
    a = att_rows["clip_natural/bfloat16"]
    n = nms_rows["B8"]
    gn_bf16 = {k: r for k, r in gn_rows.items() if k.endswith("bfloat16")}
    gn_key = max(gn_bf16, key=lambda k: gn_bf16[k]["bound_ms"])
    g = gn_bf16[gn_key]
    p = pre_rows["bfloat16"]
    bw = bwd_rows["graph_g96/bfloat16/p0.1/dbias"]
    kb = block_rows["text0/bfloat16"]
    t1 = t12_rows["head_out/bfloat16"]
    t2 = t12_rows["cheap/bfloat16"]
    demo_l = collections.Counter()
    for sess in ("session1", "session2"):
        demo_l.update(demo[sess]["launches"])
    wvc_l = demo["warm_vs_cold"]["launches"]

    def ext_l(name):
        return {cfg_name: ext_rows[f"{cfg_name}/bfloat16"][
            "launches_per_call"][name] for cfg_name in ("default", "fused")}
    kernels = [
        {"name": "attention_fwd", "route": "cuda",
         "launches_runner": run_launches.get("attention_fwd", 0),
         "launches_pretrain": pt_res["launches"].get("attention_fwd", 0),
         "launches_feed": feed["launches"].get("attention_fwd", 0),
         "launches_dagger": dag["launches"].get("attention_fwd", 0),
         "dagger_shapes": {k: r["fwd"] for k, r in dag_rows.items()},
         "launches_demo": demo_l["attention_fwd"],
         "launches_warm_vs_cold": wvc_l["attention_fwd"],
         "launches_extract_per_call": ext_l("attention_fwd"),
         "launches_dp2_per_rank_step": [
             c["attention_fwd"] for c in dist["dp2"][
                 "counts_per_rank_step"]],
         "launches_mp2_per_rank_step": [
             {t: m[t]["counts"]["attention_fwd"] for t in m}
             for m in dist["mp2"]["pretrain"]],
         "launches_video_eval": dist["video_launches"].get(
             "attention_fwd", 0),
         "head_base": {"captured_mp2_rank1": dist["mp2"]["head_base"][
             "attention_fwd"], "dropout_bits": dist["bits"]},
         "extract_shape": ext_att,
         "source": "etpnav_tpu_torch/csrc/attention.cu",
         "replaces": "etpnav_tpu/ops/pallas_attention.py:211 "
                     "fused_attention_nhd; :123 fused_attention; "
                     ":293 fused_attention_xbatch; "
                     ":340 fused_bias_attention (forward)",
         "launches": res["counts"]["attention_fwd"],
         "max_abs_err": max(r["max_abs_err"] for r in att_rows.values()),
         "ms": a["ms"], "plain_ms": a["plain_ms"], "bound_ms": a["bound_ms"],
         "bound_by": a["bound_by"], "library_ms": a["library_ms"],
         "at": "clip_natural bf16 q/k/v (96,12,50,64)",
         "design": TC_DESIGN, "kernel_ms": a["kernel_ms"],
         "library_kernel_ms": a["library_kernel_ms"]},
        {"name": "heatmap_nms_fused", "route": "cuda",
         "launches_runner": run_launches.get("heatmap_nms_fused", 0),
         "launches_feed": feed["launches"].get("heatmap_nms_fused", 0),
         "launches_dagger": dag["launches"].get("heatmap_nms_fused", 0),
         "launches_demo": demo_l["heatmap_nms_fused"],
         "launches_warm_vs_cold": wvc_l["heatmap_nms_fused"],
         "launches_video_eval": dist["video_launches"].get(
             "heatmap_nms_fused", 0),
         "source": "etpnav_tpu_torch/csrc/heatmap_nms.cu",
         "replaces": "etpnav_tpu/ops/pallas_nms.py:59 fused_heatmap_nms",
         "launches": res["counts"]["heatmap_nms_fused"],
         "max_abs_err": max(r["max_abs_err"] for r in nms_rows.values()),
         "ms": n["ms"], "plain_ms": n["plain_ms"], "bound_ms": n["bound_ms"],
         "bound_by": n["bound_by"], "library_ms": None,
         "at": "logits (8,120,12) fp32 -> map and 5 candidate slots; "
               "plain_ms is heatmap_nms_plain + extract_candidates",
         "kernel_ms": n["kernel_ms"],
         "floor_kernel_ms": n["floor_kernel_ms"],
         "perceive_ops": res["perceive_ops"],
         "perceive_ops_with_chain": res["perceive_ops_with_chain"]},
        {"name": "group_norm_fused", "route": "cuda",
         "launches_runner": run_launches.get("group_norm_fused", 0),
         "launches_extract_per_call": ext_l("group_norm_fused"),
         "source": "etpnav_tpu_torch/csrc/groupnorm.cu",
         "replaces": "etpnav_tpu/ops/pallas_groupnorm.py:57 "
                     "group_norm_fused",
         "launches": res_f["counts"]["group_norm_fused"],
         "max_abs_err": max(r["max_abs_err"] for r in gn_rows.values()),
         "ms": g["ms"], "plain_ms": g["plain_ms"],
         "bound_ms": g["bound_ms"], "bound_by": g["bound_by"],
         "library_ms": g["library_ms"],
         "at": f"{gn_key} at B=96 (the trunk's largest bound); library_ms "
               "is F.group_norm (GN only, no ReLU/residual)",
         "kernel_ms": g["kernel_ms"],
         "kernel_ms_per_perceive": sum(r["kernel_ms"] * r["per_perceive"]
                                       for r in gn_bf16.values()),
         "bound_ms_per_perceive": sum(r["bound_ms"] * r["per_perceive"]
                                      for r in gn_bf16.values()),
         "ms_per_perceive": sum(r["ms"] * r["per_perceive"]
                                for r in gn_bf16.values()),
         "plain_ms_per_perceive": sum(r["plain_ms"] * r["per_perceive"]
                                      for r in gn_bf16.values())},
        {"name": "prenorm_attention", "route": "cuda",
         "launches_runner": run_launches.get("prenorm_attention", 0),
         "launches_extract_per_call": ext_l("prenorm_attention"),
         "source": "etpnav_tpu_torch/csrc/prenorm_attention.cu",
         "replaces": "etpnav_tpu/ops/pallas_attention.py:559 "
                     "fused_prenorm_attention_v2; :456 "
                     "fused_prenorm_attention",
         "launches": res_f["counts"]["prenorm_attention"],
         "max_abs_err": max(r["max_abs_err"] for r in pre_rows.values()),
         "ms": p["ms"], "plain_ms": p["plain_ms"], "bound_ms": p["bound_ms"],
         "bound_by": p["bound_by"], "library_ms": None,
         "at": "x (96,50,768) bf16",
         "unfused_half_block_ms": p["unfused_half_block_ms"],
         "kernel_ms": p["kernel_ms"],
         "unfused_half_block_kernel_ms": p["unfused_half_block_kernel_ms"],
         "gemm_bf16": {k: {f: r[f] for f in ("kernel_ms", "matmul_kernel_ms",
                                             "ratio", "tflops")}
                       for k, r in gemm_rows.items() if k != "soak"},
         "gemm_bf16_soak": gemm_rows["soak"],
         "barrier_trap": trap["lines"]},
        {"name": "attention_bwd", "route": "cuda",
         "launches_runner": run_launches.get("attention_bwd", 0),
         "launches_pretrain": pt_res["launches"].get("attention_bwd", 0),
         "launches_feed": feed["launches"].get("attention_bwd", 0),
         "launches_dagger": dag["launches"].get("attention_bwd", 0),
         "dagger_shapes": {k: r["bwd"] for k, r in dag_rows.items()},
         "launches_demo": demo_l["attention_bwd"],
         "launches_warm_vs_cold": wvc_l["attention_bwd"],
         "launches_dp2_per_rank_step": [
             c["attention_bwd"] for c in dist["dp2"][
                 "counts_per_rank_step"]],
         "launches_mp2_per_rank_step": [
             {t: m[t]["counts"]["attention_bwd"] for t in m}
             for m in dist["mp2"]["pretrain"]],
         "head_base": {"captured_mp2_rank1": dist["mp2"]["head_base"][
             "attention_bwd"]},
         "source": "etpnav_tpu_torch/csrc/attention_bwd.cu",
         "replaces": "etpnav_tpu/ops/pallas_attention.py:377 "
                     "fused_bias_attention custom VJP (_fused_bwd :382)",
         "launches": train_res["counts"]["attention_bwd"],
         "max_abs_err": max(r["max_abs_err"] for r in bwd_rows.values()),
         "ms": bw["ms"], "plain_ms": bw["plain_ms"],
         "bound_ms": bw["bound_ms"], "bound_by": bw["bound_by"],
         "library_ms": bw["library_ms"],
         "at": "graph self-attention q/k/v (160,12,96,64) bf16 + sprel "
               "bias, dropout 0.1, dbias; library_ms is SDPA forward + "
               "backward, beside fwd_bwd_ms (K-ATT + K-ATT-BWD through "
               "AttentionFn; *_kernel_ms their device time); "
               "library_bwd_ms SDPA's backward alone",
         "fwd_bwd_ms": bw["fwd_bwd_ms"],
         "fwd_bwd_kernel_ms": bw["fwd_bwd_kernel_ms"],
         "library_kernel_ms": bw["library_kernel_ms"], "design": TC_DESIGN,
         "kernel_ms": bw["kernel_ms"],
         "library_bwd_ms": bw["library_bwd_ms"],
         "library_bwd_kernel_ms": bw["library_bwd_kernel_ms"]},
        {"name": "attention_block", "route": "cuda",
         "source": "etpnav_tpu_torch/csrc/attention_block.cu",
         "replaces": "etpnav_tpu/ops/pallas_attention.py:686 "
                     "fused_attention_block",
         "launches": block_counts["attention_block"],
         "max_abs_err": max(r["max_abs_err"] for r in block_rows.values()),
         "ms": kb["ms"], "plain_ms": kb["plain_ms"],
         "bound_ms": kb["bound_ms"], "bound_by": kb["bound_by"],
         "library_ms": None,
         "at": "text-encoder layer x (8,80,768) bf16 + key-mask bias; "
               "launches: phase 8's 9 text + 4 graph blocks in two dtypes "
               "and (160,64), (64,200), (7,83), (16,200) with a full bias "
               "in two",
         "unfused_block_ms": kb["unfused_block_ms"],
         "kernel_ms": kb["kernel_ms"],
         "unfused_block_kernel_ms": kb["unfused_block_kernel_ms"],
         "kernel_ms_by_shape": {
             k.split("/")[0]: [block_rows[k]["kernel_ms"],
                               block_rows[k]["unfused_block_kernel_ms"]]
             for k in ("text0/bfloat16", "alone_160x64/bfloat16",
                       "alone_64x200/bfloat16", "alone_7x83/bfloat16",
                       "alone_16x200_full_bias/bfloat16")}},
        {"name": "attention_fwd_head_out", "route": "cuda",
         "source": "etpnav_tpu_torch/csrc/attention.cu",
         "replaces": "tools/exp_attn_layout.py:61 bdims_attention",
         "launches": tool_res["exp_attn_layout"]["launches"][
             "attention_fwd_head_out"],
         "max_abs_err": max(t12_rows["head_out/bfloat16"]["max_abs_err"],
                            t12_rows["head_out/float32"]["max_abs_err"]),
         "ms": t1["ms"], "plain_ms": t1["plain_ms"],
         "bound_ms": t1["bound_ms"], "bound_by": t1["bound_by"],
         "library_ms": t1["library_ms"],
         "at": "q/k/v (384,50,12,64) natural, out (384,12,50,64) bf16; "
               "library_ms is SDPA on the same operands",
         "design": TC_DESIGN, "kernel_ms": t1["kernel_ms"],
         "library_kernel_ms": t1["library_kernel_ms"]},
        {"name": "attention_cheap", "route": "cuda",
         "source": "etpnav_tpu_torch/csrc/attention.cu",
         "replaces": "tools/exp_attn_pack.py:86 cheap_attention",
         "launches": tool_res["exp_attn_pack"]["launches"][
             "attention_cheap"],
         "max_abs_err": t2["max_abs_err"],
         "ms": t2["ms"], "plain_ms": t2["plain_ms"],
         "bound_ms": t2["bound_ms"], "bound_by": t2["bound_by"],
         "library_ms": t2["library_ms"],
         "at": "q/k/v (384,12,50,64) head-leading bf16; library_ms is SDPA "
               "on the same operands (softmax(x - 10) = softmax(x))",
         "design": TC_DESIGN, "kernel_ms": t2["kernel_ms"],
         "library_kernel_ms": t2["library_kernel_ms"]},
    ]
    log(f"perceive p50 default {ab['default']['p50_ms']:.2f} ms, fused "
        f"{ab['fused']['p50_ms']:.2f} ms (B=8, in turns) [{card}]")
    for name, r in depth_graph.items():
        t, n = r["times"], r["launches"]
        log(f"depth graph {name} (B=8): perceive p50 eager "
            f"{t['perceive_eager']['p50_ms']:.2f} ms, trunk by graph "
            f"{t['perceive_trunk_graph']['p50_ms']:.2f} ms; trunk eager "
            f"{t['trunk_eager']['p50_ms']:.2f} ms, graph "
            f"{t['trunk_graph']['p50_ms']:.2f} ms; kernel launch calls per "
            f"perceive {n['perceive_eager']['kernel']} eager, "
            f"{n['perceive_trunk_graph']['kernel']} + "
            f"{n['perceive_trunk_graph']['graph']} graph [{card}]")
    pg_n, pg_t = perceive_graph["launch_calls"], perceive_graph[
        "host_ms_in_turns"]
    log(f"perceive graph (B=8): p50 eager {pg_t['eager']['p50_ms']:.2f} "
        f"ms, replayed {pg_t['replay']['p50_ms']:.2f} ms; kernel launch "
        f"calls {pg_n['eager']['kernel']} + {pg_n['eager']['graph']} graph "
        f"eager, {pg_n['replay']['kernel']} + {pg_n['replay']['graph']} "
        f"graph replayed [{card}]")
    ls = train_res["learn_step"]
    log(f"learn step p50 (T20, G64) {ls['T20_G64']['p50_ms']:.2f} ms, "
        f"(T20, G96) {ls['T20_G96']['p50_ms']:.2f} ms; peak "
        f"{train_res['peak_gib']['T20_G96']:.2f} GiB; rollout s per "
        f"interval {train_res['rollout_s']}; learn parity worst grad rel "
        f"{learn_par['worst_grad_rel']:.3g}, tolerance share "
        f"{learn_par['worst_tol_share']:.3g}; K-ATT dropout rows "
        f"{len(drop_rows)}; total {time.perf_counter() - T0:.0f} s [{card}]")
    for k, r in runner["serve"].items():
        log(f"runner serve (nav_use_bf16 {r['nav_use_bf16']}): HTTP step "
            f"p50 {r['http_step_p50_ms']:.2f} ms, in-process "
            f"{r['in_process_step_p50_ms']:.2f} ms over {r['steps']} steps "
            f"of {r['sessions']} sessions, actions equal [{card}]")
    st = pt_res["step"]
    log(f"pretrain (R2R width, batch {pt_res['batch_size']}): step p50 "
        + ", ".join(f"{t} {st[t]['p50_ms']:.2f} ms" for t in st)
        + f"; peak {max(r['peak_gib'] for r in st.values()):.2f} GiB; "
        f"device busy " + ", ".join(
            f"{t} {100 * r['busy_share']:.1f}%"
            for t, r in pt_res["profile"].items())
        + f"; {pt_res['per_step_attentions']} K-ATT + "
        f"{pt_res['per_step_attentions']} K-ATT-BWD per step; attention "
        f"rows {len(pt_rows)} [{card}]")
    fb, rm = feed["b"], feed["remat"]["turns"]
    log(f"feed: runner --workers --pipeline-halves 2 loss "
        f"{feed['a']['IL_loss']:.4f}, crash recovered "
        f"({feed['a']['restarts']} respawn); rollout s per interval "
        f"in-process {fb['A']['median_s']:.3f}, workers "
        f"{fb['B']['median_s']:.3f}, workers + 2 halves "
        f"{fb['C']['median_s']:.3f}; K-ATT per learn step "
        + " -> ".join(str(r["launches_per_step"]["attention_fwd"])
                      for r in rm.values())
        + f"; phase 11 {feed['seconds']:.0f} s [{card}]")
    tr_r, up, ev = dag["train_rec_vlnbert"], dag["update"], \
        dag["eval_rec_vlnbert"]["result"]
    log(f"DAgger (R2R width, {DAGGER_ENVS} envs): collect s per iteration "
        f"rec_vlnbert {tr_r['collect_s']}, cma "
        f"{dag['train_cma']['collect_s']}; update p50 "
        f"{up['p50_ms']:.2f} ms per batch (B {up['B']}, T {up['T']}); peak "
        f"{max(up['peak_gib'], tr_r['peak_gib']):.2f} GiB; eval SR "
        f"{ev['success']:.4f} SPL {ev['spl']:.4f} (random weights); phase "
        f"12 {dag['seconds']:.0f} s [{card}]")
    s2 = demo["session2"]["eval"]
    ev_ex = {k: r for k, r in ext_rows.items() if k.endswith("bfloat16")}
    log(f"demo (R2R width, {DEMO_ENVS} envs): IL loss {s2['IL_loss']}, "
        f"s per iteration {s2['sec_per_iter']} (rollout {s2['rollout_s']}, "
        f"learn {s2['learn_s']}), resumed at {DEMO_ITERS[0]}, one "
        f"checkpoint left; warm_vs_cold summary "
        f"{json.dumps(demo['warm_vs_cold']['lines'][-1]['summary'])}; "
        f"extract ms per panorama "
        + ", ".join(f"{k.split('/')[0]} {r['ms_per_pano']:.2f} "
                    f"(on device {r['ms_per_pano_on_device']:.2f})"
                    for k, r in ev_ex.items())
        + f", peak {max(r['peak_gib'] for r in ev_ex.values()):.2f} GiB; "
        f"phase 13 {demo['seconds']:.0f} s [{card}]")
    log(f"distribution: dp 2 learn-step p50 {dist['dp2']['p50_ms']['dp2']:.1f}"
        f" ms against dp 1 {dist['dp2']['p50_ms']['dp1']:.1f} ms (two gloo "
        f"ranks sharing one card, not a scaling number); mp 2 pretrain and "
        f"fine-tune losses equal one process's; videos "
        f"{sorted(v['kind'] for v in dist['videos'].values())}; phase 14 "
        f"{dist['seconds']:.0f} s; total {time.perf_counter() - T0:.0f} s "
        f"[{card}]")
    log(f"profiler: µs from a kernel_ms window's first host op to its first "
        f"kernel, least and largest, by slice of the run "
        f"{json.dumps(skew_summary())}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"dsv2": dsv2_rows}, default=str), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": n_cards}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--trap-child"]:
        trap_child(sys.argv[2])
    if sys.argv[1:2] == ["--soak-gemm"]:
        sys.exit(soak_main(int(sys.argv[2])))
    sys.exit(main())
