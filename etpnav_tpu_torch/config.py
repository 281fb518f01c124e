"""Frozen dataclass configuration tree (the port's own copy).

The fields that the port reads, with the same names, defaults and
factories as `etpnav_tpu/config.py`, so a configuration reads the same in
both packages, with one recorded difference: `IL.remat_nav` defaults to
False here (ROADMAP §3). Switches that only the JAX package can act on
(the `jax.checkpoint` policy `remat_policy`, the bf16 attention-probs
chain `attn_probs_bf16`, the dropout PRNG choices
`rng_impl`/`dropout_bits8`) are not here (`config_yaml.py` refuses
them). `MeshConfig.backend` is the port's own field, and
`TextLLMConfig` (`text_llm`, off by default) the port's own section: a
DeepSeek-V2 decoder as the instruction encoder (`rxr_dsv2lite_config`).
Several comments below record measurements taken on a TPU for the JAX
package; they explain the defaults there and say nothing about the
port's speed on a GPU.

Replaces the reference's three-tier yacs config (vlnce_baselines/config/default.py,
habitat_extensions/config/default.py, bash flag blocks) with a single immutable
tree. Key values mirror bert_config/{bert-base-uncased,xlm-roberta-base}/config.json
and vlnce_baselines/models/etp/vlnbert_init.py:38-59 in the reference.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class PlannerConfig:
    """Cross-modal topological planner (text + pano + graph encoders).

    Mirrors the reference model hyperparameters assembled in
    vlnbert_init.py:41-59 on top of the HF BERT/XLM-R config.
    """

    # language backbone (bert-base-uncased defaults)
    vocab_size: int = 30522
    hidden_size: int = 768
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    lang_layer_norm_eps: float = 1e-12   # xlm-roberta uses 1e-5
    # training-time dropout of the planner (BERT hidden / attention
    # probabilities); the frozen waypoint TRM takes none
    hidden_dropout: float = 0.1
    attn_dropout: float = 0.1
    pad_token_id: int = 0                # xlm-roberta uses 1

    # vision / fusion parts always use eps 1e-12 in the reference
    # (hardcoded in ImageEmbeddings & friends, vilmodel_cmt.py:459-478)
    vis_layer_norm_eps: float = 1e-12

    # stack depths (vlnbert_init.py:47-49)
    num_l_layers: int = 9
    num_pano_layers: int = 2
    num_x_layers: int = 4

    # feature sizes (vlnbert_init.py:41-45)
    image_feat_size: int = 512
    depth_feat_size: int = 128
    angle_feat_size: int = 4
    max_action_steps: int = 100
    use_depth_embedding: bool = True
    graph_sprels: bool = True
    num_nav_types: int = 2

    # static shape buckets: the instruction length (r2r 80, rxr 200;
    # the pretraining sampler pads to it) and the graph length
    max_txt_len: int = 80
    max_gmap_len: int = 64       # [stop] + nodes + ghosts, bucketed
    # serving graph-length buckets for the navigation program: each step
    # runs at the smallest bucket that fits the largest live graph.
    # () = always max_gmap_len.
    gmap_len_buckets: Tuple[int, ...] = ()

    # per-layer activation checkpointing of the cross-modal (navigation)
    # layers: backward keeps each layer's (B, G, D) input and recomputes
    # its attention internals. No effect on programs that record no
    # gradient. The learn step turns it on through IL.remat_nav.
    remat_scan: bool = False

    # compute dtype for the transformer stacks
    use_bf16: bool = True
    # navigation (global graph) stack dtype override: None follows
    # use_bf16
    nav_use_bf16: Optional[bool] = None

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


@dataclasses.dataclass(frozen=True)
class WaypointConfig:
    """Waypoint predictor TRM (reference: waypoint_pred/TRM_net.py:9-60)."""

    hidden_size: int = 768
    num_heads: int = 12
    num_layers: int = 2          # TRM_LAYER
    num_angles: int = 120
    num_images: int = 12
    num_distances: int = 12      # n_classes
    neighbor: int = 1            # TRM_NEIGHBOR circular attention window
    heatmap_offset: int = 5      # HEATMAP_OFFSET rotation
    layer_norm_eps: float = 1e-12
    depth_feat_shape: Tuple[int, int, int] = (128, 4, 4)
    max_predictions: int = 5     # NMS slots (Policy_ViewSelection_ETP.py:235)
    nms_sigma: Tuple[float, float] = (7.0, 5.0)


@dataclasses.dataclass(frozen=True)
class ClipConfig:
    """CLIP ViT-B/32 image tower (reference loads via clip.load('ViT-B/32'))."""

    image_size: int = 224
    patch_size: int = 32
    width: int = 768
    layers: int = 12
    heads: int = 12
    output_dim: int = 512
    layer_norm_eps: float = 1e-5
    # run the attention half of blocks 1..L-1 (LN, q/k/v projections,
    # attention, output projection, residual) as one op, K-PRENORM
    # (ops/fused_prenorm.py); the port's form of the JAX package's module
    # switch clip_vit.USE_FUSED_BLOCK. The cls-row last block stays
    # unfused, as there.
    use_fused_block: bool = False


@dataclasses.dataclass(frozen=True)
class DepthEncoderConfig:
    """DD-PPO ResNet-50 depth encoder (habitat-style GroupNorm ResNet).

    Reference: models/encoders/resnet_encoders.py:13-50 wrapping
    habitat_baselines ResNetEncoder(baseplanes=32, ngroups=16, resnet50).
    Output (B, 4, 4, 128) for 128x128 depth input after the compression conv.
    """

    input_size: int = 128
    baseplanes: int = 32
    ngroups: int = 16
    layers: Tuple[int, int, int, int] = (3, 4, 6, 3)
    expansion: int = 4
    output_size: int = 2048     # flattened target: channels * spatial^2
    # one-pass GroupNorm(+ReLU+residual) kernel, K-GN
    # (ops/fused_groupnorm.py): stats + normalize + epilogue in one launch
    # per norm instead of PyTorch's chain of ~10 elementwise kernels.
    use_fused_gn: bool = False


@dataclasses.dataclass(frozen=True)
class GraphConfig:
    """Topological map constants (reference: models/graph_utils.py:9-10)."""

    merge_ghost: bool = True     # MODEL.merge_ghost
    # MODEL.consume_ghost: delete a ghost once the agent moves to it
    # (iter_train.yaml MODEL.consume_ghost; rollout act-4 handling)
    consume_ghost: bool = True


@dataclasses.dataclass(frozen=True)
class ILConfig:
    """Schedule-sampling IL fine-tune knobs (run_r2r/iter_train.yaml)."""

    iters: int = 15000
    log_every: int = 200         # checkpoint every N iterations (run.py)
    lr: float = 1e-5
    # envs per device; the learn step's batch is the env pool, and the
    # runner warns when NUM_ENVIRONMENTS differs from this
    batch_size: int = 8
    max_traj_len: int = 20       # max planner steps per episode
    ml_weight: float = 1.0
    sample_ratio: float = 0.75
    decay_interval: int = 3000
    expert_policy: str = "spl"   # or 'ndtw'
    waypoint_aug: bool = True
    ghost_aug: float = 0.0
    loc_noise: float = 0.5       # ghost merge radius (m)
    back_algo: str = "teleport"  # or 'control'
    tryout: bool = True
    max_text_len: int = 80
    success_distance: float = 3.0
    stop_distance: float = 1.5   # teacher stop trigger (ss_trainer_ETP.py:283)
    # MODEL.fix_{lang,pano}_embedding: freeze the text embeddings + the
    # language encoder / the pano ImageEmbeddings during fine-tuning
    # (vilmodel_cmt.py:675-682): those parameters take no gradient and
    # stay out of the optimizer, so they neither move nor decay
    fix_lang_embedding: bool = False
    fix_pano_embedding: bool = False
    # IL.is_requeue: resume from the newest checkpoint in the checkpoint
    # directory (ss_trainer_ETP.py:216-236)
    is_requeue: bool = False
    # Bucketed replay: before the learn step, slice the recorded interval's
    # trajectory axis to the smallest bucket that holds the longest live
    # episode, and the graph axis to the smallest bucket that holds the
    # largest emitted slot count. Slicing is exact (slots are
    # prefix-ordered, steps beyond the last valid one are -100-teacher
    # padding): it removes padding compute, not data. () = always the
    # record's full (max_traj_len, max_gmap_len) shape.
    train_traj_buckets: Tuple[int, ...] = ()
    train_gmap_buckets: Tuple[int, ...] = ()
    # checkpoint the pano encoder in the learn step: backward recomputes
    # its (B*T, P, D) activations instead of keeping them
    remat: bool = False
    # per-layer checkpointing of the navigation layers in the learn step's
    # replay (PlannerConfig.remat_scan), applied only when the replayed
    # graph axis G >= remat_nav_min_gmap. The JAX package defaults it on
    # because its G=96 backward does not fit a v5e's memory; on the H100
    # the (T20, G96) learn step peaks at ~10 GiB of 80, so the port
    # defaults it off (ROADMAP §3).
    remat_nav: bool = False
    remat_nav_min_gmap: int = 80
    # move depth host->device as uint16 (clip(d,0,1)*65535 rounded); the
    # agent dequantizes on the device. Halves the depth upload bytes; the
    # quantization error is <= 0.5/65535 on the [0,1] range.
    depth_transport_uint16: bool = False
    # rebuild the dense (B, T, G, T*P) aggregation matrix on the device
    # from the sparse provenance record before the replay, so the
    # aggregation's forward and backward are each one fp32 product
    # instead of a gather and its index backward. W depends on record
    # data only; no gradient flows through its construction.
    agg_dense_device: bool = False


@dataclasses.dataclass(frozen=True)
class PretrainConfig:
    """Proxy-task pretraining (pretrain_src/run_pt/
    r2r_pretrain_habitat.json), the JAX package's defaults."""

    num_train_steps: int = 100_000
    warmup_steps: int = 10_000
    learning_rate: float = 5e-5
    batch_size: int = 32
    grad_norm: float = 5.0
    weight_decay: float = 0.01
    mlm_prob: float = 0.15
    # proxy tasks and their multinomial mix ratios; mrc/og are working
    # tasks here, dormant code in the reference (pretrain_cmt.py:59-64)
    tasks: Tuple[str, ...] = ("mlm", "sap")
    task_ratios: Tuple[float, ...] = (1.0, 1.0)
    mrc_mask_prob: float = 0.15
    image_prob_size: int = 1000          # CLIP soft-label dim (MRC)
    num_objs: int = 0                    # object tokens per step (OG)
    resume: bool = False                 # resume from the newest model_step_N
    # optimizer family + schedule (optim/misc.py:26-37, optim/sched.py)
    optim: str = "adamw"   # adam | adamax | adamw | radam | ralamb | rangerlars
    lr_sched: str = "warmup_linear"      # warmup_linear | noam
    betas: Tuple[float, float] = (0.9, 0.98)
    lookahead_alpha: float = 0.5         # optim/lookahead.py:13
    lookahead_k: int = 6
    log_steps: int = 1000
    valid_steps: int = 5000
    # trajectory shape buckets
    max_traj_steps: int = 8
    views_per_step: int = 12


@dataclasses.dataclass(frozen=True)
class DaggerTaskConfig:
    """Legacy DAgger path (dagger_trainer.py:535-629; the IL.DAGGER
    section of the VLN-CE lineage)."""

    policy: str = "rec_vlnbert"  # 'rec_vlnbert' (waypoint-candidate
                                 # space) | 'cma' (low-level actions)
    iterations: int = 3          # DAGGER.iterations
    episodes_per_iter: int = 64  # DAGGER.update_size
    epochs: int = 4              # epochs per DAgger iteration
    batch_size: int = 4
    lr: float = 2.5e-4
    p: float = 0.75              # beta = p ** iteration
    max_steps: int = 60
    store_dir: str = "data/trajectories_dirs/dagger"  # lmdb_features_dir
    # released fine-tune checkpoint whose frozen CLIP/depth towers feed
    # the feature/candidate fns (models/convert.convert_full_policy);
    # '' = random init (pipeline-test mode, logged loudly)
    encoder_ckpt: str = ""
    # PREVALENT pytorch_model.bin for the rec_vlnbert policy itself
    # (models/convert.convert_rec_vlnbert); '' = random init
    policy_ckpt: str = ""
    # recurrent VLN-BERT stack depths (vlnbert_PREVALENT.py la/vl
    # layers); -1 = reuse PLANNER.num_l_layers / num_x_layers
    la_layers: int = -1
    vl_layers: int = -1


@dataclasses.dataclass(frozen=True)
class EvalConfig:
    """EVAL section (iter_train.yaml; ss_trainer_ETP.py:513-641)."""

    split: str = "val_unseen"
    episode_count: int = -1          # -1 = every episode of the split
    ckpt_path_dir: str = ""          # folder to poll (eval_loop)
    fast_eval: bool = False          # every 5th episode (ss_trainer:569)
    use_ckpt_config: bool = False


@dataclasses.dataclass(frozen=True)
class InferenceConfig:
    """INFERENCE section (iter_train.yaml; ss_trainer_ETP.py:643-756)."""

    split: str = "test"
    ckpt_path: str = ""
    predictions_file: str = "predictions.json"
    format: str = ""                 # 'r2r' | 'rxr' (jsonl); '' = task_type
    episode_count: int = -1
    sample: bool = False             # sample actions instead of argmax
    use_ckpt_config: bool = False


@dataclasses.dataclass(frozen=True)
class DataPathsConfig:
    """On-disk dataset layout for the habitat production path (reference
    TASK_CONFIG/DATASET keys: run_r2r/r2r_vlnce.yaml DATASET section,
    habitat_extensions/config/default.py:120-134). '{split}' is
    interpolated like the reference's DATA_PATH."""

    task_config: str = ""        # habitat TASK yaml (BASE_TASK_CONFIG_PATH)
    data_path: str = ""          # episodes: .../{split}/{split}.json.gz
    scenes_dir: str = ""         # MP3D scene datasets (DATASET.SCENES_DIR)
    gt_path: str = ""            # ndtw gt: .../{split}/{split}_gt.json.gz
    roles: Tuple[str, ...] = ("guide",)   # RxR DATASET.ROLES
    languages: Tuple[str, ...] = ("*",)   # RxR DATASET.LANGUAGES


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Process layout. dp = data parallel, mp = model (tensor) parallel,
    one process per device (`parallel/mesh.py`). `backend` is the
    torch.distributed backend, a field of the port only: "" picks nccl
    for CUDA devices and gloo for the CPU."""

    dp: int = -1                 # -1: world // mp
    mp: int = 1
    backend: str = ""


@dataclasses.dataclass(frozen=True)
class TextLLMConfig:
    """A DeepSeek-V2 decoder as the instruction encoder (a section of the
    port only; `models/dsv2_text.py`). With `enabled`, its last hidden
    states, after the final RMSNorm, are projected to the planner's
    width (Linear without bias + LayerNorm at
    `planner.lang_layer_norm_eps`) and become the text memory in place of
    the BERT text stack, which is then not built. The encoder is frozen:
    the trainers refuse a configuration that enables it.

    The defaults are DeepSeek-V2-Lite's published config.json: MLA
    without query compression, YaRN rotary positions, one dense SiLU
    layer, then routed experts (greedy softmax top-k, no renormalisation)
    plus shared experts. `held_experts` are the routed experts this
    process holds, its share of an expert-parallel deployment (() = all
    of them): the router scores all `n_routed_experts` and keeps its
    top-k, and only routings to held experts add to the result."""

    enabled: bool = False
    vocab_size: int = 102400
    hidden_size: int = 2048
    num_layers: int = 27
    num_heads: int = 16
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    intermediate_size: int = 10944       # the dense layers' MLP
    moe_intermediate_size: int = 1408    # one routed expert
    n_routed_experts: int = 64
    n_shared_experts: int = 2
    num_experts_per_tok: int = 6
    first_k_dense_replace: int = 1
    routed_scaling_factor: float = 1.0
    held_experts: Tuple[int, ...] = ()
    rms_norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    # YaRN (rope_scaling); factor <= 1 turns it off
    rope_factor: float = 40.0
    rope_original_max_position: int = 4096
    rope_beta_fast: float = 32.0
    rope_beta_slow: float = 1.0
    rope_mscale: float = 0.707
    rope_mscale_all_dim: float = 0.707

    @property
    def held(self) -> Tuple[int, ...]:
        return self.held_experts or tuple(range(self.n_routed_experts))


@dataclasses.dataclass(frozen=True)
class ExperimentConfig:
    task_type: str = "r2r"       # or 'rxr'
    planner: PlannerConfig = PlannerConfig()
    waypoint: WaypointConfig = WaypointConfig()
    clip: ClipConfig = ClipConfig()
    depth: DepthEncoderConfig = DepthEncoderConfig()
    graph: GraphConfig = GraphConfig()
    il: ILConfig = ILConfig()
    pretrain: PretrainConfig = PretrainConfig()
    dagger: DaggerTaskConfig = DaggerTaskConfig()
    eval: EvalConfig = EvalConfig()
    inference: InferenceConfig = InferenceConfig()
    paths: DataPathsConfig = DataPathsConfig()
    mesh: MeshConfig = MeshConfig()
    text_llm: TextLLMConfig = TextLLMConfig()
    seed: int = 0
    # MODEL.pretrained_path: the planner to start fine-tuning from, a
    # pretrain checkpoint of the port (`training/warm_start.py`) or a
    # released PyTorch pretrain checkpoint, converted (iter_train.yaml)
    pretrained_path: str = ""
    # top-level run layout (iter_train.yaml NUM_ENVIRONMENTS + *_DIR keys)
    num_environments: int = 8
    # --workers pools: respawn a crashed worker and end its episode
    # (env/vector.py)
    restart_crashed_workers: bool = False
    # route the fixed-shape observation arrays of --workers pools through
    # per-worker shared memory instead of the pickled pipe
    # (env/shm_transport.py)
    shm_observations: bool = False
    tensorboard_dir: str = "logs/tensorboard"
    checkpoint_folder: str = "checkpoints"
    results_dir: str = "logs/eval_results"
    video_dir: str = "logs/video"


def pick_bucket(need: int, buckets, cap: int) -> int:
    """Smallest configured bucket that fits `need` (bounded by `cap`);
    `cap` when none fits."""
    fits = [b for b in buckets if need <= b <= cap]
    return min(fits) if fits else cap


def r2r_config(**overrides) -> ExperimentConfig:
    """R2R-CE: bert-base-uncased text encoder (run_r2r/iter_train.yaml).

    max_gmap_len=96: the JAX package measured peak slot demand at
    reference episode shapes (T=20, K=5, merge+consume on) of p90=60 /
    max=66 with teacher-guided rollouts and up to 88 across settings
    (tools/exp_gmap_capacity.py) — a 64 cap silently evicts ghosts from
    ~8% of episodes (the reference grows unboundedly,
    graph_utils.py:193-257). 96 holds every measured episode."""
    planner = PlannerConfig(max_gmap_len=96,
                            gmap_len_buckets=(16, 32, 48, 64))
    il = ILConfig(train_traj_buckets=(12, 20),
                  train_gmap_buckets=(48, 64, 96))
    cfg = ExperimentConfig(task_type="r2r", planner=planner, il=il)
    return dataclasses.replace(cfg, **overrides)


def rxr_config(**overrides) -> ExperimentConfig:
    """RxR-CE: xlm-roberta-base text encoder, longer instructions
    (run_rxr/iter_train.yaml; vlnbert_init.py:34-39 sets type_vocab_size=2)."""
    planner = PlannerConfig(
        vocab_size=250002,
        lang_layer_norm_eps=1e-5,
        max_txt_len=200,
        pad_token_id=1,
        type_vocab_size=2,
        max_gmap_len=96,                     # see r2r_config docstring
        gmap_len_buckets=(16, 32, 48, 64),
    )
    il = ILConfig(iters=20000, lr=1.5e-5, expert_policy="ndtw",
                  max_text_len=200, train_traj_buckets=(12, 20),
                  train_gmap_buckets=(48, 64, 96))
    cfg = ExperimentConfig(task_type="rxr", planner=planner, il=il)
    return dataclasses.replace(cfg, **overrides)


def rxr_dsv2lite_config(**overrides) -> ExperimentConfig:
    """ETPNav's RxR-CE agent with DeepSeek-V2-Lite (27 layers, MLA, 64
    routed experts of which 6 a token, 2 shared) as its frozen
    instruction encoder, after NavGPT-2 (arXiv:2407.12366), which feeds a
    large language model's hidden states into the DUET-style graph
    policy that ETPNav's planner is. This process holds experts 0-15 of
    each expert layer, rank 0 of the four of an expert-parallel
    deployment over 4 H100s; attention, the shared experts, the dense
    layer and the embedding are whole. Instructions are ids of the
    model's 102400-word vocabulary, right-padded with 0 (bos 100000,
    eos 100001 are the model's own)."""
    base = rxr_config()
    planner = dataclasses.replace(base.planner, vocab_size=102400,
                                  pad_token_id=0)
    text_llm = TextLLMConfig(enabled=True, held_experts=tuple(range(16)))
    cfg = dataclasses.replace(base, planner=planner, text_llm=text_llm)
    return dataclasses.replace(cfg, **overrides)


def tiny_dsv2_config(**overrides) -> ExperimentConfig:
    """`tiny_config()` with a tiny DeepSeek-V2 instruction encoder, for
    tests: 1 dense and 2 expert layers at hidden 32, 8 routed experts of
    which 4 are held (1, 3, 4, 6) and 2 a token, 1 shared; MLA at kv rank
    16 with 8 rope dims; YaRN at the published factors. The routed sum is
    scaled by 16 (DeepSeek-V2's own factor; V2-Lite's is 1), so that at
    random weights of 0.02 the routed experts weigh in the text memory."""
    text_llm = TextLLMConfig(
        enabled=True, vocab_size=512, hidden_size=32, num_layers=3,
        num_heads=2, kv_lora_rank=16, qk_nope_head_dim=8,
        qk_rope_head_dim=8, v_head_dim=8, intermediate_size=48,
        moe_intermediate_size=16, n_routed_experts=8, n_shared_experts=1,
        num_experts_per_tok=2, routed_scaling_factor=16.0,
        held_experts=(1, 3, 4, 6))
    return tiny_config(text_llm=text_llm, **overrides)


def tiny_config(**overrides) -> ExperimentConfig:
    """Small config for tests / CI: same topology, tiny dims."""
    planner = PlannerConfig(
        vocab_size=512,
        hidden_size=64,
        num_heads=4,
        intermediate_size=128,
        max_position_embeddings=64,
        num_l_layers=2,
        num_pano_layers=1,
        num_x_layers=2,
        image_feat_size=32,
        depth_feat_size=16,
        max_txt_len=16,
        max_gmap_len=16,
        use_bf16=False,
    )
    waypoint = WaypointConfig(hidden_size=64, num_heads=4, num_layers=1,
                              depth_feat_shape=(16, 2, 2))
    clip = ClipConfig(image_size=32, patch_size=16, width=64, layers=2,
                      heads=4, output_dim=32)
    # input 64 -> spatial 2, compression channels 64/4 = 16 -> (2,2,16),
    # CHW-flat 64 matching waypoint depth_feat_shape (16,2,2)
    depth = DepthEncoderConfig(input_size=64, baseplanes=8, ngroups=4,
                               layers=(1, 1, 1, 1), output_size=64)
    il = ILConfig(iters=2, log_every=1, batch_size=2, max_traj_len=4,
                  max_text_len=16)
    pretrain = PretrainConfig(num_train_steps=4, warmup_steps=2,
                              batch_size=2, max_traj_steps=3,
                              views_per_step=12)
    dagger = DaggerTaskConfig(iterations=1, episodes_per_iter=2, epochs=1,
                              batch_size=2, max_steps=4, la_layers=2,
                              vl_layers=1)
    cfg = ExperimentConfig(task_type="r2r", planner=planner,
                           waypoint=waypoint, clip=clip, depth=depth, il=il,
                           pretrain=pretrain, dagger=dagger)
    return dataclasses.replace(cfg, **overrides)
