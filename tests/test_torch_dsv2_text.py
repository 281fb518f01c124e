"""The DeepSeek-V2 instruction encoder of the port
(`etpnav_tpu_torch/models/dsv2_text.py`) at `tiny_dsv2_config()` on the
CPU: against navbench's plain reference (`navbench/reference/
dsv2lite.py`) and transformers' DeepseekV2Model; the expert shares that
add up to the uncut layer; the plain versions of K-ATT at head width 192
and of K-MOE; the norm and bias leaves seeded weights see; the spans,
counters, trainers' refusal and YAML switch.

The JAX package has no such encoder, so nothing here holds these modules
to it."""

import copy
import dataclasses
import math

import numpy as np
import pytest
import torch

from etpnav_tpu_torch import config_yaml
from etpnav_tpu_torch.config import (
    TextLLMConfig,
    rxr_dsv2lite_config,
    tiny_dsv2_config,
)
from etpnav_tpu_torch.models import dsv2_text
from etpnav_tpu_torch.ops import moe_gemm
from etpnav_tpu_torch.ops.fused_attention import attention_fwd
from etpnav_tpu_torch.training.agent import Agent, AgentParams
from etpnav_tpu_torch.utils import logging as tracing
from navbench import model_config, program, weights
from navbench.reference import dsv2lite

torch.set_num_threads(2)

L = 16


@pytest.fixture(scope="module")
def setup():
    cfg = tiny_dsv2_config()
    params, table = program.agent_params(cfg, 77, torch.device("cpu"))
    P = weights.make_weights(table, 77, torch.device("cpu"))
    m = model_config.model_block(cfg, model_config.ETPNAV + ("text_llm",))
    rng = np.random.default_rng(5)
    ids = np.zeros((3, L), np.int64)
    for i, n in enumerate((16, 11, 4)):
        ids[i, :n] = rng.integers(10, cfg.text_llm.vocab_size, n)
    return cfg, params, P, m, torch.from_numpy(ids)


def _routes(monkeypatch_target, calls):
    orig = monkeypatch_target.route

    def spy(*a, **k):
        out = orig(*a, **k)
        calls.append(out[1].sort(-1).values)
        return out
    return spy


def test_encoder_matches_the_reference(setup, monkeypatch):
    """fp32 text memory and decoder states against the plain reference,
    the same experts chosen in every expert layer."""
    cfg, params, P, m, ids = setup
    mask = ids != cfg.planner.pad_token_id
    got_routes, want_routes = [], []
    monkeypatch.setattr(dsv2_text, "route", _routes(dsv2_text, got_routes))
    ref = dsv2lite.Ref(P, m)
    monkeypatch.setattr(ref, "route", _routes(ref, want_routes))
    with torch.no_grad():
        got = dsv2_text.encode(params.text_llm, cfg, ids, mask)
        want = ref.encode_text(ids, mask)
        got_h = dsv2_text.decode(params.text_llm, cfg, ids)
        want_h = ref.decoder(ids)
    assert len(got_routes) == len(want_routes) == 4
    for a, b in zip(got_routes, want_routes):
        assert torch.equal(a, b)
    assert got.shape == (3, L, cfg.planner.hidden_size)
    torch.testing.assert_close(got, want, atol=3e-5, rtol=0)
    torch.testing.assert_close(got_h, want_h, atol=2e-5, rtol=1e-5)


def test_agent_serves_the_encoder(setup):
    """`Agent.encode_text` (the path `NavServer.create_session` takes)
    gives the module's text memory, and builds no BERT text stack."""
    cfg, params, P, m, ids = setup
    agent = Agent(cfg, params, device="cpu")
    mask = ids != cfg.planner.pad_token_id
    got = agent.encode_text(ids.numpy(), mask.numpy())
    with torch.no_grad():
        want = dsv2_text.encode(params.text_llm, cfg, ids, mask)
    torch.testing.assert_close(got, want, atol=0, rtol=0)
    names = [n for n, _ in params.named_parameters()]
    assert not any(n.startswith(("planner.lang_encoder",
                                 "planner.embeddings.word")) for n in names)
    assert "planner.embeddings.token_type_embeddings" in names


def test_agent_casts_the_matrices_once(setup):
    """With bf16, `Agent` holds the decoder's matrices in bf16 alone (the
    router, norms, embedding and proj_ln in fp32), none of its leaves a
    view of the buffer the weights were loaded from; a load copied into
    a parameter rounds once; the bf16 text memory follows fp32's."""
    cfg, _, P, _, ids = setup
    cfg16 = dataclasses.replace(cfg, planner=dataclasses.replace(
        cfg.planner, use_bf16=True))
    params, _ = program.agent_params(cfg16, 77, torch.device("cpu"))
    agent = Agent(cfg16, params, device="cpu")
    for n, t in params.text_llm.named_parameters():
        matrix = (t.dim() >= 2 and n != "embed_tokens"
                  and not n.endswith("moe.gate.weight"))
        assert t.dtype == (torch.bfloat16 if matrix else torch.float32), n
    for t in params.parameters():
        assert t.untyped_storage().nbytes() == t.nbytes
    w = params.text_llm.layers[1].moe.experts_gate_up
    name = "text_llm.layers.1.moe.experts_gate_up"
    with torch.no_grad():
        w.copy_(P[name] * 1.5)
    assert torch.equal(w, (P[name] * 1.5).to(torch.bfloat16))
    w.data = P[name].to(torch.bfloat16)
    mask = ids != cfg.planner.pad_token_id
    got = agent.encode_text(ids.numpy(), mask.numpy())
    with torch.no_grad():
        want = dsv2lite.Ref(P, model_config.model_block(
            cfg, model_config.ETPNAV + ("text_llm",))).encode_text(ids, mask)
    m = mask[..., None].expand_as(got)
    rel = (got - want)[m].norm() / want[m].norm()
    assert rel < 2e-2


def _share(P: dict, pre: str, full: dict, held: list) -> dict:
    """P with the expert layer `pre` holding the experts `held` of the
    uncut stacked weights `full`."""
    out = dict(P)
    idx = torch.tensor(held, dtype=torch.long)
    for k in ("experts_gate_up", "experts_down"):
        out[f"{pre}.{k}"] = full[k][idx]
    return out


def test_expert_shares_add_up_to_the_uncut_layer(setup):
    """The routed parts of two complementary shares of the 8 experts
    (this configuration's held 1, 3, 4, 6 and the rest), plus the shared
    experts counted once, are the uncut reference layer; the program's
    layer at its share equals the reference's share."""
    cfg, params, P, m, ids = setup
    c = cfg.text_llm
    pre = "text_llm.layers.1.moe"
    g = torch.Generator().manual_seed(3)
    full = {k: torch.randn((8,) + tuple(P[f"{pre}.{k}"].shape[1:]),
                           generator=g) * 0.2
            for k in ("experts_gate_up", "experts_down")}
    x = torch.randn(2, L, c.hidden_size, generator=g)
    share_a, share_b = list(c.held), [e for e in range(8) if e not in c.held]
    with torch.no_grad():
        shared = dsv2lite.Ref(_share(P, pre, full, []), m).moe(pre, x, [])
        a = dsv2lite.Ref(_share(P, pre, full, share_a), m).moe(pre, x,
                                                               share_a)
        b = dsv2lite.Ref(_share(P, pre, full, share_b), m).moe(pre, x,
                                                               share_b)
        whole = dsv2lite.Ref(_share(P, pre, full, list(range(8))), m).moe(
            pre, x, list(range(8)))
        torch.testing.assert_close((a - shared) + (b - shared) + shared,
                                   whole, atol=1e-6, rtol=1e-5)
        layer = copy.deepcopy(params.text_llm.layers[1].moe)
        for k in ("experts_gate_up", "experts_down"):
            getattr(layer, k).data = full[k][share_a]
        lut = dsv2_text._constants(c, L, "cpu")["lut"]
        got = dsv2_text.moe(layer, c, x, lut, None)
    torch.testing.assert_close(got, a, atol=2e-6, rtol=1e-5)
    assert not torch.allclose(a, whole, atol=1e-3)


def test_matches_transformers_deepseek_v2(setup):
    """The decoder against transformers' DeepseekV2Model where the two
    agree: rope_scaling off (YaRN's mscale^2 in the softmax scale is the
    published code's, which transformers 4.57 leaves out) and every
    expert held."""
    from transformers import DeepseekV2Config, DeepseekV2Model
    cfg, _, _, _, ids = setup
    c = dataclasses.replace(cfg.text_llm, held_experts=(), rope_factor=1.0)
    cfg = dataclasses.replace(cfg, text_llm=c)
    torch.manual_seed(9)
    params = AgentParams(cfg)
    with torch.no_grad():
        for p in params.text_llm.parameters():
            p.normal_(0.0, 0.2 if p.dim() > 1 else 0.05).add_(
                1.0 if p.dim() == 1 else 0.0)
    hc = DeepseekV2Config(
        vocab_size=c.vocab_size, hidden_size=c.hidden_size,
        intermediate_size=c.intermediate_size,
        moe_intermediate_size=c.moe_intermediate_size,
        num_hidden_layers=c.num_layers, num_attention_heads=c.num_heads,
        num_key_value_heads=c.num_heads, n_shared_experts=c.n_shared_experts,
        n_routed_experts=c.n_routed_experts,
        routed_scaling_factor=c.routed_scaling_factor,
        kv_lora_rank=c.kv_lora_rank, q_lora_rank=None,
        qk_rope_head_dim=c.qk_rope_head_dim, v_head_dim=c.v_head_dim,
        qk_nope_head_dim=c.qk_nope_head_dim, topk_method="greedy",
        n_group=1, topk_group=1, num_experts_per_tok=c.num_experts_per_tok,
        first_k_dense_replace=c.first_k_dense_replace, norm_topk_prob=False,
        rms_norm_eps=c.rms_norm_eps, rope_theta=c.rope_theta,
        rope_scaling=None, max_position_embeddings=64,
        attn_implementation="eager")
    hf = DeepseekV2Model(hc).eval()
    t = params.text_llm
    sd = {"embed_tokens.weight": t.embed_tokens,
          "norm.weight": t.final_norm.weight}
    for i, layer in enumerate(t.layers):
        p = f"layers.{i}."
        sd[p + "input_layernorm.weight"] = layer.input_norm.weight
        sd[p + "post_attention_layernorm.weight"] = \
            layer.post_attn_norm.weight
        for k in ("q_proj", "kv_a_proj_with_mqa", "kv_b_proj", "o_proj"):
            sd[p + f"self_attn.{k}.weight"] = getattr(layer.attn, k).weight
        sd[p + "self_attn.kv_a_layernorm.weight"] = layer.attn.kv_norm.weight
        if hasattr(layer, "mlp"):
            for k in ("gate_proj", "up_proj", "down_proj"):
                sd[p + f"mlp.{k}.weight"] = getattr(layer.mlp, k).weight
            continue
        moe = layer.moe
        sd[p + "mlp.gate.weight"] = moe.gate.weight
        for e in range(c.n_routed_experts):
            gate, up = moe.experts_gate_up[e].chunk(2)
            sd[p + f"mlp.experts.{e}.gate_proj.weight"] = gate
            sd[p + f"mlp.experts.{e}.up_proj.weight"] = up
            sd[p + f"mlp.experts.{e}.down_proj.weight"] = moe.experts_down[e]
        for k in ("gate_proj", "up_proj", "down_proj"):
            sd[p + f"mlp.shared_experts.{k}.weight"] = \
                getattr(moe.shared, k).weight
    hf.load_state_dict({k: v.detach() for k, v in sd.items()}, strict=True)
    with torch.no_grad():
        want = hf(input_ids=ids).last_hidden_state
        got = dsv2_text.decode(t, cfg, ids)
    torch.testing.assert_close(got, want, atol=3e-5, rtol=1e-5)


def test_published_softmax_scale_and_yarn():
    """192^-0.5 * mscale^2 with mscale = 0.1 * 0.707 * ln 40 + 1 at the
    published widths; plain 192^-0.5 without YaRN; the mscale ratio of
    the rotary table is 1 (mscale = mscale_all_dim)."""
    c = rxr_dsv2lite_config().text_llm
    ms = 0.1 * 0.707 * math.log(40.0) + 1.0
    assert dsv2_text.softmax_scale(c) == pytest.approx(
        192 ** -0.5 * ms * ms, rel=1e-12)
    assert dsv2_text.softmax_scale(dataclasses.replace(
        c, rope_factor=1.0)) == pytest.approx(192 ** -0.5, rel=1e-12)
    cos, sin = dsv2_text.rope_table(c, 4)
    assert cos.shape == (4, 64) and torch.allclose(cos[0], torch.ones(64))
    inv = dsv2_text.rope_inv_freq(c)
    # extrapolated (the base's) frequencies at the fast end, interpolated
    # (divided by the factor) at the slow end
    assert inv[0] == 1.0 and inv[-1] == pytest.approx(
        10000.0 ** (-62 / 64) / 40.0, rel=1e-6)


def test_seeded_weight_kinds(setup):
    """Every norm leaf of the encoder draws as a norm scale (the LayerNorm
    of the projection also as a shift), and no dense layer of it has a
    bias."""
    cfg = setup[0]
    with torch.device("meta"):
        params = AgentParams(cfg)
    leaves = [(n, tuple(t.shape)) for n, t in params.state_dict().items()
              if n.startswith("text_llm.")]
    norms = [n for n, _ in leaves if "_norm." in n or "proj_ln." in n]
    assert len(norms) == 3 * 3 + 2 + 1
    for n, shape in leaves:
        k = weights.kind(n, shape)
        if n.endswith("_norm.weight") or n.endswith("proj_ln.weight"):
            assert k == "norm_scale", n
        elif n.endswith(".bias"):
            assert n == "text_llm.proj_ln.bias" and k == "norm_shift"
        else:
            assert k == "dense", n


def test_katt_plain_at_head_width_192_with_a_causal_bias():
    """K-ATT's plain version (the CPU path of `attention_fwd`) at MLA's
    head width with the causal bias, against softmax attention written
    out; v zero-padded from 128 leaves the padded output columns 0."""
    g = torch.Generator().manual_seed(4)
    B, H, Lq = 2, 3, 9
    q = torch.randn(B, Lq, H, 192, generator=g).transpose(1, 2)
    k = torch.randn(B, Lq, H, 192, generator=g).transpose(1, 2)
    v = torch.nn.functional.pad(torch.randn(B, Lq, H, 128, generator=g),
                                (0, 64)).transpose(1, 2)
    bias = torch.full((Lq, Lq), float("-inf")).triu(1)[None]
    scale = 0.1147
    got = attention_fwd(q, k, v, bias, scale)
    logits = q @ k.transpose(-1, -2) * scale
    logits = logits.masked_fill(
        ~torch.ones(Lq, Lq, dtype=torch.bool).tril(), float("-inf"))
    want = torch.softmax(logits, -1) @ v
    torch.testing.assert_close(got, want, atol=2e-6, rtol=1e-5)
    assert torch.equal(got[..., 128:], torch.zeros_like(got[..., 128:]))


def test_kmoe_plain_against_a_loop_over_routings():
    """K-MOE's plain versions, over routings sorted as the encoder sorts
    them, against each routing computed on its own."""
    g = torch.Generator().manual_seed(8)
    T, D, I, E, k = 12, 32, 16, 4, 2
    x = torch.randn(T, D, generator=g)
    experts = torch.stack([torch.randperm(6, generator=g)[:k]
                           for _ in range(T)])        # 6 experts, 4 held
    tw = torch.rand(T, k, generator=g)
    lut = torch.tensor([0, 1, 2, 3, E, E])
    local = lut[experts].reshape(-1)
    order = torch.argsort(local, stable=True)
    cnt = torch.bincount(local, minlength=E + 1)
    offsets = torch.cat([cnt.new_zeros(1), cnt[:E].cumsum(0)]).int()
    w_gu = torch.randn(E, 2 * I, D, generator=g) * 0.2
    w_d = torch.randn(E, D, I, generator=g) * 0.2
    h = moe_gemm.moe_gate_up(x[order // k], w_gu, offsets)
    y = moe_gemm.moe_down(h, w_d, offsets, tw.reshape(-1)[order],
                          order.int(), T * k).view(T, k, D)
    for t in range(T):
        for j in range(k):
            e = int(lut[experts[t, j]])
            if e == E:
                assert torch.equal(y[t, j], torch.zeros(D))
                continue
            gu = x[t] @ w_gu[e].t()
            want = tw[t, j] * ((torch.nn.functional.silu(gu[:I]) * gu[I:])
                               @ w_d[e].t())
            torch.testing.assert_close(y[t, j], want, atol=1e-6, rtol=1e-5)


def test_spans_and_counters(setup):
    """`agent.text_llm` around an encode, `agent.mla` per layer and
    `agent.moe` per expert layer inside it; the text counters."""
    cfg, params, P, m, ids = setup
    agent = Agent(cfg, params, device="cpu")
    mask = (ids != 0).numpy()
    tracing.enable()
    try:
        agent.encode_text(ids.numpy(), mask)
        spans = tracing.export()["spans"]
    finally:
        tracing.disable()
    by = {}
    for s in spans:
        by.setdefault(s["name"], []).append(s)
    (outer,) = by["agent.text_llm"]
    assert len(by["agent.mla"]) == 3 and len(by["agent.moe"]) == 2
    assert all(s["parent"] == outer["id"]
               for s in by["agent.mla"] + by["agent.moe"])
    st = agent.text_stats()
    k, n_moe = cfg.text_llm.num_experts_per_tok, 2
    assert st["text_encodes"] == 1 and st["text_tokens"] == int(mask.sum())
    assert st["moe_rows"] + st["moe_rows_elsewhere"] == n_moe * ids.numel() * k
    assert 0 < st["moe_groups"] <= n_moe * len(cfg.text_llm.held)
    assert st["moe_rows"] >= st["moe_groups"]


def test_encode_is_the_same_with_the_tracer_on_and_off(setup):
    """The tracer turns the CUDA graph off (its per-layer spans time the
    eager kernels); on the CPU both paths are the eager encoder, and the
    span says `graph` False. The counters add up over both encodes."""
    cfg, params, P, m, ids = setup
    agent = Agent(cfg, params, device="cpu")
    mask = (ids != 0).numpy()
    off = agent.encode_text(ids.numpy(), mask)
    st_off = agent.text_stats()
    tracing.enable()
    try:
        on = agent.encode_text(ids.numpy(), mask)
        spans = tracing.export()["spans"]
    finally:
        tracing.disable()
    assert torch.equal(on, off)
    (outer,) = [s for s in spans if s["name"] == "agent.text_llm"]
    assert outer["graph"] is False
    st = agent.text_stats()
    assert st["text_encodes"] == 2
    for key in ("text_tokens", "moe_rows", "moe_groups",
                "moe_rows_elsewhere"):
        assert st[key] == 2 * st_off[key]


def test_profiling_is_seen_from_every_thread():
    """The encoder leaves its CUDA graph while torch.profiler records,
    which a client's thread has to see although the profiler was
    started on another."""
    import threading

    from etpnav_tpu_torch.training.agent import profiling
    seen = []

    def look():
        seen.append(profiling())
    assert not profiling()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        t = threading.Thread(target=look)
        t.start()
        t.join()
        seen.append(profiling())
    look()
    assert seen == [True, True, False]


@pytest.mark.parametrize("trainer", ["finetune", "pretrain"])
def test_trainers_refuse_the_frozen_encoder(trainer):
    cfg = tiny_dsv2_config()
    if trainer == "finetune":
        from etpnav_tpu_torch.env.geometric import GeometricNavEnv
        from etpnav_tpu_torch.training.finetune import FinetuneTrainer
        tr = FinetuneTrainer(cfg, GeometricNavEnv(2, seed=0), device="cpu")
        with pytest.raises(ValueError, match="frozen DeepSeek-V2"):
            tr.train(1)
    else:
        from etpnav_tpu_torch.training.pretrain import (
            PretrainTrainer,
            pretrain_shapes,
        )
        with pytest.raises(ValueError, match="frozen DeepSeek-V2"):
            PretrainTrainer(cfg, pretrain_shapes(cfg), device="cpu")


def test_yaml_selects_the_encoder(tmp_path):
    """TEXT_LLM.enabled selects the encoder; the rxr_dsv2lite preset is
    DeepSeek-V2-Lite at its published widths, 16 of 64 experts held."""
    path = tmp_path / "rxr_dsv2lite.yaml"
    path.write_text("BASE: rxr_dsv2lite\nTEXT_LLM:\n  enabled: true\n")
    cfg = config_yaml.load_config(str(path))
    assert cfg == rxr_dsv2lite_config()
    c = cfg.text_llm
    assert c.enabled and c.held == tuple(range(16))
    assert (c.hidden_size, c.num_layers, c.n_routed_experts,
            c.num_experts_per_tok) == (2048, 27, 64, 6)
    tiny = config_yaml.config_from_dict({"BASE": "tiny", "TEXT_LLM": {
        "enabled": True, "held_experts": [0, 2]}})
    assert tiny.text_llm.enabled and tiny.text_llm.held == (0, 2)
    assert not config_yaml.config_from_dict({"BASE": "rxr"}).text_llm.enabled
    with pytest.raises(ValueError, match="held_experts"):
        dsv2_text.check_config(TextLLMConfig(held_experts=(0, 0)))
