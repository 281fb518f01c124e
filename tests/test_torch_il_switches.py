"""The IL switches of the port (`IL.agg_dense_device`, `IL.remat`,
`IL.remat_nav`, `IL.depth_transport_uint16`) on the CPU at
`tiny_config()` in fp32, against the JAX package (matmul precision
`highest`) with the same weights and the same seeded inputs.

- `dense_w_from_sparse` against JAX's and against the numpy
  `dense_from_sparse` of tools/exp_train_bench.py: 1e-7 absolute (the
  same products of one nonzero term each).
- Replay logits, `compute_il_loss` and every planner gradient with
  `agg_dense_device`: against the port's sparse path and against JAX with
  the switch on, dropout off: logits 2e-5 absolute, loss 1e-5 relative,
  gradients max |diff| <= 1e-4 * max |g_jax| + 1e-6 per tensor
  (tests/test_torch_training.py's bounds).
- `remat` / `remat_nav` at dropout 0.1 from the same generator seed: the
  loss and every gradient equal the memoryful step's within 1e-6 *
  max |g| + 1e-7 (the same draws, the same ops), the generator ends where
  the memoryful step leaves it, and the recompute's extra attention calls
  are counted (+ pano layers, + 2 per navigation layer). A recompute that
  draws new dropout masks moves the gradients far past this bound.
  Then at dropout 0 against JAX with its `remat` and `remat_nav` on.
- uint16 depth: the port's perceive equals JAX's uint16 perceive (2e-5),
  the dequantized depth lies within 0.5/65535 of fp32, the outputs within
  tests/test_depth_transport.py's 5e-3 of fp32; the rollout hands
  perceive uint16 depth when the switch is on.
"""

import dataclasses
import importlib.util
import pathlib

import jax
import numpy as np
import pytest
import torch

from etpnav_tpu.config import tiny_config as jax_tiny_config
from etpnav_tpu.models.planner import init_planner_params
from etpnav_tpu.training import finetune as jft
from etpnav_tpu.training.agent import JittedAgent
from etpnav_tpu.training.agent import init_agent_params as jax_init_agent
from etpnav_tpu_torch.config import tiny_config
from etpnav_tpu_torch.env.geometric import GeometricNavEnv
from etpnav_tpu_torch.models.convert import agent_params_from_jax, \
    load_jax_tree
from etpnav_tpu_torch.models.planner import PlannerParams
from etpnav_tpu_torch.ops import fused_attention as fa
from etpnav_tpu_torch.training import finetune

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parents[1]
ATOL = 2e-5
GRAD_REL = 1e-4
REMAT_REL = 1e-6


def _load_tool(name):
    spec = importlib.util.spec_from_file_location(
        f"_tools_{name}", ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _il(cfg, **kw):
    return dataclasses.replace(cfg, il=dataclasses.replace(cfg.il, **kw))


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _port_batch(host):
    return {k: (torch.from_numpy(v).long() if k in finetune._INT_FIELDS
                else torch.from_numpy(v)) for k, v in host.items()}


@pytest.fixture(scope="module")
def setup():
    """Tiny JAX planner weights, the port's copy, and a synthetic sparse
    record batch (B=2) from the JAX package's own bench tool."""
    jcfg, cfg = jax_tiny_config(), tiny_config()
    etb = _load_tool("exp_train_bench")
    host = etb.synth_batch(jcfg, 2, rng=0)
    jp = init_planner_params(jax.random.PRNGKey(0), jcfg.planner)
    planner = PlannerParams(cfg.planner)
    load_jax_tree(planner, _np_tree(jp))
    return jcfg, cfg, etb, host, jp, planner


def _port_loss_grads(planner, cfg, batch, generator=None):
    for p in planner.parameters():
        p.grad = None
    before = fa.attention_plain_calls.value
    loss = finetune.compute_il_loss(planner, cfg, batch, generator)
    loss.backward()
    grads = {n: (p.grad.clone() if p.grad is not None
                 else torch.zeros_like(p))
             for n, p in planner.named_parameters()}
    return loss.item(), grads, fa.attention_plain_calls.value - before


def _jax_loss_grads(setup, **il):
    jcfg, cfg, _, host, jp, _ = setup
    jcfg = _il(jcfg, **il)
    batch = {k: jax.numpy.asarray(v) for k, v in host.items()}
    loss, g = jax.jit(jax.value_and_grad(
        lambda p, b: jft.compute_il_loss(p, jcfg, b, None)))(jp, batch)
    want = PlannerParams(cfg.planner)
    load_jax_tree(want, _np_tree(g))
    return float(loss), dict(want.named_parameters())


def _assert_grads(got, want, rel, floor):
    assert set(got) == set(want)
    for name, g in got.items():
        w = want[name].detach()
        tol = rel * w.abs().max().item() + floor
        err = (g - w).abs().max().item()
        assert err <= tol, (name, err, tol)


# ---------------------------------------------------------------------------
# IL.agg_dense_device
# ---------------------------------------------------------------------------

def test_dense_w_matches_jax_and_numpy(setup):
    jcfg, cfg, etb, host, *_ = setup
    P = cfg.waypoint.max_predictions + 12
    got = finetune.dense_w_from_sparse(_port_batch(host), P).numpy()
    jbatch = {k: jax.numpy.asarray(v) for k, v in host.items()}
    want = np.asarray(jft.dense_w_from_sparse(jbatch, P))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-7)
    np.testing.assert_allclose(got, etb.dense_from_sparse(host, P), rtol=0,
                               atol=1e-7)


def test_agg_dense_device_matches_sparse_path_and_jax(setup):
    jcfg, cfg, _, host, jp, planner = setup
    batch = _port_batch(host)
    dense = _il(cfg, agg_dense_device=True)
    with torch.no_grad():
        lg_sparse = finetune.replay_logits(planner, cfg, batch, train=False)
        lg_dense = finetune.replay_logits(planner, dense, batch,
                                          train=False)
    jlg = np.asarray(jft.replay_logits(
        jp, _il(jcfg, agg_dense_device=True),
        {k: jax.numpy.asarray(v) for k, v in host.items()}, None,
        train=False))
    fin = np.isfinite(jlg)
    for got in (lg_dense.numpy(), lg_sparse.numpy()):
        np.testing.assert_array_equal(np.isfinite(got), fin)
        np.testing.assert_allclose(got[fin], jlg[fin], atol=ATOL)

    jloss, jgrads = _jax_loss_grads(setup, agg_dense_device=True)
    loss_d, grads_d, _ = _port_loss_grads(planner, dense, batch)
    loss_s, grads_s, _ = _port_loss_grads(planner, cfg, batch)
    assert abs(loss_d - jloss) <= 1e-5 * abs(jloss)
    assert abs(loss_d - loss_s) <= 1e-5 * abs(loss_s)
    _assert_grads(grads_d, jgrads, GRAD_REL, 1e-6)
    _assert_grads(grads_d, grads_s, GRAD_REL, 1e-6)
    # the aggregation's gradient reaches the pano encoder either way
    pano = [n for n in grads_d if n.startswith("img_embeddings.")]
    assert pano and max(grads_d[n].abs().max() for n in pano) > 0


# ---------------------------------------------------------------------------
# IL.remat / IL.remat_nav
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("switch", ["remat", "remat_nav"])
def test_remat_keeps_the_forward_dropout_draws(setup, switch):
    """At dropout 0.1 the checkpointed step, recompute included, draws
    what the memoryful step draws: equal loss and gradients, the same
    generator state after, and the recompute's extra attention calls."""
    _, cfg, _, host, _, planner = setup
    assert cfg.planner.hidden_dropout == cfg.planner.attn_dropout == 0.1
    batch = _port_batch(host)
    on = _il(cfg, **({"remat": True} if switch == "remat" else
                     {"remat_nav": True, "remat_nav_min_gmap": 0}))
    g0, g1 = (torch.Generator().manual_seed(11) for _ in range(2))
    loss0, grads0, n0 = _port_loss_grads(planner, cfg, batch, g0)
    loss1, grads1, n1 = _port_loss_grads(planner, on, batch, g1)
    p = cfg.planner
    extra = (p.num_pano_layers if switch == "remat"
             else 2 * p.num_x_layers)
    assert n1 == n0 + extra
    assert abs(loss1 - loss0) <= REMAT_REL * abs(loss0)
    _assert_grads(grads1, grads0, REMAT_REL, 1e-7)
    assert torch.equal(g0.get_state(), g1.get_state())
    # and dropout is live: another seed moves the loss
    loss2, *_ = _port_loss_grads(planner, on, batch,
                                 torch.Generator().manual_seed(12))
    assert abs(loss2 - loss0) > 1e-4 * abs(loss0)


def test_remat_nav_off_below_its_gmap_threshold(setup):
    _, cfg, _, host, _, planner = setup
    G = host["gmap_mask"].shape[2]
    off = _il(cfg, remat_nav=True, remat_nav_min_gmap=G + 1)
    _, _, n_base = _port_loss_grads(planner, cfg, _port_batch(host))
    _, _, n_off = _port_loss_grads(planner, off, _port_batch(host))
    assert n_off == n_base
    assert tiny_config().il.remat_nav is False        # ROADMAP §3
    assert jax_tiny_config().il.remat_nav is True


def test_remat_matches_jax_with_its_remat_on(setup):
    """Dropout off: the checkpointed port step against JAX's
    `jax.checkpoint` step (remat, and remat_nav at G >= 0)."""
    _, cfg, _, host, _, planner = setup
    il = dict(remat=True, remat_nav=True, remat_nav_min_gmap=0)
    jloss, jgrads = _jax_loss_grads(setup, **il)
    loss, grads, _ = _port_loss_grads(planner, _il(cfg, **il),
                                      _port_batch(host))
    assert abs(loss - jloss) <= 1e-5 * abs(jloss)
    _assert_grads(grads, jgrads, GRAD_REL, 1e-6)


# ---------------------------------------------------------------------------
# IL.depth_transport_uint16
# ---------------------------------------------------------------------------

def test_uint16_perceive_matches_jax_and_fp32():
    jcfg, cfg = jax_tiny_config(), tiny_config()
    jparams = jax_init_agent(jax.random.PRNGKey(0), jcfg)
    jagent = JittedAgent(jcfg, jparams)
    agent = agent_params_from_jax(_np_tree(jparams), cfg, device="cpu")
    rng = np.random.default_rng(0)
    rgb = rng.integers(0, 256, (2, 12, cfg.clip.image_size,
                                cfg.clip.image_size, 3), np.uint8)
    depth = rng.random((2, 12, cfg.depth.input_size, cfg.depth.input_size,
                        1)).astype(np.float32)
    q = (np.clip(depth, 0.0, 1.0) * 65535.0 + 0.5).astype(np.uint16)
    assert np.abs(q.astype(np.float32) / 65535.0 - depth).max() \
        <= 0.5 / 65535.0 + 1e-7
    got, want = agent.perceive(rgb, q), jagent.perceive(rgb, q)
    ref = agent.perceive(rgb, depth)
    for key in ("pano_embeds", "avg_pano_embeds", "dep_fts", "heatmap"):
        w = np.asarray(want[key])
        np.testing.assert_allclose(got[key].numpy(), w, atol=ATOL,
                                   err_msg=key)
        np.testing.assert_allclose(got[key].numpy(), ref[key].numpy(),
                                   atol=5e-3, err_msg=key)


def test_rollout_quantizes_depth_when_switched_on():
    cfg = _il(tiny_config(), depth_transport_uint16=True, max_traj_len=3)
    envs = GeometricNavEnv(2, seed=0, vocab_size=cfg.planner.vocab_size,
                           max_instr_len=cfg.il.max_text_len,
                           image_size=cfg.clip.image_size,
                           depth_size=cfg.depth.input_size,
                           pad_id=cfg.planner.pad_token_id)
    tr = finetune.FinetuneTrainer(cfg, envs, seed=0, device="cpu")
    seen = []
    perceive = tr.agent.perceive

    def spy(rgb, depth, generator=None):
        seen.append(depth)
        return perceive(rgb, depth, generator)
    tr.agent.perceive = spy
    logs = tr.train(1)
    assert np.isfinite(logs["IL_loss"]) and seen
    for d in seen:
        assert d.dtype == np.uint16 and d.shape[-1] == 1
