"""The port's offline feature extractor (`data/feature_pipeline.py`)
against `etpnav_tpu/data/feature_pipeline.py` at `tiny_config()` on the
CPU, with the same weights carried over by `models/convert.py`.

- `FeatureExtractor` in fp32, with and without a seeded class_proj: the
  CLIP features, the class logits and the depth means within 3e-5 of
  JAX's (JAX at `highest` matmul precision). The JAX extractor always
  runs its towers at their bf16 default, so the fp32 case patches the
  JAX model modules' `encode_image` / `encode_depth` defaults to fp32
  inside the test. At the bf16 default of both, relative L2 <= 2e-2 per
  output (XLA on the CPU may skip bf16 roundings between elementwise
  ops);
- `pose_walk` and the discrete view tables equal;
- `extract_scan_features` -> HDF5 with a last chunk that is padded: the
  stores' keys, shapes and values equal to the JAX package's (3e-5, fp32).
  The fake renderer seeds from a fixed table (Python's string hash is
  randomised per process).
"""

import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from etpnav_tpu.config import tiny_config as jax_tiny_config
from etpnav_tpu.data import feature_pipeline as jfp
from etpnav_tpu.models import clip_vit as jclip
from etpnav_tpu.models import depth_resnet as jdepth
from etpnav_tpu.training.agent import init_agent_params as jax_init
from etpnav_tpu_torch.config import tiny_config
from etpnav_tpu_torch.data import feature_pipeline as fp
from etpnav_tpu_torch.models.convert import agent_params_from_jax

torch.set_num_threads(2)

ATOL = 3e-5
BF16_L2 = 2e-2
SEEDS = {"vp0": 11, "vp1": 12, "vp2": 13}


@pytest.fixture(scope="module")
def pair():
    jcfg, cfg = jax_tiny_config(), tiny_config()
    jparams = jax_init(jax.random.PRNGKey(0), jcfg)
    agent = agent_params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams), cfg, device="cpu")
    return jcfg, cfg, jparams, agent.params


@pytest.fixture
def jax_fp32(monkeypatch):
    """The JAX towers at fp32 (their default dtype is bf16)."""
    monkeypatch.setattr(jclip, "encode_image", functools.partial(
        jclip.encode_image, dtype=jnp.float32))
    monkeypatch.setattr(jdepth, "encode_depth", functools.partial(
        jdepth.encode_depth, dtype=jnp.float32))


def _panos(cfg, B=2, V=12, seed=0):
    g = np.random.default_rng(seed)
    rgb = g.integers(0, 256, (B, V, cfg.clip.image_size,
                              cfg.clip.image_size, 3)).astype(np.uint8)
    dep = g.random((B, V, cfg.depth.input_size, cfg.depth.input_size,
                    1)).astype(np.float32)
    return rgb, dep


def _class_proj(cfg, n=40):
    return np.random.default_rng(7).standard_normal(
        (n, cfg.clip.output_dim)).astype(np.float32)


@pytest.mark.parametrize("classes", [False, True])
def test_extractor_matches_jax_fp32(pair, jax_fp32, classes):
    jcfg, cfg, jparams, params = pair
    proj = _class_proj(cfg) if classes else None
    jex = jfp.FeatureExtractor(jcfg, jparams, batch_panos=2, class_proj=proj)
    ex = fp.FeatureExtractor(cfg, params, batch_panos=2, class_proj=proj,
                             device="cpu", dtype=torch.float32)
    rgb, dep = _panos(cfg)
    (jr, jd), (r, d) = jex(rgb, dep), ex(rgb, dep)
    n_img = cfg.clip.output_dim + (40 if classes else 0)
    assert r.shape == jr.shape == (2, 12, n_img) and r.dtype == np.float32
    assert d.shape == jd.shape == (2, 12, 16)
    assert ex.num_classes == jex.num_classes == (40 if classes else 0)
    np.testing.assert_allclose(r, jr, atol=ATOL)
    np.testing.assert_allclose(d, jd, atol=ATOL)
    if classes:
        # the logits are 100 * cosine similarities
        assert np.abs(r[..., cfg.clip.output_dim:]).max() <= 100.0 + 1e-3


def test_extractor_matches_jax_bf16(pair):
    jcfg, cfg, jparams, params = pair
    proj = _class_proj(cfg)
    jex = jfp.FeatureExtractor(jcfg, jparams, batch_panos=2, class_proj=proj)
    ex = fp.FeatureExtractor(cfg, params, batch_panos=2, class_proj=proj,
                             device="cpu")
    rgb, dep = _panos(cfg, seed=1)
    for got, want in zip(ex(rgb, dep), jex(rgb, dep)):
        assert got.shape == want.shape and np.isfinite(got).all()
        l2 = np.linalg.norm(got - want) / np.linalg.norm(want)
        assert l2 <= BF16_L2, l2


def test_extractor_raises_without_gpu(pair, monkeypatch):
    *_, cfg, _, params = pair
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        fp.FeatureExtractor(cfg, params)


def _write_connectivity(tmp_path, scan="scanA", n=3):
    entries = []
    for i in range(n):
        pose = np.eye(4)
        pose[:3, 3] = [i, 0, -i]
        entries.append({
            "image_id": f"vp{i}", "pose": pose.flatten().tolist(),
            "included": True, "unobstructed": [True] * n, "height": 1.5})
    entries.append({"image_id": "excluded", "included": False,
                    "pose": np.eye(4).flatten().tolist()})
    (tmp_path / f"{scan}_connectivity.json").write_text(json.dumps(entries))
    return str(tmp_path)


def test_pose_walk_matches_jax(tmp_path):
    assert fp.DISCRETE_VIEWS_36 == jfp.DISCRETE_VIEWS_36
    assert fp.DISCRETE_VIEWS_12 == jfp.DISCRETE_VIEWS_12
    cdir = _write_connectivity(tmp_path)
    for n in (12, 36):
        got = list(fp.pose_walk(cdir, "scanA", num_views=n))
        assert got == list(jfp.pose_walk(cdir, "scanA", num_views=n))
        assert [vp for vp, _ in got] == ["vp0", "vp1", "vp2"]
        assert len(got[0][1]) == n


def test_extract_scan_features_matches_jax(pair, jax_fp32, tmp_path):
    jcfg, cfg, jparams, params = pair
    cdir = _write_connectivity(tmp_path)

    def render_fn(scan, vp, views):
        g = np.random.default_rng(SEEDS[vp])
        rgb = g.integers(0, 256, (len(views), cfg.clip.image_size,
                                  cfg.clip.image_size, 3)).astype(np.uint8)
        dep = g.random((len(views), cfg.depth.input_size,
                        cfg.depth.input_size, 1)).astype(np.float32)
        return rgb, dep

    proj = _class_proj(cfg)
    stores = {}
    for name, mod, ex in (
            ("jax", jfp, jfp.FeatureExtractor(jcfg, jparams, batch_panos=2,
                                              class_proj=proj)),
            ("port", fp, fp.FeatureExtractor(cfg, params, batch_panos=2,
                                             class_proj=proj, device="cpu",
                                             dtype=torch.float32))):
        img, dep = str(tmp_path / f"{name}_img.h5"), \
            str(tmp_path / f"{name}_dep.h5")
        # 3 viewpoints at batch 2: the second chunk is padded
        mod.extract_scan_features("scanA", render_fn, ex, img, dep,
                                  connectivity_dir=cdir, num_views=12)
        stores[name] = (fp.HDF5FeatureStore(img), fp.HDF5FeatureStore(dep))
    try:
        for (got, want), width in zip(zip(stores["port"], stores["jax"]),
                                      (cfg.clip.output_dim + 40, 16)):
            assert sorted(got.keys()) == sorted(want.keys()) == [
                "scanA_vp0", "scanA_vp1", "scanA_vp2"]
            for vp in SEEDS:
                a, b = got.get("scanA", vp), want.get("scanA", vp)
                assert a.shape == b.shape == (12, width)
                np.testing.assert_allclose(a, b, atol=ATOL)
    finally:
        for s in stores.values():
            for st in s:
                st.close()


def test_extract_scan_features_needs_viewpoints(pair, tmp_path):
    *_, cfg, _, params = pair
    ex = fp.FeatureExtractor(cfg, params, device="cpu")
    with pytest.raises(ValueError, match="connectivity_dir"):
        fp.extract_scan_features("scanA", None, ex, str(tmp_path / "i.h5"),
                                 str(tmp_path / "d.h5"))


def test_fused_configuration_matches_default(pair):
    """use_fused_block / use_fused_gn run the towers through K-PRENORM and
    K-GN (their plain versions on the CPU): the same features."""
    _, cfg, _, params = pair
    fcfg = dataclasses.replace(
        cfg, clip=dataclasses.replace(cfg.clip, use_fused_block=True),
        depth=dataclasses.replace(cfg.depth, use_fused_gn=True))
    rgb, dep = _panos(cfg, seed=2)
    want = fp.FeatureExtractor(cfg, params, device="cpu",
                               dtype=torch.float32)(rgb, dep)
    got = fp.FeatureExtractor(fcfg, params, device="cpu",
                              dtype=torch.float32)(rgb, dep)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=ATOL)
