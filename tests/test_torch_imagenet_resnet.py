"""The port's legacy ImageNet ResNet-50 RGB encoder
(`models/imagenet_resnet.py`) against `etpnav_tpu/models/imagenet_resnet.py`
and the torchvision-layout transcription of tests/test_imagenet_resnet.py
(imported from that file), on the CPU.

- `convert_torchvision_resnet50`: every leaf equal to the JAX converter's
  (the BN fold in numpy on both sides);
- `encode_imagenet_rgb` in fp32 with the same weights, spatial and raw
  output, against JAX (max |diff| <= 1e-4 * max |JAX| + 1e-5: fp32 sums
  of 53 convolutions in another order) and against the torch
  transcription (2e-3, the JAX test's bound);
- the same from the JAX package's own random init, through
  `imagenet_resnet_params_from_jax`; in bf16, relative L2 <= 2e-2 (each
  convolution rounds its fp32 sum to bf16 on both sides, but XLA on the
  CPU may skip roundings between its elementwise ops);
- `adaptive_avg_pool` against JAX and `F.adaptive_avg_pool2d`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn as nn
import torch.nn.functional as F

from etpnav_tpu.models import imagenet_resnet as jir
from etpnav_tpu_torch.models import imagenet_resnet as ir
from etpnav_tpu_torch.models.convert import imagenet_resnet_params_from_jax
from test_imagenet_resnet import (
    _randomize_bn_stats,
    _torch_reference_forward,
    _TVResNet50Trunk,
)

torch.set_num_threads(2)

REL = 1e-4


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}.{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}[{i}]")
    else:
        yield path, np.asarray(tree)


def _close(got, want, rel=REL):
    want = np.asarray(want)
    err = np.abs(got - want).max()
    assert err <= rel * np.abs(want).max() + 1e-5, err


@pytest.fixture(scope="module")
def golden():
    torch.manual_seed(0)
    rng = np.random.default_rng(0)
    model = _TVResNet50Trunk().eval()
    _randomize_bn_stats(model, rng)
    emb = nn.Embedding(ir.SPATIAL_GRID ** 2, ir.SPATIAL_EMBED_DIM)
    sd = {f"cnn.{k}": v for k, v in model.state_dict().items()}
    sd["spatial_embeddings.weight"] = emb.weight.detach()
    return model, emb, sd


def test_converter_matches_jax(golden):
    *_, sd = golden
    got = dict(_leaves(ir.convert_torchvision_resnet50(sd)))
    want = dict(_leaves(jir.convert_torchvision_resnet50(sd)))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("spatial", [True, False])
def test_encoder_matches_jax_and_torch_golden(golden, spatial):
    model, emb, sd = golden
    params = imagenet_resnet_params_from_jax(
        ir.convert_torchvision_resnet50(sd))
    jparams = jir.convert_torchvision_resnet50(sd)
    rgb = (np.random.default_rng(1).random((2, 96, 96, 3)) * 255).astype(
        np.uint8)
    with torch.no_grad():
        got = ir.encode_imagenet_rgb(params, torch.from_numpy(rgb),
                                     spatial_output=spatial,
                                     dtype=torch.float32).numpy()
    want = np.asarray(jir.encode_imagenet_rgb(
        jparams, jnp.asarray(rgb), spatial_output=spatial,
        dtype=jnp.float32))
    assert got.shape == want.shape == ((2, 4, 4, 2112) if spatial
                                       else (2, 3, 3, 2048))
    _close(got, want)
    np.testing.assert_allclose(
        got, _torch_reference_forward(model, emb, rgb, spatial), atol=2e-3)


@pytest.mark.parametrize("dtype,rel", [("float32", None), ("bfloat16", 2e-2)])
def test_encoder_from_jax_init(dtype, rel):
    jparams = jir.init_imagenet_resnet_params(jax.random.PRNGKey(3))
    params = imagenet_resnet_params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams))
    rgb = (np.random.default_rng(2).random((1, 64, 96, 3)) * 255).astype(
        np.uint8)
    with torch.no_grad():
        got = ir.encode_imagenet_rgb(params, torch.from_numpy(rgb),
                                     dtype=getattr(torch, dtype)).numpy()
    want = np.asarray(jir.encode_imagenet_rgb(
        jparams, jnp.asarray(rgb), dtype=getattr(jnp, dtype)))
    assert got.shape == want.shape == (1, 4, 4, 2112)
    assert np.isfinite(got).all()
    if rel is None:
        _close(got, want)
    else:
        l2 = np.linalg.norm(got - want) / np.linalg.norm(want)
        assert l2 <= rel, l2


def test_init_params_shapes():
    params = ir.init_imagenet_resnet_params(torch.Generator().manual_seed(0))
    jparams = jir.init_imagenet_resnet_params(jax.random.PRNGKey(0))
    shapes = {k: tuple(v.shape) for k, v in _leaves(
        jax.tree_util.tree_map(np.asarray, jparams))}
    assert sum(p.numel() for p in params.parameters()) == sum(
        int(np.prod(s)) for s in shapes.values())
    with torch.no_grad():
        out = ir.encode_imagenet_rgb(
            params, torch.zeros((1, 96, 96, 3), dtype=torch.uint8),
            dtype=torch.float32)
    assert out.shape == (1, 4, 4, 2048 + 64)
    no_spatial = ir.ImagenetResNetParams(spatial_output=False)
    assert not hasattr(no_spatial, "spatial_embeddings")


@pytest.mark.parametrize("hw,out", [(7, 4), (5, 3), (4, 4), (3, 4)])
def test_adaptive_avg_pool_matches_jax_and_torch(hw, out):
    x = np.random.default_rng(hw).random((2, hw, hw, 6)).astype(np.float32)
    got = ir.adaptive_avg_pool(torch.from_numpy(x), out).numpy()
    np.testing.assert_allclose(
        got, np.asarray(jir.adaptive_avg_pool(jnp.asarray(x), out)),
        atol=1e-6)
    np.testing.assert_allclose(
        got, F.adaptive_avg_pool2d(torch.from_numpy(x.transpose(0, 3, 1, 2)),
                                   (out, out)).numpy().transpose(0, 2, 3, 1),
        atol=1e-6)
