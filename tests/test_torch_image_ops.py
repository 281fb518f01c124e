"""The port's `ops/image.py` against `etpnav_tpu/ops/image.py` on the same
seeded inputs (numpy in, numpy out), on the CPU.

- `resize_batch` down and up (antialiased downsampling, half-pixel
  centres), per method, in fp32 (atol 2e-5 on values in [0, 255]: the
  two fp32 contractions sum in another order than XLA's one einsum) and
  in uint8 (rounded half to even after the same fp32 resample: equal,
  except where the fp32 value lies within 1e-3 of a .5 tie, where one
  step is allowed);
- `center_crop_batch`, `_cover` and `apply_obs_transforms` (the cases of
  tests/test_cli_config.py, then values against JAX);
- `panorama_to_equirect`: equal;
- `equirect_directions` / `_cube_sampling_plan`: equal (the same numpy);
- `cubemap_to_equirect`: the cases of tests/test_ops.py:157-224, then
  values against JAX (fp32 at 1e-6, uint8 equal).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from etpnav_tpu.ops import image as jimage
from etpnav_tpu_torch.ops import image

torch.set_num_threads(2)


def _j(fn, *arrays, **kw):
    return np.asarray(fn(*[jnp.asarray(a) for a in arrays], **kw))


def _t(fn, *arrays, **kw):
    return fn(*[torch.from_numpy(np.array(a)) for a in arrays], **kw).numpy()


RESIZES = [((1, 16, 16, 3), (7, 5)), ((2, 3, 17, 23, 1), (40, 9)),
           ((2, 12, 24, 1), (6, 30)), ((1, 9, 9, 2), (9, 4)),
           ((1, 256, 341, 3), (224, 298))]


@pytest.mark.parametrize("method", ["bilinear", "nearest", "cubic",
                                    "lanczos3"])
@pytest.mark.parametrize("shape,size", RESIZES)
def test_resize_float_matches_jax(shape, size, method):
    rng = np.random.default_rng(sum(shape) + len(method))
    x = (rng.random(shape) * 255).astype(np.float32)
    want = _j(jimage.resize_batch, x, size=size, method=method)
    got = _t(image.resize_batch, x, size=size, method=method)
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=2e-5 * 255, rtol=0)


@pytest.mark.parametrize("shape,size", RESIZES)
def test_resize_uint8_matches_jax(shape, size):
    rng = np.random.default_rng(len(shape) + size[0])
    x = rng.integers(0, 256, shape).astype(np.uint8)
    want = _j(jimage.resize_batch, x, size=size)
    got = _t(image.resize_batch, x, size=size)
    assert got.dtype == np.uint8 and got.shape == want.shape
    f32 = _t(image.resize_batch, x.astype(np.float32), size=size)
    near_tie = np.abs(f32 - np.floor(f32) - 0.5) < 1e-3
    diff = np.abs(got.astype(int) - want.astype(int))
    assert (diff[~near_tie] == 0).all()
    assert diff.max() <= 1


def test_resize_downsampling_antialiases():
    """A 2x downsample of a one-pixel checkerboard averages it away from
    the border (the triangle kernel widened by 2), where F.interpolate's
    bilinear would take two pixels and give 0 or 255 in a row."""
    x = np.indices((8, 8)).sum(0) % 2 * 255.0
    x = x.astype(np.float32)[None, :, :, None]
    got = _t(image.resize_batch, x, size=(4, 4))
    np.testing.assert_allclose(got[:, 1:3, 1:3], 127.5, atol=1e-4)
    np.testing.assert_allclose(got, _j(jimage.resize_batch, x, size=(4, 4)),
                               atol=1e-4)


def test_resize_and_crop_values():
    img = np.arange(16, dtype=np.float32).reshape(1, 4, 4, 1)
    up = _t(image.resize_batch, img, size=(8, 8))
    assert up.shape == (1, 8, 8, 1)
    np.testing.assert_allclose(up, _j(jimage.resize_batch, img, size=(8, 8)),
                               atol=1e-5)
    crop = image.center_crop_batch(torch.from_numpy(up), (4, 4)).numpy()
    assert crop.shape == (1, 4, 4, 1)
    np.testing.assert_array_equal(
        crop, np.asarray(jimage.center_crop_batch(jnp.asarray(up), (4, 4))))


@pytest.mark.parametrize("cur,target", [((256, 341), (224, 224)),
                                        ((480, 640), (128, 128)),
                                        ((100, 50), (224, 224)),
                                        ((224, 224), (224, 224))])
def test_cover_matches_jax(cur, target):
    assert image._cover(cur, target) == jimage._cover(cur, target)


def test_obs_transforms():
    rgb = torch.zeros((2, 3, 256, 341, 3), dtype=torch.uint8)
    dep = torch.zeros((2, 3, 256, 256, 1), dtype=torch.float32)
    out = image.apply_obs_transforms({"rgb": rgb, "depth": dep})
    assert out["rgb"].shape == (2, 3, 224, 224, 3)
    assert out["rgb"].dtype == torch.uint8
    assert out["depth"].shape == (2, 3, 128, 128, 1)
    # identity when already sized
    same = image.apply_obs_transforms(out)
    assert same["rgb"] is out["rgb"]


def test_obs_transforms_values_match_jax():
    rng = np.random.default_rng(3)
    rgb = rng.integers(0, 256, (1, 2, 96, 128, 3)).astype(np.uint8)
    dep = rng.random((1, 2, 80, 100, 1)).astype(np.float32)
    want = jimage.apply_obs_transforms(
        {"rgb": jnp.asarray(rgb), "depth": jnp.asarray(dep)},
        rgb_size=(64, 64), depth_size=(32, 32))
    got = image.apply_obs_transforms(
        {"rgb": torch.from_numpy(rgb), "depth": torch.from_numpy(dep)},
        rgb_size=(64, 64), depth_size=(32, 32))
    r_diff = np.abs(got["rgb"].numpy().astype(int)
                    - np.asarray(want["rgb"]).astype(int))
    assert r_diff.max() <= 1 and (r_diff == 0).mean() > 0.999
    np.testing.assert_allclose(got["depth"].numpy(),
                               np.asarray(want["depth"]), atol=2e-6)


@pytest.mark.parametrize("lead,out_size", [((), (16, 48)), ((2,), (8, 24)),
                                           ((1,), (64, 128))])
def test_panorama_to_equirect_matches_jax(lead, out_size):
    views = (np.arange(12 * 8 * 8 * 1).reshape(12, 8, 8, 1) % 255
             ).astype(np.uint8)
    views = np.broadcast_to(views, lead + views.shape).copy()
    if lead:
        views[0] = 255 - views[0]
    want = _j(jimage.panorama_to_equirect, views, out_size=out_size)
    got = _t(image.panorama_to_equirect, views, out_size=out_size)
    assert got.shape == lead + out_size + (1,) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


def test_cube_plan_matches_jax():
    np.testing.assert_array_equal(image.equirect_directions((16, 32)),
                                  jimage.equirect_directions((16, 32)))
    for a, b in zip(image._cube_sampling_plan((8, 8), (16, 32)),
                    jimage._cube_sampling_plan((8, 8), (16, 32))):
        np.testing.assert_array_equal(a, b)


def _render_cube_faces(fn, Hf, Wf):
    """The 6 faces (Back Down Front Left Right Up) of an analytic
    direction field fn(d) -> (..., C)."""
    out = []
    for fwd, right, up in image._CUBE_FACES:
        u = (np.arange(Wf) + 0.5) / Wf * 2 - 1
        v = (np.arange(Hf) + 0.5) / Hf * 2 - 1
        uu, vv = np.meshgrid(u, v)
        d = (np.asarray(fwd)[None, None]
             + uu[..., None] * np.asarray(right)[None, None]
             - vv[..., None] * np.asarray(up)[None, None])
        d = d / np.linalg.norm(d, axis=-1, keepdims=True)
        out.append(fn(d))
    return np.stack(out)


def test_cubemap_to_equirect_analytic_field():
    def field(d):
        return np.stack([0.5 + 0.5 * d[..., 0], 0.5 + 0.5 * d[..., 1],
                         0.5 + 0.5 * d[..., 2]], axis=-1).astype(np.float32)

    faces = _render_cube_faces(field, 64, 64)[None]      # (1,6,Hf,Wf,3)
    out = _t(image.cubemap_to_equirect, faces, out_size=(32, 64))[0]
    want = field(image.equirect_directions((32, 64)))
    assert np.abs(out - want).max() < 0.03
    assert np.abs(out - want).mean() < 0.005
    np.testing.assert_allclose(
        out, _j(jimage.cubemap_to_equirect, faces, out_size=(32, 64))[0],
        atol=1e-6)


def test_cubemap_to_equirect_face_placement():
    colors = np.arange(6, dtype=np.float32) + 1
    faces = np.ones((6, 16, 16, 1), np.float32) * colors[:, None, None, None]
    out = _t(image.cubemap_to_equirect, faces, out_size=(32, 64))
    assert out[16, 32, 0] == 3.0          # center -> Front
    assert out[16, 0, 0] == 1.0           # seam -> Back
    assert out[16, 63, 0] == 1.0
    assert out[0, 32, 0] == 6.0           # zenith -> Up
    assert out[31, 32, 0] == 2.0          # nadir -> Down
    assert out[16, 48, 0] == 5.0          # +90deg column -> Right
    assert out[16, 16, 0] == 4.0          # -90deg column -> Left
    assert set(np.unique(np.round(out, 3))) <= set(colors)


def test_cubemap_to_equirect_uint8_and_batch():
    rng = np.random.default_rng(0)
    faces = rng.integers(0, 256, (2, 6, 8, 8, 3)).astype(np.uint8)
    out = _t(image.cubemap_to_equirect, faces, out_size=(16, 32))
    assert out.shape == (2, 16, 32, 3) and out.dtype == np.uint8
    np.testing.assert_array_equal(
        out, _j(jimage.cubemap_to_equirect, faces, out_size=(16, 32)))


def test_cubemap_refuses_other_face_counts():
    with pytest.raises(ValueError, match="6 cube faces"):
        image.cubemap_to_equirect(torch.zeros(5, 4, 4, 1), (8, 16))
