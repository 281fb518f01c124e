"""Batched observation transforms on the device (the port's counterpart of
`etpnav_tpu/ops/image.py`).

Capability target: habitat_extensions/obs_transformers.py —
ResizerPerSensor (:93), CenterCropperPerSensor (:20) and CubeMap2Equirect
(:213) on batched tensors. `resize_batch` reproduces `jax.image.resize`:
separable kernels over half-pixel centres, the kernel widened by the
downsampling factor (antialiasing), each output row's weights normalised
to sum 1, and the contraction in fp32. `F.interpolate` does not
antialias, so it is not used. Integer images are rounded half to even
and clipped to [0, 255] after the fp32 resample, as in JAX.
"""

from __future__ import annotations

import functools
import math
from typing import Tuple

import numpy as np
import torch


def _triangle(x: np.ndarray) -> np.ndarray:
    return np.maximum(np.float32(0), np.float32(1) - np.abs(x))


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    out = ((np.float32(1.5) * x - np.float32(2.5)) * x) * x + np.float32(1)
    out = np.where(x >= 1, ((np.float32(-0.5) * x + np.float32(2.5)) * x
                            - np.float32(4)) * x + np.float32(2), out)
    return np.where(x >= 2, np.float32(0), out)


def _lanczos(radius: float, x: np.ndarray) -> np.ndarray:
    r = np.float32(radius)
    pi = np.float32(np.pi)
    y = r * np.sin(pi * x) * np.sin(pi * x / r)
    with np.errstate(divide="ignore", invalid="ignore"):
        out = np.where(x > np.float32(1e-3),
                       y / np.where(x != 0, pi ** 2 * x ** 2, np.float32(1)),
                       np.float32(1))
    return np.where(x > r, np.float32(0), out)


_KERNELS = {
    "linear": _triangle, "bilinear": _triangle, "trilinear": _triangle,
    "triangle": _triangle,
    "cubic": _keys_cubic, "bicubic": _keys_cubic, "tricubic": _keys_cubic,
    "lanczos3": functools.partial(_lanczos, 3.0),
    "lanczos5": functools.partial(_lanczos, 5.0),
}


@functools.lru_cache(maxsize=64)
def _weight_mat(m: int, n: int, method: str) -> np.ndarray:
    """(m, n) fp32 weights taking an axis of m samples to n (jax.image's
    `compute_weight_mat` with translation 0 and antialiasing on)."""
    f32 = np.float32
    inv_scale = f32(1.0 / (n / m))
    kernel_scale = max(inv_scale, f32(1.0))
    sample_f = (np.arange(n, dtype=f32) + f32(0.5)) * inv_scale - f32(0.5)
    x = np.abs(sample_f[None, :] - np.arange(m, dtype=f32)[:, None]) \
        / kernel_scale
    w = _KERNELS[method](x).astype(f32)
    total = w.sum(axis=0, keepdims=True, dtype=f32)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, f32(1)), f32(0))
    inside = (sample_f >= -0.5) & (sample_f <= f32(m - 0.5))
    return np.where(inside[None, :], w, f32(0)).astype(f32)


def _nearest_index(m: int, n: int) -> np.ndarray:
    f32 = np.float32
    return np.floor((np.arange(n, dtype=f32) + f32(0.5)) * f32(m) / f32(n)
                    ).astype(np.int64)


def _is_integer(t: torch.Tensor) -> bool:
    return not (t.dtype.is_floating_point or t.dtype.is_complex)


def resize_batch(images: torch.Tensor, size: Tuple[int, int],
                 method: str = "bilinear") -> torch.Tensor:
    """(..., H, W, C) -> (..., h, w, C) as `jax.image.resize`; uint8
    inputs round-trip uint8."""
    h, w = size
    H, W = images.shape[-3], images.shape[-2]
    dtype = images.dtype
    x = images.to(torch.float32)
    if method == "nearest":
        if H != h:
            x = x[..., torch.from_numpy(_nearest_index(H, h)).to(x.device),
                  :, :]
        if W != w:
            x = x[..., torch.from_numpy(_nearest_index(W, w)).to(x.device),
                  :]
    else:
        if method not in _KERNELS:
            raise ValueError(f'Unknown resize method "{method}"')
        if H != h:
            wh = torch.from_numpy(_weight_mat(H, h, method)).to(x.device)
            x = torch.einsum("...hwc,hy->...ywc", x, wh)
        if W != w:
            ww = torch.from_numpy(_weight_mat(W, w, method)).to(x.device)
            x = torch.einsum("...hwc,wx->...hxc", x, ww)
    if _is_integer(images):
        x = torch.clamp(torch.round(x), 0, 255)
    return x.to(dtype)


def center_crop_batch(images: torch.Tensor, size: Tuple[int, int]
                      ) -> torch.Tensor:
    """(..., H, W, C) center crop (CenterCropperPerSensor semantics)."""
    h, w = size
    H, W = images.shape[-3], images.shape[-2]
    top = (H - h) // 2
    left = (W - w) // 2
    return images[..., top:top + h, left:left + w, :]


def apply_obs_transforms(obs: dict, rgb_size: Tuple[int, int] = (224, 224),
                         depth_size: Tuple[int, int] = (128, 128)) -> dict:
    """Resize-then-center-crop per sensor, batched (the reference's
    RL.POLICY.OBS_TRANSFORMS pipeline)."""
    out = dict(obs)
    for key, size in (("rgb", tuple(rgb_size)), ("depth", tuple(depth_size))):
        if key in obs and tuple(obs[key].shape[-3:-1]) != size:
            out[key] = center_crop_batch(
                resize_batch(obs[key], _cover(tuple(obs[key].shape[-3:-1]),
                                              size)), size)
    return out


def panorama_to_equirect(views: torch.Tensor, out_size: Tuple[int, int],
                         hfov_deg: float = 90.0) -> torch.Tensor:
    """(..., V, H, W, C) ring of V horizontal views -> (..., h, w, C)
    equirectangular panorama: each output pixel takes the ring view whose
    yaw sector holds it, sampled by perspective projection (nearest
    neighbour), in fp32 as the JAX function computes it."""
    V, H, W = views.shape[-4], views.shape[-3], views.shape[-2]
    oh, ow = out_size
    dev = views.device
    pi = math.pi
    yaw = (torch.arange(ow, device=dev, dtype=torch.float32) + 0.5) / ow \
        * 2 * pi - pi
    pitch = (0.5 - (torch.arange(oh, device=dev, dtype=torch.float32) + 0.5)
             / oh) * pi
    yaw_g = yaw[None, :].expand(oh, ow)
    pitch_g = pitch[:, None].expand(oh, ow)
    sector = 2 * pi / V
    view_idx = torch.round(yaw_g / sector).to(torch.int32) % V
    rel_yaw = yaw_g - view_idx * sector
    f = (W / 2) / math.tan(math.radians(hfov_deg) / 2)
    x = f * torch.tan(rel_yaw) + W / 2
    y = -f * torch.tan(pitch_g) / torch.cos(rel_yaw) + H / 2
    xi = torch.clamp(x.to(torch.int32), 0, W - 1).long()
    yi = torch.clamp(y.to(torch.int32), 0, H - 1).long()
    return views[..., view_idx.long(), yi, xi, :]


# cubemap face order of the reference transformer
# (habitat_extensions/obs_transformers.py:213-245): Back Down Front Left
# Right Up, each a 90-degree-FOV pinhole. Vectors in habitat world frame
# (forward = -z, up = +y, right = +x): (forward, right, up) per face.
_CUBE_FACES = (
    ((0.0, 0.0, 1.0), (-1.0, 0.0, 0.0), (0.0, 1.0, 0.0)),    # Back
    ((0.0, -1.0, 0.0), (1.0, 0.0, 0.0), (0.0, 0.0, -1.0)),   # Down
    ((0.0, 0.0, -1.0), (1.0, 0.0, 0.0), (0.0, 1.0, 0.0)),    # Front
    ((-1.0, 0.0, 0.0), (0.0, 0.0, -1.0), (0.0, 1.0, 0.0)),   # Left
    ((1.0, 0.0, 0.0), (0.0, 0.0, 1.0), (0.0, 1.0, 0.0)),     # Right
    ((0.0, 1.0, 0.0), (1.0, 0.0, 0.0), (0.0, 0.0, 1.0)),     # Up
)


def equirect_directions(out_size: Tuple[int, int]) -> np.ndarray:
    """(h, w, 3) unit view directions of the equirectangular grid;
    column 0.5w looks at the Front face (-z)."""
    oh, ow = out_size
    theta = (np.arange(ow) + 0.5) / ow * 2 * np.pi - np.pi
    phi = (0.5 - (np.arange(oh) + 0.5) / oh) * np.pi
    t, p = np.meshgrid(theta, phi)                  # (oh, ow)
    return np.stack([np.cos(p) * np.sin(t), np.sin(p),
                     -np.cos(p) * np.cos(t)], axis=-1)


@functools.lru_cache(maxsize=8)
def _cube_sampling_plan(face_hw: Tuple[int, int],
                        out_size: Tuple[int, int]):
    """Static gather plan for cubemap -> equirect: per output pixel the
    4 bilinear source indices into the flattened (6*Hf*Wf) face stack and
    their weights, computed once per shape pair in numpy (callers must
    not write into the cached arrays)."""
    Hf, Wf = face_hw
    d = equirect_directions(out_size).reshape(-1, 3)        # (N, 3)
    best_dot = np.full(len(d), -np.inf)
    face = np.zeros(len(d), np.int64)
    u = np.zeros(len(d))
    v = np.zeros(len(d))
    for fi, (fwd, right, up) in enumerate(_CUBE_FACES):
        dot = d @ np.asarray(fwd)
        sel = dot > best_dot
        with np.errstate(divide="ignore", invalid="ignore"):
            uu = (d @ np.asarray(right)) / dot
            vv = -(d @ np.asarray(up)) / dot
        best_dot = np.where(sel, dot, best_dot)
        face = np.where(sel, fi, face)
        u = np.where(sel, uu, u)
        v = np.where(sel, vv, v)
    # face coords [-1,1] -> continuous pixel coords
    x = (u + 1.0) * 0.5 * Wf - 0.5
    y = (v + 1.0) * 0.5 * Hf - 0.5
    x0 = np.clip(np.floor(x), 0, Wf - 1).astype(np.int64)
    y0 = np.clip(np.floor(y), 0, Hf - 1).astype(np.int64)
    x1 = np.minimum(x0 + 1, Wf - 1)
    y1 = np.minimum(y0 + 1, Hf - 1)
    wx = np.clip(x - x0, 0.0, 1.0)
    wy = np.clip(y - y0, 0.0, 1.0)
    base = face * (Hf * Wf)
    idx = np.stack([base + y0 * Wf + x0, base + y0 * Wf + x1,
                    base + y1 * Wf + x0, base + y1 * Wf + x1])  # (4, N)
    w = np.stack([(1 - wy) * (1 - wx), (1 - wy) * wx,
                  wy * (1 - wx), wy * wx]).astype(np.float32)   # (4, N)
    return idx, w


def cubemap_to_equirect(faces: torch.Tensor, out_size: Tuple[int, int]
                        ) -> torch.Tensor:
    """(..., 6, Hf, Wf, C) cubemap (face order Back, Down, Front, Left,
    Right, Up — habitat_extensions/obs_transformers.py:213-245) ->
    (..., h, w, C) equirectangular projection: 4 gathers by the cached
    plan and their weighted sum in fp32. uint8 inputs round-trip uint8
    (rgb); float passes through (depth)."""
    *lead, six, Hf, Wf, C = faces.shape
    if six != 6:
        raise ValueError(f"expected 6 cube faces, got {six}")
    oh, ow = out_size
    idx, w = _cube_sampling_plan((Hf, Wf), (oh, ow))
    idx = torch.from_numpy(idx).to(faces.device)
    w = torch.from_numpy(w).to(faces.device)
    flat = faces.reshape(-1, 6 * Hf * Wf, C)
    out = torch.zeros((flat.shape[0], idx.shape[1], C), dtype=torch.float32,
                      device=faces.device)
    for corner in range(4):
        out = out + w[corner][None, :, None] * flat.index_select(
            1, idx[corner]).to(torch.float32)
    if _is_integer(faces):
        out = torch.clamp(torch.round(out), 0, 255)
    return out.to(faces.dtype).reshape(tuple(lead) + (oh, ow, C))


def _cover(cur: Tuple[int, int], target: Tuple[int, int]) -> Tuple[int, int]:
    """Smallest proportional resize covering target (resize shorter side)."""
    ch, cw = cur
    th, tw = target
    scale = max(th / ch, tw / cw)
    return max(int(round(ch * scale)), th), max(int(round(cw * scale)), tw)
