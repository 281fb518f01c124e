"""K-NMS's candidate slots (`etpnav_tpu_torch.ops.fused_nms`) against the
JAX package.

K-NMS writes the wrapped NMS map and the K candidate slots
`(angle_idx, dist_idx, valid)` in one launch; its plain version,
`heatmap_candidates_plain`, is `heatmap_nms_plain` followed by
`extract_candidates(map[:, 1:-1, :], K)`, and the CPU wrapper runs it.
Here it is held to JAX's `heatmap_to_candidates` (its XLA path on the CPU)
and to `extract_candidates` of the Pallas map (interpret mode), on random
logits and on crafted ones: a peak on a wrap row, probabilities that
underflow to 0, exact ties, fewer than K valid slots. The slots are
integers: every slot compare is exact. Maps agree to 1e-7 (the softmaxes
sum in another order). chip_smoke.py holds the kernel to the plain
version on the card, bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from etpnav_tpu.config import tiny_config as jax_tiny_config
from etpnav_tpu.models import waypoint as jwaypoint
from etpnav_tpu.ops import nms as jnms
from etpnav_tpu.ops.pallas_nms import fused_heatmap_nms
from etpnav_tpu_torch.config import tiny_config
from etpnav_tpu_torch.models import waypoint
from etpnav_tpu_torch.ops import fused_nms as tfn

torch.set_num_threads(2)

K, SIGMA = 5, (7.0, 5.0)
A, D = 120, 12


def _t(a):
    return torch.from_numpy(np.asarray(a).copy())


def _jax_slots(logits):
    """(angle_idx, dist_idx, valid) of JAX's `heatmap_to_candidates` and
    of `extract_candidates` over the Pallas kernel's map, and that map."""
    jcfg = jax_tiny_config().waypoint
    xla = jwaypoint.heatmap_to_candidates(jcfg, jnp.asarray(logits))
    pallas_map = fused_heatmap_nms(jnp.asarray(logits), K, SIGMA,
                                   interpret=True)
    pallas = jnms.extract_candidates(pallas_map[:, 1:-1, :], K)
    return ([np.asarray(xla[k]) for k in ("angle_idx", "dist_idx", "valid")],
            [np.asarray(s) for s in pallas], np.asarray(pallas_map),
            np.asarray(xla["nms_map"]))


def _check(logits):
    nms_map, *slots = tfn.heatmap_nms_fused(_t(logits), K, SIGMA)
    assert nms_map.shape == (logits.shape[0], A + 2, D)
    assert [s.dtype for s in slots] == [torch.int64, torch.int64,
                                        torch.bool]
    xla, pallas, pallas_map, xla_map = _jax_slots(logits)
    for want in (xla, pallas):
        for got, w in zip(slots, want):
            np.testing.assert_array_equal(got.numpy(), w)
    np.testing.assert_array_equal(nms_map.numpy() > 0, pallas_map > 0)
    np.testing.assert_allclose(nms_map.numpy(), pallas_map, atol=1e-7)
    np.testing.assert_allclose(nms_map[:, 1:-1].numpy(), xla_map, atol=1e-7)
    return nms_map.numpy(), [s.numpy() for s in slots]


@pytest.mark.parametrize("B", [1, 7, 8])
def test_slots_match_jax_on_random_logits(rng, B):
    logits = (rng.standard_normal((B, A, D)) * 3).astype(np.float32)
    _, (angle, dist, valid) = _check(logits)
    assert valid.all()
    # row-major order: the flat indices of the slots ascend
    flat = angle * D + dist
    assert (np.diff(flat, axis=1) > 0).all()


def test_slots_match_port_heatmap_to_candidates(rng):
    """`heatmap_to_candidates` takes its slots from the K-NMS wrapper."""
    cfg = tiny_config().waypoint
    logits = (rng.standard_normal((4, A, D)) * 3).astype(np.float32)
    cands = waypoint.heatmap_to_candidates(cfg, _t(logits))
    nms_map, *slots = tfn.heatmap_candidates_plain(_t(logits), K, SIGMA)
    for key, s in zip(("angle_idx", "dist_idx", "valid"), slots):
        np.testing.assert_array_equal(cands[key].numpy(), s.numpy())
    np.testing.assert_array_equal(cands["nms_map"].numpy(),
                                  nms_map[:, 1:-1].numpy())


def test_peak_on_a_wrap_row_is_no_slot(rng):
    """The global peak on original row A-1 appears first on wrapped row 0
    (the lower index): it is written to the map there but is no slot; its
    copy on wrapped row A is a slot of the next round. A peak on row 0
    (column 9, outside the first peak's suppressed columns 0..7) is a slot
    on wrapped row 1, and its copy on wrapped row A+1 a map entry only."""
    logits = (rng.standard_normal((2, A, D)) * 0.1).astype(np.float32)
    logits[:, A - 1, 0] = 9.0
    logits[1, 0, 9] = 8.0
    nms_map, (angle, dist, valid) = _check(logits)
    for b in range(2):
        assert nms_map[b, 0, 0] > 0 and nms_map[b, A, 0] > 0
        assert (A - 1, 0) in zip(angle[b][valid[b]], dist[b][valid[b]])
        assert valid[b].sum() < (nms_map[b] > 0).sum()
    assert nms_map[1, 1, 9] > 0 and nms_map[1, A + 1, 9] > 0
    assert (0, 9) in zip(angle[1][valid[1]], dist[1][valid[1]])


def test_underflowed_peaks_are_no_slots():
    """One cell holds all the mass: every other probability underflows to
    0, so later rounds pick zeros, which are written as 0 and are no slot:
    fewer than K valid slots, the rest (0, 0, False)."""
    logits = np.full((3, A, D), -1000.0, np.float32)
    logits[0, 50, 3] = 0.0
    logits[1, 10, 0] = 0.0
    logits[1, 90, 11] = 0.0          # two cells share the mass
    logits[2, 0, 0] = 0.0            # on row 0: also on wrapped row A+1
    nms_map, (angle, dist, valid) = _check(logits)
    assert valid.sum(axis=1).tolist() == [1, 2, 1]
    assert (angle[0, 0], dist[0, 0]) == (50, 3)
    assert [(angle[1, i], dist[1, i]) for i in range(2)] == [(10, 0),
                                                             (90, 11)]
    assert (angle[2, 0], dist[2, 0]) == (0, 0)
    for b, n in enumerate((1, 2, 1)):
        assert (angle[b, n:] == 0).all() and (dist[b, n:] == 0).all()
        assert not valid[b, n:].any()


def test_exact_ties_take_the_first_index():
    """Equal logits: every round's argmax is the first unsuppressed cell
    in row-major order of the wrapped map."""
    logits = np.zeros((2, A, D), np.float32)
    logits[1, 30:40, :] = 1.0        # a plateau of equal maxima
    _check(logits)


def test_cpu_wrapper_routes_to_plain_version(rng):
    logits = _t((rng.standard_normal((2, A, D)) * 3).astype(np.float32))
    before = (tfn.heatmap_nms_launches.value,
              tfn.heatmap_nms_plain_calls.value)
    got = tfn.heatmap_nms_fused(logits, K, SIGMA)
    assert tfn.heatmap_nms_launches.value == before[0]
    assert tfn.heatmap_nms_plain_calls.value == before[1] + 1
    want = tfn.heatmap_candidates_plain(logits, K, SIGMA)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    with pytest.raises(ValueError, match="device"):
        tfn.heatmap_nms_fused(torch.empty(2, A, D, device="meta"))
