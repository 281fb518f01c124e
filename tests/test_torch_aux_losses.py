"""The port's `utils/aux_losses.py` against `etpnav_tpu/utils/aux_losses.py`:
the cases of tests/test_utils_misc.py on the port, then both registries
fed the same seeded losses and masks (fp32, 1e-6)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from etpnav_tpu.utils.aux_losses import AuxLosses as JaxAuxLosses
from etpnav_tpu_torch.utils.aux_losses import AuxLosses

torch.set_num_threads(2)


def test_aux_losses_registry():
    al = AuxLosses()
    al.register("ignored", torch.ones(3))         # inactive -> no-op
    assert not al.is_active and al._losses == {}
    al.activate()
    al.register("a", torch.tensor([1.0, 3.0]), weight=2.0)
    al.register("b", torch.tensor([2.0, 4.0, 0.0]), weight=1.0,
                mask=torch.tensor([1.0, 1.0, 0.0]))
    total = float(al.reduce())
    assert total == 2.0 * 2.0 + 3.0       # 2*mean(1,3) + masked-mean(2,4)
    np.testing.assert_allclose(al.get("a").numpy(), [1.0, 3.0])
    al.deactivate()
    al.clear()
    assert al._losses == {}


def test_aux_losses_reduce_applies_mask():
    al = AuxLosses()
    al.activate()
    al.register("a", torch.tensor([1.0, 3.0, 100.0]), weight=2.0)
    al.register("b", torch.tensor([2.0, 4.0, 6.0]), weight=1.0,
                mask=torch.tensor([1.0, 1.0, 0.0]))
    total = float(al.reduce(mask=torch.tensor([True, True, False])))
    assert total == 2.0 * 2.0 + 3.0
    # the reduce mask narrows the registration mask, not replaces it
    total2 = float(al.reduce(mask=torch.tensor([True, False, True])))
    assert total2 == 2.0 * ((1.0 + 100.0) / 2) + 2.0


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_aux_losses_match_jax(seed):
    rng = np.random.default_rng(seed)
    losses = {n: rng.random((4, 5)).astype(np.float32) for n in "abc"}
    masks = {"a": None, "b": rng.random((4, 5)) > 0.5,
             "c": np.zeros((4, 5), bool)}          # all masked -> 0
    weights = {"a": 0.5, "b": 2.0, "c": 3.0}
    reduce_mask = rng.random((4, 1)) > 0.3
    jal, al = JaxAuxLosses(), AuxLosses()
    jal.activate()
    al.activate()
    for n in "abc":
        m = masks[n]
        jal.register(n, jnp.asarray(losses[n]), weights[n],
                     None if m is None else jnp.asarray(m))
        al.register(n, torch.from_numpy(losses[n]), weights[n],
                    None if m is None else torch.from_numpy(m))
    for rm in (None, reduce_mask):
        want = float(jal.reduce(None if rm is None else jnp.asarray(rm)))
        got = float(al.reduce(None if rm is None else torch.from_numpy(rm)))
        np.testing.assert_allclose(got, want, rtol=1e-6)


def test_aux_losses_keep_gradients():
    x = torch.tensor([1.0, 2.0, 3.0], requires_grad=True)
    al = AuxLosses()
    al.activate()
    al.register("sq", x * x, weight=0.5, mask=torch.tensor([1.0, 1.0, 0.0]))
    al.reduce().backward()
    np.testing.assert_allclose(x.grad.numpy(), [0.5, 1.0, 0.0])
