"""On the card: the CRT pipeline's base conversions (csrc/limb_digits.cu,
ops/limb_kernels.py limb_digits and limb_planes) against their plain
versions, bit for bit, with one launch a call.

Skipped without a CUDA device.  This file imports neither JAX nor the
JAX package; on the card run it without the suite's conftest, which
imports JAX:

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_limb_conversions_card.py
"""

import numpy as np
import pytest
import torch

from sdpb_tpu_torch.mp import limb
from sdpb_tpu_torch.ops import limb_kernels as lk

from torch_limb_inputs import digit_inputs, plan_sizes, plane_inputs

# The main path's calls at --precision 400 (47 slots): the batch shapes
# of one nmax6 iteration's digits_dev and planes_to_limb calls.
MAIN_BATCHES = [(11, 16, 16), (11, 15, 15), (11, 31, 31), (11, 31, 20),
                (341, 20)]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this test runs on the card")
    return torch.device("cuda")


def _same(got, want):
    return torch.equal(got.nan_to_num(0.0, 1.0, -1.0),
                       want.nan_to_num(0.0, 1.0, -1.0)) and torch.equal(
        got.isnan(), want.isnan())


def _check(card, batch, S, seed):
    """digits_dev and planes_to_limb on the card at one batch shape and
    S: each one launch, each its plain version's bits."""
    n_digits, shift, P = plan_sizes(S)
    n = int(np.prod(batch))
    rng = np.random.default_rng(seed)
    x = digit_inputs(rng, max(n, 7), S, n_digits)[:n]
    x = x.reshape(*batch, S).to(card)
    planes = plane_inputs(rng, max(n, 5), P)[:n].reshape(*batch, P).to(card)
    lk.reset_launches()
    got = limb.digits_dev(x, shift, n_digits)
    assert lk.LAUNCHES["limb_digits"] == 1
    assert torch.equal(got, limb.digits_dev_plain(x, shift, n_digits))
    got = limb.planes_to_limb(planes, 2 * shift, S)
    assert lk.LAUNCHES["limb_planes"] == 1
    assert sum(lk.LAUNCHES.values()) == 2
    assert _same(got, limb.planes_to_limb_plain(planes, 2 * shift, S))
    assert got.shape == (*batch, S) and torch.isfinite(got).all()


@pytest.mark.card
@pytest.mark.parametrize("batch", MAIN_BATCHES)
def test_conversions_at_main_path_shapes(card, batch):
    _check(card, batch, 47, 7 + len(batch))


@pytest.mark.card
@pytest.mark.parametrize("S", [116, 230, 458])
def test_conversions_in_every_slot_class(card, S):
    _check(card, (3, 5, 7), S, S)


@pytest.mark.card
@pytest.mark.parametrize("S", [4, 47, 116, 458])
def test_conversions_of_one_value(card, S):
    n_digits, shift, P = plan_sizes(S)
    for i in range(7):
        rng = np.random.default_rng(i)
        x = digit_inputs(rng, 7, S, n_digits)[i:i + 1].to(card)
        planes = plane_inputs(rng, 7, P)[i % 5:i % 5 + 1].to(card)
        lk.reset_launches()
        got_digits = limb.digits_dev(x, shift, n_digits)
        got_limbs = limb.planes_to_limb(planes, 2 * shift, S)
        assert lk.LAUNCHES["limb_digits"] == lk.LAUNCHES["limb_planes"] == 1
        assert torch.equal(got_digits,
                           limb.digits_dev_plain(x, shift, n_digits))
        assert _same(got_limbs,
                     limb.planes_to_limb_plain(planes, 2 * shift, S))
