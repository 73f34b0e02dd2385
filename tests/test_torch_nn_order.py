"""The nearest-neighbour kernels' layout step and culling bound
(``dusty_gan_torch.metrics.chamfer_cuda``) on the CPU.

Before the kernels K2 and K3 run, the wrapper orders both clouds along a
Morton curve (a stable sort), pads the partners to whole groups of 32 and
boxes each group (``nn_layout``); the kernels search the sorted clouds, skip
the groups whose box is provably farther than a query's minimum, take the
smallest original index among the partners at the minimum, and write at the
queries' original positions.  ``nn_layout_reference`` is the plain version
of that search on the layout.

* The round trip (layout, search, unpermute, map the indices back) equals
  ``nn_reference`` on the original clouds bit for bit, distances and
  first-occurrence indices, also with duplicate points at the origin and
  exact ties between distinct points on a lattice; and agrees with the JAX
  package's ``nn_pallas`` in interpret mode (distances rtol 1e-5 / atol
  1e-6, as tests/test_torch_chamfer.py; indices equal).
* The culling bound never exceeds the distance of any pair of members of
  its two boxes (a hypothesis property over clouds made from numpy seeds).
* ``_fma``, the plain version's single-rounding fma, equals the exactly
  rounded result.
"""

from fractions import Fraction

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from dusty_gan_tpu.metrics.chamfer_pallas import nn_pallas

from torch_parity import one_torch_thread  # noqa: F401  (autouse)
from dusty_gan_torch.metrics import chamfer_cuda
from dusty_gan_torch.metrics.chamfer_cuda import (GROUP, _fma, _sq_dist_fma, box_lower_bound,
                                                  morton_order, nn_layout,
                                                  nn_layout_reference, nn_reference)

TOL_NN = dict(rtol=1e-5, atol=1e-6)


def _uniform(seed, b, n, origin=0.0):
    """Unit-scale clouds with a share ``origin`` of the points exactly at the
    origin."""
    rng = np.random.RandomState(seed)
    p = rng.uniform(-1, 1, (b, n, 3)).astype(np.float32)
    p[rng.uniform(size=(b, n)) < origin] = 0.0
    return p


def _lattice(seed, b, n, side):
    """Points of the lattice (Z / 8)^3 in [-side/8, side/8]^3, drawn with
    repeats: distinct points at exactly equal distances, and duplicates."""
    rng = np.random.RandomState(seed)
    return (rng.randint(-side, side + 1, (b, n, 3)) / 8.0).astype(np.float32)


CASES = {
    "origin_duplicates": lambda: (
        np.concatenate([0.05 * _uniform(0, 2, 150), _uniform(1, 2, 150, origin=0.3)], axis=1),
        _uniform(2, 2, 700, origin=0.3)),
    "lattice_ties": lambda: (_lattice(3, 2, 300, 6), _lattice(4, 2, 400, 4)),
    "ragged": lambda: (_uniform(5, 3, 100), _uniform(6, 3, 77)),
    "group_minus_one": lambda: (_uniform(7, 2, 64), _uniform(8, 2, GROUP - 1)),
    "group_plus_one": lambda: (_uniform(9, 2, 1), _uniform(10, 2, GROUP + 1)),
    "n_much_larger": lambda: (_uniform(11, 1, 2000), _uniform(12, 1, 5)),
    "m_much_larger": lambda: (_uniform(13, 1, 7), _uniform(14, 1, 3000)),
    "all_at_origin": lambda: (np.zeros((2, 50, 3), np.float32), np.zeros((2, 70, 3), np.float32)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_layout_round_trip_equals_nn_reference(case):
    x, y = (torch.from_numpy(a) for a in CASES[case]())
    want_d, want_i = nn_reference(x, y)
    got_d, got_i = nn_layout_reference(nn_layout(x, y))
    assert got_d.dtype == torch.float32 and got_i.dtype == torch.int32
    assert torch.equal(got_d, want_d)
    assert torch.equal(got_i, want_i)


@pytest.mark.parametrize("case", ["origin_duplicates", "lattice_ties", "ragged",
                                  "all_at_origin"])
def test_layout_round_trip_matches_jax(case):
    x, y = CASES[case]()
    want_d, want_i = nn_pallas(jnp.asarray(x), jnp.asarray(y), interpret=True, need_idx=True)
    got_d, got_i = nn_layout_reference(nn_layout(torch.from_numpy(x), torch.from_numpy(y)))
    np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d), **TOL_NN)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))


def test_tie_cases_have_ties_out_of_morton_order():
    """The lattice case ties distinct partners, and for some queries the
    first tied partner in original order is not the first in Morton order:
    there the smallest-original-index rule is what keeps K3 exact."""
    x, y = (torch.from_numpy(a) for a in CASES["lattice_ties"]())
    lay = nn_layout(x, y)
    d = _sq_dist_fma(lay.xs, lay.ys)
    at_min = d == d.amin(dim=2, keepdim=True)
    first_sorted = lay.yidx.gather(1, at_min.int().argmax(dim=2))
    smallest = torch.where(at_min, lay.yidx[:, None, :], 1 << 30).amin(dim=2)
    assert bool((at_min.sum(dim=2) > 1).any())
    assert bool((first_sorted != smallest).any())


def test_morton_order_is_a_stable_sort_of_the_codes():
    x = torch.from_numpy(_uniform(15, 2, 500, origin=0.3))
    x[:, 400:] = x[:, 10:110]  # duplicates after their originals
    (order,) = morton_order(x)
    codes = chamfer_cuda.morton_codes(x)
    for b in range(2):
        assert torch.equal(order[b].sort().values, torch.arange(500))
        c = codes[b][order[b]]
        assert bool((c[1:] >= c[:-1]).all())
        same = c[1:] == c[:-1]
        assert bool((order[b][1:][same] > order[b][:-1][same]).all())  # stable
    # two batches of one size share one sort and give the same orders
    a, b = morton_order(x, x.flip(0))
    assert torch.equal(a, order) and torch.equal(b, order.flip(0))


def test_layout_pads_whole_groups_and_boxes_them():
    x, y = (torch.from_numpy(a) for a in CASES["ragged"]())
    lay = nn_layout(x, y)
    groups = -(-77 // GROUP)
    assert lay.ys.shape == (3, groups * GROUP, 3) and lay.boxes.shape == (3, groups, 6)
    assert lay.xpos.dtype == lay.yidx.dtype == lay.gmin.dtype == torch.int32
    for b in range(3):
        assert torch.equal(lay.xpos[b].sort().values, torch.arange(100, dtype=torch.int32))
        assert torch.equal(lay.yidx[b, :77].sort().values, torch.arange(77, dtype=torch.int32))
        assert bool((lay.yidx[b, 77:] == lay.yidx[b, 76]).all())  # copies of the last
        assert torch.equal(lay.ys[b], y[b, lay.yidx[b].long()])
        assert torch.equal(lay.xs[b], x[b, lay.xpos[b].long()])
    grouped = lay.ys.view(3, groups, GROUP, 3)
    assert torch.equal(lay.boxes[..., :3], grouped.amin(2))
    assert torch.equal(lay.boxes[..., 3:], grouped.amax(2))
    assert torch.equal(lay.gmin, lay.yidx.view(3, groups, GROUP).amin(2))


def test_layout_reference_chunks_m(monkeypatch):
    x, y = (torch.from_numpy(a) for a in CASES["origin_duplicates"]())
    lay = nn_layout(x, y)
    full = nn_layout_reference(lay)
    monkeypatch.setattr(chamfer_cuda, "_REFERENCE_BUDGET", 300 * 2 * 50)
    for got, want in zip(nn_layout_reference(lay), full):
        assert torch.equal(got, want)
    assert nn_layout_reference(lay, need_idx=False)[1] is None


# The kernels skip a partner group when this bound is at least a query's
# minimum (K2) or above it (K3's index pass).  That is exact because the
# bound is computed by the distance's own sequence of roundings on the gap
# between the boxes: subtraction, multiplication and FMA round
# monotonically, so for q in box A and p in box P, |fl(q - p)| >=
# max(fl(A.lo - P.hi), fl(P.lo - A.hi), 0) on each axis, and squaring and
# the two FMAs keep the order.  Clouds here span many scales and offsets,
# and snapping to a coarse grid makes boxes touch and coordinates repeat.
@settings(max_examples=300, deadline=None, derandomize=True, database=None)
@given(seed=st.integers(0, 2 ** 31 - 1), n=st.integers(1, 40), m=st.integers(1, 40),
       log_scale=st.integers(-30, 30), gap=st.floats(-2.0, 2.0), snap=st.booleans())
def test_box_lower_bound_never_exceeds_member_distance(seed, n, m, log_scale, gap, snap):
    rng = np.random.RandomState(seed)
    scale = np.float32(2.0 ** log_scale)
    a = rng.standard_normal((n, 3)).astype(np.float32)
    p = (rng.standard_normal((m, 3)) + np.float32(gap) * rng.standard_normal(3)).astype(np.float32)
    if snap:
        a, p = np.round(a * 4) / 4, np.round(p * 4) / 4
    a, p = torch.from_numpy((a * scale).astype(np.float32)), torch.from_numpy(
        (p * scale).astype(np.float32))
    d = _sq_dist_fma(a, p)  # (n, m)
    lb = box_lower_bound(a.amin(0), a.amax(0), p.amin(0), p.amax(0))
    assert float(lb) <= float(d.min())
    # K3's per-point test: one query against the partners' box
    lb_point = box_lower_bound(a, a, p.amin(0), p.amax(0))  # (n,)
    assert bool((lb_point <= d.amin(dim=1)).all())


def _exactly_rounded(a, b, c):
    """fma(a, b, c) rounded once to float32, by exact rational arithmetic."""
    ex = Fraction(float(a)) * Fraction(float(b)) + Fraction(float(c))
    f = np.float32(float(ex))
    cands = [np.nextafter(f, np.float32(-np.inf)), f, np.nextafter(f, np.float32(np.inf))]
    # nearest, ties to even
    return min(cands, key=lambda v: (abs(Fraction(float(v)) - ex), int(v.view(np.int32)) & 1))


@pytest.mark.parametrize("spread", [0, 8, 40])
def test_fma_rounds_once(spread):
    """Products and addends ``spread`` binary orders of magnitude apart."""
    rng = np.random.RandomState(16 + spread)
    a = (rng.standard_normal(400) * 2.0 ** rng.randint(-spread - 1, spread + 1, 400))
    c = (rng.standard_normal(400) * 2.0 ** rng.randint(-spread - 1, spread + 1, 400))
    a, c = a.astype(np.float32), c.astype(np.float32)
    got = _fma(torch.from_numpy(a), torch.from_numpy(a), torch.from_numpy(c)).numpy()
    want = np.array([_exactly_rounded(x, x, z) for x, z in zip(a, c)], np.float32)
    np.testing.assert_array_equal(got, want)
