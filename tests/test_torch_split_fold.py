"""The lane splits of the port's two CUDA kernels against their serial
rules, in plain torch on the CPU.

- ``csrc/mesh_hit.cu`` (nearest hit): the serial rule walks a spin's row
  in record order and keeps the first minimum (strict ``<``). The kernel
  gives a spin L lanes (L in 1, 2, 4, ..., 32): lane j tests records j, j
  + L, ... of each staged stage, keeps its own first minimum, and the L
  lanes reduce by (t, record) with an xor butterfly.
- ``csrc/fused_epoch.cu`` (epoch fold): the serial rule walks (unit c,
  group g, sublane r) and replaces the running best when ``t < best`` or
  ``t == best`` with a lower r. The kernel gives a spin 8 lanes: lane r
  folds sublane r of every (c, g) with the same compare, and the 8 lanes
  reduce by (t, r) with an xor butterfly.

The t values come from a small set, so exact ties are common. Each
emulation follows the kernel's indexing, and every lane must end with
the serial winner. A crafted epoch (``chip_smoke.fused_tie_case``, equal t
at two sublanes and across two units) also runs through the plain epoch,
which must pick the serial winners, and the quad-major table copy that
the epoch kernel reads is checked element by element.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from disimpy_tpu_torch.engine import fused_kernel

import torch_threads  # noqa: F401  (shares the cores among xdist workers)

INF = float("inf")
# Distances drawn for the rows: a small set, misses (inf) included.
T_SET = np.array([0.25, 0.5, 0.5, 0.75, INF, INF])


def _rows(seed, n_rows, width):
    rng = np.random.RandomState(seed)
    return torch.tensor(rng.choice(T_SET, size=(n_rows, width)))


def _butterfly(best, key, lanes, take):
    """xor-butterfly reduction over the last dimension (``lanes`` wide):
    in each round a lane takes its partner's (best, key) where
    ``take(partner, own)`` holds."""
    lane = torch.arange(lanes)
    off = lanes // 2
    while off:
        partner = lane ^ off
        b_o, k_o = best[:, partner], key[:, partner]
        swap = take(b_o, k_o, best, key)
        best = torch.where(swap, b_o, best)
        key = torch.where(swap, k_o, key)
        off //= 2
    return best, key


def _lexicographic(b_o, k_o, b, k):
    return (b_o < b) | ((b_o == b) & (k_o < k))


# ---------------------------------------------------------------------------
# mesh_hit: strided split over L lanes
# ---------------------------------------------------------------------------


def _serial_first_min(t):
    """The serial rule: (min t, first record reaching it), -1 for none."""
    n, width = t.shape
    best = torch.full((n,), INF, dtype=t.dtype)
    best_k = torch.full((n,), -1)
    for k in range(width):
        take = t[:, k] < best
        best = torch.where(take, t[:, k], best)
        best_k = torch.where(take, torch.tensor(k), best_k)
    return best, best_k


def _mesh_hit_split(t, L, stage):
    """The kernel's split: per stage of ``stage`` records starting at k0,
    lane j tests the local records (j - k0) & (L - 1), + L, ...; then the
    butterfly over the L lanes."""
    n, width = t.shape
    best = torch.full((n, L), INF, dtype=t.dtype)
    best_k = torch.full((n, L), -1)
    for k0 in range(0, width, stage):
        nrec = min(stage, width - k0)
        for j in range(L):
            for kl in range((j - k0) & (L - 1), nrec, L):
                k = k0 + kl
                take = t[:, k] < best[:, j]
                best[:, j] = torch.where(take, t[:, k], best[:, j])
                best_k[:, j] = torch.where(take, torch.tensor(k), best_k[:, j])
    return _butterfly(best, best_k, L, _lexicographic)


@pytest.mark.parametrize("L", [1, 2, 4, 8, 16, 32])
def test_mesh_hit_lane_split_equals_serial_rule(L):
    # Row lengths around the bench bundle's (0-316 records, stages of 46),
    # with stages that L does not divide.
    for width, stage in ((1, 46), (45, 46), (47, 46), (317, 46), (100, 64)):
        t = _rows(seed=L * 1000 + width, n_rows=64, width=width)
        want_t, want_k = _serial_first_min(t)
        got_t, got_k = _mesh_hit_split(t, L, stage)
        for j in range(L):  # every lane ends with the serial winner
            assert torch.equal(got_t[:, j], want_t)
            assert torch.equal(got_k[:, j], want_k)
    # Exact ties between lanes are common in these rows.
    assert int((t == t.min(dim=1, keepdim=True).values).sum(dim=1).gt(1).sum())


# ---------------------------------------------------------------------------
# fused_epoch: split by sublane r over 8 lanes
# ---------------------------------------------------------------------------


def _fold_take(t, r, best, best_r):
    return (t < best) | ((t == best) & (r < best_r))


def _fused_serial(t):
    """The serial rule over t (n, units, 8 groups, 8 sublanes): returns
    (best t, winning slot c * 64 + g * 8 + r or -1)."""
    n, units = t.shape[:2]
    best = torch.full((n,), INF, dtype=t.dtype)
    best_r = torch.full((n,), 8)
    slot = torch.full((n,), -1)
    for c in range(units):
        for g in range(8):
            for r in range(8):
                take = (t[:, c, g, r] < INF) & _fold_take(
                    t[:, c, g, r], torch.tensor(r), best, best_r)
                best = torch.where(take, t[:, c, g, r], best)
                best_r = torch.where(take, torch.tensor(r), best_r)
                slot = torch.where(take, torch.tensor(c * 64 + g * 8 + r),
                                   slot)
    return best, slot


def _fused_split(t):
    """The kernel's split: lane r folds sublane r of every (c, g) with the
    serial compare, then the butterfly over the 8 lanes by (t, r), the
    slot riding along."""
    n, units = t.shape[:2]
    best = torch.full((n, 8), INF, dtype=t.dtype)
    best_r = torch.full((n, 8), 8)
    slot = torch.full((n, 8), -1)
    for r in range(8):
        for c in range(units):
            for g in range(8):
                x = t[:, c, g, r]
                take = (x < INF) & _fold_take(x, torch.tensor(r), best[:, r],
                                              best_r[:, r])
                best[:, r] = torch.where(take, x, best[:, r])
                best_r[:, r] = torch.where(take, torch.tensor(r), best_r[:, r])
                slot[:, r] = torch.where(
                    take, torch.tensor(c * 64 + g * 8 + r), slot[:, r])
    # The (t, r) pair decides; r identifies the lane, so the slot follows.
    key = best_r * 100000 + slot.clamp(min=0)
    best, key = _butterfly(
        best, key, 8, lambda b_o, k_o, b, k: _lexicographic(
            b_o, k_o // 100000, b, k // 100000))
    return best, torch.where(key // 100000 < 8, key % 100000, -1)


@pytest.mark.parametrize("units", [1, 2, 5, 17])
def test_fused_sublane_split_equals_serial_rule(units):
    t = _rows(seed=units, n_rows=64, width=units * 64).reshape(64, units, 8, 8)
    want_t, want_slot = _fused_serial(t)
    got_t, got_slot = _fused_split(t)
    for r in range(8):
        assert torch.equal(got_t[:, r], want_t)
        assert torch.equal(got_slot[:, r], want_slot)
    # Ties at the minimum across sublanes and across units occur.
    at_min = t == want_t[:, None, None, None]
    assert int((at_min.sum(dim=(1, 2, 3)) > 1).sum()) > 0


def test_plain_epoch_resolves_crafted_ties_serially():
    spec, args, want = chip_smoke.fused_tie_case("cpu")
    pos, exc, crossings = fused_kernel.fused_epoch(spec, *args)  # CPU: plain
    assert torch.equal(pos, want)
    assert not bool(exc.any())
    assert int(crossings.sum()) == 0


def test_quad_major_table_layout():
    """The kernel's copy of the table: quad q of triangle 8g + r of a unit
    at (g, q, r), one copy per table tensor."""
    table = torch.randn((3, 8, 128))
    copy = fused_kernel.quad_major(table)
    assert copy.is_contiguous() and copy.shape == (3, 8, 4, 8, 4)
    for g in range(8):
        for q in range(4):
            for r in range(8):
                lo = 16 * g + 4 * q
                assert torch.equal(copy[:, g, q, r], table[:, r, lo:lo + 4])
    assert fused_kernel.quad_major(table) is copy
    other = table.clone()
    assert fused_kernel.quad_major(other) is not copy
    assert torch.equal(fused_kernel.quad_major(other), copy)
