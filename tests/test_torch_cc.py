"""K5 and K6 (the port's ``ops/cc.py``) and the 2-D component helpers
(``ops/components.py``) against the JAX package, on the CPU.

The plain versions are held against the Pallas kernels run as
``tests/test_pallas_kernels.py`` runs them (``interpret=True``): labels are
integers, so they must be equal in every pixel, including where the
relaxation caps bind. Masks come from numpy with a seed and go to both
sides.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from path_gene_multimodal_tpu.ops import components as jcomp
from path_gene_multimodal_tpu.ops.pallas.cc import (
    pallas_label_components,
    pallas_label_components_tiled,
)
from path_gene_multimodal_tpu_torch.ops import cc as tcc
from path_gene_multimodal_tpu_torch.ops import components as tcomp
from path_gene_multimodal_tpu_torch.ops.cc_sizes import cc_sizes_plain

T = torch.from_numpy
CONN = pytest.mark.parametrize("connectivity", [1, 2])


def _spiral(n: int) -> np.ndarray:
    """A 1-px square spiral with 1-px gaps between its arms: its labels need
    about one relaxation per turn, so small caps bind."""
    m = np.zeros((n, n), bool)
    y = x = d = turns = 0
    dirs = ((0, 1), (1, 0), (0, -1), (-1, 0))
    m[0, 0] = True
    inside = lambda a, b: 0 <= a < n and 0 <= b < n  # noqa: E731
    while turns < 2:
        dy, dx = dirs[d]
        ny, nx, ay, ax = y + dy, x + dx, y + 2 * dy, x + 2 * dx
        if inside(ny, nx) and not m[ny, nx] and not (inside(ay, ax) and m[ay, ax]):
            y, x, turns = ny, nx, 0
            m[y, x] = True
        else:
            d, turns = (d + 1) % 4, turns + 1
    return m


def _snake_mask(rng) -> np.ndarray:
    """``tests/test_pallas_kernels.py``'s 70x90 mask: random, plus a snake
    that crosses every 32-px tile border several times."""
    mask = rng.random((70, 90)) > 0.55
    mask[10, :] = True
    mask[:, 40] = True
    mask[50, 5:85] = True
    return mask


# ---------------------------------------------------------------- K6


@CONN
def test_k6_plain_matches_pallas_interpret(connectivity):
    rng = np.random.default_rng(60 + connectivity)
    mask = rng.random((4, 32, 48)) > 0.5
    mask[1] = False  # empty tile
    mask[2] = True  # full tile
    mask[3] = _spiral(48)[:32]
    ref = np.asarray(pallas_label_components(jnp.asarray(mask), connectivity, interpret=True))
    counts = torch.zeros(2, dtype=torch.int64)
    got = tcc.label_components_batch(T(mask), connectivity, counts=counts)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)
    # one relaxation for the empty tile, at least two for the others
    assert counts[1] == 1 and counts[0] >= 1 + 3 * 2


@CONN
def test_k6_relaxation_cap_matches_pallas(connectivity):
    """At ``max_iters=3`` the spiral tile stops unconverged, on both sides."""
    mask = _spiral(40)[None]
    ref = np.asarray(pallas_label_components(jnp.asarray(mask), connectivity, max_iters=3,
                                             interpret=True))
    counts = torch.zeros(2, dtype=torch.int64)
    got = tcc.label_components_batch_plain(T(mask), connectivity, max_iters=3, counts=counts)
    np.testing.assert_array_equal(got.numpy(), ref)
    assert counts.tolist() == [4, 1]
    full = tcc.label_components_batch_plain(T(mask), connectivity)
    assert not torch.equal(got, full)


def test_k6_equals_k2_labels_at_connectivity_1():
    mask = np.random.default_rng(61).random((3, 40, 40)) > 0.45
    np.testing.assert_array_equal(tcc.label_components_batch(T(mask)).numpy(),
                                  cc_sizes_plain(T(mask))[0].numpy())


# ---------------------------------------------------------------- K5


@CONN
def test_k5_plain_matches_pallas_interpret_snake(connectivity):
    mask = _snake_mask(np.random.default_rng(0))
    ref = np.asarray(pallas_label_components_tiled(jnp.asarray(mask), connectivity, tile=32,
                                                   interpret=True))
    got = tcc.label_components_tiled(T(mask), connectivity, tile=32)
    np.testing.assert_array_equal(got.numpy(), ref)
    # uncapped, the tiles' merge gives the untiled labels
    np.testing.assert_array_equal(
        ref, np.asarray(jcomp.label_components(jnp.asarray(mask), connectivity)))


@pytest.mark.parametrize("fill", [False, True], ids=["empty", "full"])
def test_k5_plain_degenerate_masks(fill):
    mask = np.full((40, 40), fill)
    ref = np.asarray(pallas_label_components_tiled(jnp.asarray(mask), 1, tile=32, interpret=True))
    counts = torch.zeros(2, dtype=torch.int64)
    got = tcc.label_components_tiled(T(mask), 1, tile=32, counts=counts)
    np.testing.assert_array_equal(got.numpy(), ref)
    # empty: the second round finds nothing to merge; full: tile (1, 1)
    # takes tile (0, 0)'s label through a neighbour in round 3, round 4 checks
    assert counts[1] == (4 if fill else 2) and counts[0] >= 4 * counts[1]


@CONN
def test_k5_capped_spiral_matches_pallas_and_differs_from_uncapped(connectivity):
    """``tile=16, max_iters=2, max_outer=2``: both caps bind; the plain
    version equals the Pallas kernel and differs from the exact labels."""
    mask = _spiral(48)
    kw = dict(tile=16, max_iters=2, max_outer=2)
    ref = np.asarray(pallas_label_components_tiled(jnp.asarray(mask), connectivity,
                                                   interpret=True, **kw))
    counts = torch.zeros(2, dtype=torch.int64)
    got = tcc.label_components_tiled(T(mask), connectivity, counts=counts, **kw).numpy()
    np.testing.assert_array_equal(got, ref)
    exact = np.asarray(jcomp.label_components(jnp.asarray(mask), connectivity))
    assert not np.array_equal(got, exact)
    # 1 + max_outer rounds of 9 tiles, each of at most 1 + max_iters relaxations
    assert counts[1] == 3 and counts[0] <= 3 * 9 * 3


# ---------------------------------------------------------- components


@CONN
def test_label_components_matches_jax(connectivity):
    mask = np.random.default_rng(62).random((37, 53)) > 0.5
    ref = np.asarray(jcomp.label_components(jnp.asarray(mask), connectivity))
    got = tcomp.label_components(T(mask)[None], connectivity=connectivity)[0]
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(tcomp.component_sizes(got).numpy(),
                                  np.asarray(jcomp.component_sizes(jnp.asarray(ref))))


@CONN
def test_remove_small_objects_and_holes_match_jax(connectivity):
    mask = np.random.default_rng(63).random((64, 80)) > 0.45
    for min_size in (1, 5, 30):
        ref = np.asarray(jcomp.remove_small_objects(jnp.asarray(mask), min_size, connectivity))
        got = tcomp.remove_small_objects(T(mask), min_size, connectivity)
        np.testing.assert_array_equal(got.numpy(), ref)
        ref = np.asarray(jcomp.remove_small_holes(jnp.asarray(mask), min_size, connectivity))
        got = tcomp.remove_small_holes(T(mask), min_size, connectivity)
        np.testing.assert_array_equal(got.numpy(), ref)


def test_compact_labels_matches_jax():
    lbl = np.asarray(jcomp.label_components(
        jnp.asarray(np.random.default_rng(64).random((30, 30)) > 0.5), 1))
    got, n = tcomp.compact_labels(lbl)
    ref, rn = jcomp.compact_labels(lbl)
    assert n == rn and n > 3
    np.testing.assert_array_equal(got, ref)
    assert tcomp.compact_labels(np.full((4, 4), tcomp.INF))[1] == 0


def test_wrappers_check_their_arguments():
    with pytest.raises(ValueError, match="connectivity"):
        tcomp.relax_fixpoint(torch.ones(1, 4, 4, dtype=torch.bool),
                             torch.zeros(1, 4, 4, dtype=torch.int32), connectivity=3)
