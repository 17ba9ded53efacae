"""``txr_torch.ops.scan`` / ``.segment`` against ``txr.ops.segment`` and a
numpy loop oracle.

``txr``'s Pallas scan has no interpret path on the CPU, so its XLA
``segmented_cumsum`` is the only ``txr`` oracle here; on the CPU the port's
``segmented_cumsum_cols`` takes its plain version.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from txr.ops.segment import INT_MAX as J_INT_MAX
from txr.ops.segment import segmented_cumsum as j_segmented_cumsum
from txr_torch.ops.scan import (ITEMS, MAX_COLS, THREADS, TILE, scan_geometry,
                                segmented_cumsum_cols)
from txr_torch.ops.segment import INT_MAX, segmented_cumsum

torch.set_num_threads(1)


def oracle(vals: np.ndarray, starts: np.ndarray) -> np.ndarray:
    out = np.zeros_like(vals, dtype=np.float64)
    run = np.zeros(vals.shape[1], np.float64)
    for i in range(vals.shape[0]):
        run = vals[i].astype(np.float64) if starts[i] else run + vals[i]
        out[i] = run
    return out


def starts_for(kind: str, n: int, rng) -> np.ndarray:
    if kind == "random":
        s = rng.random(n) < 0.2
    elif kind == "none":
        s = np.zeros(n, bool)
    else:
        s = np.ones(n, bool)
    return s


class TestScanParity:
    @pytest.mark.parametrize("n", [1, 7, 1000])
    @pytest.mark.parametrize("kind", ["random", "none", "all"])
    @pytest.mark.parametrize("d", [1, 8])
    def test_cols_match_txr_and_oracle(self, n, kind, d):
        """atol 1e-4: f32 sums of at most 1000 values of order 1."""
        rng = np.random.default_rng(n * 10 + d)
        vals = rng.standard_normal((n, d)).astype(np.float32)
        starts = starts_for(kind, n, rng)
        want = np.asarray(j_segmented_cumsum(jnp.asarray(vals),
                                             jnp.asarray(starts)))
        cols = tuple(torch.from_numpy(np.ascontiguousarray(vals[:, i]))
                     for i in range(d))
        got = segmented_cumsum_cols(cols, torch.from_numpy(starts))
        assert len(got) == d and all(g.shape == (n,) for g in got)
        got = np.stack([g.numpy() for g in got], axis=1)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
        np.testing.assert_allclose(got, oracle(vals, starts), rtol=0,
                                   atol=1e-4)

    def test_stacked_form_matches_txr(self):
        rng = np.random.default_rng(5)
        vals = rng.standard_normal((333, 7)).astype(np.float32)
        starts = rng.random(333) < 0.1
        want = np.asarray(j_segmented_cumsum(jnp.asarray(vals),
                                             jnp.asarray(starts)))
        got = segmented_cumsum(torch.from_numpy(vals),
                               torch.from_numpy(starts))
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)

    def test_segment_end_holds_the_total(self):
        vals = torch.ones((10, 1))
        starts = torch.tensor([1, 0, 0, 1, 0, 1, 0, 0, 0, 0], dtype=torch.bool)
        out = segmented_cumsum_cols((vals[:, 0],), starts)[0]
        assert out.tolist() == [1, 2, 3, 1, 2, 1, 2, 3, 4, 5]

    def test_column_count_limits_and_sentinel(self):
        z = torch.zeros(4)
        s = torch.zeros(4, dtype=torch.bool)
        with pytest.raises(ValueError):
            segmented_cumsum_cols((), s)
        with pytest.raises(ValueError):
            segmented_cumsum_cols((z,) * 9, s)
        assert INT_MAX == int(J_INT_MAX) == 2 ** 31 - 1


class TestScanGeometry:
    """The launch the scan kernel is sized by (pure Python; the kernel runs
    only on the card, where ``chip_smoke.py`` checks that the built library
    reports the same tile)."""

    @pytest.mark.parametrize("n", [1, TILE - 1, TILE, TILE + 1, 5_926_208])
    def test_tiles_and_scratch(self, n):
        geo = scan_geometry(n)
        tiles = geo["tiles"]
        assert (tiles - 1) * TILE < n <= tiles * TILE
        assert geo["threads"] == THREADS
        # counter + (status, aggregate count, inclusive count) per tile
        assert geo["int_words"] == 1 + 3 * tiles
        # an aggregate and an inclusive prefix of every column per tile
        assert geo["float_words"] == 2 * MAX_COLS * tiles
        # only the counter and the status words are reset per launch
        assert geo["reset_bytes"] == 4 * (1 + tiles)
        assert geo["scratch_bytes"] == 4 * (geo["int_words"]
                                            + geo["float_words"])

    def test_path_shape_and_tile(self):
        assert TILE == THREADS * ITEMS == 2048 and MAX_COLS == 8
        # a full 2^21 map and 8 frames of 518 x 924 points
        assert scan_geometry((1 << 21) + 8 * 518 * 924)["tiles"] == 2894
        with pytest.raises(ValueError):
            scan_geometry(0)


class TestScanAcrossTiles:
    """What the one-pass kernel must also get right, held here against txr
    and the loop oracle through the plain version."""

    @pytest.mark.parametrize("case", ["one segment over three tiles",
                                      "ragged last tile"])
    def test_long_and_ragged(self, case):
        rng = np.random.default_rng(len(case))
        if case == "one segment over three tiles":
            n = 3 * TILE + 100
            starts = rng.random(n) < 0.05
            starts[50:50 + 2 * TILE + 300] = False
            starts[50] = True
        else:
            n = 2 * TILE + 7
            starts = rng.random(n) < 0.3
        vals = rng.random((n, 3)).astype(np.float32)
        got = segmented_cumsum_cols(
            tuple(torch.from_numpy(np.ascontiguousarray(vals[:, i]))
                  for i in range(3)), torch.from_numpy(starts))
        got = np.stack([g.numpy() for g in got], axis=1)
        want = np.asarray(j_segmented_cumsum(jnp.asarray(vals),
                                             jnp.asarray(starts)))
        # f32 sums of up to 4400 values in [0, 1)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-3)
        np.testing.assert_allclose(got, oracle(vals, starts), rtol=1e-5,
                                   atol=1e-3)
