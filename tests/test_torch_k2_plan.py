"""The tiling planner of the in-projection LSTM kernels (K2,
``se_tpu_torch/csrc/lstm_inproj.cu``) at every shape the port's paths run:
pure Python, no kernel is built or launched here."""

from __future__ import annotations

import pytest

from se_tpu_torch.ops import fused_lstm_inproj as k2


def _shapes():
    """(label, Bb, In, H) of every K2 launch on the paths: CRN's LSTM,
    DCCRN's real LSTM (two layers), FullSubNet's full band (Bb = B) and sub
    band (Bb = 257 B), two layers each, and the ragged case of
    ``chip_smoke.py``."""
    for B in range(1, 17):
        yield f"CRN B={B}", B, 512, 128
        yield f"DCCRN real l0 B={B}", B, 1024, 256
        yield f"DCCRN real l1 B={B}", B, 256, 256
    for B in range(1, 11):
        yield f"FullSubNet fb l0 B={B}", B, 257, 512
        yield f"FullSubNet fb l1 B={B}", B, 512, 512
        yield f"FullSubNet sb l0 B={B}", 257 * B, 32, 384
        yield f"FullSubNet sb l1 B={B}", 257 * B, 384, 384
    yield "ragged", 5, 24, 32


SHAPES = list(_shapes())


@pytest.mark.parametrize("backward", [False, True], ids=["forward", "backward"])
def test_plan_covers_each_row_and_unit_once_and_fits(backward):
    assert k2.MAX_SMEM == 227 * 1024  # the shared memory a block may use on an H100
    for label, Bb, In, H in SHAPES:
        p = k2.plan(Bb, In, H, backward=backward)
        rows = [b for tile in range(p.tiles) for b in range(tile * p.R, min((tile + 1) * p.R, Bb))]
        units = [u for q in range(p.N) for u in range(q * p.U, min((q + 1) * p.U, H))]
        assert rows == list(range(Bb)), (label, p)
        assert units == list(range(H)), (label, p)
        assert (p.tiles - 1) * p.R < Bb and (p.N - 1) * p.U < H, (label, p)  # no idle CTA
        assert 1 <= p.N <= 16 and p.R % 4 == 0 and p.R <= 32 and 1 <= p.C <= 8, (label, p)
        smem = k2.smem_bytes(p.R, p.N, p.U, p.C, In, H, p.resident, backward)
        assert p.smem == smem <= k2.MAX_SMEM, (label, p)
        assert k2.cell_threads(p.U, p.R) <= 512, (label, p)  # a thread per (unit, 4 rows)


@pytest.mark.parametrize("backward", [False, True], ids=["forward", "backward"])
def test_plan_keeps_the_slice_resident_exactly_where_it_fits(backward):
    for label, Bb, In, H in SHAPES:
        p = k2.plan(Bb, In, H, backward=backward)
        smallest = k2.smem_bytes(4, p.N, p.U, 1, In, H, True, backward)  # 4 rows, 1 step
        assert p.resident == (smallest <= k2.MAX_SMEM), (label, p)


def test_plan_at_the_paths_shapes():
    """One cluster of 16 CTAs holds a few-row batch (the full band's slice
    streamed); the sub band tiles its 2056 rows at B=8 into clusters of 16
    CTAs, 32 rows each, the slice resident."""
    crn = k2.plan(8, 512, 128)
    assert (crn.tiles, crn.N, crn.U, crn.R, crn.resident) == (1, 16, 8, 8, True)
    fb = k2.plan(8, 257, 512, backward=True)
    assert (fb.tiles, fb.N, fb.U, fb.resident) == (1, 16, 32, False)
    sb = k2.plan(2056, 32, 384)
    assert (sb.tiles, sb.N, sb.U, sb.R, sb.resident) == (65, 16, 24, 32, True)
    ragged = k2.plan(37, 20, 44)  # neither Bb by R nor H by N divides
    assert (ragged.tiles, ragged.R, ragged.N, ragged.U) == (2, 20, 6, 8)
    assert ragged.args() == (20, 6, 8, 1)
