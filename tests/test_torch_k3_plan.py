"""The design and tiling planner of the in-projection GRU kernels (K3,
``se_tpu_torch/csrc/gru_inproj.cu``) at every shape FullSubNet-GRU runs,
on the planner K3 shares with K2 (``ops/cluster_plan.py``, at three gates):
pure Python, no kernel is built or launched here."""

from __future__ import annotations

import pytest

from se_tpu_torch.ops import cluster_plan
from se_tpu_torch.ops import fused_gru_inproj as k3


def _shapes():
    """(label, Bb, In, H) of every K3 launch on the paths: FullSubNet-GRU's
    full band (Bb = B) and sub band (Bb = 257 B), two layers each, and the
    three ragged cases of ``chip_smoke.py``."""
    for B in range(1, 11):
        yield f"fb l0 B={B}", B, 257, 512
        yield f"fb l1 B={B}", B, 512, 512
        yield f"sb l0 B={B}", 257 * B, 32, 384
        yield f"sb l1 B={B}", 257 * B, 384, 384
    yield "ragged", 5, 33, 32
    yield "ragged 8-row tiles", 1069, 33, 64
    yield "ragged tiles and units", 37, 20, 44


SHAPES = list(_shapes())


@pytest.mark.parametrize("backward", [False, True], ids=["forward", "backward"])
def test_plan_covers_each_row_and_unit_once_and_fits(backward):
    for label, Bb, In, H in SHAPES:
        p = k3.plan(Bb, In, H, backward=backward)
        rows = [b for tile in range(p.tiles) for b in range(tile * p.R, min((tile + 1) * p.R, Bb))]
        units = [u for q in range(p.N) for u in range(q * p.U, min((q + 1) * p.U, H))]
        assert rows == list(range(Bb)), (label, p)
        assert units == list(range(H)), (label, p)
        assert (p.tiles - 1) * p.R < Bb and (p.N - 1) * p.U < H, (label, p)  # no idle CTA
        assert 1 <= p.N <= 16 and p.R % 4 == 0 and p.R <= 32 and 1 <= p.C <= 8, (label, p)
        smem = cluster_plan.smem_bytes(p.R, p.N, p.U, p.C, In, H, p.resident, backward, gates=3)
        assert p.smem == smem <= cluster_plan.MAX_SMEM == 227 * 1024, (label, p)
        assert cluster_plan.cell_threads(p.U, p.R) <= 512, (label, p)  # a thread per (unit, 4 rows)


@pytest.mark.parametrize("backward", [False, True], ids=["forward", "backward"])
def test_plan_keeps_the_slice_resident_exactly_where_it_fits(backward):
    """The slice is resident where a tile of 4 rows fits beside it, and the
    cluster design runs only on a resident slice (K3 has no streamed form)."""
    for label, Bb, In, H in SHAPES:
        p = k3.plan(Bb, In, H, backward=backward)
        smallest = cluster_plan.smem_bytes(4, p.N, p.U, 1, In, H, True, backward, gates=3)
        assert p.resident == (smallest <= cluster_plan.MAX_SMEM), (label, p)
        assert p.resident or not p.cluster, (label, p)


def test_slice_rows_keep_the_backward_off_shared_bank_conflicts():
    """K3's slice rows are an odd number of floats apart (its backward's
    lanes step along k); K2's are 4U + 4, a unit's four gates one float4."""
    for U in range(1, 40):
        assert cluster_plan.slice_ld(3, U) in (3 * U, 3 * U + 1)
        assert cluster_plan.slice_ld(3, U) % 2 == 1
        assert cluster_plan.slice_ld(4, U) == 4 * U + 4


def test_plan_runs_clusters_where_they_run_in_one_wave():
    """The cluster design where the slice is resident and the launch holds
    at most ``CLUSTER_TILES`` clusters a stack, in tiles of as few rows as
    that allows; the per-block kernel elsewhere."""
    for label, Bb, In, H in SHAPES:
        for backward in (False, True):
            p = k3.plan(Bb, In, H, backward=backward)
            assert p.cluster == (p.resident and p.tiles <= k3.CLUSTER_TILES), (label, p)
            if p.cluster:
                assert p.R == 4 or -(-Bb // (p.R - 4)) > k3.CLUSTER_TILES, (label, p)


def test_plan_at_the_paths_shapes():
    """FullSubNet-GRU at B=8: the full band on two clusters of 16 CTAs of 4
    rows each, the 194 KiB slice resident; the sub band (2056 rows) on the
    per-block kernel, its cluster tiling 65 tiles or more."""
    fb0 = k3.plan(8, 257, 512)
    assert (fb0.tiles, fb0.N, fb0.U, fb0.R, fb0.C, fb0.resident) == (2, 16, 32, 4, 4, True)
    fb0b = k3.plan(8, 257, 512, backward=True)
    assert (fb0b.tiles, fb0b.R, fb0b.C, fb0b.resident) == (2, 4, 2, True)
    fb1 = k3.plan(8, 512, 512)
    assert (fb1.tiles, fb1.R, fb1.C, fb1.resident) == (2, 4, 2, True)
    fb1b = k3.plan(8, 512, 512, backward=True)
    assert (fb1b.tiles, fb1b.R, fb1b.C, fb1b.resident) == (2, 4, 1, True)
    assert all(p.cluster for p in (fb0, fb0b, fb1, fb1b))
    assert k3.plan(10, 257, 512, backward=True).tiles == 3  # the 10 train steps' batch
    sb = [k3.plan(2056, In, 384, backward=b) for In in (32, 384) for b in (False, True)]
    assert [(p.tiles, p.R) for p in sb] == [(65, 32), (65, 32), (65, 32), (103, 20)]
    assert not any(p.cluster for p in sb)
    ragged = k3.plan(37, 20, 44)  # neither Bb by R nor H by N divides
    assert (ragged.tiles, ragged.R, ragged.N, ragged.U, ragged.cluster) == (5, 8, 6, 8, True)
