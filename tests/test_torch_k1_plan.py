"""The design and tiling planner of the LSTM-stack scan (K1,
``se_tpu_torch/csrc/lstm_scan.cu``) at every shape the port runs it, on the
planner K1 shares with K2 and K3 (``ops/cluster_plan.py``, at four gates and
no input projection): pure Python, no kernel is built or launched here."""

from __future__ import annotations

import pytest

from se_tpu_torch.ops import cluster_plan
from se_tpu_torch.ops import fused_lstm as k1


def _shapes():
    """(label, L, Bb, H) of every K1 launch on the paths: DCCRN's two stacks of
    H = rnn_units / 2 = 128 over the doubled batch Bb = 2 B, and the ragged
    case of ``chip_smoke.py`` (T=7, L=3, Bb=5, H=32)."""
    for B in range(1, 11):
        yield f"DCCRN B={B}", 2, 2 * B, 128
    yield "ragged", 3, 5, 32


SHAPES = list(_shapes())


@pytest.mark.parametrize("backward", [False, True], ids=["forward", "backward"])
def test_plan_covers_each_row_and_unit_once_and_fits(backward):
    for label, L, Bb, H in SHAPES:
        p = k1.plan(L, Bb, H, backward=backward)
        rows = [b for tile in range(p.tiles) for b in range(tile * p.R, min((tile + 1) * p.R, Bb))]
        units = [u for q in range(p.N) for u in range(q * p.U, min((q + 1) * p.U, H))]
        assert rows == list(range(Bb)), (label, p)
        assert units == list(range(H)), (label, p)
        assert (p.tiles - 1) * p.R < Bb and (p.N - 1) * p.U < H, (label, p)  # no idle CTA
        assert 1 <= p.N <= 16 and p.R % 4 == 0 and p.R <= 32 and 1 <= p.C <= 8, (label, p)
        smem = cluster_plan.smem_bytes(p.R, p.N, p.U, p.C, 0, H, p.resident, backward)
        assert p.smem == smem <= cluster_plan.MAX_SMEM == 227 * 1024, (label, p)
        assert cluster_plan.cell_threads(p.U, p.R) <= cluster_plan.THREADS, (label, p)


@pytest.mark.parametrize("backward", [False, True], ids=["forward", "backward"])
def test_plan_keeps_the_slice_resident_in_chunks_of_eight_steps(backward):
    """At every shape of the paths the W_hh slice fits beside the step's
    buffers, so it stays resident, and the chunk is 8 steps of x_proj
    (nothing to project: the chunk's buffer is all K1 stages)."""
    for label, L, Bb, H in SHAPES:
        p = k1.plan(L, Bb, H, backward=backward)
        smallest = cluster_plan.smem_bytes(4, p.N, p.U, 1, 0, H, True, backward)
        assert p.resident == (smallest <= cluster_plan.MAX_SMEM), (label, p)
        assert p.resident and p.C == cluster_plan.MAX_CHUNK, (label, p)


@pytest.mark.parametrize("N", [1, 2, 3, 4, 8, 16])
def test_split_leaves_no_cta_without_units(N):
    """``split(H, N)``: U = ceil(H / N) units a CTA, as many CTAs as that
    needs: never one without units, never more than asked."""
    for H in (1, 5, 7, 32, 44, 128, 384, 512):
        n, U = cluster_plan.split(H, N)
        assert U == -(-H // min(N, H)) and n <= N and (n - 1) * U < H <= n * U, (H, N, n, U)
    with pytest.raises(ValueError, match="1 to 16"):
        cluster_plan.split(128, 17)


@pytest.mark.parametrize("backward", [False, True], ids=["forward", "backward"])
def test_plan_keeps_every_cluster_of_a_launch_on_the_card(backward):
    """The launch's L x tiles clusters of CTAS[backward] CTAs never exceed
    what the card holds at once (CLUSTERS_AT_ONCE), in tiles of as few rows
    as that allows: the clusters of a launch run in one wave."""
    for label, L, Bb, H in SHAPES:
        p = k1.plan(L, Bb, H, backward=backward)
        budget = k1.CLUSTERS_AT_ONCE[k1.CTAS[backward]]
        assert p.N == min(k1.CTAS[backward], H // p.U), (label, p)
        assert L * p.tiles <= budget, (label, p)
        assert p.R == 4 or L * -(-Bb // (p.R - 4)) > budget, (label, p)


def test_plan_at_dccrns_shapes_is_the_measured_fastest():
    """DCCRN's enhance batch (B=8: Bb=16) and train batch (B=10: Bb=20) on
    the tilings measured fastest on an H100 (PERF.md §6): the forward on 4
    clusters a stack of 8 CTAs and 4 rows (1.87 ms at Bb=16), the backward
    on 3 clusters a stack of 16 CTAs and 8 rows (4.42 ms at Bb=20)."""
    fwd = k1.plan(2, 16, 128)
    assert (fwd.tiles, fwd.N, fwd.U, fwd.R, fwd.C, fwd.resident) == (4, 8, 16, 4, 8, True)
    bwd = k1.plan(2, 20, 128, backward=True)
    assert (bwd.tiles, bwd.N, bwd.U, bwd.R, bwd.C, bwd.resident) == (3, 16, 8, 8, 8, True)
    assert k1.plan(2, 20, 128).R == 4 and k1.plan(2, 16, 128, backward=True).R == 8
    ragged = k1.plan(3, 5, 32)  # chip_smoke.py's: 4 units a CTA, two tiles of 4 rows
    assert (ragged.tiles, ragged.N, ragged.U, ragged.R) == (2, 8, 4, 4)
    assert fwd.args() == (4, 8, 8, 1)


def test_plan_without_n_is_the_parents_for_k2_and_k3():
    """Passing no N keeps ``cluster_split``: K2's and K3's tilings do not
    move (their own plan tests hold them at their paths' shapes)."""
    for Bb, In, H in ((8, 512, 128), (2056, 32, 384), (8, 257, 512), (37, 20, 44)):
        for gates in (3, 4):
            for backward in (False, True):
                p = cluster_plan.plan(Bb, In, H, backward, gates)
                assert (p.N, p.U) == cluster_plan.cluster_split(H), (Bb, In, H, gates, p)
