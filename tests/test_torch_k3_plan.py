"""The design and tiling planner of the in-projection GRU kernels (K3,
``se_tpu_torch/csrc/gru_inproj.cu``) at every shape FullSubNet-GRU runs:
the cluster design's tiling on the planner K3 shares with K2
(``ops/cluster_plan.py``, at three gates), the wave design's on the gate
product's (``probes/gate_product.py``), and the wave design's weight
layouts against the plain gate math.  Pure Python and small CPU tensors:
no kernel is built or launched here."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from se_tpu_torch.ops import cluster_plan
from se_tpu_torch.ops import fused_gru_inproj as k3
from se_tpu_torch.probes import gate_product as gp


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
    """Each shape's cluster tiling (the design at the full band, and the
    tiling the others are measured beside) and, where the plan takes it,
    the wave tiling cover each row and unit once and fit a block."""
    for label, Bb, In, H in SHAPES:
        p = k3.cluster_tiling(Bb, In, H, backward=backward)
        rows = [b for tile in range(p.tiles) for b in range(tile * p.R, min((tile + 1) * p.R, Bb))]
        units = [u for q in range(p.N) for u in range(q * p.U, min((q + 1) * p.U, H))]
        assert rows == list(range(Bb)), (label, p)
        assert units == list(range(H)), (label, p)
        assert (p.tiles - 1) * p.R < Bb and (p.N - 1) * p.U < H, (label, p)  # no idle CTA
        assert 1 <= p.N <= 16 and p.R % 4 == 0 and p.R <= 32 and 1 <= p.C <= 8, (label, p)
        smem = cluster_plan.smem_bytes(p.R, p.N, p.U, p.C, In, H, p.resident, backward, gates=3)
        assert p.smem == smem <= cluster_plan.MAX_SMEM == 227 * 1024, (label, p)
        assert cluster_plan.cell_threads(p.U, p.R) <= 512, (label, p)  # a thread per (unit, 4 rows)
        if k3.plan(Bb, In, H, backward=backward).design == "wave":
            _check_wave_tiling(label, k3.plan(Bb, In, H, backward=backward), Bb, In, H, backward)


def _check_wave_tiling(label, p, Bb, In, H, backward):
    """16-row tiles covering each row once, all units in whole warps of one
    CTA, x padded to a pair of slabs, a ring of 2 to 8 slabs beside the
    buffers within a block's shared memory."""
    assert p.design == "wave" and p.R == gp.TILE_ROWS == 16, (label, p)
    rows = [b for tile in range(p.tiles) for b in range(tile * p.R, min((tile + 1) * p.R, Bb))]
    assert rows == list(range(Bb)) and (p.tiles - 1) * p.R < Bb, (label, p)
    assert p.Hp % gp.UNITS_PER_WARP == 0 and H <= p.Hp < H + gp.UNITS_PER_WARP, (label, p)
    assert p.Hp <= gp.MAX_UNITS == 12 * gp.UNITS_PER_WARP, (label, p)  # 12 consumer warps
    assert p.In_p % (2 * gp.SLAB_ROWS) == 0 and In <= p.In_p < In + 2 * gp.SLAB_ROWS, (label, p)
    assert 2 <= p.stages <= k3.WAVE_MAX_STAGES, (label, p)
    assert p.smem == k3.wave_smem(p.In_p, p.Hp, p.stages, backward) <= gp.MAX_SMEM, (label, p)
    assert (p.stages == k3.WAVE_MAX_STAGES
            or k3.wave_smem(p.In_p, p.Hp, p.stages + 1, backward) > gp.MAX_SMEM), (label, p)
    assert p.N == k3.WAVE_CLUSTER and p.clusters == -(-p.tiles // p.N), (label, p)
    # the ring's two stretches take their slabs in pairs: (x; h) and W_hh^T's 3 Hp / 4 rows
    assert (p.In_p + p.Hp) % (2 * gp.SLAB_ROWS) == 0, (label, p)
    assert (3 * p.Hp // 4) % (2 * gp.SLAB_ROWS) == 0, (label, p)


@pytest.mark.parametrize("backward", [False, True], ids=["forward", "backward"])
def test_plan_keeps_the_slice_resident_exactly_where_it_fits(backward):
    """The slice is resident where a tile of 4 rows fits beside it, and the
    cluster design runs only on a resident slice (K3 has no streamed form)."""
    for label, Bb, In, H in SHAPES:
        p = k3.cluster_tiling(Bb, In, H, backward=backward)
        smallest = cluster_plan.smem_bytes(4, p.N, p.U, 1, In, H, True, backward, gates=3)
        assert p.resident == (smallest <= cluster_plan.MAX_SMEM), (label, p)
        assert p.resident or k3.plan(Bb, In, H, backward=backward).design != "cluster", (label, p)


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
    that allows; the wave or the per-block design elsewhere."""
    for label, Bb, In, H in SHAPES:
        for backward in (False, True):
            p = k3.cluster_tiling(Bb, In, H, backward=backward)
            design = k3.plan(Bb, In, H, backward=backward).design
            assert (design == "cluster") == (p.resident and p.tiles <= k3.CLUSTER_TILES), (label, p)
            if design == "cluster":
                assert p.R == 4 or -(-Bb // (p.R - 4)) > k3.CLUSTER_TILES, (label, p)


def test_plan_at_the_paths_shapes():
    """FullSubNet-GRU at B=8: the full band on two clusters of 16 CTAs of 4
    rows each, the 194 KiB slice resident; the sub band (2056 rows) in the
    wave design, one wave of 129 tiles of 16 rows in 65 clusters of 2 (its
    cluster tiling 65 tiles or more, in waves of 7)."""
    fb0 = k3.plan(8, 257, 512)
    assert (fb0.tiles, fb0.N, fb0.U, fb0.R, fb0.C, fb0.resident) == (2, 16, 32, 4, 4, True)
    fb0b = k3.plan(8, 257, 512, backward=True)
    assert (fb0b.tiles, fb0b.R, fb0b.C, fb0b.resident) == (2, 4, 2, True)
    fb1 = k3.plan(8, 512, 512)
    assert (fb1.tiles, fb1.R, fb1.C, fb1.resident) == (2, 4, 2, True)
    fb1b = k3.plan(8, 512, 512, backward=True)
    assert (fb1b.tiles, fb1b.R, fb1b.C, fb1b.resident) == (2, 4, 1, True)
    assert all(p.design == "cluster" for p in (fb0, fb0b, fb1, fb1b))
    assert k3.plan(10, 257, 512, backward=True).tiles == 3  # the 10 train steps' batch
    sb = [k3.cluster_tiling(2056, In, 384, backward=b) for In in (32, 384) for b in (False, True)]
    assert [(p.tiles, p.R) for p in sb] == [(65, 32), (65, 32), (65, 32), (103, 20)]
    waves = [k3.plan(2056, In, 384, backward=b) for In in (32, 384) for b in (False, True)]
    assert [(p.design, p.tiles, p.clusters, p.waves) for p in waves] == [("wave", 129, 65, 1)] * 4
    assert [(p.In_p, p.Hp, p.stages) for p in waves] == [(32, 384, 7), (32, 384, 4),
                                                         (384, 384, 5), (384, 384, 3)]
    ragged = k3.plan(37, 20, 44)  # neither Bb by R nor H by N divides
    assert (ragged.tiles, ragged.R, ragged.N, ragged.U, ragged.design) == (5, 8, 6, 8, "cluster")


# The design taken at each sub-band shape the paths launch, forward and
# backward alike: the per-block kernel while its blocks of 4 or 8 rows all
# run at once (B <= 4, a stream's chunk of 257 rows), the wave design from
# B = 5 (PERF.md §6: where each measured faster on the card)
SUB_BAND_DESIGNS = {B: "block" if B <= 4 else "wave" for B in range(1, 11)}


@pytest.mark.parametrize("B", sorted(SUB_BAND_DESIGNS))
def test_plan_pins_the_design_at_each_sub_band_batch(B):
    for In in (32, 384):
        for backward in (False, True):
            p = k3.plan(257 * B, In, 384, backward=backward)
            assert p.design == SUB_BAND_DESIGNS[B], (B, In, backward, p)
            assert p.design == "cluster" or k3.block_tiles(257 * B) > k3.SMS or p.design == "block"


def test_plan_pins_the_design_at_the_stream_and_ragged_shapes():
    """The stream's chunk (Bb = 257, both sub-band layers) and the full
    band's (Bb = 1) and ``chip_smoke.py``'s ragged cases, among them one
    where H = 64 (two warps: the per-block kernel) and one of two stacks
    in the wave design."""
    for In, H, design in ((32, 384, "block"), (384, 384, "block"), (257, 512, "cluster"),
                          (512, 512, "cluster")):
        Bb = 257 if H == 384 else 1
        assert k3.plan(Bb, In, H).design == k3.plan(Bb, In, H, True).design == design, (In, H)
    for (L, Bb, In, H), design in (((3, 5, 33, 32), "cluster"), ((1, 1069, 33, 64), "block"),
                                   ((2, 37, 20, 44), "cluster"), ((2, 600, 20, 200), "wave")):
        for backward in (False, True):
            assert k3.plan(Bb, In, H, backward, L).design == design, (L, Bb, In, H)
    p = k3.plan(600, 20, 200, L=2)
    assert (p.tiles, p.clusters, p.waves, p.In_p, p.Hp) == (38, 38, 1, 24, 224), p


@pytest.mark.parametrize("B", [8, 9, 10, 32])
def test_wave_count_is_as_reckoned(B):
    """Clusters of 2 of 16-row tiles, in waves of the 66 clusters of 2 the
    card holds at once: one wave to B = 8 (129 tiles), two at 9 and 10,
    four at the CLI's B = 32 (257 clusters)."""
    for In in (32, 384):
        for backward in (False, True):
            p = k3.wave_plan(257 * B, In, 384, backward)
            assert p.tiles == -(-257 * B // 16) and p.clusters == -(-p.tiles // 2), p
            assert p.waves == -(-p.clusters // gp.CLUSTERS_AT_ONCE[2]), p
            assert p.waves == {8: 1, 9: 2, 10: 2, 32: 4}[B], p


def _weights(L, In, H, seed):
    rng = np.random.default_rng(seed)
    k = 1 / np.sqrt(H)
    host = (rng.uniform(-k, k, (L, In, 3 * H)), rng.uniform(-k, k, (L, 3 * H)),
            rng.uniform(-k, k, (L, H, 3 * H)), rng.uniform(-k, k, (L, 3 * H)))
    return [torch.from_numpy(a.astype(np.float32)) for a in host]


@pytest.mark.parametrize("L, Bb, In, H", [(1, 5, 32, 384), (2, 7, 20, 44), (1, 3, 33, 64)],
                         ids=["sub band", "ragged two stacks", "ragged"])
def test_wave_layout_gives_the_plain_gates(L, Bb, In, H):
    """A plain product of ``[x; h]`` (x padded to In_p, h to Hp) with the
    laid-out ``w`` plus the folded ``bias`` gives the plain ``_gates``: r
    and z from its r, z columns, n = tanh(n_x + r n_h), n_h = hp_n."""
    w_ih, b_ih, w_hh, b_hh = _weights(L, In, H, 0)
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((L, Bb, In)).astype(np.float32))
    h = torch.from_numpy(0.5 * rng.standard_normal((L, Bb, H)).astype(np.float32))
    p = k3.wave_plan(Bb, In, H)
    w, bias = k3.wave_layout(w_ih, b_ih, w_hh, b_hh, p.In_p, p.Hp)
    assert w.shape == (L, p.In_p + p.Hp, 4 * p.Hp) and bias.shape == (L, 4 * p.Hp)
    assert w.dtype == bias.dtype == torch.float32 and w.is_contiguous()
    # in f64, so that only the layout (exact copies of the f32 weights, and
    # the biases' one f32 sum) can part the two
    a = torch.zeros(L, Bb, p.In_p + p.Hp, dtype=torch.float64)
    a[..., :In], a[..., p.In_p:p.In_p + H] = x, h
    acc = (torch.bmm(a, w.double()) + bias.double()[:, None]).reshape(L, Bb, p.Hp, 4)
    assert torch.count_nonzero(acc[:, :, H:]) == 0  # the padded units stay out
    acc = acc[:, :, :H]
    r, z, n, hp_n = k3._gates(x.double(), w_ih.double(), b_ih.double(), h.double(),
                              w_hh.double(), b_hh.double(), H)
    got_r, got_z = torch.sigmoid(acc[..., 0]), torch.sigmoid(acc[..., 1])
    got_n = torch.tanh(acc[..., 2] + got_r * acc[..., 3])
    for name, got, want in (("r", got_r, r), ("z", got_z, z), ("n", got_n, n),
                            ("hp_n", acc[..., 3], hp_n)):
        assert (got - want).abs().max().item() <= 1e-6, name


@pytest.mark.parametrize("H", [384, 44, 64], ids=["sub band", "ragged", "two warps"])
def test_wave_transpose_gives_the_plain_dh_product(H):
    """The backward's dh product on the laid-out W_hh^T, its four parts of
    3 Hp / 4 rows summed (p0 + p1) + (p2 + p3) as the kernel sums them,
    equals ``dhp @ W_hh^T`` (``_bwd_gru_kernel``'s dh term)."""
    L, Bb = 2, 6
    _, _, w_hh, _ = _weights(L, 8, H, 2)
    p = k3.wave_plan(Bb, 8, H)
    wt = k3.wave_transpose(w_hh, p.Hp)
    Q = 3 * p.Hp // 4
    assert wt.shape == (L, Q, 4 * p.Hp) and wt.is_contiguous()
    dhp = torch.from_numpy(np.random.default_rng(3).standard_normal((L, Bb, 3 * H))
                           .astype(np.float32))
    a = torch.zeros(L, Bb, 3, p.Hp, dtype=torch.float64)  # f64: only the layout parts them
    a[..., :H] = dhp.reshape(L, Bb, 3, H)  # rows k' = g Hp + j
    parts = torch.einsum("lbpk,lkip->lbip", a.reshape(L, Bb, 4, Q),
                         wt.double().reshape(L, Q, p.Hp, 4))
    got = (parts[..., 0] + parts[..., 1]) + (parts[..., 2] + parts[..., 3])
    assert torch.count_nonzero(got[..., H:]) == 0
    want = torch.bmm(dhp.double(), w_hh.double().transpose(1, 2))
    assert (got[..., :H] - want).abs().max().item() <= 1e-6
