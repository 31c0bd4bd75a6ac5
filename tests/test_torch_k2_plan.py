"""The design and tiling planner of the in-projection LSTM kernels (K2,
``se_tpu_torch/csrc/lstm_inproj.cu``) at every shape the port's paths run:
the cluster design's tiling (``ops/cluster_plan.py`` at four gates), the
wave design's (``probes/gate_product.py``, K3's), and the wave design's
weight layouts against the plain gate math.  Pure Python and small CPU
tensors: no kernel is built or launched here."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from se_tpu_torch.ops import fused_lstm_inproj as k2
from se_tpu_torch.probes import gate_product as gp


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
    yield "ragged wave", 600, 20, 200


SHAPES = list(_shapes())


@pytest.mark.parametrize("backward", [False, True], ids=["forward", "backward"])
def test_plan_covers_each_row_and_unit_once_and_fits(backward):
    """Each shape's cluster tiling (the design at CRN, DCCRN's real LSTM and
    the full band, and the tiling the wave design is measured beside) and,
    where the plan takes it, the wave tiling cover each row and unit once
    and fit a block."""
    assert k2.MAX_SMEM == 227 * 1024  # the shared memory a block may use on an H100
    for label, Bb, In, H in SHAPES:
        if k2.plan(Bb, In, H, backward=backward).design == "wave":
            _check_wave_tiling(label, k2.plan(Bb, In, H, backward=backward), Bb, In, H, backward)
        p = k2.cluster_tiling(Bb, In, H, backward=backward)
        rows = [b for tile in range(p.tiles) for b in range(tile * p.R, min((tile + 1) * p.R, Bb))]
        units = [u for q in range(p.N) for u in range(q * p.U, min((q + 1) * p.U, H))]
        assert rows == list(range(Bb)), (label, p)
        assert units == list(range(H)), (label, p)
        assert (p.tiles - 1) * p.R < Bb and (p.N - 1) * p.U < H, (label, p)  # no idle CTA
        assert 1 <= p.N <= 16 and p.R % 4 == 0 and p.R <= 32 and 1 <= p.C <= 8, (label, p)
        smem = k2.smem_bytes(p.R, p.N, p.U, p.C, In, H, p.resident, backward)
        assert p.smem == smem <= k2.MAX_SMEM, (label, p)
        assert k2.cell_threads(p.U, p.R) <= 512, (label, p)  # a thread per (unit, 4 rows)


def _check_wave_tiling(label, p, Bb, In, H, backward):
    """16-row tiles covering each row once, all units in whole warps of one
    CTA, x padded to a pair of slabs, the deepest ring of 2 to 8 slabs that
    fits beside the buffers (the source's formula, ``wave_smem``) within a
    block's shared memory; both stretches of the backward's ring in pairs
    of slabs."""
    assert p.design == "wave" and p.R == gp.TILE_ROWS == 16, (label, p)
    rows = [b for tile in range(p.tiles) for b in range(tile * p.R, min((tile + 1) * p.R, Bb))]
    assert rows == list(range(Bb)) and (p.tiles - 1) * p.R < Bb, (label, p)
    assert p.Hp % gp.UNITS_PER_WARP == 0 and H <= p.Hp < H + gp.UNITS_PER_WARP, (label, p)
    assert p.Hp <= gp.MAX_UNITS == 12 * gp.UNITS_PER_WARP, (label, p)  # 12 consumer warps
    assert p.In_p % (2 * gp.SLAB_ROWS) == 0 and In <= p.In_p < In + 2 * gp.SLAB_ROWS, (label, p)
    assert 2 <= p.stages <= gp.WAVE_MAX_STAGES, (label, p)
    # forward: two buffers [x; h]; backward: [x; h_prev] and the dgates' 4 Hp rows
    buf_rows = p.In_p + 5 * p.Hp if backward else 2 * (p.In_p + p.Hp)
    smem = 4 * (p.stages * gp.SLAB_ROWS * 4 * p.Hp + buf_rows * gp.TILE_ROWS) + 16 * p.stages
    assert p.smem == smem == gp.wave_smem(p.In_p, p.Hp, p.stages, backward) <= gp.MAX_SMEM
    assert (p.stages == gp.WAVE_MAX_STAGES
            or gp.wave_smem(p.In_p, p.Hp, p.stages + 1, backward) > gp.MAX_SMEM), (label, p)
    assert p.N == gp.WAVE_CLUSTER and p.clusters == -(-p.tiles // p.N), (label, p)
    # the ring's two stretches take their slabs in pairs: (x; h) and W_hh^T's Hp rows
    assert (p.In_p + p.Hp) % (2 * gp.SLAB_ROWS) == 0 and p.Hp % (2 * gp.SLAB_ROWS) == 0, (label, p)


@pytest.mark.parametrize("backward", [False, True], ids=["forward", "backward"])
def test_plan_keeps_the_slice_resident_exactly_where_it_fits(backward):
    for label, Bb, In, H in SHAPES:
        p = k2.cluster_tiling(Bb, In, H, backward=backward)
        smallest = k2.smem_bytes(4, p.N, p.U, 1, In, H, True, backward)  # 4 rows, 1 step
        assert p.resident == (smallest <= k2.MAX_SMEM), (label, p)


def test_plan_at_the_paths_shapes():
    """One cluster of 16 CTAs holds a few-row batch (the full band's slice
    streamed); the sub band's 2056 rows at B=8 run in the wave design, one
    wave of 129 tiles of 16 rows in 65 clusters of 2, rings of 7 and 5
    slabs forward, 4 and 3 backward (its cluster tiling: clusters of 16
    CTAs, 32 rows each, the slice resident)."""
    crn = k2.plan(8, 512, 128)
    assert (crn.design, crn.tiles, crn.N, crn.U, crn.R, crn.resident) == (
        "cluster", 1, 16, 8, 8, True)
    fb = k2.plan(8, 257, 512, backward=True)
    assert (fb.design, fb.tiles, fb.N, fb.U, fb.resident) == ("cluster", 1, 16, 32, False)
    sb = k2.cluster_tiling(2056, 32, 384)
    assert (sb.tiles, sb.N, sb.U, sb.R, sb.resident) == (65, 16, 24, 32, True)
    waves = [k2.plan(2056, In, 384, backward=b) for In in (32, 384) for b in (False, True)]
    assert [(p.design, p.tiles, p.clusters, p.waves) for p in waves] == [("wave", 129, 65, 1)] * 4
    assert [(p.In_p, p.Hp, p.stages) for p in waves] == [(32, 384, 7), (32, 384, 4),
                                                         (384, 384, 5), (384, 384, 3)]
    ragged = k2.plan(37, 20, 44)  # neither Bb by R nor H by N divides
    assert (ragged.design, ragged.tiles, ragged.R, ragged.N, ragged.U) == ("cluster", 2, 20, 6, 8)
    assert ragged.args() == (20, 6, 8, 1)


# The design taken at each sub-band shape FullSubNet launches (B; forward
# and backward of both layers): the cluster design while the wave design's
# 16-row CTAs would fill under a third of the card (B = 1, 2: 17 and 33
# CTAs), the wave design from B = 3 (PERF.md §6: where each measured
# faster on the card, but sb l1's forward at B = 2, by 4%)
SUB_BAND_DESIGNS = {B: "cluster" if B <= 2 else "wave" for B in range(1, 11)}


@pytest.mark.parametrize("B", sorted(SUB_BAND_DESIGNS))
def test_plan_pins_the_design_at_each_sub_band_batch(B):
    for In in (32, 384):
        for backward in (False, True):
            p = k2.plan(257 * B, In, 384, backward=backward)
            assert p.design == SUB_BAND_DESIGNS[B], (B, In, backward, p)
            ctas = -(-257 * B // 16)
            assert (p.design == "wave") == (ctas >= k2.WAVE_MIN_CTAS), (B, In, backward, ctas)


def test_plan_pins_the_design_at_the_stream_and_other_shapes():
    """Clusters at a stream's chunk (Bb = 257 at the sub band, 1 at the full
    band), CRN, DCCRN's real LSTM, the full band (H = 512 is above the gate
    product's 384 units) and the small ragged cases; ``chip_smoke.py``'s
    ragged case of two stacks in the wave design."""
    shapes = [(257, 32, 384), (257, 384, 384), (1, 257, 512), (1, 512, 512)]
    shapes += [(B, 512, 128) for B in range(1, 17)] + [(8, 1024, 256), (8, 256, 256)]
    shapes += [(10 * B, In, 512) for B in range(1, 11) for In in (257, 512)]
    for Bb, In, H in shapes + [(5, 24, 32), (37, 20, 44)]:
        for backward in (False, True):
            assert k2.plan(Bb, In, H, backward, L=3 if H == 32 else 1).design == "cluster", (
                Bb, In, H, backward)
    for backward in (False, True):
        p = k2.plan(600, 20, 200, backward, L=2)
        assert (p.design, p.tiles, p.clusters, p.waves, p.In_p, p.Hp) == (
            "wave", 38, 38, 1, 24, 224), p


@pytest.mark.parametrize("B", [8, 9, 10])
def test_wave_count_is_as_reckoned(B):
    """Clusters of 2 of 16-row tiles, in waves of the 66 clusters of 2 the
    card holds at once: 129 tiles in 65 clusters, one wave, at B = 8; 161
    tiles in 81 clusters, two waves, at B = 10."""
    for In in (32, 384):
        for backward in (False, True):
            p = k2.plan(257 * B, In, 384, backward)
            assert p.tiles == -(-257 * B // 16) and p.clusters == -(-p.tiles // 2), p
            assert p.waves == -(-p.clusters // gp.CLUSTERS_AT_ONCE[2]), p
            assert (p.tiles, p.clusters, p.waves) == {8: (129, 65, 1), 9: (145, 73, 2),
                                                      10: (161, 81, 2)}[B], p


def _weights(L, In, H, seed):
    rng = np.random.default_rng(seed)
    k = 1 / np.sqrt(H)
    host = (rng.uniform(-k, k, (L, In, 4 * H)), rng.uniform(-2 * k, 2 * k, (L, 4 * H)),
            rng.uniform(-k, k, (L, H, 4 * H)))
    return [torch.from_numpy(a.astype(np.float32)) for a in host]


@pytest.mark.parametrize("L, Bb, In, H", [(2, 7, 20, 44), (1, 5, 32, 384)],
                         ids=["ragged two stacks", "sub band"])
def test_wave_layout_gives_the_plain_gates(L, Bb, In, H):
    """A plain product of ``[x; h]`` (x padded to In_p, h to Hp) with the
    laid-out ``w`` plus the laid-out ``bias``, its columns regrouped from
    unit-major to gate-major, gives the plain ``_gates`` (i, f, g, o)."""
    w_ih, bias, w_hh = _weights(L, In, H, 0)
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((L, Bb, In)).astype(np.float32))
    h = torch.from_numpy(0.5 * rng.standard_normal((L, Bb, H)).astype(np.float32))
    p = k2.wave_plan(Bb, In, H)
    w, b = k2.wave_layout(w_ih, bias, w_hh, p.In_p, p.Hp)
    assert w.shape == (L, p.In_p + p.Hp, 4 * p.Hp) and b.shape == (L, 4 * p.Hp)
    assert w.dtype == b.dtype == torch.float32 and w.is_contiguous() and b.is_contiguous()
    # in f64, so that only the layout (exact copies of the f32 weights) can part the two
    a = torch.zeros(L, Bb, p.In_p + p.Hp, dtype=torch.float64)
    a[..., :In], a[..., p.In_p:p.In_p + H] = x, h
    acc = (torch.bmm(a, w.double()) + b.double()[:, None]).reshape(L, Bb, p.Hp, 4)
    assert torch.count_nonzero(acc[:, :, H:]) == 0  # the padded units stay out
    got = acc[:, :, :H].transpose(2, 3).reshape(L, Bb, 4 * H)  # unit-major -> gate-major
    want = k2._gates(x.double(), w_ih.double(), bias.double(), h.double(), w_hh.double())
    assert (got - want).abs().max().item() <= 1e-6
    # and in f32, the kernel's one chain x, h, then the bias, against the
    # plain f32 gates: within f32 rounding
    a32 = a.float()
    got32 = (torch.bmm(a32, w) + b[:, None]).reshape(L, Bb, p.Hp, 4)[:, :, :H]
    got32 = got32.transpose(2, 3).reshape(L, Bb, 4 * H)
    want32 = k2._gates(x, w_ih, bias, h, w_hh)
    assert (got32 - want32).abs().max().item() <= 1e-5 * max(1.0, want32.abs().max().item())


@pytest.mark.parametrize("H", [44, 384], ids=["ragged", "sub band"])
def test_wave_transpose_gives_the_plain_dh_product(H):
    """The backward's dh product on the laid-out W_hh^T, its four parts (one
    a gate, Hp rows each) summed (p0 + p1) + (p2 + p3) as the kernel sums
    them, equals ``dgates @ W_hh^T`` (``_bwd_inproj_kernel``'s dh term)."""
    L, Bb = 2, 6
    _, _, w_hh = _weights(L, 20, H, 2)
    p = k2.wave_plan(Bb, 20, H)
    wt = k2.wave_transpose(w_hh, p.Hp)
    assert wt.shape == (L, p.Hp, 4 * p.Hp) and wt.dtype == torch.float32 and wt.is_contiguous()
    dg = torch.from_numpy(np.random.default_rng(3).standard_normal((L, Bb, 4 * H))
                          .astype(np.float32))
    a = torch.zeros(L, Bb, 4, p.Hp, dtype=torch.float64)  # f64: only the layout parts them
    a[..., :H] = dg.reshape(L, Bb, 4, H)  # rows k' = g Hp + j
    parts = torch.einsum("lbpk,lkip->lbip", a, wt.double().reshape(L, p.Hp, p.Hp, 4))
    got = (parts[..., 0] + parts[..., 1]) + (parts[..., 2] + parts[..., 3])
    assert torch.count_nonzero(got[..., H:]) == 0
    want = torch.bmm(dg.double(), w_hh.double().transpose(1, 2))
    assert (got[..., :H] - want).abs().max().item() <= 1e-6
