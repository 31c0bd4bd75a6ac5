"""The tiling planner and weight layout of the probes' gate product: P2, the
wavefront LSTM (``se_tpu_torch/csrc/wavefront_lstm.cu``,
``probes/wavefront_probe.plan``), and P3's dots-only mode
(``csrc/vpu_probe.cu``, ``probes/vpu_probe.dots_plan``), on the shared
``probes/gate_product.py``.  Pure Python and small CPU tensors: no kernel
is built or launched here."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from se_tpu_torch.probes import gate_product as gp
from se_tpu_torch.probes import vpu_probe, wavefront_probe

SUB_BAND = (32, 384)  # In, H of the sub band's first layer


def _rows_of(p, Bb):
    return [b for tile in range(p.tiles) for b in range(tile * p.R, min((tile + 1) * p.R, Bb))]


# (label, Bb): B = 8 (one wave), the CLI's default B = 32 (waves), a ragged
# tile of 10 rows, the sub band's 257 rows a stream's chunk, and the
# card-side checks' two-wave shape
SHAPES = [("B=8", 8 * 257), ("B=32", 32 * 257), ("ragged", 10), ("B=1", 257),
          ("B=2", 2 * 257), ("odd", 16 * 130 + 1)]


@pytest.mark.parametrize("label, Bb", SHAPES, ids=[s[0] for s in SHAPES])
def test_plan_covers_each_row_once_in_tiles_of_16(label, Bb):
    p = wavefront_probe.plan(Bb, *SUB_BAND)
    assert p.R == gp.TILE_ROWS >= 16, p
    assert _rows_of(p, Bb) == list(range(Bb)), p
    assert (p.tiles - 1) * p.R < Bb <= p.tiles * p.R, p  # no tile without rows
    assert p.clusters == -(-p.tiles // p.N) and (p.clusters - 1) * p.N < p.tiles, p


def test_plan_runs_b8_in_one_wave():
    """The sub band at B = 8: 2056 rows in 129 tiles of 16, one wave of
    clusters the card holds at once, on the largest cluster that allows it
    (65 clusters of 2: the card holds 30 of 4, 33 would be needed)."""
    p = wavefront_probe.plan(8 * 257, *SUB_BAND)
    assert (p.tiles, p.waves) == (129, 1), p
    assert p.clusters <= gp.CLUSTERS_AT_ONCE[p.N], p
    assert all(-(-p.tiles // n) > gp.CLUSTERS_AT_ONCE[n] for n in gp.CLUSTER_SIZES if n > p.N), p
    assert p.N > 1, p  # W multicast across the cluster


def test_plan_runs_waves_beyond_one():
    """The CLI's default B = 32 (8224 rows, 514 tiles) needs several waves;
    the plan takes the fewest, and the rows' recurrences being independent,
    each wave is whole chains."""
    p = wavefront_probe.plan(32 * 257, *SUB_BAND)
    assert p.tiles == 514 and p.waves > 1, p
    assert p.waves == -(-p.clusters // gp.CLUSTERS_AT_ONCE[p.N]), p
    for n in gp.CLUSTER_SIZES:
        assert p.waves <= -(-(-(-p.tiles // n)) // gp.CLUSTERS_AT_ONCE[n]), (n, p)


def test_plan_takes_a_ragged_last_tile():
    """10 rows: one tile of 16, six of its rows past the batch (the kernel
    computes them on zeros and writes none)."""
    p = wavefront_probe.plan(10, *SUB_BAND)
    assert (p.tiles, p.waves, p.R) == (1, 1, 16), p
    assert 2056 % p.R and wavefront_probe.plan(2056, *SUB_BAND).tiles * p.R - 2056 == 8


@pytest.mark.parametrize("label, Bb", SHAPES, ids=[s[0] for s in SHAPES])
def test_plan_fits_shared_memory(label, Bb):
    """Two buffers [x; h1; h2] of 16 rows and the ring within the 232,448
    bytes a block may use, by the formula the kernel checks; the deepest
    ring that fits, at least two slabs deep."""
    In, H = SUB_BAND
    p = wavefront_probe.plan(Bb, In, H)
    assert (p.In_p, p.Hp) == gp.padded(In, H) == (32, 384), p
    buf_rows = p.In_p + 2 * p.Hp
    assert p.smem == gp.smem_bytes(p.stages, p.Hp, buf_rows) <= gp.MAX_SMEM == 232448, p
    assert 2 <= p.stages <= gp.MAX_STAGES, p
    assert p.stages == gp.MAX_STAGES or gp.smem_bytes(p.stages + 1, p.Hp, buf_rows) > gp.MAX_SMEM
    assert p.smem == 225360, p  # 2 x 800 x 16 floats, 5 slabs of 4 x 1536, 10 barriers


@pytest.mark.parametrize("label, Bb", SHAPES, ids=[s[0] for s in SHAPES])
def test_cluster_size_within_what_is_co_resident(label, Bb):
    """N is 2 or 4, so W's slabs are multicast, and a wave's clusters never
    exceed what the card holds at once (the occupancy query's count for N,
    one CTA an SM)."""
    p = wavefront_probe.plan(Bb, *SUB_BAND)
    assert p.N in gp.CLUSTER_SIZES and p.N <= 4, p
    assert min(p.clusters, gp.CLUSTERS_AT_ONCE[p.N]) * p.N <= 132, p
    assert gp.CLUSTERS_AT_ONCE[p.N] * p.N <= 132
    per_wave = -(-p.clusters // p.waves)
    assert per_wave <= gp.CLUSTERS_AT_ONCE[p.N], p


@pytest.mark.parametrize("label, Bb", SHAPES, ids=[s[0] for s in SHAPES])
def test_plan_takes_the_larger_cluster_on_a_tie(label, Bb):
    """Of the sizes that run in the fewest waves, the plan takes the larger,
    which shares each slab among more CTAs; a single tile, or any shape
    whose clusters of 4 fit the waves of 2, runs on clusters of 4."""
    p = wavefront_probe.plan(Bb, *SUB_BAND)
    tiles = p.tiles
    waves = {n: -(-(-(-tiles // n)) // gp.CLUSTERS_AT_ONCE[n]) for n in gp.CLUSTER_SIZES}
    assert p.waves == min(waves.values()), p
    assert p.N == max(n for n in waves if waves[n] == p.waves), p
    if waves[4] <= waves[2]:
        assert p.N == 4, p


def test_plan_refuses_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="H <= 384"):
        wavefront_probe.plan(10, 32, 512)
    with pytest.raises(ValueError, match="In >= 1"):
        wavefront_probe.plan(10, 0, 64)
    with pytest.raises(ValueError, match="Bb"):
        wavefront_probe.plan(0, 32, 384)


def test_threads_and_registers_fit_an_sm():
    """Three consumer warpgroups of 160 registers a thread and the
    producer's of 24, after setmaxnreg, within an SM's 65,536 registers;
    12 warps of 32 units each cover H = 384."""
    assert gp.THREADS == 512
    assert (gp.THREADS - 128) * 160 + 128 * 24 <= 65536
    assert gp.MAX_UNITS == 12 * gp.UNITS_PER_WARP


def test_layout_holds_each_gate_where_the_kernel_reads_it():
    """``unit_major``: column 4 u + g holds gate g of unit u (gate-major
    column g H + u), zeros for the padded units; ``layout`` stacks the
    blocks with zero rows to each block's padded height, so (x; h) padded
    the same way times the laid-out W is x . W_ih + h . W_hh, unit-major."""
    rng = np.random.default_rng(0)
    T_in, H, Hp, In_p = 5, 20, 32, 8
    wih = torch.from_numpy(rng.standard_normal((T_in, 4 * H)).astype(np.float32))
    whh = torch.from_numpy(rng.standard_normal((H, 4 * H)).astype(np.float32))
    um = gp.unit_major(whh, Hp)
    assert um.shape == (H, 4 * Hp)
    for u in range(Hp):
        for g in range(4):
            want = whh[:, g * H + u] if u < H else torch.zeros(H)
            assert torch.equal(um[:, 4 * u + g], want), (u, g)
    w = gp.layout(((wih, In_p), (whh, Hp)), Hp)
    assert w.shape == (In_p + Hp, 4 * Hp) and w.is_contiguous()
    x = torch.from_numpy(rng.standard_normal((3, T_in)).astype(np.float32))
    h = torch.from_numpy(rng.standard_normal((3, H)).astype(np.float32))
    a = torch.zeros(3, In_p + Hp)
    a[:, :T_in], a[:, In_p:In_p + H] = x, h
    got = (a.double() @ w.double()).reshape(3, Hp, 4)[:, :H]  # [row, unit, gate]
    want = (x.double() @ wih.double() + h.double() @ whh.double()).reshape(3, 4, H)
    torch.testing.assert_close(got, want.transpose(1, 2), rtol=1e-12, atol=1e-12)


def test_wavefront_layout_shapes_and_biases():
    p = wavefront_probe.plan(10, 7, 40)
    assert (p.In_p, p.Hp) == (8, 64)
    rng = np.random.default_rng(1)
    G = 160
    w = lambda k: torch.from_numpy(rng.standard_normal((k, G)).astype(np.float32))
    b1, b2 = torch.arange(G, dtype=torch.float32), -torch.arange(G, dtype=torch.float32)
    w1, w2, bias = wavefront_probe.layout(w(7), b1, w(40), w(40), b2, w(40), p)
    assert w1.shape == (8 + 64, 256) and w2.shape == (128, 256) and bias.shape == (2, 256)
    assert bias[0, 4 * 3 + 2] == b1[2 * 40 + 3] and bias[1, 4 * 39 + 1] == b2[40 + 39]
    assert not bias[:, 4 * 40:].any() and not w1[7].any() and not w2[40:64].any()
    assert w1.shape[0] % gp.SLAB_ROWS == 0 and w2.shape[0] % gp.SLAB_ROWS == 0


@pytest.mark.parametrize("steps", [1, 7, 1956, 1957])
def test_dots_plan_fills_one_wave_and_covers_every_step(steps):
    """P3's dots-only over the 176-row tile: 11 row tiles times the groups
    of steps in one wave of co-resident clusters; every step in exactly one
    group (the last group fewer where the groups do not divide the steps)."""
    p = vpu_probe.dots_plan(vpu_probe.BB, vpu_probe.IN, vpu_probe.H, steps)
    assert p.tiles == 11 and p.N in gp.CLUSTER_SIZES, p
    assert p.clusters == -(-p.tiles * p.groups // p.N) <= gp.CLUSTERS_AT_ONCE[p.N], p
    covered = [s for g in range(p.groups) for s in range(g * p.per, min((g + 1) * p.per, steps))]
    assert covered == list(range(steps)), p
    assert p.smem == gp.smem_bytes(p.stages, p.Hp, p.In_p + p.Hp) <= gp.MAX_SMEM, p
    if steps == 1957:
        assert steps % p.groups, p  # a ragged last group


def test_dots_plan_at_the_probe_volume():
    """1956 steps (B = 8, T = 163): 12 groups of 163 steps on clusters of 2
    (132 CTAs, one wave); clusters of 4 would hold 10 groups (30 clusters),
    196 steps a CTA.  A few steps fit one wave of clusters of 4 as well,
    and then the plan takes them."""
    p = vpu_probe.dots_plan(176, 32, 384, 1956)
    assert (p.N, p.groups, p.per, p.clusters) == (2, 12, 163, 66), p
    assert 30 * 4 // 11 == 10 and -(-1956 // 10) > p.per
    p = vpu_probe.dots_plan(176, 32, 384, 7)
    assert (p.N, p.groups, p.per) == (4, 7, 1), p


@pytest.mark.parametrize("op", list(vpu_probe.PIPE_COUNTS))
def test_elementwise_bound_is_the_slower_of_mufu_and_fp32(op):
    """An elementwise op's bound is its own MUFU instructions at the SFU's
    16 a clock an SM or its FP32 ones at 128, whichever takes longer: no
    loads, addressing, loop control or keep-chain in it.  With at least
    one MUFU instruction for eight FP32 ones, every op is MUFU-bound."""
    n = vpu_probe.PIPE_COUNTS[op]
    assert set(n) == {"MUFU", "FP32"} and n["MUFU"] >= 1, n
    rates = vpu_probe.PIPE_RATES
    assert rates["FP32"] / rates["MUFU"] == 8
    elements = 1956 * vpu_probe.BB * vpu_probe.H
    mufu, fp32 = (1e3 * elements * n[p] / rates[p] for p in ("MUFU", "FP32"))
    assert vpu_probe.bound_ms(op, 1956) == pytest.approx(max(mufu, fp32), rel=1e-12)
    assert vpu_probe.bound_pipe(op) == "MUFU" and mufu >= fp32


def test_elementwise_bounds_at_the_probe_volume():
    """1956 steps of 176 x 384 (B = 8, T = 163): one MUFU instruction an
    element is 132.2 M at 4.19 T a second, 0.0316 ms (exp); sigmoid and
    the tanh forms two, 0.0631; gates-only ten, 0.316; dots-only's FMAs at
    67 TFLOP/s, 6.57 ms."""
    assert vpu_probe.bound_ms("exp", 1956) == pytest.approx(0.03157, rel=1e-3)
    for op in ("sigmoid", "tanh", "0.5*tanh+0.5"):
        assert vpu_probe.bound_ms(op, 1956) == pytest.approx(0.06314, rel=1e-3)
    assert vpu_probe.bound_ms("gates-only", 1956) == pytest.approx(0.3157, rel=1e-3)
    assert vpu_probe.bound_ms("dots-only", 1956) == pytest.approx(6.57, abs=0.01)
