"""The tiling and the weight layout of the gate product
(``csrc/gate_product.cuh``): the probes' P2's wavefront kernel
(``csrc/wavefront_lstm.cu``) and P3's dots-only mode (``csrc/vpu_probe.cu``),
and the wave design of K2 and K3 (``csrc/lstm_inproj.cu``,
``csrc/gru_inproj.cu``; :func:`wave_plan`).

A CTA holds ``TILE_ROWS`` batch rows and three warpgroups of consumer
warps, 32 units a warp (H at most ``MAX_UNITS``), beside the producer's
warpgroup.  W reaches it in
slabs of ``SLAB_ROWS`` rows k through a ring of ``stages`` slabs in shared
memory, each slab copied once a cluster of N CTAs (2 or 4) and multicast
to all N.  Pure Python, as ``ops/cluster_plan.py``: the kernels
check the tiling they are given against the same shared-memory formula
(``smem_bytes``) and refuse any other.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch
import torch.nn.functional as F

TILE_ROWS = 16  # rows a CTA: every weight a CTA receives serves 16 rows
SLAB_ROWS = 4  # rows k of W a ring slab
UNITS_PER_WARP = 32  # a consumer warp's units: 16 lanes of a row group, two units each
MAX_UNITS = 384  # 12 consumer warps (160 registers a thread) and the producer's 4 (24)
THREADS = 32 * (MAX_UNITS // UNITS_PER_WARP + 4)
MAX_SMEM = 232448  # bytes of shared memory a block may use on an H100
MAX_STAGES = 8
CLUSTER_SIZES = (4, 2)
# clusters of 2 and 4 CTAs of these kernels (one CTA an SM: ~225 KB of
# shared memory each) that an H100 holds at once: the occupancy query
# (active_clusters) on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md §6).
# Clusters of one CTA are not taken: the card holds 132, so they never run
# in fewer waves than clusters of 2, which share each slab
CLUSTERS_AT_ONCE = {2: 66, 4: 30}


# The wave design's cluster: 2 CTAs share each W slab.  Clusters of 4 hold
# 120 CTAs at once against 132 (CLUSTERS_AT_ONCE), so they never run in
# fewer waves, and P2 (the same product) ran no faster on 1 CTA than on 2
# (PERF.md §6): the FFMA issue bounds it, not L2.
WAVE_CLUSTER = 2
WAVE_MAX_STAGES = 8  # the ring's slabs at most (csrc/gate_product.cuh: kWaveMaxStages)
# The wave design's fewest units (whole warps): one consumer warp an SM
# quarter.  With fewer (K3's ragged H = 64) the ring's round trips are not
# hidden and the per-block kernel measured faster (PERF.md §6).
WAVE_MIN_UNITS = 4 * UNITS_PER_WARP


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@dataclass(frozen=True)
class WavePlan:
    """A launch's tiling in the wave design of K2 and K3 (on
    ``csrc/gate_product.cuh``): ``tiles`` row tiles of ``R`` = 16 rows a
    stack, one a CTA with all ``Hp`` units (H rounded up to whole warps), in
    ``clusters`` clusters of ``N`` CTAs over the L stacks, ``waves`` waves
    of the clusters the card holds at once; x padded to ``In_p`` rows k; a
    ring of ``stages`` W slabs; ``smem`` bytes a CTA."""

    R: int
    N: int
    stages: int
    In_p: int
    Hp: int
    tiles: int
    clusters: int
    waves: int
    smem: int
    design: str = "wave"

    def args(self) -> tuple:
        """The wave entries' tiling arguments ``(In_p, N, stages)``."""
        return self.In_p, self.N, self.stages


def wave_smem(In_p: int, Hp: int, stages: int, backward: bool) -> int:
    """A wave-design CTA's shared memory (``wave_smem`` in the source): the
    ring's ``stages`` slabs of 4 x 4 Hp floats; forward two operand
    buffers [x; h] of ``In_p + Hp`` rows of 16 floats, backward ``In_p + 5
    Hp`` rows (K3: one buffer [x; h_prev; dys] and dhp's 3 Hp rows; K2: [x;
    h_prev] and the dgates' 4 Hp rows); a full and an empty mbarrier a
    slab."""
    rows = In_p + 5 * Hp if backward else 2 * (In_p + Hp)
    return 4 * (stages * SLAB_ROWS * 4 * Hp + rows * TILE_ROWS) + 16 * stages


def wave_plan(Bb: int, In: int, H: int, backward: bool = False, L: int = 1) -> WavePlan:
    """The wave design's tiling of a launch over ``L`` stacks of ``Bb`` rows
    of ``In`` inputs and ``H`` units (at most ``MAX_UNITS``): tiles of 16
    rows, clusters of ``WAVE_CLUSTER``, the deepest ring that fits beside
    the buffers; raises where not even two slabs do."""
    In_p, Hp = padded(In, H)
    stages = next((s for s in range(WAVE_MAX_STAGES, 1, -1)
                   if wave_smem(In_p, Hp, s, backward) <= MAX_SMEM), None)
    if stages is None:
        raise ValueError(f"no wave tiling fits In={In}, H={H} in {MAX_SMEM} bytes")
    R, N = TILE_ROWS, WAVE_CLUSTER
    tiles = _cdiv(Bb, R)
    clusters = L * _cdiv(tiles, N)
    return WavePlan(R, N, stages, In_p, Hp, tiles, clusters,
                    _cdiv(clusters, CLUSTERS_AT_ONCE[N]), wave_smem(In_p, Hp, stages, backward))


def padded(In: int, H: int) -> tuple:
    """``(In_p, Hp)``: In rounded up to a pair of slabs (a product takes
    its slabs two at a time), H to whole warps."""
    if not 1 <= H <= MAX_UNITS or In < 1:
        raise ValueError(f"the gate product takes 1 <= H <= {MAX_UNITS} and In >= 1, "
                         f"not In={In}, H={H}")
    return _cdiv(In, 2 * SLAB_ROWS) * 2 * SLAB_ROWS, _cdiv(H, UNITS_PER_WARP) * UNITS_PER_WARP


def smem_bytes(stages: int, Hp: int, buf_rows: int) -> int:
    """A CTA's shared memory: the ring's ``stages`` slabs of SLAB_ROWS x 4 Hp
    floats, two operand buffers of ``buf_rows`` x TILE_ROWS floats, and a
    full and an empty mbarrier a stage (``gate_smem_bytes``)."""
    return 4 * (stages * SLAB_ROWS * 4 * Hp + 2 * buf_rows * TILE_ROWS) + 16 * stages


def ring_stages(Hp: int, buf_rows: int) -> int:
    """The deepest ring, up to ``MAX_STAGES`` slabs, that fits beside the
    buffers; raises where not even two do."""
    stages = next((s for s in range(MAX_STAGES, 1, -1)
                   if smem_bytes(s, Hp, buf_rows) <= MAX_SMEM), None)
    if stages is None:
        raise ValueError(f"no ring of two slabs fits beside {buf_rows} buffer rows at Hp={Hp}")
    return stages


def unit_major(w: torch.Tensor, Hp: int) -> torch.Tensor:
    """``w [..., 4H]`` with gate-major columns (``g H + u``, gates i, f, g,
    o) -> ``[..., 4 Hp]`` with unit-major ones (``4 u + g``), zero past H."""
    H = w.shape[-1] // 4
    v = w.reshape(*w.shape[:-1], 4, H).transpose(-1, -2)
    return F.pad(v, (0, 0, 0, Hp - H)).reshape(*w.shape[:-1], 4 * Hp)


def layout(blocks, Hp: int) -> torch.Tensor:
    """The weights as the gate product reads them: each ``(w [k, 4H],
    rows)`` of ``blocks`` unit-major and padded with zero rows to ``rows``,
    stacked: ``[sum of rows, 4 Hp]``, contiguous f32, a slab every
    SLAB_ROWS rows."""
    return torch.cat([F.pad(unit_major(w.float(), Hp), (0, 0, 0, rows - w.shape[0]))
                      for w, rows in blocks]).contiguous()


def active_clusters(lib, query: str, In: int, H: int, In_p: int, N: int, stages: int,
                    device=None) -> int:
    """How many clusters of N CTAs of a gate-product kernel fit on the CUDA
    ``device`` at once: ``lib.<query>``, the runtime's occupancy query for
    that tiling (In, H, In_p, N, stages); raises on a CUDA error."""
    dev = torch.device("cuda") if device is None else torch.device(device)
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    fn = getattr(lib, query)
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_int] * 6
        fn.restype = ctypes.c_int
    got = fn(In, H, In_p, N, stages, index)
    if got < 0:
        raise RuntimeError(f"{query} failed: CUDA error {-got} "
                           f"({lib.se_cuda_error_string(-got).decode()})")
    return got
