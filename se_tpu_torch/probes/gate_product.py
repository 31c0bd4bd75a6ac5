"""The tiling and the weight layout of the probes' gate product
(``csrc/gate_product.cuh``): P2's wavefront kernel
(``csrc/wavefront_lstm.cu``) and P3's dots-only mode (``csrc/vpu_probe.cu``).

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


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


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
