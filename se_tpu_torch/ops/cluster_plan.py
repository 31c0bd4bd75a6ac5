"""The tiling planner of the recurrent scans on thread-block clusters: K2
(``csrc/lstm_inproj.cu``, the LSTM's four gates), K1 (``csrc/lstm_scan.cu``,
the same kernels without the input projection) and K3
(``csrc/gru_inproj.cu``, the GRU's three), all on the machinery of
``csrc/cluster_scan.cuh``.

A cluster of N CTAs holds a tile of R batch rows of one stack, CTA q the
U = ceil(H / N) units q U .. and their gate columns; C steps a chunk of the
input projection.  Pure Python: the kernels check the tiling they are given
against the same shared-memory formula (``tiling_smem``) and refuse any
other.
"""

from __future__ import annotations

from dataclasses import dataclass

MAX_SMEM = 232448  # bytes of shared memory a block may use on an H100
MAX_CLUSTER = 16  # CTAs a cluster (above 8: the card's non-portable size)
MAX_ROWS = 32  # rows a tile
ROW_QUANTUM = 4  # a thread's rows, read as one float4
MAX_CHUNK = 8  # steps a chunk projects at once
THREADS = 512  # a CTA's threads


@dataclass(frozen=True)
class Plan:
    """One launch's tiling: ``tiles`` clusters of ``N`` CTAs per stack,
    ``R`` rows a cluster, ``U`` units a CTA (the last one fewer where N does
    not divide H), chunks of ``C`` steps, the CTA's W_hh slice ``resident``
    in shared memory (else read from L2 every step), ``smem`` bytes a
    CTA.  ``design`` is ``"cluster"``, the one design K1 has; K2 and K3
    run others at their sub band (``fused_lstm_inproj.plan``,
    ``fused_gru_inproj.plan``)."""

    R: int
    N: int
    U: int
    C: int
    resident: bool
    smem: int
    tiles: int
    design: str = "cluster"

    def args(self) -> tuple:
        """The entries' tiling arguments ``(R, N, C, resident)``."""
        return self.R, self.N, self.C, int(self.resident)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def cell_threads(U: int, R: int) -> int:
    """The threads of a CTA's cell update: a warp per 8 units x 4 row groups
    of 4 rows (the same for either gate count)."""
    return 32 * _cdiv(U, 8) * _cdiv(R // ROW_QUANTUM, 4)


def cluster_split(H: int) -> tuple:
    """``(N, U)``: a CTA per 8 units, at most ``MAX_CLUSTER``: H = 128 and
    more on 16 CTAs, which share the chunk's input projection too (the same
    for either gate count)."""
    N = min(MAX_CLUSTER, max(1, _cdiv(H, 8)))
    U = _cdiv(H, N)
    return _cdiv(H, U), U


def slice_ld(gates: int, U: int) -> int:
    """The floats between two rows k of the resident W_hh slice, which holds
    a unit's gates side by side: K2 reads its four as one float4, rows
    4U + 4 apart; K3's backward reads along k a lane each, so its rows are
    an odd number of floats apart (``csrc/cluster_scan.cuh::slice_ld``)."""
    return 4 * U + 4 if gates == 4 else (gates * U) | 1


def smem_bytes(R: int, N: int, U: int, C: int, In: int, H: int, resident: bool,
               backward: bool, gates: int = 4) -> int:
    """A CTA's shared memory: the chunk's x [C][In][R] and projections
    [C][gates U][R]; forward h [H][R] and one [U][R] buffer (K2: c; K3:
    hp_n), backward h_prev [H][R], the partial dh it receives [N][U][R] and
    two [U][R] buffers (K2: the dh and dc carries; K3: the dh carry and
    hp_n); the resident W_hh slice [H][slice_ld]."""
    floats = C * R * (In + gates * U)
    floats += (H + N * U + 2 * U) * R if backward else (H + U) * R
    if resident:
        floats += H * slice_ld(gates, U)
    return 4 * floats


def split(H: int, N: int) -> tuple:
    """``(N', U)``: H units over at most N CTAs, U = ceil(H / N) each, and
    as many CTAs as that needs (none without units)."""
    if not 1 <= N <= MAX_CLUSTER:
        raise ValueError(f"a cluster holds 1 to {MAX_CLUSTER} CTAs, not {N}")
    U = _cdiv(H, min(N, H))
    return _cdiv(H, U), U


def plan(Bb: int, In: int, H: int, backward: bool = False, gates: int = 4,
         max_rows: int = MAX_ROWS, N: int | None = None) -> Plan:
    """The tiling of a launch of a ``gates``-gate scan (4: K1, K2; 3: K3;
    forward, or the backward's reverse scan) over ``Bb`` rows of ``In``
    inputs (K1: 0, its projection made outside) and ``H`` units, on
    clusters of ``cluster_split(H)`` CTAs or, given ``N``, ``split(H, N)``.
    The W_hh slice is resident wherever a tile of 4 rows fits beside it.  A
    tile takes as many rows (up to ``max_rows``, at most ``MAX_ROWS``) as
    fit, the tiles then evened out over the batch; the chunk is the longest
    up to ``MAX_CHUNK`` steps that fits.  The stream dtype does not enter: x
    is staged as f32 in both forms."""
    N, U = cluster_split(H) if N is None else split(H, N)

    def fits(R, C, resident):  # in shared memory, a cell item a thread
        return (smem_bytes(R, N, U, C, In, H, resident, backward, gates) <= MAX_SMEM
                and cell_threads(U, R) <= THREADS)

    resident = fits(ROW_QUANTUM, 1, True)
    top = min(max_rows, MAX_ROWS, _cdiv(Bb, ROW_QUANTUM) * ROW_QUANTUM)
    widest = next((R for R in range(top, 0, -ROW_QUANTUM) if fits(R, 1, resident)), None)
    if widest is None:
        raise ValueError(f"no {gates}-gate cluster tiling fits Bb={Bb}, In={In}, H={H} "
                         f"in {MAX_SMEM} bytes")
    tiles = _cdiv(Bb, widest)
    R = _cdiv(_cdiv(Bb, tiles), ROW_QUANTUM) * ROW_QUANTUM
    C = next(c for c in range(MAX_CHUNK, 0, -1) if fits(R, c, resident))
    return Plan(R, N, U, C, resident, smem_bytes(R, N, U, C, In, H, resident, backward, gates),
                tiles)
