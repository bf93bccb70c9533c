"""Wrapper of the CUDA family-count kernel (``csrc/family_counts.cu``).

    family_counts(xd [N, Fd] int32, strides [M, Fd] int32, w [N] f32, C)
        -> counts [M, C] f32,  counts[m, c] = sum_n w[n] [code(n, m) == c]

with ``code(n, m) = sum_f strides[m, f] * xd[n, f]``; a code outside
[0, C) counts nothing.  Same signature as the Pallas kernel of
``repro.kernels.family_counts``.

A tensor on the CPU goes to the plain PyTorch version
(``kernels.ref.family_counts_ref``); a CUDA tensor launches the kernel or
raises -- there is no fallback.  Launches are counted in :data:`LAUNCHES`.

Before a launch the wrapper compacts the dense stride matrix into k
(column, stride) pairs per family (:func:`compact_strides`) and picks the
launch geometry (:func:`plan`): families per block, the instance tile, the
split of C into ranges whose bin-major histograms fit shared memory
(weighing more ranges against more resident blocks), and the number of
instance slabs.  Every shape is taken except a family with more than 32
nonzero strides, or more than 511 discrete columns (a tile of at least 8
instances must fit 16 KB of shared memory).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Tuple

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.clg_stats import _check, _launch, _route, sm_count

Tensor = torch.Tensor

LAUNCHES = {"family_counts": 0}

THREADS = 256                     # kThreads in family_counts.cu
STAGES = 2                        # kStages: the xd tiles' double buffer
MAX_K = 32                        # the largest KMAX instantiated there
SM_SMEM = 233472                  # shared memory of an SM (228 KB)
BLOCK_RESERVED = 1024             # shared memory the runtime keeps a block
SMEM_MAX = 232448                 # dynamic shared memory a block may use
MAX_BLOCKS = 8                    # 2048 threads an SM / 256
TILE_WORDS = 4096                 # int32 words of an xd tile (16 KB)
MIN_TILE, MAX_TILE = 8, 256
MAX_FD = TILE_WORDS // MIN_TILE - 1       # 511
PARTIAL_WORDS = 1 << 24           # 64 MB of slab partials at most


class Plan(NamedTuple):
    G: int            # families per block (power of two, 32..256)
    T: int            # instances per shared-memory tile (a multiple of 4)
    Cb: int           # bins per block (C is split into ceil(C / Cb) ranges)
    slab_len: int     # instances per slab (a multiple of T)
    n_slabs: int
    n_groups: int
    n_cranges: int
    smem_bytes: int
    blocks_per_sm: int    # resident blocks an SM, by shared memory


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def compact_strides(strides: Tensor) -> Tuple[Tensor, Tensor]:
    """[M, Fd] strides -> (cols [M, k], svals [M, k]) int32: each family's
    nonzero strides in column order, padded with stride 0, so
    ``sum_j svals[m, j] * xd[n, cols[m, j]]`` is the family's code.
    k = the most nonzero strides of any family (at least 1)."""
    nz = strides != 0
    k = max(1, int(nz.sum(1).max())) if strides.shape[0] else 1
    order = torch.argsort((~nz).to(torch.int8), dim=1, stable=True)[:, :k]
    return order.to(torch.int32), torch.gather(strides, 1, order).to(
        torch.int32)


def quad_stride(T: int) -> int:
    """Words a column of the transposed byte tile takes (odd: the columns a
    warp reads sit in distinct banks)."""
    return (T // 4) | 1


def smem_bytes(Fd: int, Cb: int, T: int) -> int:
    """Shared memory of a block: the bin-major histograms [Cb + 1, 256] (a
    spill bin takes the codes outside the block's range), :data:`STAGES`
    weight and int32 xd tiles, and the byte tile."""
    return 4 * (THREADS * (Cb + 1) + STAGES * T * (1 + Fd)
                + Fd * quad_stride(T))


def resident_blocks(smem: int) -> int:
    """Blocks of ``smem`` bytes an SM holds, by shared memory and threads."""
    return min(MAX_BLOCKS, SM_SMEM // (smem + BLOCK_RESERVED))


def plan(N: int, Fd: int, M: int, C: int, sms: int) -> Plan:
    """Launch geometry for ``N`` instances of ``Fd`` columns, ``M``
    families and ``C`` bins on a card of ``sms`` SMs (raises on what the
    kernel does not take).

    C is split into the fewest ranges that fit one block an SM, or into
    the fewest that fit two where that costs fewer passes per resident
    block (``ranges / min(blocks an SM, 2)``; a tie keeps the fewer ranges,
    which measured faster at C = 256).  The slabs fill one round of the
    card's resident blocks: more slabs only add partials to write and
    sum."""
    if Fd > MAX_FD:
        raise ValueError(f"family_counts: {Fd} discrete columns exceed the "
                         f"kernel's limit of {MAX_FD} (a tile of {MIN_TILE} "
                         f"instances in {4 * TILE_WORDS} bytes of shared "
                         f"memory)")
    T = max(MIN_TILE, min(MAX_TILE, TILE_WORDS // Fd) // 4 * 4)
    tile = smem_bytes(Fd, -1, T)

    def split(blocks):
        per_block = min(SMEM_MAX, SM_SMEM // blocks - BLOCK_RESERVED)
        n = -(-C // ((per_block - tile) // (4 * THREADS) - 1))
        return n / min(2, resident_blocks(smem_bytes(Fd, -(-C // n), T))), n

    n_cranges = min(split(1), split(2))[1]
    Cb = -(-C // n_cranges)
    smem = smem_bytes(Fd, Cb, T)
    G = 32
    while G < min(M, THREADS):
        G *= 2
    n_groups = -(-M // G)
    n_tiles = -(-N // T)
    per_sm = resident_blocks(smem)
    want = sms * per_sm // (n_groups * n_cranges)
    n_slabs = max(1, min(n_tiles, want, PARTIAL_WORDS // max(1, M * C)))
    slab_len = -(-n_tiles // n_slabs) * T
    n_slabs = -(-N // slab_len)
    return Plan(G=G, T=T, Cb=Cb, slab_len=slab_len, n_slabs=n_slabs,
                n_groups=n_groups, n_cranges=n_cranges, smem_bytes=smem,
                blocks_per_sm=per_sm)


def _lib():
    from repro_torch.kernels import build

    lib = build.load("family_counts")
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.family_counts_launch.argtypes = [p, p, p, p, p, p, i, i, i, i, i,
                                             i, i, i, i, p]
        lib.family_counts_launch.restype = i
        for fn in (lib.family_counts_threads, lib.family_counts_max_k):
            fn.argtypes, fn.restype = [], i
        lib.family_counts_smem_bytes.argtypes = [i, i, i]
        lib.family_counts_smem_bytes.restype = ctypes.c_long
        lib.family_counts_blocks_per_sm.argtypes = [i, i]
        lib.family_counts_blocks_per_sm.restype = i
        if (lib.family_counts_threads() != THREADS
                or lib.family_counts_max_k() != MAX_K):
            raise RuntimeError("family_counts.cu and family_counts.py "
                               "disagree on the block size or MAX_K")
        for Fd, Cb, T in ((32, 64, 128), (3, 9, 256), (511, 16, 8)):
            if lib.family_counts_smem_bytes(Fd, Cb, T) != smem_bytes(Fd, Cb,
                                                                     T):
                raise RuntimeError("family_counts.cu and family_counts.py "
                                   "disagree on the shared memory of a block")
        lib._typed = True
    return lib


def blocks_per_sm(k: int, p: Plan) -> int:
    """Blocks of the counting kernel (families of ``k`` pairs, plan ``p``)
    that one SM of the current card holds at once
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``)."""
    return _lib().family_counts_blocks_per_sm(k, p.smem_bytes)


def family_counts(xd: Tensor, strides: Tensor, w: Tensor, C: int) -> Tensor:
    """Weighted joint-configuration histogram of every family in one pass
    over the instances: xd [N, Fd] int32, strides [M, Fd] int32 mixed-radix
    weights (0 outside the family), w [N] float32 -> counts [M, C]."""
    name = "family_counts"
    dev = xd.device
    _check(name, xd, "xd", torch.int32, 2, dev)
    _check(name, strides, "strides", torch.int32, 2, dev)
    _check(name, w, "w", torch.float32, 1, dev)
    N, Fd = xd.shape
    M = strides.shape[0]
    if strides.shape[1] != Fd or w.shape[0] != N or C < 1:
        raise ValueError(f"{name}: shapes xd{tuple(xd.shape)} strides"
                         f"{tuple(strides.shape)} w{tuple(w.shape)} C={C} "
                         f"disagree")
    if not _route(name, dev):
        return ref.family_counts_ref(xd, strides, w, C)
    if N == 0 or M == 0:
        return torch.zeros(M, C, dtype=torch.float32, device=dev)
    cols, svals = compact_strides(strides)
    k = cols.shape[1]
    if k > MAX_K:
        raise ValueError(f"{name}: a family with {k} nonzero strides exceeds "
                         f"the kernel's limit of {MAX_K}")
    p = plan(N, Fd, M, C, sm_count(dev))
    opts = dict(dtype=torch.float32, device=dev)
    partial = torch.empty(p.n_slabs * M * C, **opts)
    out = torch.empty(M, C, **opts)
    _launch(LAUNCHES, name, dev, _lib().family_counts_launch,
            xd.data_ptr(), cols.data_ptr(), svals.data_ptr(), w.data_ptr(),
            partial.data_ptr(), out.data_ptr(), N, Fd, M, k, C, p.Cb, p.G,
            p.T, p.slab_len)
    return out
