"""Wrappers of the CUDA suff-stats kernels (``csrc/clg_stats.cu``).

The three public functions compute what the Pallas kernels of
``repro.kernels.clg_stats`` compute, with the same signatures:

    clg_suffstats(d, y, r)                          -> sxx, sxy, syy
    clg_suffstats_latent(obs, h_mean, y, r, s_hh)   -> sxx, sxy, syy (dense)
    clg_disc_counts(xd, r, C)                       -> disc [Fd, K, C]

and :func:`clg_suffstats_chunks` launches ``clg_suffstats`` once over equal
instance chunks of one array (the CLG structure search's float64 scheme),
each chunk's moments the same bits as ``clg_suffstats`` of that chunk;
:func:`clg_seq_suffstats` is ``clg_suffstats`` over sequence batches
(``[B, T]`` leading axes read as one instance axis: the temporal models'
M-steps).

A tensor on the CPU goes to the plain PyTorch version (``kernels.ref``); a
CUDA tensor launches the kernel or raises -- there is no fallback.  Each
wrapper counts its launches in :data:`LAUNCHES`, so a run can show that its
main path went through the kernels.  :func:`_route` and :func:`_launch`,
shared by every wrapper of the port, also count each dispatch for
``repro_torch.obs`` (``<kernel>:einsum`` for the plain version,
``<kernel>:cuda`` for a launch), and the launch counts are safe under the
serving tier's worker threads.

The kernels read their inputs in place, through their row strides: any
number of leaves, any design width and any number of discrete columns go in
one launch, with no padding and no copy.  Each splits its instances into a
fixed range partition sized by the shapes and the card's SM count
(:func:`moments_plan`, :func:`latent_plan`, :func:`disc_plan`), so two
launches on one input give the same bits.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels import ref
from repro_torch.obs import sink as obs_sink

Tensor = torch.Tensor

LAUNCHES = {"clg_suffstats": 0, "clg_suffstats_chunks": 0,
            "clg_seq_suffstats": 0, "clg_suffstats_latent": 0,
            "clg_disc_counts": 0}

THREADS = 256                 # kThreads in clg_stats.cu
ROW_BLOCK = 32                # kRowsBlock: columns of a row a D > 8 unit sums
MAX_SLOTS = 48                # kMaxSlots: sums a thread keeps
BLOCKS_PER_SM = 8             # stage-1 blocks a chunk aims at, an SM
DISC_BLOCKS_PER_SM = 4        # clg_disc_counts: blocks an SM at most,
DISC_MIN_ITERS = 32           # and instances an instance lane at least
MIN_ITERS = 8                 # instances an instance lane takes at least
RANGE_LANES = 32              # kRangeLanes: stage 2's range lanes


class MomentPlan(NamedTuple):
    """How ``clg_suffstats`` splits one chunk of ``n`` instances.  A unit is KG components of a leaf (D <= 8)
    or one component, one row of sxx and one block of up to ``ROW_BLOCK``
    columns of that row (D > 8); a block is FT leaves x UB units x NL
    instance lanes; the chunk is R ranges of ``range_len`` instances."""
    KG: int
    FT: int
    UB: int
    NL: int
    W: int            # units a leaf
    n_ublocks: int    # blocks along the units
    R: int
    range_len: int


def entries_per_unit(D: int) -> int:
    """Moments of one (leaf, component): sxx's upper triangle, sxy, syy."""
    return D * (D + 1) // 2 + D + 1


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


@functools.lru_cache(maxsize=16)
def _sms_of_index(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def sm_count(device: torch.device) -> int:
    """SMs of the card ``device`` names (the current card for a bare
    ``cuda``), asked once a card."""
    index = device.index
    return _sms_of_index(torch.cuda.current_device() if index is None
                         else index)


def _ranges(n: int, per_range: int, NL: int, sms: int,
            per_sm: int = BLOCKS_PER_SM, min_iters: int = MIN_ITERS
            ) -> Tuple[int, int]:
    """(R, range_len): ``n`` instances in R ranges, enough blocks of
    ``per_range`` a range to give each of ``sms`` SMs ``per_sm``, and at
    least ``min_iters`` instances an instance lane."""
    R = max(1, min(per_sm * sms // per_range, n // (NL * min_iters)))
    range_len = -(-n // R)
    return -(-n // range_len), range_len


@functools.lru_cache(maxsize=256)
def moments_plan(n: int, F: int, D: int, K: int, sms: int) -> MomentPlan:
    """The fixed partition of a chunk of ``n`` instances on a card of
    ``sms`` SMs: it depends on the shapes alone, so a chunk of a chunked
    launch is split as a call on that chunk alone would split it."""
    U = entries_per_unit(D)
    if D <= 8:
        # the fewest units: KG covers K where it can (K = 3 takes 4 slots,
        # one idle), as long as the accumulators fit MAX_SLOTS
        KG = next(g for g in (4, 2, 1)
                  if g == 1 or (g < 2 * K and g * U <= MAX_SLOTS))
        W = -(-K // KG)
    else:
        KG, W = 1, K * D * -(-D // ROW_BLOCK)
    FT = min(F, 32)
    UB = min(W, THREADS // FT)
    NL = THREADS // (FT * UB)
    n_ublocks = -(-W // UB)
    R, range_len = _ranges(n, -(-F // FT) * n_ublocks, NL, sms)
    return MomentPlan(KG=KG, FT=FT, UB=UB, NL=NL, W=W, n_ublocks=n_ublocks,
                      R=R, range_len=range_len)


class RowBlock(NamedTuple):
    """A D > 8 latent unit's row i of sxx and its column block j, which
    holds the columns col0 .. col0 + width - 1."""
    i: int
    j: int
    col0: int
    width: int


@functools.lru_cache(maxsize=64)
def latent_row_units(D: int, L: int) -> Tuple[RowBlock, ...]:
    """The live (row, column block) units of one component of the latent
    moments with D > 8, row by row (``ColBlocks`` in clg_stats.cu): blocks
    of up to ROW_BLOCK of the D - L observed columns, then of the L latent
    ones, so that a block reads one array; row i takes the blocks from the
    one that holds column i on (the others lie left of the diagonal)."""
    Dp = D - L
    NBo = -(-Dp // ROW_BLOCK)
    blocks = ([(c, min(ROW_BLOCK, Dp - c)) for c in range(0, Dp, ROW_BLOCK)]
              + [(c, min(ROW_BLOCK, D - c)) for c in range(Dp, D, ROW_BLOCK)])
    block_of = lambda b: (b // ROW_BLOCK if b < Dp
                          else NBo + (b - Dp) // ROW_BLOCK)
    return tuple(RowBlock(i, j, *blocks[j]) for i in range(D)
                 for j in range(block_of(i), len(blocks)))


class LatentUnits(NamedTuple):
    """The layout of ``clg_suffstats_latent``'s stage 1 (``LatentLayout``
    in clg_stats.cu).  The latent-latent block is the same for every leaf,
    so a leaf unit belongs to a (leaf, component) and a latent unit to a
    component: UO entries a (leaf, component) -- the Do observed rows of
    sxx's upper triangle, sxy, syy -- and UH a component -- the latent
    rows, rsum_k.  D <= 8: one unit of each kind holds them all (Wo = Wh =
    1); D > 8: Wo leaf units (the y row's column blocks, for sxy and syy,
    then the observed rows' live units of :func:`latent_row_units`) and Wh
    latent units (the latent rows' live units)."""
    UO: int
    UH: int
    Wo: int
    Wh: int


@functools.lru_cache(maxsize=64)
def latent_units(Do: int, L: int) -> LatentUnits:
    D = Do + L
    UO, UH = Do * D - Do * (Do - 1) // 2 + D + 1, L * (L + 1) // 2 + 1
    if D <= 8:
        return LatentUnits(UO, UH, 1, 1)
    rows = latent_row_units(D, L)
    n_obs = sum(u.i < Do for u in rows)
    NB = sum(u.i == 0 for u in rows)
    return LatentUnits(UO, UH, NB + n_obs, len(rows) - n_obs)


class LatentPlan(NamedTuple):
    """How ``clg_suffstats_latent`` splits its ``n`` instances: a leaf
    block is FT leaves x UB of the K * Wo leaf units x NL instance lanes, a
    latent block UBh of the K * Wh latent units x NLh lanes
    (:class:`LatentUnits`); the instances are R ranges of ``range_len``."""
    FT: int
    UB: int
    NL: int
    UBh: int
    NLh: int
    R: int
    range_len: int


@functools.lru_cache(maxsize=256)
def latent_plan(n: int, F: int, Do: int, L: int, K: int, sms: int
                ) -> LatentPlan:
    """The fixed partition of ``clg_suffstats_latent``'s instances on a
    card of ``sms`` SMs: it depends on the shapes alone.  The ranges are
    sized by the leaf blocks (the latent blocks are F times lighter)."""
    u = latent_units(Do, L)
    W, Wh = K * u.Wo, K * u.Wh
    FT = min(F, 32)
    UB = min(W, THREADS // FT)
    NL = THREADS // (FT * UB)
    UBh = min(Wh, THREADS)
    R, range_len = _ranges(n, -(-F // FT) * -(-W // UB), NL, sms)
    return LatentPlan(FT=FT, UB=UB, NL=NL, UBh=UBh, NLh=THREADS // UBh,
                      R=R, range_len=range_len)


class DiscPlan(NamedTuple):
    """How ``clg_disc_counts`` splits its ``n`` instances
    (``clg_disc_counts_launch`` in clg_stats.cu).  A unit is a leaf x KG
    components x CB bins (a power of two), KG * CB <= MAX_SLOTS sums in
    registers; there are Fd x n_kg x n_cb units, unit u = (kg * n_cb + cb)
    * Fd + f.  A block is PU unit positions x NL = THREADS / PU instance
    lanes (thread t: position t % PU, lane t // PU); the instances are R
    ranges of ``range_len``, lane l of a range taking l, l + NL, ..."""
    KG: int
    CB: int
    n_kg: int
    n_cb: int
    PU: int
    NL: int
    R: int
    range_len: int


def _pow2_at_least(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


@functools.lru_cache(maxsize=256)
def disc_plan(n: int, Fd: int, K: int, C: int, sms: int) -> DiscPlan:
    """The fixed partition of ``clg_disc_counts`` over ``n`` instances of
    ``Fd`` leaves, ``K`` components and ``C`` categories on a card of
    ``sms`` SMs.  Bins: blocks of CB = the power of two >= C (2..16).
    Components: the fewest groups of at most 4 (and MAX_SLOTS / CB), KG
    each.  Unit positions: the power of two >= the units, at most 32 (a
    warp of neighbouring leaves).  Ranges: DISC_MIN_ITERS instances a
    lane (a lane's loads are a chain of trips to device memory, and fewer,
    longer ranges spend less on the lanes' sums and stage 2), up to
    DISC_BLOCKS_PER_SM blocks an SM where the lanes are few (PU large)."""
    CB = min(16, _pow2_at_least(max(2, C)))
    n_kg = -(-K // min(4, MAX_SLOTS // CB))
    KG = -(-K // n_kg)
    n_cb = -(-C // CB)
    units = Fd * n_kg * n_cb
    PU = min(32, _pow2_at_least(units))
    NL = THREADS // PU
    R, range_len = _ranges(n, -(-units // PU), NL, sms, DISC_BLOCKS_PER_SM,
                           DISC_MIN_ITERS)
    return DiscPlan(KG=KG, CB=CB, n_kg=n_kg, n_cb=n_cb, PU=PU, NL=NL, R=R,
                    range_len=range_len)


def _lib():
    from repro_torch.kernels import build

    lib = build.load("clg_stats")
    if not getattr(lib, "_typed", False):
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_long
        lib.clg_latent_launch.argtypes = [p] * 9 + [ll] + [i] * 12 + [p]
        lib.clg_latent_launch.restype = i
        lib.clg_suffstats_launch.argtypes = ([p] * 7 + [ll] * 5
                                             + [i] * 14 + [p])
        lib.clg_suffstats_launch.restype = i
        lib.clg_disc_counts_launch.argtypes = ([p] * 4 + [ll] + [i] * 7
                                               + [ll, p])
        lib.clg_disc_counts_launch.restype = i
        lib.clg_stats_threads.argtypes = []
        lib.clg_stats_threads.restype = i
        if lib.clg_stats_threads() != THREADS:
            raise RuntimeError("clg_stats.cu and clg_stats.py disagree on the "
                               "block size")
        lib.clg_latent_units.argtypes = [i, i, ctypes.POINTER(i)]
        lib.clg_latent_units.restype = i
        for Do, L in ((1, 4), (3, 5), (1, 16), (2, 38), (40, 3), (1, 70)):
            out = (i * 4)()
            lib.clg_latent_units(Do, L, out)
            if tuple(out) != latent_units(Do, L):
                raise RuntimeError(f"clg_stats.cu and clg_stats.py disagree "
                                   f"on the latent units of Do = {Do}, L = "
                                   f"{L}")
        lib._typed = True
    return lib


def _check(name: str, t: Tensor, what: str, dtype: torch.dtype, ndim: int,
           device: torch.device) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: {what} must be a torch.Tensor")
    if t.dtype != dtype:
        raise TypeError(f"{name}: {what} must be {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: {what} must have {ndim} dims, got "
                         f"shape {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name}: {what} is on {t.device}, expected {device}")
    if device.type == "cuda" and not t.is_contiguous():
        raise ValueError(f"{name}: {what} must be contiguous")


# guards every wrapper's LAUNCHES bump (the serving tier's workers launch
# from several threads)
_LAUNCH_LOCK = threading.Lock()


def _route(name: str, device: torch.device) -> bool:
    """True -> launch the kernel; False -> plain version (CPU tensors),
    counted as ``<name>:einsum`` when obs is on."""
    if device.type == "cpu":
        obs_sink.count_kernel(name + ":einsum")
        return False
    if device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {device}")
    return True


def _launch(counts: Optional[dict], name: str, dev: torch.device, fn,
            *args) -> None:
    """Call the C launcher ``fn(*args, stream)`` on ``dev``'s current stream
    and count one launch of ``name`` in ``counts`` (under a lock) and, when
    obs is on, one ``<name>:cuda`` dispatch; ``counts`` None counts
    nothing (a launch inside another wrapper's call).  The device is switched
    only when it is not the current one: the smallest kernels take tens of
    microseconds, and the host's cost per call must stay below that."""
    current = torch.cuda.current_device()
    index = current if dev.index is None else dev.index
    # the raw handle: torch.cuda.current_stream builds a Stream object,
    # which costs more host time than the smallest of these kernels
    stream = torch._C._cuda_getCurrentRawStream(index)
    if index == current:
        err = fn(*args, stream)
    else:
        with torch.cuda.device(index):
            err = fn(*args, stream)
    if err:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error "
                           f"{err}")
    if counts is None:
        return
    with _LAUNCH_LOCK:
        counts[name] += 1
    obs_sink.count_kernel(name + ":cuda")


def _check_moments(name: str, d: Tensor, y: Tensor, r: Tensor) -> None:
    dev = d.device
    _check(name, d, "d", torch.float32, 3, dev)
    _check(name, y, "y", torch.float32, 2, dev)
    _check(name, r, "r", torch.float32, 2, dev)
    N, F, D = d.shape
    if tuple(y.shape) != (N, F) or r.shape[0] != N:
        raise ValueError(f"{name}: shapes d{tuple(d.shape)} y{tuple(y.shape)}"
                         f" r{tuple(r.shape)} disagree")


def _suffstats_launch(name: str, d: Tensor, y: Tensor, r: Tensor,
                      chunk: int, chunked: bool
                      ) -> Tuple[Tensor, Tensor, Tensor]:
    """One launch over ``ceil(N / chunk)`` chunks of ``chunk`` instances
    (the last one shorter): float32 moments of each, with a leading chunk
    axis where ``chunked``."""
    N, F, D = d.shape
    K = r.shape[1]
    if N == 0:
        raise ValueError(f"{name}: needs at least one instance")
    if D < 1:
        raise ValueError(f"{name}: a design needs at least one column")
    n_chunks = -(-N // chunk)
    if n_chunks > 65535:
        raise ValueError(f"{name}: {n_chunks} chunks exceed the grid's limit "
                         f"of 65535")
    sms = sm_count(d.device)
    full = moments_plan(min(chunk, N), F, D, K, sms)
    last = moments_plan(N - (n_chunks - 1) * chunk, F, D, K, sms)
    E = F * K * entries_per_unit(D)
    opts = dict(dtype=torch.float32, device=d.device)
    partial = torch.empty(n_chunks * max(full.R, last.R) * E, **opts)
    a, b = n_chunks * F * K * D * D, n_chunks * F * K * D
    out = torch.empty(a + b + n_chunks * F * K, **opts)
    lead = (n_chunks,) if chunked else ()
    sxx = out[:a].view(lead + (F, K, D, D))
    sxy = out[a:a + b].view(lead + (F, K, D))
    syy = out[a + b:].view(lead + (F, K))
    vec = 1
    if D <= 8:
        vec = next(v for v in (4, 2, 1)
                   if v == 1 or (D % v == 0 and d.data_ptr() % (4 * v) == 0))
    rvec = full.KG if (K % full.KG == 0
                       and r.data_ptr() % (4 * full.KG) == 0) else 1
    _launch(LAUNCHES, name, d.device, _lib().clg_suffstats_launch,
            d.data_ptr(), y.data_ptr(), r.data_ptr(), partial.data_ptr(),
            sxx.data_ptr(), sxy.data_ptr(), syy.data_ptr(), F * D, F, K,
            chunk, N, n_chunks, F, D, K, full.KG, full.FT, full.UB, full.NL,
            full.R, full.range_len, last.R, last.range_len, vec, rvec)
    return sxx, sxy, syy


def clg_suffstats(d: Tensor, y: Tensor, r: Tensor
                  ) -> Tuple[Tensor, Tensor, Tensor]:
    """d: [N, F, D] design vectors; y: [N, F]; r: [N, K] responsibilities.
    Returns (sxx [F, K, D, D], sxy [F, K, D], syy [F, K])."""
    name = "clg_suffstats"
    _check_moments(name, d, y, r)
    if not _route(name, d.device):
        return ref.clg_suffstats_ref(d, y, r)
    return _suffstats_launch(name, d, y, r, max(1, d.shape[0]), False)


def clg_suffstats_chunks(d: Tensor, y: Tensor, r: Tensor, chunk: int
                         ) -> Tuple[Tensor, Tensor, Tensor]:
    """The float32 moments of each ``chunk``-instance slice of (d, y, r)
    (the last one shorter), in one launch: (sxx [n, F, K, D, D],
    sxy [n, F, K, D], syy [n, F, K]) with n = ceil(N / chunk).  Slice i
    has the same bits as ``clg_suffstats`` of ``d[i*chunk:(i+1)*chunk]``
    and its y and r."""
    name = "clg_suffstats_chunks"
    _check_moments(name, d, y, r)
    if chunk < 1:
        raise ValueError(f"{name}: chunk must be positive, got {chunk}")
    if not _route(name, d.device):
        parts = [ref.clg_suffstats_ref(d[i:i + chunk], y[i:i + chunk],
                                       r[i:i + chunk])
                 for i in range(0, d.shape[0], chunk)]
        if not parts:                                  # N = 0
            F, D, K = d.shape[1], d.shape[2], r.shape[1]
            return (d.new_zeros(0, F, K, D, D), d.new_zeros(0, F, K, D),
                    d.new_zeros(0, F, K))
        return tuple(torch.stack(p) for p in zip(*parts))
    return _suffstats_launch(name, d, y, r, chunk, True)


def clg_seq_suffstats(d: Tensor, y: Tensor, r: Tensor
                      ) -> Tuple[Tensor, Tensor, Tensor]:
    """Sequence-batch moments: d [B, T, F, D], y [B, T, F], r [B, T, K]
    -> (sxx [F, K, D, D], sxy [F, K, D], syy [F, K]), in one launch of the
    ``clg_suffstats`` kernel over the B*T frames (views, no copy: a
    non-contiguous CUDA input raises).  Masking is the caller's job: zero
    ``r`` rows contribute nothing."""
    name = "clg_seq_suffstats"
    if d.dim() != 4 or y.dim() != 3 or r.dim() != 3:
        raise ValueError(f"{name}: expected d [B, T, F, D], y [B, T, F], "
                         f"r [B, T, K]; got d{tuple(d.shape)} "
                         f"y{tuple(y.shape)} r{tuple(r.shape)}")
    if d.device.type == "cuda":
        for a, what in ((d, "d"), (y, "y"), (r, "r")):
            if not a.is_contiguous():        # reshape would copy it
                raise ValueError(f"{name}: {what} must be contiguous")
    B, T = r.shape[:2]
    d2 = d.reshape(B * T, *d.shape[2:])
    y2 = y.reshape(B * T, y.shape[2])
    r2 = r.reshape(B * T, r.shape[2])
    _check_moments(name, d2, y2, r2)
    if not _route(name, d.device):
        return ref.clg_suffstats_ref(d2, y2, r2)
    return _suffstats_launch(name, d2, y2, r2, max(1, B * T), False)


def clg_suffstats_latent(obs: Tensor, h_mean: Tensor, y: Tensor, r: Tensor,
                         s_hh: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """Moments over the component-major design d[n,f,k] = [obs[n,f],
    E[h|z=k]] with ``rsum_k * S_k`` folded into the latent-latent block.

    obs: [N, F, Do]; h_mean: [N, K, L]; y: [N, F]; r: [N, K];
    s_hh: [K, L, L].  Returns dense (sxx [F, K, D, D], sxy [F, K, D],
    syy [F, K]) with D = Do + L."""
    name = "clg_suffstats_latent"
    dev = obs.device
    _check(name, obs, "obs", torch.float32, 3, dev)
    _check(name, h_mean, "h_mean", torch.float32, 3, dev)
    _check(name, y, "y", torch.float32, 2, dev)
    _check(name, r, "r", torch.float32, 2, dev)
    _check(name, s_hh, "s_hh", torch.float32, 3, dev)
    N, F, _ = obs.shape
    K, L = r.shape[1], h_mean.shape[2]
    if (tuple(y.shape) != (N, F) or r.shape[0] != N
            or tuple(h_mean.shape[:2]) != (N, K)
            or tuple(s_hh.shape) != (K, L, L) or L < 1):
        raise ValueError(
            f"{name}: shapes obs{tuple(obs.shape)} h_mean"
            f"{tuple(h_mean.shape)} y{tuple(y.shape)} r{tuple(r.shape)} "
            f"s_hh{tuple(s_hh.shape)} disagree")
    if not _route(name, dev):
        return ref.clg_suffstats_latent_ref(obs, h_mean, y, r, s_hh)
    if N == 0:
        raise ValueError(f"{name}: needs at least one instance")
    Do = obs.shape[2]
    if Do < 1:
        raise ValueError(f"{name}: the kernel needs Do >= 1 observed columns")
    D = Do + L
    p = latent_plan(N, F, Do, L, K, sm_count(dev))
    u = latent_units(Do, L)
    hp = h_mean.data_ptr()
    vec = 4 if L % 4 == 0 and hp % 16 == 0 else (
        2 if L % 2 == 0 and hp % 8 == 0 else 1)
    opts = dict(dtype=torch.float32, device=dev)
    partial = torch.empty(p.R * (F * K * u.UO + K * u.UH), **opts)
    a, b = F * K * D * D, F * K * D
    out = torch.empty(a + b + F * K, **opts)
    sxx, sxy, syy = (out[:a].view(F, K, D, D), out[a:a + b].view(F, K, D),
                     out[a + b:].view(F, K))
    _launch(LAUNCHES, name, dev, _lib().clg_latent_launch, obs.data_ptr(),
            h_mean.data_ptr(), y.data_ptr(), r.data_ptr(), s_hh.data_ptr(),
            partial.data_ptr(), sxx.data_ptr(), sxy.data_ptr(),
            syy.data_ptr(), N, F, Do, K, L, p.FT, p.UB, p.NL, p.UBh, p.NLh,
            p.R, p.range_len, vec)
    return sxx, sxy, syy


def clg_disc_counts(xd: Tensor, r: Tensor, C: int) -> Tensor:
    """xd: [N, Fd] int32 categories (outside [0, C), -1 included, counts
    nothing); r: [N, K].  Returns disc [Fd, K, C] = sum_n r[n,k]
    [xd[n,f] == c]."""
    name = "clg_disc_counts"
    dev = xd.device
    _check(name, xd, "xd", torch.int32, 2, dev)
    _check(name, r, "r", torch.float32, 2, dev)
    N, Fd = xd.shape
    K = r.shape[1]
    if r.shape[0] != N or C < 1:
        raise ValueError(f"{name}: shapes xd{tuple(xd.shape)} "
                         f"r{tuple(r.shape)} C={C} disagree")
    if not _route(name, dev):
        return ref.clg_disc_counts_ref(xd, r, C)
    if N == 0:
        raise ValueError(f"{name}: needs at least one instance")
    opts = dict(dtype=torch.float32, device=dev)
    out = torch.empty((Fd, K, C), **opts)
    if not out.numel():
        return out
    p = disc_plan(N, Fd, K, C, sm_count(dev))
    partial = torch.empty(p.R * Fd * K * C, **opts)
    _launch(LAUNCHES, name, dev, _lib().clg_disc_counts_launch,
            xd.data_ptr(), r.data_ptr(), partial.data_ptr(), out.data_ptr(),
            N, Fd, K, C, p.KG, p.CB, p.PU, p.R, p.range_len)
    return out
