"""Kernel 1: the two-float pair force in its three forms, their plain
versions and their wrappers.

Counterpart of ``ephemeris_explorer_tpu.ops.pallas_nbody``'s TPU kernel
``_accel_kernel`` in its square form (``pairwise_accel_df64`` and the
drop-in f64 ``pairwise_accel``), its ensemble grid
(``pairwise_accel_df64_ensemble``, drop-in ``pairwise_accel_ensemble``) and
its rows form (``pairwise_accel_df64_rows``), and of
``split_f64``/``combine_f64``.  The CUDA source is ``csrc/accel_df64.cu``;
its header note says what bounds it on an H100 and how the design answers
that.

Each wrapper takes its plain PyTorch version (``*_plain``) only for CPU
tensors; on CUDA tensors it launches the kernel or raises.  Each counts its
own launches: ``pairwise_accel_df64.launches``,
``pairwise_accel_df64_ensemble.launches``,
``pairwise_accel_df64_rows.launches``.  Every form sums each receiver in
the square form's order, so an ensemble member equals the square form on
that member, and a rows call the square form's row slice, bitwise, in the
kernels and in the plain versions alike.
"""

from __future__ import annotations

import operator
from contextlib import contextmanager

import torch

from .. import _build
from . import eft
from .eft import TwoFloat, const

# the source range is split so that about this many blocks of the pair
# kernel are in flight (132 SMs on an H100)
_TARGET_BLOCKS = 4 * 132


def _source_splits(n_tiles: int) -> int:
    """Splits of the source tiles across gridDim.y, none of them empty."""
    splits = min(n_tiles, max(1, -(-_TARGET_BLOCKS // n_tiles)))
    per_split = -(-n_tiles // splits)
    return -(-n_tiles // per_split)


# The warp-tiled loop of kernels 5-7 (csrc/forcef32.cuh): a warp holds a
# group of 128 receivers and walks one split of the 32-source tiles; a block
# holds up to 8 warps, splits of one group, and a row of blocks all of a
# group's splits.  About this many warps are wanted in flight (16 on each of
# an H100's 132 SMs).
F32_PAIR_TILE = 32
F32_PAIR_GROUP = 128
F32_PAIR_WARPS = 8
_F32_PAIR_TARGET_WARPS = 16 * 132


def _f32_pair_geometry(n: int) -> tuple[int, int]:
    """(warps a block, blocks a group) of kernels 5-7 on N sources: the
    splits = warps x blocks of every receiver group, at most one a tile so
    that none is empty.  It depends on N alone, so a receiver is summed in
    the same order whatever the receivers beside it (the rows form)."""
    tiles = -(-n // F32_PAIR_TILE)
    groups = -(-n // F32_PAIR_GROUP)
    want = -(-_F32_PAIR_TARGET_WARPS // groups)
    splits = max(1, min(want, tiles))
    if splits <= F32_PAIR_WARPS:
        return splits, 1
    return F32_PAIR_WARPS, splits // F32_PAIR_WARPS


_PAIR_COUNTERS: dict = {}


def _pair_counters(dev: torch.device, stream: int, groups: int) -> torch.Tensor:
    """The per-receiver-group arrival counters of kernels 5-7 launched on
    ``stream``: zeros between launches (each launch's last block of a group
    rearms its counter), one buffer a stream so that launches in flight on
    two streams never share one."""
    key = (dev.index, stream)
    counters = _PAIR_COUNTERS.get(key)
    if counters is None or counters.numel() < groups:
        counters = torch.zeros(max(groups, 64), dtype=torch.int32, device=dev)
        _PAIR_COUNTERS[key] = counters
    return counters


def _f32_split_tiles(n: int, splits: int) -> list[list[int]]:
    """The tiles of each split in the order the split adds them, as the
    kernels walk them (csrc/forcef32.cuh): split s of S takes s, s + S,
    s + 2 S, ... below T = ceil(N / 32)."""
    return [list(range(s, -(-n // F32_PAIR_TILE), splits)) for s in range(splits)]


def split_f64(x: torch.Tensor, transpose: bool = False):
    """Split an f64 tensor into exact (hi, lo) f32 parts (on its device)."""
    if transpose:
        x = x.t()
    hi = x.to(torch.float32)
    lo = (x - hi.to(torch.float64)).to(torch.float32)
    return hi.contiguous(), lo.contiguous()


def combine_f64(hi: torch.Tensor, lo: torch.Tensor, transpose: bool = False) -> torch.Tensor:
    out = hi.to(torch.float64) + lo.to(torch.float64)
    return out.t() if transpose else out


def _sqr_presplit(x: TwoFloat, xs) -> TwoFloat:
    """x*x with a precomputed split of x.hi (shared with other products)."""
    two = const(2.0, x.dtype)
    p = x.hi * x.hi
    err = ((xs[0] * xs[0] - p) + two * (xs[0] * xs[1])) + xs[1] * xs[1]
    err = err + two * (x.hi * x.lo)
    return TwoFloat(*eft.quick_two_sum(p, err))


def _rsqrt_df(x: TwoFloat) -> TwoFloat:
    """Two-float rsqrt: f32 seed, one Newton step specialised for the seed's
    zero low part, plus the (3/8)(s-1)^2 term of the next Taylor order
    folded into corr.lo (pallas_nbody._rsqrt_df: removes the step's
    systematic undershoot)."""
    f32 = x.dtype
    y0 = torch.rsqrt(x.hi)
    xy2 = eft.mul(x, TwoFloat(*eft.two_sqr(y0)))
    t = (xy2.hi - const(1.0, f32)) + xy2.lo
    corr = eft.add_float(eft.mul_float(xy2, const(-0.5, f32)), const(1.5, f32))
    corr = TwoFloat(corr.hi, corr.lo + const(0.375, f32) * t * t)
    y = TwoFloat(*eft.two_prod(y0, corr.hi))
    return TwoFloat(*eft.quick_two_sum(y.hi, y.lo + y0 * corr.lo))


def _tree_sum(x: TwoFloat) -> TwoFloat:
    """Accurate two-float sum over the last axis, pairwise (zero-padded)."""
    hi, lo = x.hi, x.lo
    p = 1 << max(hi.shape[-1] - 1, 0).bit_length()
    if p != hi.shape[-1]:
        pad = (0, p - hi.shape[-1])
        hi, lo = torch.nn.functional.pad(hi, pad), torch.nn.functional.pad(lo, pad)
    while hi.shape[-1] > 1:
        h = hi.shape[-1] // 2
        s = eft.add(TwoFloat(hi[..., :h], lo[..., :h]), TwoFloat(hi[..., h:], lo[..., h:]))
        hi, lo = s.hi, s.lo
    return TwoFloat(hi[..., 0], lo[..., 0])


def _dd_tree_sum(x: TwoFloat, dim: int) -> TwoFloat:
    """pallas_nbody._dd_tree_sum: the halving tree a[k] = add_sloppy(a[k],
    a[k + m]) along ``dim`` (a power-of-two length), kept as a size-1 dim."""
    hi, lo = x.hi, x.lo
    while hi.shape[dim] > 1:
        m = hi.shape[dim] // 2
        s = eft.add_sloppy(TwoFloat(hi.narrow(dim, 0, m), lo.narrow(dim, 0, m)),
                           TwoFloat(hi.narrow(dim, m, m), lo.narrow(dim, m, m)))
        hi, lo = s.hi, s.lo
    return TwoFloat(hi, lo)


def _df64_rows_plain(pos_hi, pos_lo, mu_hi, mu_lo, rows_hi, rows_lo, row0: int):
    """Kernel 1's chain on the (NL, N) pair grid of sources pos (3, N) and
    receivers rows (NL, 3) at global indices row0 .. row0 + NL - 1.  Every
    op is elementwise and the sum runs over each row alone, so a row's
    result does not depend on which other rows are computed with it."""
    n, nl = pos_hi.shape[1], rows_hi.shape[0]
    dev = pos_hi.device
    self_mask = (torch.arange(nl, device=dev)[:, None] + row0) == torch.arange(n, device=dev)[None, :]
    d = [
        eft.sub(TwoFloat(pos_hi[c][None, :], pos_lo[c][None, :]),
                TwoFloat(rows_hi[:, c][:, None], rows_lo[:, c][:, None]))
        for c in range(3)
    ]
    d_splits = [eft.split(dc.hi) for dc in d]
    r2 = eft.add(
        eft.add(_sqr_presplit(d[0], d_splits[0]), _sqr_presplit(d[1], d_splits[1])),
        _sqr_presplit(d[2], d_splits[2]),
    )
    r2 = eft.where(self_mask, TwoFloat(torch.ones_like(r2.hi), torch.zeros_like(r2.lo)), r2)
    u = _rsqrt_df(r2)
    # w = (u^2 mu) u: u^3 alone reaches f32-subnormal low words on distant
    # solar-system pairs (pallas_nbody.py:165-172)
    w = eft.mul(eft.mul(eft.sqr(u), TwoFloat(mu_hi, mu_lo)), u)
    zero = torch.zeros_like(w.hi)
    w = eft.where(self_mask, TwoFloat(zero, zero), w)
    w_split = eft.split(w.hi)
    out = [_tree_sum(eft.mul_presplit(w, w_split, d[c], d_splits[c])) for c in range(3)]
    return (torch.stack([o.hi for o in out], -1), torch.stack([o.lo for o in out], -1))


def pairwise_accel_df64_plain(pos_hi, pos_lo, mu_hi, mu_lo):
    """Plain PyTorch version of kernel 1, on any device.

    pos_hi/pos_lo: (3, N) f32; mu_hi/mu_lo: (1, N) f32.  Returns (acc_hi,
    acc_lo) of shape (N, 3).  The per-pair chain is the kernel's, vectorised
    over the (N, N) pair grid; the sum over sources is a pairwise tree of
    accurate adds (the kernel sums in source order).
    """
    return _df64_rows_plain(pos_hi, pos_lo, mu_hi, mu_lo, pos_hi.t(), pos_lo.t(), 0)


def pairwise_accel_df64_ensemble_plain(pos_hi, pos_lo, mu_hi, mu_lo):
    """Plain version of kernel 1's ensemble form: pos (E, 3, N) f32, mu
    (1, N) shared -> (E, N, 3) hi/lo, member by member through
    :func:`pairwise_accel_df64_plain`."""
    e, _, n = pos_hi.shape
    if e == 0:
        z = pos_hi.new_zeros((0, n, 3))
        return z, z.clone()
    outs = [pairwise_accel_df64_plain(pos_hi[m], pos_lo[m], mu_hi, mu_lo) for m in range(e)]
    return torch.stack([o[0] for o in outs]), torch.stack([o[1] for o in outs])


def pairwise_accel_df64_rows_plain(pos_hi, pos_lo, mu_hi, mu_lo, rows_hi, rows_lo, row0: int):
    """Plain version of kernel 1's rows form: sources pos (3, N), receivers
    rows (NL, 3) at global offset ``row0`` -> (NL, 3) hi/lo, equal bitwise
    to rows row0 .. row0 + NL - 1 of :func:`pairwise_accel_df64_plain`."""
    return _df64_rows_plain(pos_hi, pos_lo, mu_hi, mu_lo, rows_hi, rows_lo, operator.index(row0))


@contextmanager
def on_device(dev: torch.device):
    """Make ``dev`` the current CUDA device (if it is not already) and yield
    the handle of its current stream, on which a kernel launches."""
    if dev.index is None or dev.index == torch.cuda.current_device():
        yield torch.cuda.current_stream(dev).cuda_stream
    else:
        with torch.cuda.device(dev):
            yield torch.cuda.current_stream(dev).cuda_stream


def _check_input(name: str, x: torch.Tensor, shape, device, dtype=torch.float32) -> None:
    if x.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(x.shape)}")
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _scratch(n: int, shape, dev):
    """(splits, part_hi, part_lo): the split count of N sources and the
    (splits, *shape) partial sums of a pair kernel of kernel 1's tile."""
    splits = _source_splits(-(-n // _build.library().eet_accel_df64_tile()))
    part = torch.empty((2, splits, *shape), dtype=torch.float32, device=dev)
    return splits, part[0], part[1]


def pairwise_accel_df64(pos_hi, pos_lo, mu_hi, mu_lo):
    """Pairwise accelerations in two-float precision (kernel 1).

    pos_hi/pos_lo: (3, N) f32 component-major split positions.
    mu_hi/mu_lo:   (1, N) f32 split gravitational parameters.
    Returns (acc_hi, acc_lo) of shape (N, 3).  CPU tensors take the plain
    version; CUDA tensors launch the kernel.
    """
    dev = pos_hi.device
    if dev.type == "cpu":
        return pairwise_accel_df64_plain(pos_hi, pos_lo, mu_hi, mu_lo)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    n = pos_hi.shape[1]
    for name, x, shape in (("pos_hi", pos_hi, (3, n)), ("pos_lo", pos_lo, (3, n)),
                           ("mu_hi", mu_hi, (1, n)), ("mu_lo", mu_lo, (1, n))):
        _check_input(name, x, shape, dev)
    out_hi = torch.empty((n, 3), dtype=torch.float32, device=dev)
    out_lo = torch.empty((n, 3), dtype=torch.float32, device=dev)
    if n == 0:
        return out_hi, out_lo
    lib = _build.library()
    splits, part_hi, part_lo = _scratch(n, (n, 3), dev)
    with on_device(dev) as stream:
        err = lib.eet_accel_df64(
            pos_hi.data_ptr(), pos_lo.data_ptr(), mu_hi.data_ptr(), mu_lo.data_ptr(),
            part_hi.data_ptr(), part_lo.data_ptr(), out_hi.data_ptr(), out_lo.data_ptr(),
            n, splits, stream,
        )
    _build.check(err, "accel_df64")
    pairwise_accel_df64.launches += 1
    return out_hi, out_lo


pairwise_accel_df64.launches = 0


def pairwise_accel_df64_ensemble(pos_hi, pos_lo, mu_hi, mu_lo):
    """Ensemble pairwise accelerations (kernel 1's ensemble form, one launch
    for all members).

    pos_hi/pos_lo: (E, 3, N) f32 split positions; mu_hi/mu_lo: (1, N) f32,
    shared by the members.  Returns (acc_hi, acc_lo) of shape (E, N, 3);
    member e equals :func:`pairwise_accel_df64` on member e bitwise.  CPU
    tensors take the plain version; CUDA tensors launch the kernel.
    """
    dev = pos_hi.device
    if dev.type == "cpu":
        return pairwise_accel_df64_ensemble_plain(pos_hi, pos_lo, mu_hi, mu_lo)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if pos_hi.dim() != 3:
        raise ValueError(f"pos_hi must be (E, 3, N), got {tuple(pos_hi.shape)}")
    e, n = pos_hi.shape[0], pos_hi.shape[2]
    for name, x, shape in (("pos_hi", pos_hi, (e, 3, n)), ("pos_lo", pos_lo, (e, 3, n)),
                           ("mu_hi", mu_hi, (1, n)), ("mu_lo", mu_lo, (1, n))):
        _check_input(name, x, shape, dev)
    out_hi = torch.empty((e, n, 3), dtype=torch.float32, device=dev)
    out_lo = torch.empty((e, n, 3), dtype=torch.float32, device=dev)
    if n == 0 or e == 0:
        return out_hi, out_lo
    lib = _build.library()
    splits, part_hi, part_lo = _scratch(n, (e, n, 3), dev)
    with on_device(dev) as stream:
        err = lib.eet_accel_df64_ensemble(
            pos_hi.data_ptr(), pos_lo.data_ptr(), mu_hi.data_ptr(), mu_lo.data_ptr(),
            part_hi.data_ptr(), part_lo.data_ptr(), out_hi.data_ptr(), out_lo.data_ptr(),
            n, e, splits, stream,
        )
    _build.check(err, "accel_df64_ensemble")
    pairwise_accel_df64_ensemble.launches += 1
    return out_hi, out_lo


pairwise_accel_df64_ensemble.launches = 0


def pairwise_accel_df64_rows(pos_hi, pos_lo, mu_hi, mu_lo, rows_hi, rows_lo, row0: int):
    """Rows form of kernel 1: NL receiver rows against N sources.

    pos_hi/pos_lo: (3, N) f32 split SOURCE positions (all bodies).
    mu_hi/mu_lo:   (1, N) f32 split gravitational parameters.
    rows_hi/rows_lo: (NL, 3) f32 split RECEIVER positions.
    row0: global index of receiver row 0, a Python int (the rank's row
    offset is known on the host; a device scalar would force a sync).
    Returns (acc_hi, acc_lo) of shape (NL, 3), equal bitwise to rows
    row0 .. row0 + NL - 1 of :func:`pairwise_accel_df64` when the receivers
    are those sources.  CPU tensors take the plain version; CUDA tensors
    launch the kernel.
    """
    row0 = operator.index(row0)
    dev = pos_hi.device
    if dev.type == "cpu":
        return pairwise_accel_df64_rows_plain(pos_hi, pos_lo, mu_hi, mu_lo, rows_hi, rows_lo, row0)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    n, nl = pos_hi.shape[1], rows_hi.shape[0]
    for name, x, shape in (("pos_hi", pos_hi, (3, n)), ("pos_lo", pos_lo, (3, n)),
                           ("mu_hi", mu_hi, (1, n)), ("mu_lo", mu_lo, (1, n)),
                           ("rows_hi", rows_hi, (nl, 3)), ("rows_lo", rows_lo, (nl, 3))):
        _check_input(name, x, shape, dev)
    out_hi = torch.zeros((nl, 3), dtype=torch.float32, device=dev)
    out_lo = torch.zeros((nl, 3), dtype=torch.float32, device=dev)
    if n == 0 or nl == 0:
        return out_hi, out_lo
    lib = _build.library()
    # the split count follows from the sources alone, so every receiver is
    # summed as in the square form
    splits, part_hi, part_lo = _scratch(n, (nl, 3), dev)
    with on_device(dev) as stream:
        err = lib.eet_accel_df64_rows(
            pos_hi.data_ptr(), pos_lo.data_ptr(), mu_hi.data_ptr(), mu_lo.data_ptr(),
            rows_hi.data_ptr(), rows_lo.data_ptr(), part_hi.data_ptr(), part_lo.data_ptr(),
            out_hi.data_ptr(), out_lo.data_ptr(), n, nl, row0, splits, stream,
        )
    _build.check(err, "accel_df64_rows")
    pairwise_accel_df64_rows.launches += 1
    return out_hi, out_lo


pairwise_accel_df64_rows.launches = 0


def pairwise_accel(pos: torch.Tensor, mu_hi, mu_lo) -> torch.Tensor:
    """Drop-in O(N^2) acceleration through kernel 1: f64 (N, 3) in and out.

    ``mu_hi``/``mu_lo`` are the (1, N) f32 split parameters (:func:`split_f64`).
    """
    ph, plo = split_f64(pos, transpose=True)      # (3, N)
    ah, al = pairwise_accel_df64(ph, plo, mu_hi, mu_lo)
    return combine_f64(ah, al)                    # (N, 3)


def pairwise_accel_ensemble(pos: torch.Tensor, mu_hi, mu_lo) -> torch.Tensor:
    """Drop-in ensemble acceleration through kernel 1's ensemble form: f64
    (E, N, 3) in and out, ``mu_hi``/``mu_lo`` (1, N) f32 shared."""
    ph, plo = split_f64(pos.transpose(1, 2))      # (E, 3, N)
    ah, al = pairwise_accel_df64_ensemble(ph, plo, mu_hi, mu_lo)
    return combine_f64(ah, al)                    # (E, N, 3)
