"""Kernel 1: the two-float pair force, its plain version and its wrapper.

Counterpart of ``ephemeris_explorer_tpu.ops.pallas_nbody``'s square form:
``pairwise_accel_df64`` (TPU kernel ``_accel_kernel``), the drop-in f64
``pairwise_accel``, and ``split_f64``/``combine_f64``.  The CUDA source is
``csrc/accel_df64.cu``; its header note says what bounds it on an H100 and
how the design answers that.

:func:`pairwise_accel_df64` takes the plain PyTorch version
(:func:`pairwise_accel_df64_plain`) only for CPU tensors; on CUDA tensors it
launches the kernel or raises.  ``pairwise_accel_df64.launches`` counts its
kernel launches.
"""

from __future__ import annotations

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


def pairwise_accel_df64_plain(pos_hi, pos_lo, mu_hi, mu_lo):
    """Plain PyTorch version of kernel 1, on any device.

    pos_hi/pos_lo: (3, N) f32; mu_hi/mu_lo: (1, N) f32.  Returns (acc_hi,
    acc_lo) of shape (N, 3).  The per-pair chain is the kernel's, vectorised
    over the (N, N) pair grid; the sum over sources is a pairwise tree of
    accurate adds (the kernel sums in source order).
    """
    n = pos_hi.shape[1]
    idx = torch.arange(n, device=pos_hi.device)
    self_mask = idx[:, None] == idx[None, :]
    d = [
        eft.sub(TwoFloat(pos_hi[c][None, :], pos_lo[c][None, :]),
                TwoFloat(pos_hi[c][:, None], pos_lo[c][:, None]))
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


@contextmanager
def on_device(dev: torch.device):
    """Make ``dev`` the current CUDA device (if it is not already) and yield
    the handle of its current stream, on which a kernel launches."""
    if dev.index is None or dev.index == torch.cuda.current_device():
        yield torch.cuda.current_stream(dev).cuda_stream
    else:
        with torch.cuda.device(dev):
            yield torch.cuda.current_stream(dev).cuda_stream


def _check_f32(name: str, x: torch.Tensor, shape, device) -> None:
    if x.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(x.shape)}")
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


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
        _check_f32(name, x, shape, dev)
    out_hi = torch.empty((n, 3), dtype=torch.float32, device=dev)
    out_lo = torch.empty((n, 3), dtype=torch.float32, device=dev)
    if n == 0:
        return out_hi, out_lo
    lib = _build.library()
    splits = _source_splits(-(-n // lib.eet_accel_df64_tile()))
    part_hi = torch.empty((splits, n, 3), dtype=torch.float32, device=dev)
    part_lo = torch.empty((splits, n, 3), dtype=torch.float32, device=dev)
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


def pairwise_accel(pos: torch.Tensor, mu_hi, mu_lo) -> torch.Tensor:
    """Drop-in O(N^2) acceleration through kernel 1: f64 (N, 3) in and out.

    ``mu_hi``/``mu_lo`` are the (1, N) f32 split parameters (:func:`split_f64`).
    """
    ph, plo = split_f64(pos, transpose=True)      # (3, N)
    ah, al = pairwise_accel_df64(ph, plo, mu_hi, mu_lo)
    return combine_f64(ah, al)                    # (N, 3)
