"""Kernels 8 and 9 and the magnitude-split force mode.

Counterpart of ``ephemeris_explorer_tpu.ops.pallas_nbody``'s
``_strong_correction_fast`` (TPU kernel ``_strong_corr_kernel_fast``, square
and ``rows=`` forms), ``_strong_correction_df64`` (TPU kernel
``_strong_corr_kernel``, ``corr="dd"``), ``pairwise_accel_split`` and
``pairwise_accel_split_rows``.  The split mode sums each body's K strongest
attractors (:mod:`.split`) with the two-float strong-pair correction
(kernel 8, ``csrc/strong_corr.cu``, whose header note says what bounds it on
an H100 and how the design answers that) and every other pair with the
masked f32 kernel (kernel 7, :mod:`.cuda_f32`).  ~1e-9 relative for
dominated hierarchies, ~1e-7 for random clouds.

:func:`strong_correction_pair` takes the plain PyTorch version
(:func:`strong_correction_pair_plain`) only for CPU tensors; on CUDA tensors
it launches the kernel or raises.  ``strong_correction_pair.launches``
counts its kernel launches.  The kernel reads ``idx`` itself and gathers the
split limbs, where the reference gathers, transposes and splits on the host.
Kernel 9 (:func:`strong_correction_dd`, plain version
:func:`strong_correction_dd_plain`, counter ``strong_correction_dd.launches``)
is the same chain and tree on the f64-differenced feed, in the same source
file: it gathers the f64 positions itself, differences them in f64 and
splits the difference and mu in registers.
"""

from __future__ import annotations

import torch

from .. import _build
from . import eft
from .cuda_f32 import pairwise_accel_f32_masked, pairwise_accel_f32_masked_rows
from .cuda_nbody import _check_input, _rsqrt_df, combine_f64, on_device, split_f64
from .eft import TwoFloat
from .split import _strong_correction


def _padded_width(k: int) -> int:
    """KP: the next power of two of K (pallas_nbody.py:1311)."""
    return 1 << max(k - 1, 0).bit_length()


def _dd_tree_sum(x: TwoFloat) -> TwoFloat:
    """The reference's binary-tree reduction over the last axis (a power of
    two), halving as a[k] = add_sloppy(a[k], a[k + m]) (pallas_nbody.py:47)."""
    hi, lo = x.hi, x.lo
    assert hi.shape[-1] & (hi.shape[-1] - 1) == 0, "tree sum requires power-of-two length"
    while hi.shape[-1] > 1:
        m = hi.shape[-1] // 2
        s = eft.add_sloppy(TwoFloat(hi[..., :m], lo[..., :m]), TwoFloat(hi[..., m:], lo[..., m:]))
        hi, lo = s.hi, s.lo
    return TwoFloat(hi[..., 0], lo[..., 0])


def _split_pad(x, kp: int) -> TwoFloat:
    """The exact (hi, lo) f32 split of an f64 (..., K) tensor
    (pallas_nbody._split_f64), the KP - K padding zeros in front."""
    hi, lo = split_f64(x)
    pad = (kp - x.shape[-1], 0)
    return TwoFloat(torch.nn.functional.pad(hi, pad), torch.nn.functional.pad(lo, pad))


def _correction_tree(d, mu: TwoFloat):
    """The strong-pair chain of pallas_nbody.py:1183-1196 / 1284-1295 from
    the (NL, KP) two-float differences d (three components) and mu, then the
    reference's tree over KP: (hi, lo) of shape (NL, 3)."""
    r2 = eft.add(eft.add(eft.sqr(d[0]), eft.sqr(d[1])), eft.sqr(d[2]))
    pad = r2.hi == 0.0
    r2 = TwoFloat(r2.hi.masked_fill(pad, 1.0), r2.lo.masked_fill(pad, 0.0))
    u = _rsqrt_df(r2)
    w = eft.mul(eft.mul(eft.sqr(u), mu), u)
    out = [_dd_tree_sum(eft.mul(w, d[c])) for c in range(3)]
    return torch.stack([o.hi for o in out], -1), torch.stack([o.lo for o in out], -1)


def _check_indices(idx, n: int) -> None:
    if idx.min() < 0 or idx.max() >= n:
        raise IndexError(f"strong-set index outside [0, {n})")


def strong_correction_pair_plain(pos_hi, pos_lo, rows_hi, rows_lo, mu_hi, mu_lo, idx):
    """Plain PyTorch version of kernel 8, on any device.

    pos_hi/pos_lo (N, 3) f32 split sources, rows_hi/rows_lo (NL, 3) f32
    split receivers, mu_hi/mu_lo (N,) f32 split mu, idx (NL, K) int32.
    Returns (hi, lo) of shape (NL, 3).  The chain of
    pallas_nbody.py:1281-1295 on the gathered (NL, KP) pairs, the KP - K
    padding entries in front with mu = 0 and a position of 0, then the
    reference's tree over KP.
    """
    nl, k = idx.shape
    if nl == 0 or k == 0:
        z = torch.zeros((nl, 3), dtype=torch.float32, device=pos_hi.device)
        return z, z.clone()
    _check_indices(idx, pos_hi.shape[0])
    kp = _padded_width(k)
    g = idx.long()

    def gather(x):                          # (NL, KP), padding in front
        return torch.nn.functional.pad(x[g], (kp - k, 0))

    d = [eft.sub(TwoFloat(gather(pos_hi[:, c]), gather(pos_lo[:, c])),
                 TwoFloat(rows_hi[:, c:c + 1], rows_lo[:, c:c + 1])) for c in range(3)]
    return _correction_tree(d, TwoFloat(gather(mu_hi), gather(mu_lo)))


def strong_correction_pair(pos_hi, pos_lo, rows_hi, rows_lo, mu_hi, mu_lo, idx):
    """The two-float strong-pair correction (kernel 8) on split f32 inputs,
    as :func:`strong_correction_pair_plain` describes them; returns the raw
    (hi, lo) pair.  CPU tensors take the plain version; CUDA tensors launch
    the kernel.  An index outside [0, N) raises IndexError in the plain
    version; the kernel, which cannot raise, gives NaN for that receiver."""
    dev = pos_hi.device
    if dev.type == "cpu":
        return strong_correction_pair_plain(pos_hi, pos_lo, rows_hi, rows_lo, mu_hi, mu_lo, idx)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    n = pos_hi.shape[0]
    nl, k = idx.shape
    for name, x, shape in (("pos_hi", pos_hi, (n, 3)), ("pos_lo", pos_lo, (n, 3)),
                           ("rows_hi", rows_hi, (nl, 3)), ("rows_lo", rows_lo, (nl, 3)),
                           ("mu_hi", mu_hi, (n,)), ("mu_lo", mu_lo, (n,))):
        _check_input(name, x, shape, dev)
    _check_input("idx", idx, (nl, k), dev, dtype=torch.int32)
    if nl == 0 or k == 0:
        z = torch.zeros((nl, 3), dtype=torch.float32, device=dev)
        return z, z.clone()
    if n == 0:
        raise IndexError("idx indexes sources, but there are none")
    out_hi = torch.empty((nl, 3), dtype=torch.float32, device=dev)
    out_lo = torch.empty((nl, 3), dtype=torch.float32, device=dev)
    lib = _build.library()
    with on_device(dev) as stream:
        err = lib.eet_strong_corr(
            pos_hi.data_ptr(), pos_lo.data_ptr(), rows_hi.data_ptr(), rows_lo.data_ptr(),
            mu_hi.data_ptr(), mu_lo.data_ptr(), idx.data_ptr(), out_hi.data_ptr(),
            out_lo.data_ptr(), n, nl, k, stream,
        )
    _build.check(err, "strong_corr")
    strong_correction_pair.launches += 1
    return out_hi, out_lo


strong_correction_pair.launches = 0


def strong_correction_dd_plain(pos, mu, idx):
    """Plain PyTorch version of kernel 9, on any device.

    pos (N, 3) f64, mu (N,) f64, idx (N, K) int32.  Returns (hi, lo) of
    shape (N, 3).  The reference's feed (pallas_nbody.py:1217-1225): the
    f64 difference pos[idx] - pos[i], then the exact limb splits of it and
    of mu[idx], the KP - K padding in front with d = 0 and mu = 0; then the
    chain and tree of kernel 8.
    """
    n, k = idx.shape
    if n == 0 or k == 0:
        z = torch.zeros((n, 3), dtype=torch.float32, device=pos.device)
        return z, z.clone()
    _check_indices(idx, pos.shape[0])
    kp = _padded_width(k)
    g = idx.long()
    d64 = pos[g] - pos[:, None, :]                 # (N, K, 3)
    d = [_split_pad(d64[..., c], kp) for c in range(3)]
    return _correction_tree(d, _split_pad(mu[g], kp))


def strong_correction_dd(pos, mu, idx):
    """The strong-pair correction on the f64-differenced feed (kernel 9):
    pos (N, 3) f64, mu (N,) f64, idx (N, K) int32 -> the raw (hi, lo) f32
    pair of shape (N, 3).  Square form only, as in the reference.  CPU
    tensors take the plain version; CUDA tensors launch the kernel.  An
    index outside [0, N) raises IndexError in the plain version; the
    kernel gives NaN for that receiver (kernel 8's rule)."""
    dev = pos.device
    if dev.type == "cpu":
        return strong_correction_dd_plain(pos, mu, idx)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    n, k = idx.shape
    _check_input("pos", pos, (n, 3), dev, dtype=torch.float64)
    _check_input("mu", mu, (n,), dev, dtype=torch.float64)
    _check_input("idx", idx, (n, k), dev, dtype=torch.int32)
    if n == 0 or k == 0:
        z = torch.zeros((n, 3), dtype=torch.float32, device=dev)
        return z, z.clone()
    out = torch.empty((2, n, 3), dtype=torch.float32, device=dev)
    lib = _build.library()
    with on_device(dev) as stream:
        err = lib.eet_strong_corr_dd(pos.data_ptr(), mu.data_ptr(), idx.data_ptr(),
                                     out[0].data_ptr(), out[1].data_ptr(), n, k, stream)
    _build.check(err, "strong_corr_dd")
    strong_correction_dd.launches += 1
    return out[0], out[1]


strong_correction_dd.launches = 0


def _strong_correction_df64(pos, mu, idx):
    """The strong-pair correction on the f64-differenced feed in two-float
    (~2^-47; 4e-14 per row on the hierarchy fixture, where the split-limb
    feed of :func:`_strong_correction_fast` gives 1.7e-12): pos (N, 3) f64,
    mu (N,) f64, idx (N, K) -> (N, 3) in pos's dtype.  Kernel 9."""
    hi, lo = strong_correction_dd(pos.contiguous(), mu.contiguous(),
                                  idx.to(torch.int32).contiguous())
    return combine_f64(hi, lo).to(pos.dtype)


def _strong_correction_fast(pos, mu, idx, rows=None):
    """The production strong-pair correction in two-float (~2^-47 per pair;
    ~1.7e-12 on the hierarchy fixture, where the limbs' 2^-48-of-|p|
    rounding meets close pairs): pos (N, 3) f64, mu (N,) f64, idx (NL, K)
    int32 -> (NL, 3) in pos's dtype.  ``rows`` (NL, 3) selects the rows
    form: receivers are the local rows, idx holds GLOBAL source columns.
    Each receiver is computed alone, so the rows form equals the square
    form's row slices bitwise."""
    pos_hi, pos_lo = split_f64(pos)
    rows_hi, rows_lo = (pos_hi, pos_lo) if rows is None else split_f64(rows)
    mu_hi, mu_lo = split_f64(mu)
    hi, lo = strong_correction_pair(pos_hi, pos_lo, rows_hi, rows_lo, mu_hi, mu_lo,
                                    idx.to(torch.int32).contiguous())
    return combine_f64(hi, lo).to(pos.dtype)


def pairwise_accel_split(pos, mu, idx, mask, corr: str = "fast", exact_f64: bool = False):
    """Magnitude-split O(N^2) acceleration: f64 (N, 3) positions and (N,) mu
    in, f64 (N, 3) accelerations out.  idx/mask from
    :func:`.split.strong_pair_indices` / :func:`.split.strong_pair_mask` on a
    recent snapshot (refresh per chunk).  The mask MUST carry the self
    diagonal (``strong_pair_mask`` does): kernel 7 runs with
    ``diag_in_mask=True`` here, as in the JAX package.

    ``corr`` selects the strong-pair correction:
      - "fast" (production): the two-float correction, kernel 8;
      - "dd": the f64-differenced feed (kernel 9, ~4e-14 on the hierarchy:
        the accuracy cross-check of "fast");
      - "f64": the native-f64 chain (the cross-check oracle).
    ``exact_f64=True`` is the old spelling of ``corr="f64"``.
    """
    if exact_f64:
        corr = "f64"
    corrections = {"fast": _strong_correction_fast, "dd": _strong_correction_df64,
                   "f64": _strong_correction}
    if corr not in corrections:
        raise ValueError(f"unknown strong-pair correction {corr!r}")
    a32 = pairwise_accel_f32_masked(pos.to(torch.float32), mu.to(torch.float32).reshape(1, -1),
                                    mask, diag_in_mask=True)
    return corrections[corr](pos, mu, idx) + a32.to(pos.dtype)


def pairwise_accel_split_rows(pos, rows, mu, idx, mask):
    """Rows form of :func:`pairwise_accel_split` (the two-float correction
    only): pos (N, 3) f64 all bodies, rows (NL, 3) f64 local receivers, mu
    (N,), idx (NL, K) GLOBAL strong columns
    (:func:`.split.strong_pair_indices_rows`), mask (NL, N) int8 with the
    global diagonal (:func:`.split.strong_pair_mask_rows`) -> (NL, 3) f64,
    equal bitwise to the square form's row slices."""
    a32 = pairwise_accel_f32_masked_rows(pos.to(torch.float32),
                                         mu.to(torch.float32).reshape(1, -1), mask,
                                         rows.to(torch.float32))
    return _strong_correction_fast(pos, mu, idx, rows=rows) + a32.to(pos.dtype)
