"""Kernel 3: the 3-limb pair force in its two forms, their plain versions
and their wrappers.

Counterpart of ``ephemeris_explorer_tpu.ops.pallas_nbody``'s TPU kernel
``_accel_kernel3`` in its square form (``pairwise_accel_limbs_pair``,
``pairwise_accel_limbs``) and its rows form
(``pairwise_accel_limbs_pair_rows``).  The CUDA source is
``csrc/accel_limbs3.cu``; its header note says what bounds it on an H100
and how the design answers that.

Each wrapper takes its plain PyTorch version (``*_plain``) only for CPU
tensors; on CUDA tensors it launches the kernel or raises.
``pairwise_accel_limbs_pair.launches`` and
``pairwise_accel_limbs_pair_rows.launches`` count the launches of each
form.  A rows call equals the square form's row slice bitwise, in the
kernel and in the plain version alike.
"""

from __future__ import annotations

import operator

import torch

from .. import _build
from . import eft
from .cuda_nbody import _check_input, _source_splits, _sqr_presplit, _rsqrt_df, _tree_sum
from .cuda_nbody import combine_f64, on_device
from .eft import TwoFloat


def _limb_difference(pj, pi) -> TwoFloat:
    """Error-free p_j - p_i from three limbs each (pallas_nbody.py:418-422)."""
    s0, e0 = eft.two_sum(pj[0], -pi[0])
    s1, e1 = eft.two_sum(pj[1], -pi[1])
    s2 = pj[2] - pi[2]
    return eft.add_float(eft.add_sloppy(TwoFloat(s0, e0), TwoFloat(s1, e1)), s2)


def _limbs3_rows_plain(src, mu_hi, mu_lo, rows, row0: int):
    """Kernel 3's chain on the (NL, N) pair grid: ``src`` the three (3, N)
    source limbs, ``rows`` the three (NL, 3) receiver limbs at global
    indices row0 .. row0 + NL - 1.  Elementwise ops and a per-row sum, so a
    row's result does not depend on the other rows computed with it."""
    n, nl = src[0].shape[1], rows[0].shape[0]
    dev = src[0].device
    self_mask = (torch.arange(nl, device=dev)[:, None] + row0) == torch.arange(n, device=dev)[None, :]
    d = [
        _limb_difference([p[c][None, :] for p in src], [r[:, c][:, None] for r in rows])
        for c in range(3)
    ]
    d_splits = [eft.split(dc.hi) for dc in d]
    r2 = eft.add_sloppy(
        eft.add_sloppy(_sqr_presplit(d[0], d_splits[0]), _sqr_presplit(d[1], d_splits[1])),
        _sqr_presplit(d[2], d_splits[2]),
    )
    r2 = eft.where(self_mask, TwoFloat(torch.ones_like(r2.hi), torch.zeros_like(r2.lo)), r2)
    u = _rsqrt_df(r2)
    w = eft.mul(eft.mul(eft.sqr(u), TwoFloat(mu_hi, mu_lo)), u)
    zero = torch.zeros_like(w.hi)
    w = eft.where(self_mask, TwoFloat(zero, zero), w)
    w_split = eft.split(w.hi)
    out = [_tree_sum(eft.mul_presplit(w, w_split, d[c], d_splits[c])) for c in range(3)]
    return (torch.stack([o.hi for o in out], -1), torch.stack([o.lo for o in out], -1))


def pairwise_accel_limbs_pair_plain(l0, l1, l2, mu_hi, mu_lo):
    """Plain PyTorch version of kernel 3, on any device.

    l0/l1/l2: (N, 3) f32 position limbs; mu_hi/mu_lo: (1, N) f32.  Returns
    (acc_hi, acc_lo) of shape (N, 3).  The per-pair chain is the kernel's,
    vectorised over the (N, N) pair grid (receiver rows, source columns);
    the sum over sources is a pairwise tree of accurate adds (the kernel
    sums in source order).
    """
    limbs = (l0, l1, l2)
    return _limbs3_rows_plain(tuple(l.t() for l in limbs), mu_hi, mu_lo, limbs, 0)


def pairwise_accel_limbs_pair_rows_plain(p0, p1, p2, mu_hi, mu_lo, r0, r1, r2, row0: int):
    """Plain version of kernel 3's rows form: source limbs (3, N), receiver
    limbs (NL, 3) at global offset ``row0`` -> (NL, 3) hi/lo, equal bitwise
    to rows row0 .. row0 + NL - 1 of :func:`pairwise_accel_limbs_pair_plain`."""
    return _limbs3_rows_plain((p0, p1, p2), mu_hi, mu_lo, (r0, r1, r2), operator.index(row0))


def pairwise_accel_limbs_pair(l0, l1, l2, mu_hi, mu_lo):
    """O(N^2) acceleration from 3-limb f32 positions (kernel 3).

    l0/l1/l2: (N, 3) f32 limb tensors (the three leading limbs of an
    expansion, e.g. a ring head of :class:`..integrators.multistep.ELM2CarryQ`).
    mu_hi/mu_lo: (1, N) f32 split gravitational parameters.
    Returns the raw (hi, lo) f32 pair of (N, 3) accelerations, which the
    4-limb update (kernel 4) consumes directly.  CPU tensors take the plain
    version; CUDA tensors launch the kernel.
    """
    dev = l0.device
    if dev.type == "cpu":
        return pairwise_accel_limbs_pair_plain(l0, l1, l2, mu_hi, mu_lo)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    n = l0.shape[0]
    for name, x, shape in (("l0", l0, (n, 3)), ("l1", l1, (n, 3)), ("l2", l2, (n, 3)),
                           ("mu_hi", mu_hi, (1, n)), ("mu_lo", mu_lo, (1, n))):
        _check_input(name, x, shape, dev)
    out_hi = torch.empty((n, 3), dtype=torch.float32, device=dev)
    out_lo = torch.empty((n, 3), dtype=torch.float32, device=dev)
    if n == 0:
        return out_hi, out_lo
    lib = _build.library()
    splits = _source_splits(-(-n // lib.eet_accel_limbs3_tile()))
    part_hi = torch.empty((splits, n, 3), dtype=torch.float32, device=dev)
    part_lo = torch.empty((splits, n, 3), dtype=torch.float32, device=dev)
    with on_device(dev) as stream:
        err = lib.eet_accel_limbs3(
            l0.data_ptr(), l1.data_ptr(), l2.data_ptr(), mu_hi.data_ptr(), mu_lo.data_ptr(),
            part_hi.data_ptr(), part_lo.data_ptr(), out_hi.data_ptr(), out_lo.data_ptr(),
            n, splits, stream,
        )
    _build.check(err, "accel_limbs3")
    pairwise_accel_limbs_pair.launches += 1
    return out_hi, out_lo


pairwise_accel_limbs_pair.launches = 0


def pairwise_accel_limbs_pair_rows(p0, p1, p2, mu_hi, mu_lo, r0, r1, r2, row0: int):
    """Rows form of kernel 3: NL receiver rows against N sources.

    p0/p1/p2: (3, N) f32 SOURCE limbs (all bodies, component-major).
    mu_hi/mu_lo: (1, N) f32 split gravitational parameters.
    r0/r1/r2: (NL, 3) f32 RECEIVER limbs.
    row0: global index of receiver row 0, a Python int.
    Returns (acc_hi, acc_lo) of shape (NL, 3), equal bitwise to rows
    row0 .. row0 + NL - 1 of :func:`pairwise_accel_limbs_pair` when the
    receivers are those sources.  CPU tensors take the plain version; CUDA
    tensors launch the kernel.
    """
    row0 = operator.index(row0)
    dev = p0.device
    if dev.type == "cpu":
        return pairwise_accel_limbs_pair_rows_plain(p0, p1, p2, mu_hi, mu_lo, r0, r1, r2, row0)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    n, nl = p0.shape[1], r0.shape[0]
    for name, x, shape in (("p0", p0, (3, n)), ("p1", p1, (3, n)), ("p2", p2, (3, n)),
                           ("mu_hi", mu_hi, (1, n)), ("mu_lo", mu_lo, (1, n)),
                           ("r0", r0, (nl, 3)), ("r1", r1, (nl, 3)), ("r2", r2, (nl, 3))):
        _check_input(name, x, shape, dev)
    out_hi = torch.zeros((nl, 3), dtype=torch.float32, device=dev)
    out_lo = torch.zeros((nl, 3), dtype=torch.float32, device=dev)
    if n == 0 or nl == 0:
        return out_hi, out_lo
    lib = _build.library()
    # the split count follows from the sources alone, so every receiver is
    # summed as in the square form
    splits = _source_splits(-(-n // lib.eet_accel_limbs3_tile()))
    part = torch.empty((2, splits, nl, 3), dtype=torch.float32, device=dev)
    with on_device(dev) as stream:
        err = lib.eet_accel_limbs3_rows(
            p0.data_ptr(), p1.data_ptr(), p2.data_ptr(), mu_hi.data_ptr(), mu_lo.data_ptr(),
            r0.data_ptr(), r1.data_ptr(), r2.data_ptr(), part[0].data_ptr(), part[1].data_ptr(),
            out_hi.data_ptr(), out_lo.data_ptr(), n, nl, row0, splits, stream,
        )
    _build.check(err, "accel_limbs3_rows")
    pairwise_accel_limbs_pair_rows.launches += 1
    return out_hi, out_lo


pairwise_accel_limbs_pair_rows.launches = 0


def pairwise_accel_limbs(l0, l1, l2, mu_hi, mu_lo) -> torch.Tensor:
    """O(N^2) acceleration from 3-limb f32 positions, combined to f64 (N, 3)."""
    return combine_f64(*pairwise_accel_limbs_pair(l0, l1, l2, mu_hi, mu_lo))
