"""Kernels 5 and 7: the f32 pair force, unmasked and masked, with their plain
versions and wrappers.

Counterpart of ``ephemeris_explorer_tpu.ops.pallas_nbody``'s fast f32 mode,
``pairwise_accel_f32`` (TPU kernel ``_accel_kernel_f32``), and of the split
mode's weak tail, ``pairwise_accel_f32_masked`` and
``pairwise_accel_f32_masked_rows`` (TPU kernel ``_accel_kernel_f32_masked``).
Both CUDA kernels are instances of one template in ``csrc/accel_f32.cu``; its
header note says what bounds them on an H100 and how the design answers
that.  The Pallas tile arguments are the TPU's and are not taken: the
kernels take any N.

The wrappers take the plain PyTorch versions only for CPU tensors; on CUDA
tensors they launch the kernel or raise.  ``pairwise_accel_f32.launches``
counts kernel 5's launches, ``pairwise_accel_f32_masked.launches`` kernel
7's, from the square and the rows form alike.
"""

from __future__ import annotations

import torch

from .. import _build
from .cuda_nbody import _check_input, _source_splits, on_device
from .eft import const


def _f32_sum(d, mu, skip):
    """The f32 chain of pallas_nbody.py:888-897 from the three (NL, N)
    differences ``d`` (source minus receiver), mu (1, N) and skip (NL, N)
    bool.  Sums over sources with ``torch.sum`` (the kernels sum in source
    order)."""
    f32 = d[0].dtype
    r2 = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
    r2 = r2.masked_fill(skip, 1.0)
    u = torch.rsqrt(r2)
    u = u * (const(1.5, f32) - const(0.5, f32) * r2 * u * u)
    w = mu * (u * u * u)
    w = w.masked_fill(skip, 0.0)
    return torch.stack([(w * d[c]).sum(dim=1) for c in range(3)], -1)


def _f32_force(src, mu, rows, skip):
    """:func:`_f32_sum` of src (N, 3) sources on rows (NL, 3) receivers."""
    return _f32_sum([src[:, c][None, :] - rows[:, c][:, None] for c in range(3)], mu, skip)


def _self_pairs(nl: int, n: int, device, row0: int = 0) -> torch.Tensor:
    rows = torch.arange(nl, device=device)[:, None] + row0
    return rows == torch.arange(n, device=device)[None, :]


def pairwise_accel_f32_plain(pos, mu):
    """Plain PyTorch version of kernel 5: pos (N, 3) f32, mu (1, N) f32 ->
    (N, 3) f32."""
    n = pos.shape[0]
    return _f32_force(pos, mu, pos, _self_pairs(n, n, pos.device))


def pairwise_accel_f32_masked_plain(pos, mu, mask, rows=None, diag_in_mask=False):
    """Plain PyTorch version of kernel 7: pairs with ``mask[i, j] != 0`` are
    skipped.  ``rows`` (NL, 3) selects the rows form, which needs the self
    diagonal in the mask (local row ids are not global column ids)."""
    skip = mask != 0
    if rows is None:
        rows = pos
        if not diag_in_mask:
            skip = skip | _self_pairs(pos.shape[0], pos.shape[0], pos.device)
    return _f32_force(pos, mu, rows, skip)


def _launch_checks(pos, mu, dev):
    n = pos.shape[0]
    _check_input("pos", pos, (n, 3), dev)
    _check_input("mu", mu, (1, n), dev)
    return n


def pairwise_accel_f32(pos, mu):
    """Fast-mode O(N^2) acceleration in f32 (kernel 5, ~1e-6 relative force
    error): pos (N, 3) f32, mu (1, N) f32 -> (N, 3) f32.  CPU tensors take
    the plain version; CUDA tensors launch the kernel."""
    dev = pos.device
    if dev.type == "cpu":
        return pairwise_accel_f32_plain(pos, mu)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    n = _launch_checks(pos, mu, dev)
    out = torch.empty((n, 3), dtype=torch.float32, device=dev)
    if n == 0:
        return out
    lib = _build.library()
    splits = _source_splits(-(-n // lib.eet_accel_f32_tile()))
    part = torch.empty((splits, n, 3), dtype=torch.float32, device=dev)
    with on_device(dev) as stream:
        err = lib.eet_accel_f32(pos.data_ptr(), mu.data_ptr(), part.data_ptr(), out.data_ptr(),
                                n, splits, stream)
    _build.check(err, "accel_f32")
    pairwise_accel_f32.launches += 1
    return out


pairwise_accel_f32.launches = 0


def _masked(pos, mu, mask, rows, diag_in_mask):
    """Kernel 7 on CUDA tensors: rows (NL, 3) receivers, mask (NL, N)."""
    dev = pos.device
    n = _launch_checks(pos, mu, dev)
    nl = rows.shape[0]
    _check_input("rows", rows, (nl, 3), dev)
    _check_input("mask", mask, (nl, n), dev, dtype=torch.int8)
    out = torch.empty((nl, 3), dtype=torch.float32, device=dev)
    if n == 0 or nl == 0:
        return out.zero_()
    lib = _build.library()
    # the split count follows from the sources alone, so the rows form sums
    # every receiver as the square form does
    splits = _source_splits(-(-n // lib.eet_accel_f32_tile()))
    part = torch.empty((splits, nl, 3), dtype=torch.float32, device=dev)
    with on_device(dev) as stream:
        err = lib.eet_accel_f32_masked(
            pos.data_ptr(), mu.data_ptr(), rows.data_ptr(), mask.data_ptr(), part.data_ptr(),
            out.data_ptr(), n, nl, splits, int(diag_in_mask), stream,
        )
    _build.check(err, "accel_f32_masked")
    pairwise_accel_f32_masked.launches += 1
    return out


def pairwise_accel_f32_masked(pos, mu, mask, diag_in_mask: bool = False):
    """The f32 kernel with per-pair exclusions (kernel 7): ``mask[i, j] != 0``
    pairs contribute zero (the split mode re-adds them in two-float).  pos
    (N, 3) f32, mu (1, N) f32, mask (N, N) int8 -> (N, 3) f32.
    ``diag_in_mask=True`` promises that the mask already excludes the self
    diagonal (as :func:`..split.strong_pair_mask` builds it) and drops the
    kernel's self compare; a mask without it then gives non-finite forces."""
    dev = pos.device
    if dev.type == "cpu":
        return pairwise_accel_f32_masked_plain(pos, mu, mask, diag_in_mask=diag_in_mask)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    return _masked(pos, mu, mask, pos, diag_in_mask)


pairwise_accel_f32_masked.launches = 0


def pairwise_accel_f32_masked_rows(pos, mu, mask, rows):
    """Rows form of kernel 7: pos (N, 3) f32 all sources, rows (NL, 3) f32
    receivers, mask (NL, N) int8 carrying the GLOBAL self diagonal
    (:func:`..split.strong_pair_mask_rows`) -> (NL, 3) f32.  Each receiver
    is summed as in the square form, so a row decomposition equals the
    square result's row slices bitwise."""
    dev = pos.device
    if dev.type == "cpu":
        return pairwise_accel_f32_masked_plain(pos, mu, mask, rows=rows)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    return _masked(pos, mu, mask, rows, True)
