"""Kernel 6: the mixed-precision pair force, its plain version and its wrapper.

Counterpart of ``ephemeris_explorer_tpu.ops.pallas_nbody.pairwise_accel_mixed``
(TPU kernel ``_accel_kernel_mixed``): error-free pair differences of split
(hi, lo) f32 positions, then the f32 weight chain of kernel 5, ~1e-6
relative force error for every pair geometry.  The CUDA source is
``csrc/accel_mixed.cu``; its header note says what bounds it on an H100 and
how the design answers that.  Positions are split with
:func:`.cuda_nbody.split_f64` (``transpose=True``).

:func:`pairwise_accel_mixed` takes the plain PyTorch version
(:func:`pairwise_accel_mixed_plain`) only for CPU tensors; on CUDA tensors it
launches the kernel or raises.  ``pairwise_accel_mixed.launches`` counts its
kernel launches.
"""

from __future__ import annotations

import torch

from .. import _build
from . import eft
from .cuda_f32 import _f32_sum, _self_pairs
from .cuda_nbody import _check_input, _source_splits, on_device


def pairwise_accel_mixed_plain(pos_hi, pos_lo, mu):
    """Plain PyTorch version of kernel 6: pos_hi/pos_lo (3, N) f32, mu (1, N)
    f32 -> (N, 3) f32.  Each difference is s + (e + (pj_lo - pi_lo)) with
    s, e = two_sum(pj_hi, -pi_hi) (pallas_nbody.py:800-803); the rest is
    kernel 5's chain."""
    d = []
    for c in range(3):
        s, e = eft.two_sum(pos_hi[c][None, :], -pos_hi[c][:, None])
        d.append(s + (e + (pos_lo[c][None, :] - pos_lo[c][:, None])))
    n = pos_hi.shape[1]
    return _f32_sum(d, mu, _self_pairs(n, n, pos_hi.device))


def pairwise_accel_mixed(pos_hi, pos_lo, mu):
    """Mixed-precision O(N^2) acceleration (kernel 6): split (hi, lo) f32
    positions in, f32 (N, 3) accelerations out.

    pos_hi/pos_lo: (3, N) f32 split positions; mu: (1, N) f32.  CPU tensors
    take the plain version; CUDA tensors launch the kernel.
    """
    dev = pos_hi.device
    if dev.type == "cpu":
        return pairwise_accel_mixed_plain(pos_hi, pos_lo, mu)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    n = pos_hi.shape[1]
    for name, x, shape in (("pos_hi", pos_hi, (3, n)), ("pos_lo", pos_lo, (3, n)),
                           ("mu", mu, (1, n))):
        _check_input(name, x, shape, dev)
    out = torch.empty((n, 3), dtype=torch.float32, device=dev)
    if n == 0:
        return out
    lib = _build.library()
    splits = _source_splits(-(-n // lib.eet_accel_mixed_tile()))
    part = torch.empty((splits, n, 3), dtype=torch.float32, device=dev)
    with on_device(dev) as stream:
        err = lib.eet_accel_mixed(pos_hi.data_ptr(), pos_lo.data_ptr(), mu.data_ptr(),
                                  part.data_ptr(), out.data_ptr(), n, splits, stream)
    _build.check(err, "accel_mixed")
    pairwise_accel_mixed.launches += 1
    return out


pairwise_accel_mixed.launches = 0
