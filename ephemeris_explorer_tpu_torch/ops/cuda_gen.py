"""Kernel 11: a whole generation chunk in one kernel, its plain version and
its wrapper.

Counterpart of ``ephemeris_explorer_tpu.ops.pallas_gen`` (TPU kernel
``_gen_kernel``, ``elm2_gen_scan``): ``n_steps`` steps of the two-float ELM2
update (kernel 2's arithmetic), the N x N two-float pair force, the ring
shift and the emission of the new positions, from an f64 ``ELM2Carry``.  The
state is two-float (~2^-48) throughout, the rings in the reference's
component-major flat layout (ORDER, 3N), and the bodies padded to a power of
two with massless ghosts parked far away, exactly as the reference pads
them.  The CUDA source is ``csrc/gen_scan.cu``; its header note says what
bounds it on an H100 and how the design answers that.

:func:`elm2_gen_scan` takes the plain version (:func:`elm2_gen_scan_plain`'s
arithmetic) only for CPU tensors; on CUDA tensors it launches the kernel or
raises.  ``elm2_gen_scan.launches`` counts its launches (one per call).  The
kernel and the plain version run the same ops in the same order, so they
agree bitwise.
"""

from __future__ import annotations

import torch

from .. import _build
from . import eft
from .cuda_elm2 import _tables, elm2f_update_plain
from .cuda_nbody import _check_input, _dd_tree_sum, _rsqrt_df, _sqr_presplit, on_device
from .eft import TwoFloat

MAX_PADDED_N = 256  # the rings of the largest padded N fill one block's shared memory


def _pair_force(y: TwoFloat, mu: TwoFloat, n: int) -> TwoFloat:
    """pallas_gen._pair_force: the (3N,) component-major force on the
    (3N,) component-major positions ``y``; ``mu`` (1, N)."""
    cols = [TwoFloat(y.hi[c * n:(c + 1) * n][None, :], y.lo[c * n:(c + 1) * n][None, :])
            for c in range(3)]
    self_mask = torch.eye(n, dtype=torch.bool, device=y.hi.device)
    d = [eft.sub(cc, TwoFloat(cc.hi.t(), cc.lo.t())) for cc in cols]   # (N, N): p_j - p_i
    ds = [eft.split(dc.hi) for dc in d]
    r2 = eft.add(eft.add(_sqr_presplit(d[0], ds[0]), _sqr_presplit(d[1], ds[1])),
                 _sqr_presplit(d[2], ds[2]))
    r2 = eft.where(self_mask, TwoFloat(torch.ones_like(r2.hi), torch.zeros_like(r2.lo)), r2)
    u = _rsqrt_df(r2)
    # w = (u^2 u) mu as pallas_gen.py:72 writes it (the row kernels fold mu
    # in first; see csrc/gen_scan.cu on why this order is kept)
    w = eft.mul(eft.mul(eft.sqr(u), u), mu)
    zero = torch.zeros_like(w.hi)
    w = eft.where(self_mask, TwoFloat(zero, zero), w)
    ws = eft.split(w.hi)
    out = [_dd_tree_sum(eft.mul_presplit(w, ws, d[c], ds[c]), 1) for c in range(3)]
    return TwoFloat(torch.cat([o.hi[:, 0] for o in out]), torch.cat([o.lo[:, 0] for o in out]))


def _gen_scan_flat_plain(coef, c_y, mu: TwoFloat, ys: TwoFloat, dd: TwoFloat, n: int,
                         n_steps: int):
    """The chunk on flat (ORDER, 3N) rings: (emitted (n_steps, 3N) pair, ys,
    dd after the chunk)."""
    order = ys.hi.shape[0]
    emit_hi, emit_lo = [], []
    for _ in range(n_steps):
        y = elm2f_update_plain(coef, c_y, ys, dd)
        f = _pair_force(y, mu, n)
        emit_hi.append(y.hi)
        emit_lo.append(y.lo)
        ys = TwoFloat(torch.cat([y.hi[None], ys.hi[:order - 1]]),
                      torch.cat([y.lo[None], ys.lo[:order - 1]]))
        dd = TwoFloat(torch.cat([f.hi[None], dd.hi[:order - 1]]),
                      torch.cat([f.lo[None], dd.lo[:order - 1]]))
    m = ys.hi.shape[1]
    if not emit_hi:
        empty = ys.hi.new_zeros((0, m))
        return TwoFloat(empty, empty.clone()), ys, dd
    return TwoFloat(torch.stack(emit_hi), torch.stack(emit_lo)), ys, dd


def _padded(carry, mu_pair: TwoFloat):
    """(n, flat ys, flat dd, padded mu): the bodies padded to a power of two
    n with mu = 0 ghosts at 1e12 + 1e9 k km (pallas_gen.py:176-202), the rings
    split into (ORDER, 3n) component-major (hi, lo) f32."""
    o, n_real, _ = carry.ys.shape
    n = 1 << (n_real - 1).bit_length()
    pad = n - n_real
    dev = carry.ys.device
    ys64, dd64 = carry.ys, carry.ddys
    mu = mu_pair
    if pad:
        ghost = 1.0e12 + 1.0e9 * torch.arange(pad, dtype=torch.float64, device=dev)[:, None]
        ys64 = torch.cat([ys64, ghost.expand(o, pad, 3)], dim=1)
        dd64 = torch.cat([dd64, dd64.new_zeros((o, pad, 3))], dim=1)
        z = mu_pair.hi.new_zeros((1, pad))
        mu = TwoFloat(torch.cat([mu_pair.hi, z], dim=1), torch.cat([mu_pair.lo, z], dim=1))

    def to_flat(x64):
        x = x64.transpose(1, 2).reshape(o, 3 * n)   # (O, 3, N) -> (O, 3N)
        hi = x.to(torch.float32)
        return TwoFloat(hi, (x - hi.to(torch.float64)).to(torch.float32))

    return n, to_flat(ys64), to_flat(dd64), mu


def _unpadded(x: TwoFloat, n: int, n_real: int) -> torch.Tensor:
    """(lead, 3n) flat pairs -> (lead, n_real, 3) f64."""
    x64 = x.hi.to(torch.float64) + x.lo.to(torch.float64)
    return x64.reshape(x64.shape[0], 3, n).transpose(1, 2)[:, :n_real]


def _result(h, carry, n, emit, ys, dd):
    from ..integrators.multistep import ELM2Carry

    n_real = carry.ys.shape[1]
    new = ELM2Carry(t=carry.t + emit.hi.shape[0] * h, ys=_unpadded(ys, n, n_real),
                    ddys=_unpadded(dd, n, n_real), dy=carry.dy)
    return _unpadded(emit, n, n_real), new


def elm2_gen_scan_plain(tab, h: float, carry, mu_pair: TwoFloat, n_steps: int):
    """Plain PyTorch version of :func:`elm2_gen_scan`, on any device: the
    same padding, layout and conversions around the chunk's arithmetic in
    eager torch, one step at a time."""
    coef, c_y = _tables(tab, h)
    n, ys, dd, mu = _padded(carry, mu_pair)
    emit, ys, dd = _gen_scan_flat_plain(coef, c_y, mu, ys, dd, n, n_steps)
    return _result(h, carry, n, emit, ys, dd)


def elm2_gen_scan(tab, h: float, carry, mu_pair: TwoFloat, n_steps: int):
    """Run ``n_steps`` fused generation steps from an f64 ELM2Carry (kernel 11).

    carry: :class:`..integrators.multistep.ELM2Carry` with (ORDER, N, 3) f64
    rings; mu_pair: TwoFloat (1, N) f32.  Returns (ys_f64, new_carry): the
    (n_steps, N, 3) emitted positions and the advanced f64 carry, its
    velocity stale (restore it with ``elm2_velocity``).  The bodies, padded
    to a power of two, may number at most :data:`MAX_PADDED_N`.  CPU tensors
    take the plain version; CUDA tensors launch the kernel.
    """
    n_real = carry.ys.shape[1]
    n_pad = 1 << (n_real - 1).bit_length()
    if n_pad > MAX_PADDED_N:
        raise ValueError(f"the generation kernel holds at most {MAX_PADDED_N} bodies padded to a "
                         f"power of two; {n_real} pad to {n_pad}")
    dev = carry.ys.device
    if dev.type == "cpu":
        return elm2_gen_scan_plain(tab, h, carry, mu_pair, n_steps)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    for name, x in (("mu_pair.hi", mu_pair.hi), ("mu_pair.lo", mu_pair.lo)):
        _check_input(name, x, (1, n_real), dev)
    coef, c_y = _tables(tab, h)
    n, ys, dd, mu = _padded(carry, mu_pair)
    order, m = ys.hi.shape
    if order != len(tab.c_y):
        raise ValueError(f"ring depth {order} != method order {len(tab.c_y)}")
    emit = torch.empty((2, n_steps, m), dtype=torch.float32, device=dev)
    rings = torch.empty((4, order, m), dtype=torch.float32, device=dev)
    if n_steps == 0:
        return _result(h, carry, n, TwoFloat(emit[0], emit[1]), ys, dd)
    lib = _build.library()
    with on_device(dev) as stream:
        err = lib.eet_gen_scan(
            coef.ctypes.data, c_y.ctypes.data, order, mu.hi.data_ptr(), mu.lo.data_ptr(),
            ys.hi.data_ptr(), ys.lo.data_ptr(), dd.hi.data_ptr(), dd.lo.data_ptr(),
            emit[0].data_ptr(), emit[1].data_ptr(), *(r.data_ptr() for r in rings),
            n, n_steps, stream,
        )
    _build.check(err, "gen_scan")
    elm2_gen_scan.launches += 1
    return _result(h, carry, n, TwoFloat(emit[0], emit[1]),
                   TwoFloat(rings[0], rings[1]), TwoFloat(rings[2], rings[3]))


elm2_gen_scan.launches = 0
