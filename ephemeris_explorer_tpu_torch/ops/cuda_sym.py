"""Kernel 10: the symmetric (third-law) two-float pair force, its plain
version and its wrappers.

Counterpart of ``ephemeris_explorer_tpu.ops.pallas_nbody``'s TPU kernel
``_accel_kernel_sym`` (``pairwise_accel_df64_sym`` and the drop-in f64
``pairwise_accel_sym``).  Each unordered pair is evaluated once, over the
upper triangle of (TILE, TILE) tile pairs, and its force goes to both
bodies: the row side to receiver tile i, the column side, negated, to tile
j (zero on the diagonal tile).  The CUDA source is ``csrc/accel_sym.cu``;
its header note says what bounds it on an H100 and how the design answers
that.

The sums run in the reference's order: within a tile pair, the halving
tree of ``_dd_tree_sum`` over the tile's columns (row side) and over its
rows (column side); across tiles, ``add_sloppy`` from zero in tile order,
the row side over j = i .. NT-1 and the column side over i = 0 .. j-1; then
``add_sloppy(row, col)``.  The kernel's tile is 32 (a warp), so the plain
version at its default tile equals the kernel bitwise.  N must be a
multiple of the tile, as in the reference; otherwise the wrappers raise.

:func:`pairwise_accel_df64_sym` takes the plain version only for CPU
tensors; on CUDA tensors it launches the kernel or raises.
``pairwise_accel_df64_sym.launches`` counts its launches.
"""

from __future__ import annotations

import torch

from .. import _build
from . import eft
from .cuda_nbody import (
    _check_input, _dd_tree_sum, _rsqrt_df, _sqr_presplit, combine_f64, on_device, split_f64,
)
from .eft import TwoFloat

TILE = 32  # the kernel's tile: a warp's lanes (csrc/accel_sym.cu kTile)


def _check_tile(n: int, tile: int) -> None:
    if n % tile:
        raise ValueError(f"the symmetric pair force needs N a multiple of its tile {tile}, got {n}")


def _tile_row(pos_hi, pos_lo, mu_hi, mu_lo, r0: int, tile: int):
    """Receiver tile [r0, r0 + tile) against sources r0 .. N-1: (the row
    side's tile sums (tile, NT - r0/tile, 3), the column side's tile sums
    (N - r0, 3)), each a TwoFloat; the first tile of column sums is the
    diagonal's, which the fold leaves out."""
    n = pos_hi.shape[1]
    w = n - r0
    ri = slice(r0, r0 + tile)
    d = [eft.sub(TwoFloat(pos_hi[c, r0:][None, :], pos_lo[c, r0:][None, :]),
                 TwoFloat(pos_hi[c, ri][:, None], pos_lo[c, ri][:, None])) for c in range(3)]
    ds = [eft.split(dc.hi) for dc in d]
    r2 = eft.add(eft.add(_sqr_presplit(d[0], ds[0]), _sqr_presplit(d[1], ds[1])),
                 _sqr_presplit(d[2], ds[2]))
    self_mask = torch.arange(tile, device=pos_hi.device)[:, None] == torch.arange(
        w, device=pos_hi.device)[None, :]
    r2 = eft.where(self_mask, TwoFloat(torch.ones_like(r2.hi), torch.zeros_like(r2.lo)), r2)
    u = _rsqrt_df(r2)
    # u^2 with mu folded in before the last multiply by u (pallas_nbody.py:649-652)
    u2 = eft.sqr(u)
    zero = torch.zeros_like(u2.hi)
    u2 = eft.where(self_mask, TwoFloat(zero, zero), u2)
    u2s = eft.split(u2.hi)
    mu_c = TwoFloat(mu_hi[:, r0:], mu_lo[:, r0:])
    mu_r = TwoFloat(mu_hi[0, ri][:, None], mu_lo[0, ri][:, None])
    wr = eft.mul(eft.mul_presplit(u2, u2s, mu_c, eft.split(mu_c.hi)), u)
    wc = eft.mul(eft.mul_presplit(u2, u2s, mu_r, eft.split(mu_r.hi)), u)
    wrs, wcs = eft.split(wr.hi), eft.split(wc.hi)
    rows, cols = [], []
    for c in range(3):
        rt = eft.mul_presplit(wr, wrs, d[c], ds[c])             # (tile, w)
        rt = TwoFloat(rt.hi.reshape(tile, w // tile, tile), rt.lo.reshape(tile, w // tile, tile))
        rows.append(_dd_tree_sum(rt, 2))                        # (tile, w/tile, 1)
        cols.append(_dd_tree_sum(eft.mul_presplit(wc, wcs, d[c], ds[c]), 0))   # (1, w)
    return (TwoFloat(torch.cat([s.hi for s in rows], 2), torch.cat([s.lo for s in rows], 2)),
            TwoFloat(torch.cat([s.hi for s in cols], 0).t(), torch.cat([s.lo for s in cols], 0).t()))


def pairwise_accel_df64_sym_plain(pos_hi, pos_lo, mu_hi, mu_lo, tile: int = TILE):
    """Plain PyTorch version of kernel 10, on any device.

    pos_hi/pos_lo: (3, N) f32; mu_hi/mu_lo: (1, N) f32; N a multiple of
    ``tile``.  Returns (acc_hi, acc_lo) of shape (N, 3).  The pair chain and
    every sum are the kernel's, op for op, vectorised over one receiver tile
    and all the sources at or after it.
    """
    n = pos_hi.shape[1]
    _check_tile(n, tile)
    nt = n // tile
    z = pos_hi.new_zeros
    row_part = TwoFloat(z((n, nt, 3)), z((n, nt, 3)))   # [receiver, slot j]
    col_part = TwoFloat(z((nt, n, 3)), z((nt, n, 3)))   # [slot i, receiver]
    for ti in range(nt):
        r0 = ti * tile
        rs, cs = _tile_row(pos_hi, pos_lo, mu_hi, mu_lo, r0, tile)
        row_part.hi[r0:r0 + tile, ti:] = rs.hi
        row_part.lo[r0:r0 + tile, ti:] = rs.lo
        col_part.hi[ti, r0 + tile:] = cs.hi[tile:]
        col_part.lo[ti, r0 + tile:] = cs.lo[tile:]
    # the fold: row side over slots tile(r) .. NT-1, column side (negated)
    # over slots 0 .. tile(r)-1, each add_sloppy from zero in slot order
    tile_of = (torch.arange(n, device=pos_hi.device) // tile)[:, None]
    row = TwoFloat(z((n, 3)), z((n, 3)))
    col = TwoFloat(z((n, 3)), z((n, 3)))
    for s in range(nt):
        row = eft.where(tile_of <= s, eft.add_sloppy(row, TwoFloat(row_part.hi[:, s],
                                                                   row_part.lo[:, s])), row)
        col = eft.where(tile_of > s, eft.add_sloppy(col, TwoFloat(-col_part.hi[s],
                                                                  -col_part.lo[s])), col)
    out = eft.add_sloppy(row, col)
    return out.hi, out.lo


def pairwise_accel_df64_sym(pos_hi, pos_lo, mu_hi, mu_lo):
    """Symmetric pairwise accelerations in two-float precision (kernel 10).

    pos_hi/pos_lo: (3, N) f32 component-major split positions.
    mu_hi/mu_lo:   (1, N) f32 split gravitational parameters.
    Returns (acc_hi, acc_lo) of shape (N, 3).  N must be a multiple of
    :data:`TILE`.  CPU tensors take the plain version; CUDA tensors launch
    the kernel.
    """
    dev = pos_hi.device
    n = pos_hi.shape[1]
    _check_tile(n, TILE)
    if dev.type == "cpu":
        return pairwise_accel_df64_sym_plain(pos_hi, pos_lo, mu_hi, mu_lo)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    for name, x, shape in (("pos_hi", pos_hi, (3, n)), ("pos_lo", pos_lo, (3, n)),
                           ("mu_hi", mu_hi, (1, n)), ("mu_lo", mu_lo, (1, n))):
        _check_input(name, x, shape, dev)
    out_hi = torch.empty((n, 3), dtype=torch.float32, device=dev)
    out_lo = torch.empty((n, 3), dtype=torch.float32, device=dev)
    if n == 0:
        return out_hi, out_lo
    lib = _build.library()
    # the (NT, N, 3) slots of the row and column partial sums, hi and lo
    part = torch.empty((4, n // TILE, n, 3), dtype=torch.float32, device=dev)
    with on_device(dev) as stream:
        err = lib.eet_accel_sym(
            pos_hi.data_ptr(), pos_lo.data_ptr(), mu_hi.data_ptr(), mu_lo.data_ptr(),
            *(p.data_ptr() for p in part), out_hi.data_ptr(), out_lo.data_ptr(), n, stream,
        )
    _build.check(err, "accel_sym")
    pairwise_accel_df64_sym.launches += 1
    return out_hi, out_lo


pairwise_accel_df64_sym.launches = 0


def pairwise_accel_sym(pos: torch.Tensor, mu_hi, mu_lo) -> torch.Tensor:
    """Drop-in symmetric O(N^2/2) acceleration through kernel 10: f64 (N, 3)
    in and out."""
    ph, plo = split_f64(pos, transpose=True)
    return combine_f64(*pairwise_accel_df64_sym(ph, plo, mu_hi, mu_lo))
