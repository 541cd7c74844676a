"""The magnitude-split force mode's plain ops: the strong set and the f64
oracle of its correction.

Counterparts of ``ephemeris_explorer_tpu.ops.pallas_nbody``'s
``strong_pair_indices``, ``strong_pair_indices_rows``, ``strong_pair_mask``,
``strong_pair_mask_rows`` and ``_strong_correction``, which the JAX package
runs outside any kernel; here they are plain torch on any device.

The split mode sums each body's K strongest attractors, by weight
``mu_j / r_ij^3`` (the f32 error model: the pairs whose f32 position
rounding hurts most), in two-float arithmetic (kernel 8,
:mod:`.cuda_split`), and every other pair in f32 (kernel 7,
:mod:`.cuda_f32`).  The strong set moves on orbital timescales: build it
once per chunk, not per step.  ``torch.topk`` may order equal weights
differently from ``lax.top_k``; the index sets are what the two share.
"""

from __future__ import annotations

import torch


def _weights(p, r, self_):
    """(NL, N) f32 r^-3 from sources p (N, 3) to receivers r (NL, 3), the
    self entries' r^2 set to 1."""
    d = p[None, :, :] - r[:, None, :]
    r2 = (d * d).sum(-1).masked_fill(self_, 1.0)
    u = torch.rsqrt(r2)
    return u * u * u


def _top_k(p, r, mu, self_, k):
    s = mu.to(torch.float32)[None, :] * _weights(p, r, self_)
    s = s.masked_fill(self_, float("-inf"))
    return torch.topk(s, k, dim=1).indices.to(torch.int32)


def strong_pair_indices(pos, mu, k: int = 16):
    """Per-row top-k columns by weight mu_j / r_ij^3: pos (N, 3), mu (N,) ->
    (N, k) int32 column indices, self excluded.  O(N^2) scratch: run per
    chunk, not per step."""
    # k == n would select the -inf self entry, and the correction would
    # divide by r2 == 0
    assert k < pos.shape[0], f"strong set k={k} must be < n={pos.shape[0]}"
    p = pos.to(torch.float32)
    n = p.shape[0]
    eye = torch.eye(n, dtype=torch.bool, device=p.device)
    return _top_k(p, p, mu, eye, k)


def strong_pair_indices_rows(pos, rows, mu, row0: int, k: int = 16):
    """Rows form of :func:`strong_pair_indices`: the top-k GLOBAL columns for
    the receivers rows (NL, 3) at global offset ``row0``.  Each row is
    computed as in the square form."""
    assert k < pos.shape[0], f"strong set k={k} must be < n={pos.shape[0]}"
    p = pos.to(torch.float32)
    r = rows.to(torch.float32)
    cols = torch.arange(p.shape[0], device=p.device)[None, :]
    self_ = cols == (row0 + torch.arange(r.shape[0], device=p.device))[:, None]
    return _top_k(p, r, mu, self_, k)


def strong_pair_mask(idx, n: int):
    """(N, N) int8 exclusion table: 1 at each (i, idx[i, k]) and on the self
    diagonal, which lets kernel 7 drop its self compare (``diag_in_mask``)."""
    return strong_pair_mask_rows(idx, n, 0)


def strong_pair_mask_rows(idx, n: int, row0: int):
    """Rows form of :func:`strong_pair_mask`: (NL, N) int8, the self
    diagonal at the GLOBAL column row0 + i."""
    nl = idx.shape[0]
    rows = torch.arange(nl, device=idx.device)
    m = torch.zeros((nl, n), dtype=torch.int8, device=idx.device)
    m[rows[:, None], idx.long()] = 1
    m[rows, row0 + rows] = 1
    return m


def _strong_correction(pos, mu, idx):
    """Native-precision acceleration from each row's strong set: gathered
    (N, K) pair math in the input dtype (f64: the cross-check oracle of the
    two-float correction, ``corr="f64"``)."""
    g = idx.long()
    d = pos[g] - pos[:, None, :]                   # (N, K, 3)
    r2 = (d * d).sum(-1)
    w = mu[g] / (r2 * torch.sqrt(r2))              # mu_j / r^3
    return (w[..., None] * d).sum(1)
