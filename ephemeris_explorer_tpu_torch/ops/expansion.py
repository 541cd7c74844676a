"""Fixed-size floating-point expansions over exact f32 arithmetic.

Port of ``ephemeris_explorer_tpu.ops.expansion``: a value is an unevaluated
sum of ``K`` f32 limbs (Shewchuk/QD-style expansion), ~24*K significant bits
(K = 4: ~2^-96).  The long-horizon integrator state
(:class:`..integrators.multistep.ELM2CarryQ`) keeps positions this way, and
the 4-limb update kernel (``csrc/elm2q_update.cu``) runs the same
:func:`renorm` / :func:`add` cascade per element.

An expansion is a tuple of K same-shaped f32 tensors.  Every op is eager
elementwise torch, one rounding per op (see :mod:`.eft`): never run under
``torch.compile``.
"""

from __future__ import annotations

import numpy as np
import torch

from .eft import const, two_sum

K = 4  # limbs


def zeros(shape, device="cpu") -> tuple:
    z = torch.zeros(shape, dtype=torch.float32, device=device)
    return (z,) * K


def renorm(*limbs) -> tuple:
    """Renormalise a limb list to K limbs.

    Three bottom-up two_sum sweeps (distillation cascade) push the mass into
    the leading limbs; terms beyond K are folded into the last limb (they
    are O(ulp^K) of the head by then).  Branch-free and elementwise.
    """
    x = list(limbs)
    n = len(x)
    for _ in range(3):
        for i in range(n - 2, -1, -1):
            x[i], x[i + 1] = two_sum(x[i], x[i + 1])
    tail = x[K - 1] if n >= K else x[-1]
    for t in x[K:]:
        tail = tail + t
    out = x[: K - 1] + [tail]
    while len(out) < K:
        out.append(torch.zeros_like(out[0]))
    return tuple(out[:K])


def add(a: tuple, b: tuple) -> tuple:
    """Expansion + expansion -> K-limb expansion (limbs interleaved a0 b0 a1
    b1 ... so the sweeps see a near-sorted sequence)."""
    merged = []
    for x, y in zip(a, b):
        merged.append(x)
        merged.append(y)
    return renorm(*merged)


def from_two(hi, lo) -> tuple:
    z = torch.zeros_like(hi)
    return (hi, lo, z, z)


def from_f64_host(x, device="cpu") -> tuple:
    """Exact host-side limb split of IEEE f64 (numpy) values, as f32 tensors
    on ``device``: three f32 limbs hold any binary64 exactly, the fourth is
    zero, and f32 transfers are exact."""
    x = np.asarray(x, np.float64)
    limbs = []
    for _ in range(K - 1):
        limb = x.astype(np.float32)
        limbs.append(limb)
        x = x - limb.astype(np.float64)
    limbs.append(x.astype(np.float32))
    return tuple(torch.as_tensor(np.ascontiguousarray(l), device=device) for l in limbs)


def from_f64(x: torch.Tensor) -> tuple:
    """Exact lift of an f64 tensor into f32 limbs (on its device)."""
    a0 = x.to(torch.float32)
    r = x - a0.to(x.dtype)
    a1 = r.to(torch.float32)
    r = r - a1.to(x.dtype)
    a2 = r.to(torch.float32)
    return (a0, a1, a2, torch.zeros_like(a2))


def to_f64(a: tuple) -> torch.Tensor:
    """Round an expansion to f64: sum low-to-high."""
    out = a[-1].to(torch.float64)
    for x in a[-2::-1]:
        out = out + x.to(torch.float64)
    return out


def hi_lo(a: tuple):
    """The two leading limbs: a two-float pair."""
    return a[0], a[1]


def scale_pow2i(a: tuple, c: float) -> tuple:
    """Exact scaling by +-2^k (the ELM2 alpha coefficients), per limb."""
    cf = const(float(c), torch.float32)
    return tuple(x * cf for x in a)


def neg(a: tuple) -> tuple:
    return tuple(-x for x in a)
