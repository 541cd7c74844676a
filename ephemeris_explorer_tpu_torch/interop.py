"""Carry state and parameters across from the JAX package, and back.

Every function takes the JAX package's objects duck-typed and reads them
through ``numpy.asarray``, so this module imports neither package's JAX
side; tests use it to start both packages from the same bits.
"""

from __future__ import annotations

import numpy as np
import torch

from .ftime import Duration, Epoch
from .integrators.multistep import ELM2Carry, ELM2CarryF
from .io.scene import Body, EphemeridesSettings, InterpolationParameters, SolarSystemState
from .ops.eft import TwoFloat


def _t(x, device, dtype=None) -> torch.Tensor:
    a = np.array(np.asarray(x), order="C")  # a writable host copy
    return torch.as_tensor(a, dtype=dtype, device=device)


def state_from(state) -> SolarSystemState:
    """The port's SolarSystemState from the JAX package's."""
    return SolarSystemState(
        name=state.name,
        epoch=Epoch.from_offset_seconds(state.epoch.as_offset_seconds()),
        bodies=[
            Body(
                name=b.name, mu=float(b.mu),
                position=np.array(b.position, dtype=np.float64),
                velocity=np.array(b.velocity, dtype=np.float64),
            )
            for b in state.bodies
        ],
    )


def settings_from(settings) -> EphemeridesSettings:
    """The port's EphemeridesSettings from the JAX package's."""
    return EphemeridesSettings(
        dt=Duration(settings.dt.as_seconds()),
        settings={
            name: InterpolationParameters(degree=int(s.degree), count=int(s.count))
            for name, s in settings.settings.items()
        },
    )


def carry_from(carry, device="cpu") -> ELM2Carry:
    """The port's f64 ELM2Carry from the JAX package's ELM2Carry."""
    return ELM2Carry(
        t=float(np.asarray(carry.t)),
        ys=_t(carry.ys, device, torch.float64),
        ddys=_t(carry.ddys, device, torch.float64),
        dy=_t(carry.dy, device, torch.float64),
    )


def pair_from(pair, device="cpu") -> TwoFloat:
    """A TwoFloat (or a (hi, lo) tuple) of f32 arrays as a torch TwoFloat."""
    hi, lo = pair
    return TwoFloat(_t(hi, device, torch.float32), _t(lo, device, torch.float32))


def carry_f_from(carry, device="cpu") -> ELM2CarryF:
    """The port's two-float ELM2CarryF from the JAX package's ELM2CarryF."""
    return ELM2CarryF(
        t=float(np.asarray(carry.t)),
        ys=pair_from(carry.ys, device),
        dd=pair_from(carry.dd, device),
        dy=_t(carry.dy, device, torch.float64),
    )


def mu_pair_from(mu_hi, mu_lo, device="cpu") -> tuple[torch.Tensor, torch.Tensor]:
    """The (1, N) f32 split gravitational parameters."""
    return _t(mu_hi, device, torch.float32), _t(mu_lo, device, torch.float32)


def to_numpy(x):
    """Tensors, TwoFloats and carries back to numpy (recursively, on the host)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if isinstance(x, tuple):
        return type(x)(*map(to_numpy, x)) if hasattr(x, "_fields") else tuple(map(to_numpy, x))
    return x
