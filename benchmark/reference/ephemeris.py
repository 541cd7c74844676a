"""Plain ephemeris generation, fit and evaluation.

The upstream project's generation semantics: the bodies stepped by QT12 at
the scene's dt, body b's position sampled every ``count_b`` steps (sample k
at step k * count_b, sample 0 the initial state), and each run of 9
samples, 8 sample periods, fitted by least squares with a polynomial of
degree ``degree_b`` in tau = i / 8 over the segment; coefficients ascending,
padded to 9.  A segment covers ``dt * count_b * 8`` seconds; at a time t a
body takes the segment ``ceil((t - start) / interval) - 1`` (clamped to its
segments) and Horner's rule in tau.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from . import nbody

DIV = 8
COEFFS = DIV + 1


def fit_matrix(degree: int) -> np.ndarray:
    """(9, 9): 9 samples at tau = i / 8 to the padded least-squares
    coefficients of a degree ``degree`` polynomial."""
    tau = np.arange(COEFFS, dtype=np.float64) / DIV
    v = tau[:, None] ** np.arange(degree + 1)[None, :]
    out = np.zeros((COEFFS, COEFFS))
    out[: degree + 1] = np.linalg.lstsq(v, np.eye(COEFFS), rcond=None)[0]
    return out


@dataclass
class Ephemeris:
    """Every body's segments: start (N,) and interval (N,) f64 seconds,
    coeffs[b] (S_b, 9, 3) in the generation's dtype."""

    start: torch.Tensor
    interval: torch.Tensor
    coeffs: list
    mu: torch.Tensor

    @property
    def end_s(self) -> float:
        return min(float(s + i * c.shape[0])
                   for s, i, c in zip(self.start, self.interval, self.coeffs))

    def padded(self) -> tuple[torch.Tensor, torch.Tensor]:
        """(coeffs (N, S_max, 9, 3), nseg (N,)) for batched lookups."""
        smax = max(c.shape[0] for c in self.coeffs)
        out = self.coeffs[0].new_zeros((len(self.coeffs), smax, COEFFS, 3))
        for b, c in enumerate(self.coeffs):
            out[b, : c.shape[0]] = c
        nseg = torch.tensor([c.shape[0] for c in self.coeffs], device=out.device)
        return out, nseg


class Evaluator:
    """Positions (and velocities) of every body at times of any shape."""

    def __init__(self, eph: Ephemeris):
        self.coeffs, self.nseg = eph.padded()
        self.start, self.interval = eph.start, eph.interval

    def __call__(self, t: torch.Tensor, velocity: bool = False):
        """t (...,) -> positions (..., N, 3) [, velocities (..., N, 3)]."""
        local = t[..., None] - self.start                       # (..., N)
        idx = torch.ceil(local / self.interval).long() - 1
        idx = torch.minimum(idx.clamp(min=0), self.nseg - 1)
        tau = ((local - self.interval * idx) / self.interval)[..., None].to(self.coeffs.dtype)
        body = torch.arange(self.coeffs.shape[0], device=t.device).expand_as(idx)
        c = self.coeffs[body, idx]                               # (..., N, 9, 3)
        p = c[..., COEFFS - 1, :]
        for d in range(COEFFS - 2, -1, -1):
            p = p * tau + c[..., d, :]
        if not velocity:
            return p
        dp = c[..., COEFFS - 1, :] * (COEFFS - 1)
        for d in range(COEFFS - 2, 0, -1):
            dp = dp * tau + c[..., d, :] * d
        return p, dp / self.interval[..., None].to(dp.dtype)


def generate(state: dict, settings: dict, n_steps: int, dtype=torch.float64,
             device="cpu") -> Ephemeris:
    """``n_steps`` QT12 steps of the scene from its epoch, then the fit."""
    kw = {"dtype": dtype, "device": device}
    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    mu = np.asarray(state["mu"], dtype=np_dtype)
    h = float(settings["dt_s"])
    pos = np.asarray(state["pos"], dtype=np_dtype)
    vel = np.asarray(state["vel"], dtype=np_dtype)
    # stepped with numpy: a few dozen bodies, where a torch call costs more
    # than its arithmetic
    track_np = np.empty((n_steps + 1,) + pos.shape, dtype=np_dtype)
    track_np[0] = pos
    ys, ddys, _ = nbody.startup(pos, vel, mu, h)
    track_np[1:nbody.ORDER + 1] = ys[::-1]
    for n in range(nbody.ORDER + 1, n_steps + 1):
        ys, ddys = nbody.step(ys, ddys, mu, h)
        track_np[n] = ys[0]
    track = torch.from_numpy(track_np).to(device)
    mu = torch.from_numpy(mu).to(device)
    coeffs = []
    for b, (count, degree) in enumerate(zip(settings["count"], settings["degree"])):
        samples = track[:: int(count), b]                        # (K + 1, 3)
        nseg = (samples.shape[0] - 1) // DIV
        win = torch.arange(nseg, device=device)[:, None] * DIV + torch.arange(COEFFS, device=device)
        m = torch.as_tensor(fit_matrix(int(degree)), **kw)
        coeffs.append(torch.einsum("dk,skc->sdc", m, samples[win]))
    # times stay f64 in every dtype: an epoch in f32 would be off by seconds
    counts = torch.as_tensor(np.asarray(settings["count"], dtype=np.float64), device=device)
    start = torch.full_like(counts, float(state["epoch_s"]))
    return Ephemeris(start=start, interval=counts * (h * DIV), coeffs=coeffs, mu=mu)
