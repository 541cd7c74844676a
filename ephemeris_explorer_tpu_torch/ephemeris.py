"""Ephemeris generation and evaluation: the celestial production path.

Port of ``ephemeris_explorer_tpu.ephemeris`` (the reference pipeline
NBodyPropagator + SplineInterpolators + UniformSpline,
``ephemeris/src/propagators/nbody.rs``, ``ephemeris/src/trajectory.rs:412-633``):

* integration is a Python loop over fixed QT12/Stormer13 multistep steps (one
  O(N^2) force evaluation per step), queued on the device without host syncs;
* per-body position sampling (every ``count`` steps) and the 9-sample
  least-squares polynomial fits run as one batched pass per chunk over the
  recorded sample rows;
* :class:`BodyEphemeris` mirrors ``UniformSpline`` (end-inclusive segment
  lookup, push/clear/append/prepend, Horner value and derivative), and
  :class:`PackedEphemeris` is the flattened device view.

Routing at ``precision="f64"``: below ``N*3 = 4096`` (and off CUDA) each
step is the plain native-f64 ``elm2_step``.  From there on a CUDA device,
the chunk runs the fused two-float step: kernel 2 for the position update
and kernel 1 for the force (:func:`_use_fused_f`).  A third branch runs
the whole chunk in kernel 11 (:func:`_use_gen_kernel`), off as in the JAX
package.

``precision="extended"`` / ``"extended3"`` keep positions as 4-limb f32
expansions (``elm2_init_q`` from the exact host limb split, then
``elm2_step_q`` with precise beta sums by default); under ``"extended3"``
every force evaluation, startup included, is kernel 3 on the three leading
limbs.  As in the JAX package, generation never takes the fused expansion
step (kernel 4): that is the ``elm2_step_qf`` API.

Time is carried as f64 seconds since the TAI epoch (ftime.Epoch offsets).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from . import _device
from .ftime import Duration, Epoch
from .integrators import get as get_method
from .integrators.multistep import (
    ELM2Carry,
    ELM2CarryQ,
    elm2_f_from,
    elm2_f_to,
    elm2_init_q,
    elm2_startup_scan,
    elm2_step,
    elm2_step_f,
    elm2_step_q,
    elm2_velocity,
    elm2_velocity_q,
)
from .io.scene import DIV, EphemeridesSettings, SolarSystemState
from .ops import cuda_gen, cuda_limbs, cuda_nbody, nbody
from .ops import expansion as ex
from .ops.eft import TwoFloat
from .ops.polyfit import MAX_COEFFS, fit_matrices, horner, horner_and_deriv

# Canonical generation chunk (steps per dispatch), shared with the JAX
# package: ~90 days of dt=600 s steps.
CHUNK_STEPS = 13184


def bucket_tail(n: int, chunk: int, min_n: int = 1) -> int:
    """Round a tail chunk up to the bucket ladder, capped at ``chunk``.

    The ladder is powers of two plus their 1.5x midpoints.  Applied only when
    the caller did not pick an explicit chunk size; ``min_n`` is a floor
    (e.g. the multistep order the startup chunk must cover).
    """
    n = max(n, min_n)
    p = 1 << max(n - 1, 1).bit_length()  # next pow2 >= n
    mid = 3 * (p // 4)                   # 1.5x the previous octave
    if p >= 4 and mid >= n:
        p = mid
    return min(p, chunk)


def _to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array on ``device`` without a host sync (pinned async copy)."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


# ---------------------------------------------------------------------------
# Host-side per-body container (UniformSpline semantics)
# ---------------------------------------------------------------------------


class BodyEphemeris:
    """Piecewise-polynomial trajectory over uniform segments.

    Equivalent of ``UniformSpline<DVec3>`` (trajectory.rs:412-633): ``start``
    is the epoch of the first segment, every segment spans ``interval``
    seconds, and segment coefficients are ascending-power polynomials in
    tau = (t - seg_start) / interval, padded to 9 coefficients (host numpy).
    The mutable state is one ``(start_s, coeffs)`` tuple published in a
    single assignment per mutation, so a concurrent reader sees either the
    old or the new snapshot.
    """

    __slots__ = ("interval_s", "_snap")

    def __init__(self, start_s: float, interval_s: float, coeffs: np.ndarray):
        self.interval_s = float(interval_s)
        self._snap = (float(start_s), coeffs)

    @property
    def start_s(self) -> float:
        return self._snap[0]

    @property
    def coeffs(self) -> np.ndarray:
        return self._snap[1]

    def snapshot(self) -> tuple[float, np.ndarray]:
        return self._snap

    @property
    def segment_count(self) -> int:
        return self._snap[1].shape[0]

    @property
    def span_s(self) -> float:
        return self.interval_s * self.segment_count

    @property
    def end_s(self) -> float:
        start, coeffs = self._snap
        return start + self.interval_s * coeffs.shape[0]

    @property
    def start(self) -> Epoch:
        return Epoch.from_offset_seconds(self.start_s)

    @property
    def end(self) -> Epoch:
        return Epoch.from_offset_seconds(self.end_s)

    def contains(self, t: Epoch | float) -> bool:
        ts = t.as_offset_seconds() if isinstance(t, Epoch) else float(t)
        start, coeffs = self._snap
        local = ts - start
        return local >= 0.0 and local <= self.interval_s * coeffs.shape[0]

    def _index_exclusive(self, local: float, nseg: int) -> int | None:
        """End-inclusive 'previous polynomial at a knot' rule."""
        if local < 0.0 or local > self.interval_s * nseg:
            return None
        return max(int(np.ceil(local / self.interval_s)) - 1, 0)

    def get_polynomial(self, t: Epoch | float):
        ts = t.as_offset_seconds() if isinstance(t, Epoch) else float(t)
        start, coeffs = self._snap
        nseg = coeffs.shape[0]
        local = ts - start
        idx = self._index_exclusive(local, nseg)
        if idx is None or idx >= nseg:
            return None
        tau = (local - self.interval_s * idx) / self.interval_s
        return coeffs[idx], tau

    def position(self, t: Epoch | float) -> np.ndarray | None:
        pt = self.get_polynomial(t)
        if pt is None:
            return None
        c, tau = pt
        return horner(torch.from_numpy(np.ascontiguousarray(c)), tau).numpy()

    def state_vector(self, t: Epoch | float):
        pt = self.get_polynomial(t)
        if pt is None:
            return None
        c, tau = pt
        pos, dtau = horner_and_deriv(torch.from_numpy(np.ascontiguousarray(c)), tau)
        # dx/dt = dx/dtau / interval  (trajectory.rs:466-469)
        return pos.numpy(), dtau.numpy() / self.interval_s

    def push_back(self, coeffs: np.ndarray) -> None:
        start, old = self._snap
        self._snap = (start, np.concatenate([old, coeffs.reshape(-1, MAX_COEFFS, 3)]))

    def push_front(self, coeffs: np.ndarray) -> None:
        start, old = self._snap
        c = coeffs.reshape(-1, MAX_COEFFS, 3)
        self._snap = (start - self.interval_s * c.shape[0], np.concatenate([c, old]))

    def append(self, other: "BodyEphemeris") -> None:
        start, old = self._snap
        o_start, o_coeffs = other._snap
        assert abs((start + self.interval_s * old.shape[0]) - o_start) < 1e-6
        self._snap = (start, np.concatenate([old, o_coeffs]))

    def prepend(self, other: "BodyEphemeris") -> None:
        start, old = self._snap
        o_start, o_coeffs = other._snap
        assert abs(start - (o_start + other.interval_s * o_coeffs.shape[0])) < 1e-6
        self._snap = (o_start, np.concatenate([o_coeffs, old]))

    def clear_after(self, t: Epoch | float) -> None:
        """Truncate segments at/after `t`; out-of-range `t` is a no-op."""
        ts = t.as_offset_seconds() if isinstance(t, Epoch) else float(t)
        start, coeffs = self._snap
        local = ts - start
        if local < 0.0 or local >= self.interval_s * coeffs.shape[0]:
            return
        self._snap = (start, coeffs[: int(local / self.interval_s)])

    def clear_before(self, t: Epoch | float) -> None:
        """Drop segments strictly before `t` (trajectory.rs:537-542)."""
        ts = t.as_offset_seconds() if isinstance(t, Epoch) else float(t)
        start, coeffs = self._snap
        nseg = coeffs.shape[0]
        idx = self._index_exclusive(ts + self.interval_s - start, nseg)
        if idx is None:
            return
        idx = min(idx, nseg)
        self._snap = (start + self.interval_s * idx, coeffs[idx:])

    def between(self, start, end) -> "BodyEphemeris | None":
        """Sub-spline covering [start, end] (trajectory.rs:484-502)."""
        b_start, coeffs = self._snap
        nseg = coeffs.shape[0]
        if nseg == 0:
            return None
        s = start.as_offset_seconds() if isinstance(start, Epoch) else float(start)
        e = end.as_offset_seconds() if isinstance(end, Epoch) else float(end)
        i0 = self._index_exclusive(s - b_start, nseg)
        i1 = self._index_exclusive(e - b_start, nseg)
        if i0 is None or i1 is None:
            return None
        i1 = min(i1, nseg - 1)
        return BodyEphemeris(
            start_s=b_start + self.interval_s * i0,
            interval_s=self.interval_s,
            coeffs=coeffs[i0 : i1 + 1].copy(),
        )

    @property
    def nbytes(self) -> int:
        return int(self._snap[1].nbytes)


@dataclass
class Ephemeris:
    """A system of body ephemerides (ordered as the scene's body list)."""

    names: list[str]
    mus: np.ndarray                    # (N,)
    bodies: dict[str, BodyEphemeris]

    @property
    def n(self) -> int:
        return len(self.names)

    def __getitem__(self, name: str) -> BodyEphemeris:
        return self.bodies[name]

    @property
    def start(self) -> Epoch:
        """Latest per-body start; Epoch.ZERO when empty."""
        return max((b.start for b in self.bodies.values()), default=Epoch.ZERO)

    @property
    def end(self) -> Epoch:
        """Earliest per-body end; Epoch.ZERO when empty."""
        return min((b.end for b in self.bodies.values()), default=Epoch.ZERO)

    def contains(self, t: Epoch | float) -> bool:
        return all(b.contains(t) for b in self.bodies.values())

    def positions(self, t: Epoch | float) -> np.ndarray | None:
        out = []
        for n in self.names:
            p = self.bodies[n].position(t)
            if p is None:
                return None
            out.append(p)
        return np.stack(out)

    @property
    def nbytes(self) -> int:
        return sum(b.nbytes for b in self.bodies.values())

    def pack(self, device=None) -> "PackedEphemeris":
        """The flattened view on ``device`` (one snapshot per body; None =
        the card, :func:`._device.resolve`)."""
        device = _device.resolve(device)
        snaps = [self.bodies[n].snapshot() for n in self.names]
        starts = np.array([s for s, _ in snaps])
        intervals = np.array([self.bodies[n].interval_s for n in self.names])
        nsegs = np.array([c.shape[0] for _, c in snaps], dtype=np.int64)
        offsets = np.concatenate([[0], np.cumsum(nsegs)[:-1]]).astype(np.int64)
        flat = np.concatenate([c for _, c in snaps])

        def dev(a):
            return torch.as_tensor(np.ascontiguousarray(a), device=device)

        return PackedEphemeris(
            mus=dev(np.asarray(self.mus, np.float64)), starts=dev(starts),
            intervals=dev(intervals), offsets=dev(offsets), nsegs=dev(nsegs),
            coeffs=dev(flat),
        )


class PackedEphemeris(NamedTuple):
    """Flattened device view for evaluation (ragged across bodies)."""

    mus: torch.Tensor        # (N,)
    starts: torch.Tensor     # (N,)
    intervals: torch.Tensor  # (N,)
    offsets: torch.Tensor    # (N,) first-segment index into coeffs
    nsegs: torch.Tensor      # (N,)
    coeffs: torch.Tensor     # (sum(nsegs), MAX_COEFFS, 3)

    @property
    def start_s(self) -> torch.Tensor:
        return self.starts.max()

    @property
    def end_s(self) -> torch.Tensor:
        return (self.starts + self.intervals * self.nsegs).min()

    def _segments(self, t):
        """(seg_coeffs (N, MAX_COEFFS, 3), tau (N,)) at time t (f64 seconds)."""
        local = t - self.starts
        idx = torch.ceil(local / self.intervals).to(torch.int64) - 1
        idx = torch.minimum(idx.clamp(min=0), self.nsegs - 1)
        tau = (local - self.intervals * idx) / self.intervals
        return self.coeffs[self.offsets + idx], tau

    def positions(self, t) -> torch.Tensor:
        """All body positions at time t: (N, 3).  No bounds checking."""
        c, tau = self._segments(t)
        return horner(c, tau)

    def state_vectors(self, t):
        c, tau = self._segments(t)
        pos, dtau = horner_and_deriv(c, tau)
        return pos, dtau / self.intervals[:, None]


# ---------------------------------------------------------------------------
# Generation: step loop with sample recording, then one fitting pass
# ---------------------------------------------------------------------------


class SampleState(NamedTuple):
    ring: torch.Tensor    # (N, DIV, 3) sample ring; slot = sample_idx % 8
    n: int                # global step count


class GenCarry(NamedTuple):
    ms: ELM2Carry | ELM2CarryQ   # ELM2CarryQ under the extended precisions
    samp: SampleState


def _sample_rows(counts, n0: int, L: int) -> np.ndarray:
    """Chunk rows holding a sample of some body (row i = global step n0+i+1)."""
    steps = n0 + 1 + np.arange(L)
    need = np.zeros(L, dtype=bool)
    for cb in set(int(c) for c in counts):
        need |= steps % cb == 0
    return np.nonzero(need)[0]


def _fit_chunk_pass(rec, rows, ring, counts, fit_ms, n0: int, L: int):
    """Sampling + fitting for one chunk of L steps starting after step n0.

    rec: (S, N, 3) positions recorded at chunk rows ``rows`` (host ints,
    sorted; every sample row of every body is among them).  ring: (N, DIV, 3)
    holding each body's <= 8 samples preceding the chunk.  Every index is
    computed on the host from n0, so the pass is a few gathers and one
    broadcast-reduce per group of bodies sharing (count, fit matrix).

    Returns (new_ring, coeffs) with coeffs the (sum n_new, 9, 3) f64
    segments completed in the chunk, body after body in scene order.
    """
    dev = ring.device
    S = rec.shape[0]
    slot = np.full(L, -1, dtype=np.int64)
    slot[rows] = np.arange(S)
    src = torch.cat([rec, ring.transpose(0, 1)])     # ring slot j at row S + j

    def src_rows(k, steps):
        """Rows of `src` holding sample k (global step `steps`)."""
        idx = np.where(steps > n0, slot[np.clip(steps - n0 - 1, 0, L - 1)], S + k % DIV)
        assert (idx >= 0).all(), "a sample row was not recorded"
        return idx

    groups: dict[tuple, list[int]] = {}
    for b, cb in enumerate(counts):
        groups.setdefault((int(cb), fit_ms[b].tobytes()), []).append(b)

    pieces: list = [None] * len(counts)
    new_ring = ring.clone()
    for (cb, _), bodies in groups.items():
        g = _to_device(np.asarray(bodies, dtype=np.int64), dev)
        src_g = src.index_select(1, g)                # (S + DIV, |G|, 3)
        m0 = (n0 // cb) // DIV
        nn = ((n0 + L) // cb) // DIV - m0              # segments completed
        if nn > 0:
            k = DIV * m0 + np.arange(DIV * nn + 1)    # sample indices
            idx = src_rows(k, k * cb)
            win = np.arange(nn)[:, None] * DIV + np.arange(DIV + 1)[None, :]
            seg = src_g.index_select(0, _to_device(idx[win].reshape(-1), dev))
            seg = seg.reshape(nn, DIV + 1, len(bodies), 3)
            m_g = _to_device(fit_ms[bodies[0]], dev)   # (9, 9)
            coeffs = (m_g[None, :, :, None, None] * seg[:, None]).sum(2)  # (nn, 9, |G|, 3)
            for gi, b in enumerate(bodies):
                pieces[b] = coeffs[:, :, gi]
        else:
            for b in bodies:
                pieces[b] = rec.new_zeros((0, MAX_COEFFS, 3))

        # ring update: per slot j, the latest sample k with k % 8 == j inside
        # this chunk, else the old entry
        k_max = (n0 + L) // cb
        js = np.arange(DIV)
        ks = k_max - ((k_max - js) % DIV)
        steps_r = ks * cb
        fresh = (steps_r > n0) & (ks >= 0)
        ridx = np.where(fresh, src_rows(ks, steps_r), S + js)
        new_ring[g] = src_g.index_select(0, _to_device(ridx, dev)).transpose(0, 1)
    return new_ring, torch.cat(pieces)


@dataclass(frozen=True)
class GenSpec:
    """Static per-generation configuration."""

    method: str                      # "QuinlanTremaine12" | "Stormer13" | ...
    h: float                         # signed step (seconds); negative = backward
    counts: tuple[int, ...]          # per-body sample stride in steps
    degrees: tuple[int, ...]
    precise_sums: bool = False       # pair-precision beta sums (extended modes)

    @property
    def backward(self) -> bool:
        return self.h < 0


def _use_fused_f(n_bodies: int, device: torch.device) -> bool:
    """Route a chunk through the fused two-float step (kernels 1 and 2)?

    The threshold is the JAX package's gate (``N*3 >= 4096`` on its
    accelerator), taken over as it is: where the fused and the native-f64
    steps cross over on a GPU has not been measured.  The gate also switches
    precision: the fused branch carries two-float state (~2^-48 relative),
    the other native f64.
    """
    return n_bodies * 3 >= 4096 and device.type == "cuda"


def _use_gen_kernel(n_bodies: int, device: torch.device) -> bool:
    """Route a chunk through the whole-chunk generation kernel (kernel 11,
    :func:`.ops.cuda_gen.elm2_gen_scan`)?

    Off, as the JAX package's ``gen_kernel = False`` is: taking it would
    switch ``"f64"`` generation from native f64 to two-float state, a
    decision that waits for accuracy numbers.  Tests reach the branch by
    patching this gate.
    """
    return False


EXTENDED = ("extended", "extended3")


def _chunk_fn(spec: GenSpec, precision: str, n_scan: int, startup: bool):
    """The generation chunk for a static config: ``n_scan`` multistep steps
    (after the ORDER startup steps when ``startup``), then the fit pass.

    Returns ``chunk(mu, carry, init_y, init_dy, init_limbs, t0, n0) ->
    (GenCarry, coeffs)``.  The JAX package caches one compiled chunk per
    shape; eager torch has nothing to cache.
    """
    tab = get_method(spec.method)
    h = spec.h
    counts = spec.counts
    fit_ms = fit_matrices(spec.degrees, backward=spec.backward)
    extended = precision in EXTENDED

    def chunk(mu, carry: GenCarry | None, init_y, init_dy, init_limbs, t0: float, n0: int):
        def accel(t, y):
            return nbody.pairwise_accel(y, mu)

        accel_limbs = None
        if precision == "extended3":
            mu_hi, mu_lo = cuda_nbody.split_f64(mu.reshape(1, -1))

            def accel_limbs(t, limbs):
                return cuda_limbs.pairwise_accel_limbs(limbs[0], limbs[1], limbs[2], mu_hi, mu_lo)

        L = n_scan + (tab.order if startup else 0)
        rows = _sample_rows(counts, n0, L)
        need = np.zeros(L, dtype=bool)
        need[rows] = True
        rec: list[torch.Tensor] = []

        if startup:
            ring0 = torch.zeros((len(counts), DIV, 3), dtype=torch.float64, device=mu.device)
            ring0[:, 0] = init_y  # sample k=0 = initial position
            samp = SampleState(ring=ring0, n=0)
            if extended:
                # limb-aware startup from the exact host-split initial limbs
                ms = elm2_init_q(tab, accel, t0, init_y, init_dy, h,
                                 accel_limbs=accel_limbs, y0_limbs=init_limbs)
                ys_fwd = ex.to_f64(tuple(l.flip(0) for l in ms.ys))
            else:
                t, dy, ys_fwd, ddys_fwd = elm2_startup_scan(tab, accel, t0, init_y, init_dy, h)
                ms = ELM2Carry(t=t, ys=ys_fwd.flip(0), ddys=ddys_fwd.flip(0), dy=dy)
            rec += [ys_fwd[i] for i in range(tab.order) if need[i]]
            row = tab.order
        else:
            ms, samp = carry
            row = 0

        if extended:
            for _ in range(n_scan):
                ms = elm2_step_q(tab, accel, h, ms, accel_limbs=accel_limbs,
                                 with_velocity=False, precise_sums=spec.precise_sums)
                if need[row]:
                    rec.append(ex.to_f64(tuple(l[0] for l in ms.ys)))
                row += 1
        elif n_scan > 0 and _use_gen_kernel(len(counts), mu.device):
            mu_hi, mu_lo = cuda_nbody.split_f64(mu.reshape(1, -1))
            scan_ys, ms = cuda_gen.elm2_gen_scan(tab, h, ms, TwoFloat(mu_hi, mu_lo), n_scan)
            rec += [scan_ys[i] for i in np.flatnonzero(need[row:row + n_scan])]
            row += n_scan
        elif n_scan > 0 and _use_fused_f(len(counts), mu.device):
            mu_hi, mu_lo = cuda_nbody.split_f64(mu.reshape(1, -1))

            def accel_pair(t, y: TwoFloat) -> TwoFloat:
                return TwoFloat(*cuda_nbody.pairwise_accel_df64(
                    y.hi.t().contiguous(), y.lo.t().contiguous(), mu_hi, mu_lo
                ))

            msf = elm2_f_from(ms)
            for _ in range(n_scan):
                msf = elm2_step_f(tab, accel_pair, h, msf)
                if need[row]:
                    rec.append(msf.ys.hi[0].to(torch.float64) + msf.ys.lo[0].to(torch.float64))
                row += 1
            ms = elm2_f_to(msf)
        else:
            for _ in range(n_scan):
                ms = elm2_step(tab, accel, h, ms, with_velocity=False)
                if need[row]:
                    rec.append(ms.ys[0])  # a view: keeps that ring alive, costs no launch
                row += 1
        if n_scan > 0:
            # the force is velocity-independent: the Cowell velocity is
            # restored once per chunk
            if extended:
                ms = ms._replace(dy=elm2_velocity_q(tab, ms, h, precise_sums=spec.precise_sums))
            else:
                ms = ms._replace(dy=elm2_velocity(tab, ms, h))

        rec_t = torch.stack(rec) if rec else samp.ring.new_zeros((0, len(counts), 3))
        ring, coeffs = _fit_chunk_pass(rec_t, rows, samp.ring, counts, fit_ms, n0, L)
        return GenCarry(ms=ms, samp=SampleState(ring=ring, n=samp.n + L)), coeffs

    return chunk


class NBodyPropagator:
    """Incremental fixed-step N-body propagation emitting fitted segments.

    Call :meth:`step_chunk` repeatedly; each call advances ``n_steps``
    integration steps on ``device`` and returns the per-body polynomial
    segments completed during the chunk.
    """

    def __init__(
        self,
        state: SolarSystemState,
        settings: EphemeridesSettings,
        direction: int = +1,
        method: str = "QuinlanTremaine12",
        precision: str = "auto",
        perturbations: tuple = (),
        precise_sums: bool | None = None,
        device=None,
    ):
        """precision: "f64" (native IEEE f64 on CPU and on CUDA), "extended"
        (4-limb f32 expansion position state, force in f64), "extended3"
        (expansion state + the 3-limb force, kernel 3 on CUDA), or "auto"
        (= "f64", as the JAX package resolves it off the TPU).

        precise_sums: pair-precision beta sums in the multistep update
        (multistep._wsum_precise).  None = on for the extended precisions,
        off for "f64" (where, as in the JAX package, it changes nothing).

        device: where the chunks run; None = the card (raises without CUDA,
        :func:`._device.resolve`), ``"cpu"`` for the CPU.

        "extendedF" and perturbations wait for ROADMAP.md queue 1, item 8."""
        names = [b.name for b in state.bodies]
        missing = [n for n in names if n not in settings.settings]
        if missing:
            raise KeyError(f"missing interpolation parameters for {missing}")
        if precision == "auto":
            precision = "f64"
        if precision == "extendedF":
            raise NotImplementedError(
                "precision='extendedF' (the tf96 force) is not ported yet "
                "(ROADMAP.md queue 1, item 8: precision ladder)"
            )
        if precision not in ("f64", *EXTENDED):
            raise ValueError(precision)
        if perturbations:
            raise NotImplementedError(
                "perturbations are not ported yet "
                "(ROADMAP.md queue 1, item 8: precision ladder)"
            )
        if precise_sums is None:
            precise_sums = precision in EXTENDED
        self.precision = precision
        self.device = _device.resolve(device)
        self.spec = GenSpec(
            method=method,
            h=float(np.copysign(settings.dt.as_seconds(), direction)),
            counts=tuple(settings.settings[n].count for n in names),
            degrees=tuple(settings.settings[n].degree for n in names),
            precise_sums=bool(precise_sums),
        )
        self.names = names
        self.mus = state.mus()
        self.dt_s = settings.dt.as_seconds()
        self.t0_s = state.epoch.as_offset_seconds()
        self._tab = get_method(method)
        self._carry: GenCarry | None = None
        self._n_steps_done = 0

        def dev(a):
            return torch.as_tensor(np.asarray(a, np.float64), device=self.device)

        self._mu_dev = dev(self.mus)
        self._init_state = (dev(state.positions()), dev(state.velocities()))
        # the exact host-side limb split of the initial positions, which the
        # extended precisions start from (ops.expansion.from_f64_host)
        self._init_limbs = ex.from_f64_host(state.positions(), self.device)

    @property
    def steps_done(self) -> int:
        return self._n_steps_done

    def time(self) -> Epoch:
        return Epoch.from_offset_seconds(self.t0_s + self.spec.h * self._n_steps_done)

    def _segments_done(self, n_steps: int) -> np.ndarray:
        c = np.array(self.spec.counts, dtype=np.int64)
        return (n_steps // c) // DIV

    def step_chunk_async(self, n_steps: int):
        """Queue `n_steps` steps on the device; return a zero-arg fetcher for
        the per-body coefficients (the one host sync of the chunk).

        The caller can queue the NEXT chunk before invoking this chunk's
        fetcher, so the copy of the fitted block overlaps integration.
        """
        startup = self._carry is None
        tab = self._tab
        n_scan = n_steps - (tab.order if startup else 0)
        if n_scan < 0:
            raise ValueError(f"first chunk must cover at least {tab.order} steps")

        n0 = self._n_steps_done
        n_new = self._segments_done(n0 + n_steps) - self._segments_done(n0)
        offs = np.concatenate([[0], np.cumsum(n_new)])

        init_y, init_dy = self._init_state
        carry, coeffs = _chunk_fn(self.spec, self.precision, n_scan, startup)(
            self._mu_dev, self._carry, init_y, init_dy, self._init_limbs, self.t0_s, n0
        )
        self._carry = carry
        self._n_steps_done += n_steps
        names = self.names

        def fetch() -> dict[str, np.ndarray]:
            out_np = coeffs.cpu().numpy()
            return {name: out_np[offs[i] : offs[i + 1]] for i, name in enumerate(names)}

        return fetch

    def step_chunk(self, n_steps: int) -> dict[str, np.ndarray]:
        """Advance `n_steps` steps; return dict name -> (n_new, 9, 3) coeffs."""
        return self.step_chunk_async(n_steps)()

    def segment_epochs(self, name: str, first_seg: int, n_seg: int):
        """(start_s, interval_s) of segments [first_seg, first_seg + n_seg)."""
        i = self.names.index(name)
        interval = self.dt_s * self.spec.counts[i] * DIV
        if not self.spec.backward:
            start = self.t0_s + interval * first_seg
        else:
            start = self.t0_s - interval * (first_seg + n_seg)
        return start, interval


def generate_ephemeris(
    state: SolarSystemState,
    settings: EphemeridesSettings,
    span: Duration,
    direction: int = +1,
    method: str = "QuinlanTremaine12",
    chunk_steps: int | None = None,
    precision: str = "auto",
    perturbations: tuple = (),
    precise_sums: bool | None = None,
    device=None,
) -> Ephemeris:
    """Generate a full system ephemeris over `span` (one direction) on
    ``device`` (None = the card; ``"cpu"`` for the CPU) (load/mod.rs:673-687):
    fixed-step integration with per-body sampling/fitting, assembled into
    UniformSpline-equivalent containers."""
    prop = NBodyPropagator(
        state, settings, direction=direction, method=method,
        precision=precision, perturbations=perturbations,
        precise_sums=precise_sums, device=device,
    )
    n_steps = int(round(abs(span.as_seconds()) / prop.dt_s))
    chunk = chunk_steps or min(n_steps, CHUNK_STEPS)

    names = prop.names
    parts: dict[str, list[np.ndarray]] = {n: [] for n in names}
    done = 0
    pending = None
    while done < n_steps:
        this = min(chunk, n_steps - done)
        if chunk_steps is None and this < chunk:
            this = bucket_tail(this, chunk)
        # queue chunk k+1 BEFORE fetching chunk k's coefficients
        fetch = prop.step_chunk_async(this)
        if pending is not None:
            res = pending()
            for n in names:
                parts[n].append(res[n])
        pending = fetch
        done += this
    if pending is not None:
        res = pending()
        for n in names:
            parts[n].append(res[n])

    bodies = {}
    for n in names:
        coeffs = np.concatenate(parts[n]) if parts[n] else np.zeros((0, MAX_COEFFS, 3))
        if prop.spec.backward:
            # backward generation produces segments newest-first
            coeffs = coeffs[::-1]
        start, interval = prop.segment_epochs(n, 0, coeffs.shape[0])
        bodies[n] = BodyEphemeris(start_s=start, interval_s=interval, coeffs=coeffs)
    return Ephemeris(names=names, mus=prop.mus, bodies=bodies)


def merge_bidirectional(forward: Ephemeris, backward: Ephemeris) -> Ephemeris:
    """Combine forward + backward ephemerides into one span (prepend merge,
    celestial.rs:216-235)."""
    bodies = {}
    for n in forward.names:
        f, b = forward.bodies[n], backward.bodies[n]
        merged = BodyEphemeris(start_s=f.start_s, interval_s=f.interval_s, coeffs=f.coeffs)
        if b.segment_count:
            merged.prepend(b)
        bodies[n] = merged
    return Ephemeris(names=forward.names, mus=forward.mus, bodies=bodies)
