"""The entry ``ship_flights``: ``spacecraft.propagate_ship`` or
``propagate_ships`` flying edited copies of a scene's ship, judged against
the plain generation, fit and Verner87 flight.

An entry builds the program's state in ``setup`` (set-up, warmed on the
cell's own shapes), serves one request in ``request`` (what the window
times), and after the window hands the program's outputs and the same
inputs to the plain reference in ``judge``.
"""

from __future__ import annotations

import dataclasses
import math
import time

import numpy as np
import torch

from harness import roofline
from harness import traffic as gen
from harness.cells import BENCH
from harness.checks import Check
from reference import ephemeris as ref_eph
from reference import flight as ref_flight
from reference import scene as ref_scene

DAY = 86400.0


class Entry:
    """``spacecraft.propagate_ship`` (one ship a request) or
    ``spacecraft.propagate_ships`` (a batch): a closed loop, one planner,
    each request the scene's ship with some burns scaled by factors drawn
    from the seed, flown over its whole plan."""

    def __init__(self, cell: dict, seed: int, device: torch.device):
        self.cell, self.seed, self.device = cell, seed, device
        self.cfg, self.tr = cell["config"], cell["traffic"]
        self.ships = int(self.tr["ships_per_request"])
        self.scaled = [int(b) for b in self.tr["scaled_burns"]]
        self.max_knots = int(self.tr["max_knots"])
        d = BENCH / self.cfg["dir"]
        self.paths = {k: d / self.cfg[k] for k in ("state", "settings", "ship")}
        self.ref_state = ref_scene.load_state(self.paths["state"])
        self.ref_settings = ref_scene.load_settings(self.paths["settings"],
                                                    self.ref_state["names"])
        self.ref_ship = ref_scene.load_ship(self.paths["ship"])
        end = self.ref_ship["end_s"]
        if "flight_days" in self.cfg:               # a shorter plan, for tests
            end = self.ref_ship["start_s"] + float(self.cfg["flight_days"]) * DAY
        self.end_s = end
        self.step_ops = roofline.ship_step_ops(
            ref_flight.STAGES, sum(1 for row in ref_flight.A for x in row if x != 0.0),
            sum(1 for x in ref_flight.B if x != 0.0), sum(1 for x in ref_flight.E if x != 0.0),
            [int(d) for d in self.ref_settings["degree"]])
        # whole segments of the slowest-sampled body past the plan's end
        seg = float(self.ref_settings["count"].max()) * self.ref_settings["dt_s"] * 8
        span = math.ceil((end - self.ref_state["epoch_s"]) / seg) * seg
        self.n_steps = int(round(span / self.ref_settings["dt_s"]))
        # requests the check follows: two drawn from the seed among the first
        # 8, the flight with the most knots so far, and the last
        self.sampled = set(gen.sample(seed, 3, 2, 0, 8))
        self.kept: dict = {}
        self.longest = (-1, None)
        self.unreached = 0

    def setup(self) -> None:
        from ephemeris_explorer_tpu_torch import Duration, ephemeris, spacecraft
        from ephemeris_explorer_tpu_torch.io import scene

        self.sc = spacecraft
        state = scene.load_state(self.paths["state"])
        settings = scene.load_ephemerides_settings(self.paths["settings"])
        self.template = scene.load_ship(self.paths["ship"])
        span = Duration.from_seconds(self.n_steps * self.ref_settings["dt_s"])
        self.eph = ephemeris.generate_ephemeris(state, settings, span, device=self.device)
        self.request(-1)                              # the warm request
        self.kept.clear()
        self.longest, self.unreached = (-1, None), 0

    def _ships(self, i: int):
        """Request ``i``'s ships (factors 1 for the warm request)."""
        f = (np.ones((self.ships, len(self.scaled))) if i < 0
             else gen.burn_factors(self.tr, self.seed, i))
        until = self.sc.Epoch.from_offset_seconds(self.end_s) if "flight_days" in self.cfg \
            else None
        out = []
        for k in range(self.ships):
            burns = list(self.template.burns)
            for j, b in enumerate(self.scaled):
                burns[b] = dataclasses.replace(burns[b],
                                               acceleration=burns[b].acceleration * f[k, j])
            out.append(dataclasses.replace(self.template, name=f"{self.template.name} {k}",
                                           burns=burns))
        return out, f, until

    def request(self, i: int) -> dict:
        ships, f, until = self._ships(i)
        it0 = self.sc.propagate_batch.iterations
        t0 = time.perf_counter()
        if self.ships == 1:
            trajs = [self.sc.propagate_ship(self.eph, ships[0], until=until,
                                            max_knots=self.max_knots, device=self.device)]
        else:
            out = self.sc.propagate_ships(self.eph, ships, until=until,
                                          max_knots=self.max_knots, device=self.device)
            trajs = [out[s.name] for s in ships]
        wall = time.perf_counter() - t0
        iterations = self.sc.propagate_batch.iterations - it0
        bad = sum(1 for tr in trajs if not self._reached(tr))
        self.unreached += bad
        knots = [len(tr.ts) for tr in trajs]
        if i in self.sampled:
            self.kept[i] = self._pick(i, f, trajs)
        self.last = (i, f, trajs)
        k = int(np.argmax(knots))
        if knots[k] > self.longest[0]:
            self.longest = (knots[k], (f[k:k + 1], [trajs[k]]))
        accepted = sum(knots) - len(knots)
        return {"wall_s": wall, "work": self.ships * (self.end_s - self.ref_ship["start_s"]) / DAY,
                "ops": accepted * self.step_ops, "iterations": iterations,
                "accepted": accepted, "failed": bad > 0}

    def _reached(self, tr) -> bool:
        return (len(tr.ts) > 1 and tr.ts[0] == self.ref_ship["start_s"]
                and bool(np.all(tr.pos[0] == self.ref_ship["pos"]))
                and tr.ts[-1] >= self.end_s - 1.0)

    def sizes(self) -> dict:
        counts = self.ref_settings["count"]
        nseg = (self.n_steps // counts) // 8
        return {"ships": self.ships, "degrees": [int(d) for d in self.ref_settings["degree"]],
                "coeff_bytes": float(nseg.sum() * 9 * 3 * 8)}

    def _pick(self, i: int, f, trajs) -> tuple:
        """The ships of request ``i`` that the check follows: all of a
        one-ship request, four drawn from the seed of a batch."""
        ks = gen.sample(self.seed, 100 + i, 4, 0, len(trajs))
        return f[ks], [trajs[k] for k in ks]

    def close(self) -> None:
        i, f, trajs = self.last
        self.kept[i] = self._pick(i, f, trajs)
        self.kept["longest"] = self.longest[1]
        self.last = None

    def _port_ephemeris(self) -> ref_eph.Ephemeris:
        """The program's ephemeris as the reference reads it (to judge it)."""
        names = self.eph.names
        f64 = torch.float64
        return ref_eph.Ephemeris(
            start=torch.tensor([self.eph.bodies[n].start_s for n in names], dtype=f64),
            interval=torch.tensor([self.eph.bodies[n].interval_s for n in names], dtype=f64),
            coeffs=[torch.from_numpy(np.ascontiguousarray(self.eph.bodies[n].coeffs))
                    for n in names],
            mu=torch.as_tensor(self.ref_state["mu"], dtype=f64))

    def judge(self, control: bool = False) -> list[Check]:
        """The set-up's ephemeris against the reference's own generation at
        4,096 times drawn from the seed (in km); every step of the kept
        flights taken again by the reference, on its own ephemeris, from the
        program's knot before it (the largest gap at the next knot, in units
        of the ship's tolerance; each knot judged, not the flight's whole
        path: a flight that grazes Mars parts from any other f64 flight by
        kilometres); every flight of the window started at the plan's start
        and reached its end; and the step controller: each kept flight's
        accepted steps against the reference's own adaptive flight of its
        plan (``knot_gap``: a controller that accepts steps above the
        tolerance takes fewer).  With ``control`` the reference in f32
        stands in the program's place: its own generation, flights through
        the program's knot times from the plan's start, and its own
        adaptive flights."""
        ref = ref_eph.generate(self.ref_state, self.ref_settings, self.n_steps)
        ev = ref_eph.Evaluator(ref)
        if control:
            got = ref_eph.generate(self.ref_state, self.ref_settings, self.n_steps,
                                   dtype=torch.float32)
        else:
            got = self._port_ephemeris()
        got_ev = ref_eph.Evaluator(got)
        rng = np.random.default_rng([self.seed, 11])
        t = torch.as_tensor(rng.uniform(self.ref_state["epoch_s"], self.end_s, 4096))
        eph_gap = float((got_ev(t).double() - ev(t)).abs().max())
        gap = 0.0
        tol = self.ref_ship["tol"]
        plans, steps = [], []
        for f, trajs in self.kept.values():
            for k, tr in enumerate(trajs):
                if len(tr.ts) < 2:                     # counted in unreached
                    continue
                plan = self._plan(f[k])
                if k == 0:                             # one flight a kept request
                    plans.append(plan)
                    steps.append(len(tr.ts) - 1)
                ts = torch.from_numpy(tr.ts)
                y = torch.from_numpy(np.concatenate([tr.pos, tr.vel], 1))
                if control:
                    y = ref_flight.follow(got_ev, got.mu, plan, ts, y[0].float()).double()
                y_new, _ = ref_flight.step_from(ev, ref.mu, plan, ts[:-1], y[:-1],
                                                ts[1:] - ts[:-1])
                gap = max(gap, float((y_new - y[1:]).abs().max()) / tol)
        if control:
            got, got_done = self._fly(got_ev, got.mu, plans, torch.float32, max(steps))
        else:
            got, got_done = torch.tensor(steps, dtype=torch.float64), True
        want, want_done = self._fly(ev, ref.mu, plans, torch.float64, max(steps))
        # a flight cut at its attempts gives a floor of its gap where it has
        # already taken more steps than the reference's, and no number else
        gaps = torch.where(want_done & (got_done | (got > want)), (got - want).abs() / want,
                           float("inf"))
        knot_gap = float(gaps.max())
        lim = self.cell["limits"]
        return [Check("eph_gap_km", eph_gap, lim["eph_gap_km"]),
                Check("step_gap", gap, lim["step_gap"]),
                Check("knot_gap", knot_gap, lim["knot_gap"]),
                Check("unreached", float(self.unreached), 0.0)]

    def _fly(self, ev, mu, plans, dtype, most: int) -> tuple:
        """(the accepted steps (f64), whether each reached the end) of each
        plan's own adaptive flight from the ship's start, within four times
        the steps of the program's longest kept flight."""
        y0 = torch.as_tensor(np.concatenate([self.ref_ship["pos"], self.ref_ship["vel"]]),
                             dtype=dtype)
        steps, reached = ref_flight.fly(ev, mu.to(dtype), plans, self.ref_ship["start_s"], y0,
                                        self.end_s, self.ref_ship["tol"], 4 * most + 1000)
        return steps.double(), reached

    def _plan(self, factors) -> list[tuple]:
        burns = [dict(b) for b in self.ref_ship["burns"]]
        for j, b in enumerate(self.scaled):
            burns[b]["accel"] = burns[b]["accel"] * factors[j]
        return ref_flight.timeline(burns, self.ref_state["names"])
