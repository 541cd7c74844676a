"""The entry ``ensemble_scan``: ``parallel.sharding.make_fused_ensemble_scan``
stepping an ensemble of clusters, judged against the plain QT12 reference.

An entry builds the program's state in ``setup`` (set-up, warmed on the
cell's own shapes), serves one request in ``request`` (what the window
times), and after the window hands the program's outputs and the same
inputs to the plain reference in ``judge``.
"""

from __future__ import annotations

import time

import torch

from harness import roofline
from harness import traffic as gen
from harness.checks import Q99, Check, com_dev, disp_dev, each_dev, rel_dev
from harness.device import sync
from reference import nbody as ref_nbody


class Entry:
    """``parallel.sharding.make_fused_ensemble_scan``: a closed loop of
    scans of ``steps_per_request`` QT12 steps of the whole ensemble, one
    synchronisation a scan."""

    def __init__(self, cell: dict, seed: int, device: torch.device):
        self.cell, self.seed, self.device = cell, seed, device
        self.cfg, self.tr = cell["config"], cell["traffic"]
        self.members = int(self.tr["members"])
        self.steps = int(self.tr["steps_per_request"])
        self.h = float(self.cfg["h_s"])
        # scans the check follows: one drawn from the seed among the first
        # 16, and the last of the window
        self.sampled = gen.sample(seed, 1, 1, 0, 16)[0]
        n = int(self.cfg["bodies"])
        self.step_ops = (roofline.accel_ensemble(self.members, n)[0]
                         + roofline.elm2_update(ref_nbody.C_Y, ref_nbody.C_DY,
                                                self.members * n * 3)[0])
        self.kept: dict[int, tuple] = {}

    def setup(self) -> None:
        from ephemeris_explorer_tpu_torch.integrators import get
        from ephemeris_explorer_tpu_torch.parallel import sharding

        self.pos, self.vel, self.mu = gen.cluster(self.cfg, self.members, self.seed, self.device)
        tab = get(self.cfg["method"])
        self.carry0 = sharding.init_fused_ensemble_carry(tab, self.mu, 0.0, self.pos, self.vel,
                                                         self.h, device=self.device)
        self.run = sharding.make_fused_ensemble_scan(tab, self.mu, self.h, self.steps,
                                                     device=self.device)
        self.carry = self.run(self.carry0)           # the warm scan
        sync(self.device)

    def request(self, i: int) -> dict:
        prev = self.carry
        t0 = time.perf_counter()
        self.carry = self.run(prev)
        sync(self.device)
        wall = time.perf_counter() - t0
        if i == self.sampled:
            self.kept[i] = (prev, self.carry)
        self.last = (i, prev, self.carry)
        return {"wall_s": wall, "work": float(self.members * self.pos.shape[1] * self.steps),
                "ops": self.steps * self.step_ops, "steps": self.steps, "failed": False}

    def sizes(self) -> dict:
        return {"members": self.members, "bodies": int(self.pos.shape[1]),
                "steps_per_request": self.steps, "c_y": ref_nbody.C_Y, "c_dy": ref_nbody.C_DY}

    def close(self) -> None:
        """Free what the check does not judge."""
        i, prev, after = self.last
        self.kept[i] = (prev, after)
        self.carry = self.run = self.last = None

    def judge(self, control: bool = False) -> list[Check]:
        """What the window's path produced, against the reference.

        ``start_dev``: the startup of two members drawn from the seed, from
        the inputs (the force kernel and the startup, 289 evaluations).
        For each kept scan, followed from the program's rings at its start
        (the cluster is chaotic: two f64 runs part after a few thousand
        steps, so the window's whole path has no reference): ``force_dev``,
        every ring row's force against the reference's at the program's own
        positions, every body; ``scan_com``, each member's mu-weighted
        centre after the scan (the update's position terms, and momentum);
        ``scan_dev``, the median body after the scan (the update's force
        terms).  Only a median is steady there: a near-collision of this
        unsoftened cluster in a scan parts two f64 runs of it far at the
        99th percentile (see PERF.md).  With ``control`` the reference in
        f32 stands in the program's place."""
        ms = gen.sample(self.seed, 2, 2, 0, self.members)
        pos, vel = self.pos[ms], self.vel[ms]
        ys, ddys, _ = ref_nbody.startup(pos, vel, self.mu, self.h)
        if control:
            f32 = [x.float() for x in (pos, vel, self.mu)]
            got_ys, got_ddys, _ = ref_nbody.startup(*f32, self.h)
        else:
            got_ys, got_ddys = self.carry0.ys[:, ms], self.carry0.ddys[:, ms]
        start = max(disp_dev(got_ys, ys, pos, Q99), rel_dev(got_ddys, ddys, Q99))
        force = com = scan = 0.0
        for prev, after in self.kept.values():
            ys, ddys = self._scan(prev.ys, prev.ddys, self.mu)
            vel = ref_nbody.velocity(ys, ddys, self.h)
            if control:
                got_ys, got_ddys = self._scan(prev.ys.float(), prev.ddys.float(), self.mu.float())
                got_v = ref_nbody.velocity(got_ys, got_ddys, self.h)
            else:
                got_ys, got_ddys, got_v = after.ys, after.ddys, after.dy
            at_got = torch.stack([ref_nbody.accel(y.double(), self.mu) for y in got_ys])
            force = max(force, each_dev(got_ddys, at_got))
            com = max(com, com_dev(got_ys[0], ys[0], prev.ys[0], self.mu))
            scan = max(scan, disp_dev(got_ys[0], ys[0], prev.ys[0]), rel_dev(got_v, vel))
        lim = self.cell["limits"]
        return [Check("start_dev", start, lim["start_dev"]),
                Check("force_dev", force, lim["force_dev"]),
                Check("scan_com", com, lim["scan_com"]),
                Check("scan_dev", scan, lim["scan_dev"])]

    def _scan(self, ys, ddys, mu):
        for _ in range(self.steps):
            ys, ddys = ref_nbody.step(ys, ddys, mu, self.h)
        return ys, ddys
