"""Scale-out: device meshes, the row decomposition of the pair force, ensembles.

Port of ``ephemeris_explorer_tpu.parallel.sharding``.  Its scaling axes:

* N (bodies): the O(N^2) pair interaction is sharded by receiver rows over
  the mesh dimension "model".  Each rank all-gathers the source positions
  (one ``torch.distributed.all_gather`` per force over
  ``mesh.get_group("model")``) and computes its local rows with the rows
  forms of the pair kernels: kernel 1's (:func:`make_rowsharded_scan_f`),
  kernel 3's (:func:`make_rowsharded_scan_qf`), kernels 7 and 8's
  (:func:`make_rowsharded_split_force`).  The update kernels (2 and 4) are
  elementwise over rows and run rank-local with no collective.
* E (ensemble): independent initial conditions, split over "data" with no
  collective in the loop (:func:`make_shardmap_ensemble_scan_f`); on one
  card, the whole ensemble runs through kernel 1's ensemble form
  (:func:`make_fused_ensemble_scan_f`, and on the packed carry
  :func:`make_fused_ensemble_scan_fp`).
* time: sequential.  The JAX package's ``lax.scan`` programs become Python
  step loops with the time a host float, as in ``integrators.multistep``.

Shard convention: a sharded argument or result is this rank's local shard.
Row shards are equal, NL rows each, and the rank with "model" coordinate r
holds global rows r*NL .. (r+1)*NL - 1 (``mesh.get_local_rank("model") *
NL``, a host int).  Ensemble shards hold the members of their "data"
coordinate alike.  ``jax.shard_map`` has no counterpart: every rank runs
these functions on its own shard, and the collectives are explicit.  The
rows forms sum every receiver as the square kernels do, so the row-sharded
scans equal the unsharded ones bitwise.

The entry points run on the card unless the caller asks for the CPU:
``make_mesh`` and the ``make_*``/``init_*`` functions without a mesh take
``device=None`` (the card; raises without CUDA); with a mesh, the mesh's
device type decides.  The caller starts the default process group (NCCL on
CUDA, gloo on the CPU) before :func:`make_mesh`.

Not ported (ROADMAP.md, item 10): ``make_sharded_fleet_propagator``
(spacecraft, item 6) and the vmapped GSPMD
layout (``carry_sharding``, ``make_sharded_ensemble_step``/``_scan``,
``init_ensemble_carry``), whose collectives XLA inserts.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from .. import _device
from ..integrators.multistep import (
    ELM2Carry, ELM2CarryF, ELM2CarryFP, ELM2CarryQF, elm2_f_from, elm2_fp_from, elm2_init,
    elm2_qf_from_q, elm2_step, elm2_step_f, elm2_step_fp, elm2_step_qf, elm2_velocity,
    elm2_velocity_f, elm2_velocity_fp, elm2_velocity_qf,
)
from ..ops import nbody
from ..ops.cuda_limbs import pairwise_accel_limbs_pair_rows
from ..ops.cuda_nbody import (
    pairwise_accel_df64_ensemble, pairwise_accel_df64_rows, pairwise_accel_ensemble, split_f64,
)
from ..ops.cuda_split import pairwise_accel_split_rows
from ..ops.eft import TwoFloat
from ..ops.split import strong_pair_indices_rows, strong_pair_mask_rows

F64 = torch.float64


def make_mesh(data: int = 1, model: int = 1, device=None):
    """A ``DeviceMesh`` of shape (data, model) with dims ("data", "model")
    over the default process group, which the caller has started and which
    must hold exactly data * model ranks.  ``device=None`` is the card."""
    from torch.distributed.device_mesh import DeviceMesh

    device = _device.resolve(device)
    if not dist.is_initialized():
        raise RuntimeError("start the default process group first "
                           "(torch.distributed.init_process_group)")
    n = data * model
    world = dist.get_world_size()
    assert world == n, f"a ({data}, {model}) mesh needs {n} ranks, the group has {world}"
    return DeviceMesh(device.type, torch.arange(n).reshape(data, model),
                      mesh_dim_names=("data", "model"))


def _mesh_device(mesh) -> torch.device:
    return torch.device(mesh.device_type)


def _row0(mesh, nl: int) -> int:
    """Global index of this rank's first row (host int)."""
    return mesh.get_local_rank("model") * nl


def _gather_rows(mesh, *xs):
    """All of "model"'s rows of each (NL, ...) tensor in ``xs`` (all of one
    shape and dtype), concatenated in rank order: one all_gather."""
    group = mesh.get_group("model")
    local = torch.stack(xs)
    parts = [torch.empty_like(local) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, local, group=group)
    return torch.cat(parts, dim=1).unbind(0)


# ---------------------------------------------------------------------------
# The row decomposition (N over "model")
# ---------------------------------------------------------------------------


def pairwise_accel_rowsharded(mesh, pos, mu):
    """O(N^2) f64 acceleration with bodies sharded over "model": pos (NL, 3)
    and mu (NL,) this rank's rows; returns its (NL, 3) rows.  The plain f64
    decomposition (ref :42): all-gather the sources, mask the self pair by
    global row index."""
    n_local = pos.shape[0]
    (both,) = _gather_rows(mesh, torch.cat([pos, mu[:, None]], dim=1))
    pos_all, mu_all = both[:, :3], both[:, 3]
    d = pos_all[None, :, :] - pos[:, None, :]
    r2 = (d * d).sum(-1)
    rows = _row0(mesh, n_local) + torch.arange(n_local, device=pos.device)
    self_mask = rows[:, None] == torch.arange(pos_all.shape[0], device=pos.device)[None, :]
    r2 = torch.where(self_mask, torch.ones_like(r2), r2)
    inv_r = torch.rsqrt(r2)
    inv_r3 = torch.where(self_mask, torch.zeros_like(r2), inv_r * inv_r * inv_r)
    return torch.einsum("ij,ijc->ic", mu_all[None, :] * inv_r3, d)


def pairwise_accel_rowsharded_pair(mesh, pos_hi, pos_lo, mu_hi, mu_lo):
    """Row-sharded two-float force through kernel 1's rows form.

    pos_hi/pos_lo: (NL, 3) f32 split positions, this rank's rows.
    mu_hi/mu_lo:   (1, N) f32 split mu, replicated.
    Returns (acc_hi, acc_lo), this rank's (NL, 3) rows, equal bitwise to
    those rows of the unsharded :func:`..ops.cuda_nbody.pairwise_accel_df64`.
    """
    hi_all, lo_all = _gather_rows(mesh, pos_hi, pos_lo)
    return pairwise_accel_df64_rows(hi_all.t().contiguous(), lo_all.t().contiguous(), mu_hi,
                                    mu_lo, pos_hi, pos_lo, _row0(mesh, pos_hi.shape[0]))


def _split_mu(mus, device):
    return split_f64(torch.as_tensor(mus, dtype=F64, device=device).reshape(1, -1))


def make_rowsharded_scan_f(mesh, tab, mus, h, n_steps: int):
    """N-axis fused scan: the ELM2CarryF rings row-sharded over "model", the
    force through one all-gather and kernel 1's rows form, the update
    (kernel 2) rank-local.  Returns (run, to_f): feed ``run`` this rank's
    rows of ``to_f(elm2_init(...))``; it runs ``n_steps`` steps and
    restores the velocity at the end."""
    mu_hi, mu_lo = _split_mu(mus, _mesh_device(mesh))

    def accel_pair(t, y: TwoFloat) -> TwoFloat:  # y: (NL, 3) local rows
        return TwoFloat(*pairwise_accel_rowsharded_pair(mesh, y.hi, y.lo, mu_hi, mu_lo))

    def run(carry: ELM2CarryF) -> ELM2CarryF:
        for _ in range(n_steps):
            carry = elm2_step_f(tab, accel_pair, h, carry)
        return carry._replace(dy=elm2_velocity_f(tab, carry, h))

    return run, elm2_f_from


def make_rowsharded_scan_qf(mesh, tab, mus, h, n_steps: int, precise_sums: bool = False):
    """Row-sharded expansion engine: the 4-limb rings sharded over "model",
    the force through one all-gather of the three leading limbs and kernel
    3's rows form, the update (kernel 4, ``precise_sums`` selecting its
    mode) rank-local.  Returns (run, to_qf): feed ``run`` this rank's rows
    of ``to_qf(elm2_init_q(...))``."""
    mu_hi, mu_lo = _split_mu(mus, _mesh_device(mesh))

    def accel_pair(t, limbs):  # (l0, l1, l2) local rows (NL, 3)
        src = [x.t().contiguous() for x in _gather_rows(mesh, *limbs)]
        return pairwise_accel_limbs_pair_rows(*src, mu_hi, mu_lo, *limbs,
                                              _row0(mesh, limbs[0].shape[0]))

    def run(carry: ELM2CarryQF) -> ELM2CarryQF:
        for _ in range(n_steps):
            carry = elm2_step_qf(tab, accel_pair, h, carry, precise_sums=precise_sums)
        return carry._replace(dy=elm2_velocity_qf(tab, carry, h))

    return run, elm2_qf_from_q


def make_rowsharded_split_force(mesh, mus, k: int = 16):
    """Row-sharded magnitude-split force: returns ``(refresh, force)``.

    * ``refresh(pos)``: the per-chunk strong-set refresh from this rank's
      (NL, 3) f64 rows: all-gather the positions, the local top-k and the
      exclusion table with the GLOBAL self diagonal -> (idx, mask), this
      rank's rows.
    * ``force(pos, idx, mask)``: the per-step acceleration: all-gather and
      :func:`..ops.cuda_split.pairwise_accel_split_rows` (kernel 7's rows
      form and kernel 8 on the local receivers) -> (NL, 3) f64.

    Both equal the unsharded ``strong_pair_indices`` / ``strong_pair_mask``
    / ``pairwise_accel_split`` rows bitwise: every piece is per receiver
    row, with the square form's column order.
    """
    mu_dev = torch.as_tensor(mus, dtype=F64, device=_mesh_device(mesh))

    def refresh(pos_l):
        (pos_all,) = _gather_rows(mesh, pos_l)
        row0 = _row0(mesh, pos_l.shape[0])
        idx = strong_pair_indices_rows(pos_all, pos_l, mu_dev, row0, k=k)
        return idx, strong_pair_mask_rows(idx, pos_all.shape[0], row0)

    def force(pos_l, idx_l, mask_l):
        (pos_all,) = _gather_rows(mesh, pos_l)
        return pairwise_accel_split_rows(pos_all, pos_l, mu_dev, idx_l, mask_l)

    return refresh, force


# ---------------------------------------------------------------------------
# Ensembles (E), the ensemble axis kept inside the carry
# ---------------------------------------------------------------------------
#
# elm2_step is shape-generic (its weighted sums reduce the leading ORDER
# axis, everything else is elementwise), so the carry keeps the ensemble
# axis inside: ys/ddys are (ORDER, E, N, 3), dy is (E, N, 3), one shared t.


def _fused_ensemble_accel(mus, device: torch.device):
    """Force on an (E, N, 3) f64 batch.  On CUDA the accelerator branch:
    kernel 1's ensemble form, f64 in and out (``pairwise_accel_ensemble``),
    as generation's fused branch takes kernel 1 (``_use_fused_f``).  On the
    CPU the plain native-f64 force member by member (ref :505-516, which
    takes its Pallas kernel on the TPU and vmapped jnp elsewhere)."""
    mu_dev = torch.as_tensor(mus, dtype=F64, device=device)
    if device.type == "cuda":
        mu_hi, mu_lo = split_f64(mu_dev.reshape(1, -1))
        return lambda t, y: pairwise_accel_ensemble(y, mu_hi, mu_lo)
    return lambda t, y: torch.stack([nbody.pairwise_accel(m, mu_dev) for m in y.unbind(0)])


def init_fused_ensemble_carry(tab, mus, t0, pos, vel, h, device=None) -> ELM2Carry:
    """Startup for the ensemble layout: pos/vel (E, N, 3) -> ys (ORDER, E, N,
    3), with :func:`_fused_ensemble_accel`'s force.  ``device=None`` is the
    card."""
    device = _device.resolve(device)
    accel = _fused_ensemble_accel(mus, device)
    return elm2_init(tab, accel, t0, torch.as_tensor(pos, dtype=F64, device=device),
                     torch.as_tensor(vel, dtype=F64, device=device), h)


def make_fused_ensemble_scan(tab, mus, h, n_steps: int, device=None):
    """``n_steps`` QT12 steps of the whole ensemble on the f64 carry, the
    force :func:`_fused_ensemble_accel`'s.  The velocity is left out of the
    loop (Newtonian forces never read it) and restored once per call.
    Returns ``run(carry) -> carry``.  ``device=None`` is the card."""
    accel = _fused_ensemble_accel(mus, _device.resolve(device))

    def run(carry: ELM2Carry) -> ELM2Carry:
        for _ in range(n_steps):
            carry = elm2_step(tab, accel, h, carry, with_velocity=False)
        return carry._replace(dy=elm2_velocity(tab, carry, h))

    return run


def make_fused_ensemble_scan_f(tab, mus, h, n_steps: int, device=None):
    """Pair-native ensemble stepping: kernel 1's ensemble form for the force
    of all members in one launch, kernel 2 for the update of the
    (ORDER, E, N, 3) pair rings.  Returns (run, to_f), where to_f converts
    an :func:`init_fused_ensemble_carry` carry.  Member e equals the
    single-system fused step (``elm2_step_f`` with kernel 1's square form)
    on member e bitwise.  ``device=None`` is the card."""
    accel_pair = _ensemble_accel_pair(mus, _device.resolve(device))

    def run(carry: ELM2CarryF) -> ELM2CarryF:
        for _ in range(n_steps):
            carry = elm2_step_f(tab, accel_pair, h, carry)
        return carry._replace(dy=elm2_velocity_f(tab, carry, h))

    return run, elm2_f_from


def _ensemble_accel_pair(mus, device: torch.device):
    """The pair force of an (E, N, 3) TwoFloat batch through kernel 1's
    ensemble form, all members in one launch."""
    mu_hi, mu_lo = _split_mu(mus, device)

    def accel_pair(t, y: TwoFloat) -> TwoFloat:
        return TwoFloat(*pairwise_accel_df64_ensemble(
            y.hi.transpose(1, 2).contiguous(), y.lo.transpose(1, 2).contiguous(), mu_hi, mu_lo))

    return accel_pair


def make_fused_ensemble_scan_fp(tab, mus, h, n_steps: int, shape: tuple, device=None):
    """The pair-native ensemble scan on the packed carry (ref :544-582):
    :func:`make_fused_ensemble_scan_f` with the rings stored (ORDER, SUB,
    E*N*3/SUB) across steps and kernel 2 through its packed entry point.
    ``shape`` is the logical (E, N, 3).  Returns (run, to_fp), where to_fp
    converts an :func:`init_fused_ensemble_carry` carry; the rings equal the
    unpacked scan's bitwise.  ``device=None`` is the card."""
    accel_pair = _ensemble_accel_pair(mus, _device.resolve(device))
    shape = tuple(shape)

    def run(carry: ELM2CarryFP) -> ELM2CarryFP:
        for _ in range(n_steps):
            carry = elm2_step_fp(tab, accel_pair, h, carry, shape)
        return carry._replace(dy=elm2_velocity_fp(tab, carry, h, shape))

    return run, lambda c: elm2_fp_from(elm2_f_from(c))


def make_shardmap_ensemble_scan_f(mesh, tab, mus, h, n_steps: int):
    """Ensemble members split over "data", each rank running the
    pair-native ensemble scan (:func:`make_fused_ensemble_scan_f`) on its
    own members: no collective in the loop, the data-parallel serving
    shape.  Returns (run, to_f); feed ``run`` this rank's members of
    ``to_f(init_fused_ensemble_carry(...))`` (ring axis 1, dy axis 0)."""
    return make_fused_ensemble_scan_f(tab, mus, h, n_steps, device=_mesh_device(mesh))
