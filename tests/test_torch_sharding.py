"""The row decomposition and the data-parallel ensemble over two gloo ranks,
and the rows forms of kernels 1 and 3, against the port's unsharded results
and the JAX package's.

Two CPU processes, spawned once for the module with ``torch.multiprocessing``
and joined by a ``FileStore`` under a temporary directory, run every
sharded path on their rows (or members) of inputs the parent made with
numpy and saved; the parent compares.  The worker lives at module level,
and JAX is imported only inside the test functions, so the children never
import it.  A run that outlives ``JOIN_S`` is terminated and fails the
tests instead of hanging the suite.

Tolerances.  Sharded against the port's unsharded result: bitwise (each
rows form sums a receiver as its square form does), except the plain f64
decomposition (an einsum against a sum, 1e-12 as test_rowsharded_accel
_matches).  Against the JAX package's row-sharded results on its 8-device
virtual mesh (model=2): the scans 2^-40 of max |y|, the bar
test_fused_ensemble_scan_f_matches_plain holds; the pair force 1e-13 of
max |a| (kernel 1's bar); the split force 1e-6 of max |a| (the f32 tails
sum in other orders, test_torch_forcemodes.py).
"""

import time
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from ephemeris_explorer_tpu_torch import ephemeris as eph
from ephemeris_explorer_tpu_torch.integrators import get
from ephemeris_explorer_tpu_torch.integrators import multistep as ms
from ephemeris_explorer_tpu_torch.ops import cuda_limbs, cuda_nbody, cuda_split, nbody, split
from ephemeris_explorer_tpu_torch.ops import expansion as ex
from ephemeris_explorer_tpu_torch.ops.eft import TwoFloat
from ephemeris_explorer_tpu_torch.parallel import sharding as sh

QT12 = "QuinlanTremaine12"
H = 600.0
RANKS = 2
JOIN_S = 120.0
STEPS = 8
SCAN_VS_JAX = 2.0**-40
PAIR_VS_JAX = 1e-13
SPLIT_VS_JAX = 1e-6
SPLIT_K = 6
ENS_STEPS = 10


def _cloud(n, seed, clusters=1):
    rng = np.random.default_rng(seed)
    pos = np.concatenate([rng.normal(size=(n // clusters, 3)) * 1e6 + 3e7 * c
                          for c in range(clusters)])
    return pos, rng.normal(size=(n, 3)), rng.uniform(1e3, 1e5, n)


def _inputs():
    """The seeded inputs of every case (the JAX package's sharding fixtures)."""
    return {"force": _cloud(64, 3), "scan_f": _cloud(32, 5), "scan_qf": _cloud(32, 7),
            "split": _cloud(64, 23, clusters=2), "ensemble": _ensemble(4, 16, 17)}


def _ensemble(e, n, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(e, n, 3)) * 1.0e6, rng.normal(size=(e, n, 3)) * 1.0,
            rng.uniform(1.0e3, 1.0e5, size=n))


def _starts(inp):
    """The unsharded start states, made once in the parent (CPU)."""
    tab = get(QT12)

    def f64_init(pos, vel, mu):
        mu_t = torch.tensor(mu)
        return ms.elm2_init(tab, lambda t, y: nbody.pairwise_accel(y, mu_t), 0.0,
                            torch.tensor(pos), torch.tensor(vel), H)

    def q_init(pos, vel, mu):
        mu_t = torch.tensor(mu)
        return ms.elm2_init_q(tab, lambda t, y: nbody.pairwise_accel(y, mu_t), 0.0,
                              torch.tensor(pos), torch.tensor(vel), H)

    p, v, m = inp["ensemble"]
    return {"scan_f": ms.elm2_f_from(f64_init(*inp["scan_f"])),
            "scan_qf": ms.elm2_qf_from_q(q_init(*inp["scan_qf"])),
            "ensemble": ms.elm2_f_from(sh.init_fused_ensemble_carry(tab, m, 0.0, p, v, H,
                                                                    device="cpu"))}


def _rows(x, rank, axis=0):
    """This rank's equal share of ``x`` along ``axis``."""
    n = x.shape[axis] // RANKS
    return x.narrow(axis, rank * n, n).contiguous()


def _carry_rows(c, rank, axis=1):
    """This rank's share of a carry: rows, or ensemble members, are axis 1
    of the rings and axis 0 of dy."""
    def ring(r):
        if isinstance(r, TwoFloat):
            return TwoFloat(_rows(r.hi, rank, axis), _rows(r.lo, rank, axis))
        return tuple(_rows(x, rank, axis) for x in r)
    return c._replace(ys=ring(c.ys), dd=ring(c.dd), dy=_rows(c.dy, rank, axis - 1))


def _worker(rank: int, store_path: str, out_dir: str) -> None:
    """One gloo rank: every sharded path on its rows, results to a file."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, RANKS), rank=rank,
                            world_size=RANKS)
    try:
        inp = _inputs()
        starts = torch.load(Path(out_dir) / "starts.pt", weights_only=False)
        rows_mesh = sh.make_mesh(1, RANKS, device="cpu")
        data_mesh = sh.make_mesh(RANKS, 1, device="cpu")
        tab = get(QT12)
        out = {}

        pos, _, mu = inp["force"]
        p, m = torch.tensor(pos), torch.tensor(mu)
        out["force_f64"] = sh.pairwise_accel_rowsharded(rows_mesh, _rows(p, rank), _rows(m, rank))
        ph, pl = cuda_nbody.split_f64(_rows(p, rank))
        mh, ml = cuda_nbody.split_f64(m.reshape(1, -1))
        out["force_pair"] = sh.pairwise_accel_rowsharded_pair(rows_mesh, ph, pl, mh, ml)

        run, _ = sh.make_rowsharded_scan_f(rows_mesh, tab, inp["scan_f"][2], H, STEPS)
        out["scan_f"] = run(_carry_rows(starts["scan_f"], rank))
        for precise in (False, True):
            run, _ = sh.make_rowsharded_scan_qf(rows_mesh, tab, inp["scan_qf"][2], H, STEPS,
                                                precise_sums=precise)
            out[f"scan_qf_{precise}"] = run(_carry_rows(starts["scan_qf"], rank))

        pos, _, mu = inp["split"]
        refresh, force = sh.make_rowsharded_split_force(rows_mesh, mu, k=SPLIT_K)
        p_l = _rows(torch.tensor(pos), rank)
        idx, mask = refresh(p_l)
        out["split"] = (idx, mask, force(p_l, idx, mask))

        run, _ = sh.make_shardmap_ensemble_scan_f(data_mesh, tab, inp["ensemble"][2], H,
                                                  ENS_STEPS)
        out["ensemble"] = run(_carry_rows(starts["ensemble"], data_mesh.get_local_rank("data")))
        torch.save(out, Path(out_dir) / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The two ranks' results, {name: [rank 0's, rank 1's]}."""
    out_dir = tmp_path_factory.mktemp("gloo")
    torch.save(_starts(_inputs()), out_dir / "starts.pt")
    ctx = torch.multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_worker, args=(r, str(out_dir / "store"), str(out_dir)))
             for r in range(RANKS)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + JOIN_S
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    hung = [p for p in procs if p.is_alive()]
    for p in hung:
        p.terminate()
        p.join(10)
    if hung:
        pytest.fail(f"the gloo ranks did not finish within {JOIN_S} s")
    assert [p.exitcode for p in procs] == [0] * RANKS, [p.exitcode for p in procs]
    res = [torch.load(out_dir / f"rank{r}.pt", weights_only=False) for r in range(RANKS)]
    return {k: [r[k] for r in res] for k in res[0]}


def _cat_carry(parts, axis=1):
    """The unsharded carry from the ranks' shares."""
    def ring(rs):
        if isinstance(rs[0], TwoFloat):
            return TwoFloat(torch.cat([r.hi for r in rs], axis), torch.cat([r.lo for r in rs], axis))
        return tuple(torch.cat(limbs, axis) for limbs in zip(*rs))
    return parts[0]._replace(ys=ring([p.ys for p in parts]), dd=ring([p.dd for p in parts]),
                             dy=torch.cat([p.dy for p in parts], axis - 1))


def _head(ys):
    """Ring head as f64 numpy, from a pair ring or limb tuple of either package."""
    if isinstance(ys, tuple) and not hasattr(ys, "hi"):
        return sum(np.asarray(l[0], np.float64) for l in ys)
    return np.asarray(ys.hi[0], np.float64) + np.asarray(ys.lo[0], np.float64)


def _close(a, ref, bound):
    a, ref = np.asarray(a), np.asarray(ref)
    assert np.abs(a - ref).max() <= bound * np.abs(ref).max()


def _equal_carry(a, b):
    for x, y in ((a.ys, b.ys), (a.dd, b.dd)):
        for u, v in zip(x, y):
            assert torch.equal(u, v)
    assert torch.equal(a.dy, b.dy)


def _unsharded_f(carry, mu, steps):
    mh, ml = cuda_nbody.split_f64(torch.tensor(mu).reshape(1, -1))

    def accel_pair(t, y):
        return TwoFloat(*cuda_nbody.pairwise_accel_df64(y.hi.t().contiguous(),
                                                        y.lo.t().contiguous(), mh, ml))

    for _ in range(steps):
        carry = ms.elm2_step_f(get(QT12), accel_pair, H, carry)
    return carry._replace(dy=ms.elm2_velocity_f(get(QT12), carry, H))


def _jax_mesh(data, model):
    from ephemeris_explorer_tpu.parallel import sharding as jsh

    return jsh, jsh.make_mesh(data=data, model=model)


# -- rows forms: plain versions against the square form's row slices -----------

@pytest.mark.parametrize("row0", [0, 8, 24])
def test_kernel1_rows_plain_is_the_square_slice(row0):
    """Kernel 1's rows form (plain version, which its wrapper takes on CPU
    tensors) equals rows row0 .. row0 + 8 of the square form bitwise."""
    pos, _, mu = _cloud(64, 31)
    ph, pl = cuda_nbody.split_f64(torch.tensor(pos), transpose=True)
    mh, ml = cuda_nbody.split_f64(torch.tensor(mu).reshape(1, -1))
    sq = cuda_nbody.pairwise_accel_df64(ph, pl, mh, ml)
    rows = cuda_nbody.split_f64(torch.tensor(pos[row0:row0 + 8]))
    before = cuda_nbody.pairwise_accel_df64_rows.launches
    got = cuda_nbody.pairwise_accel_df64_rows(ph, pl, mh, ml, *rows, row0)
    assert cuda_nbody.pairwise_accel_df64_rows.launches == before
    for g, s in zip(got, sq):
        assert torch.equal(g, s[row0:row0 + 8])


@pytest.mark.parametrize("row0", [0, 8, 24])
def test_kernel3_rows_plain_is_the_square_slice(row0):
    """Kernel 3's rows form (plain version) equals rows row0 .. row0 + 8 of
    the square form bitwise; sources (3, N) limbs, receivers (NL, 3)."""
    pos, _, mu = _cloud(64, 32)
    limbs = ex.from_f64_host(pos, torch.device("cpu"))[:3]
    mh, ml = cuda_nbody.split_f64(torch.tensor(mu).reshape(1, -1))
    sq = cuda_limbs.pairwise_accel_limbs_pair(*limbs, mh, ml)
    src = [l.t().contiguous() for l in limbs]
    recv = [l[row0:row0 + 8] for l in limbs]
    before = cuda_limbs.pairwise_accel_limbs_pair_rows.launches
    got = cuda_limbs.pairwise_accel_limbs_pair_rows(*src, mh, ml, *recv, row0)
    assert cuda_limbs.pairwise_accel_limbs_pair_rows.launches == before
    for g, s in zip(got, sq):
        assert torch.equal(g, s[row0:row0 + 8])


def test_kernel1_rows_plain_matches_pallas_rows():
    """Kernel 1's rows form against the JAX package's
    ``pairwise_accel_df64_rows`` (interpret mode, row0 = 16): 1e-13."""
    import jax.numpy as jnp
    from ephemeris_explorer_tpu.ops import pallas_nbody as jp

    pos, _, mu = _cloud(64, 33)
    jph, jpl = jp.split_f64(jnp.asarray(pos), transpose=True)
    jmh, jml = jp.split_f64(jnp.asarray(mu).reshape(1, -1))
    rh, rl = jp.split_f64(jnp.asarray(pos[16:48]))
    ref = jp.pairwise_accel_df64_rows(jph, jpl, jmh, jml, rh, rl, jnp.array([16], jnp.int32),
                                      tile_rows=16, tile_cols=16, interpret=True)
    ph, pl = cuda_nbody.split_f64(torch.tensor(pos), transpose=True)
    mh, ml = cuda_nbody.split_f64(torch.tensor(mu).reshape(1, -1))
    got = cuda_nbody.pairwise_accel_df64_rows(ph, pl, mh, ml,
                                              *cuda_nbody.split_f64(torch.tensor(pos[16:48])), 16)
    _close(cuda_nbody.combine_f64(*got), np.asarray(ref[0], np.float64) + np.asarray(ref[1]),
           PAIR_VS_JAX)


def test_kernel3_rows_plain_matches_pallas_rows():
    """Kernel 3's rows form against the JAX package's
    ``pairwise_accel_limbs_pair_rows`` (interpret mode, row0 = 32): 1e-13."""
    import jax.numpy as jnp
    from ephemeris_explorer_tpu.ops import pallas_nbody as jp

    pos, _, mu = _cloud(64, 34)
    limbs = ex.from_f64_host(pos, torch.device("cpu"))[:3]
    jl = [jnp.asarray(l.numpy()) for l in limbs]
    jmh, jml = jp.split_f64(jnp.asarray(mu).reshape(1, -1))
    ref = jp.pairwise_accel_limbs_pair_rows(*(l.T for l in jl), jmh, jml,
                                            *(l[32:] for l in jl), jnp.array([32], jnp.int32),
                                            tile_rows=16, tile_cols=16, interpret=True)
    mh, ml = cuda_nbody.split_f64(torch.tensor(mu).reshape(1, -1))
    got = cuda_limbs.pairwise_accel_limbs_pair_rows(*(l.t().contiguous() for l in limbs), mh, ml,
                                                    *(l[32:] for l in limbs), 32)
    _close(cuda_nbody.combine_f64(*got), np.asarray(ref[0], np.float64) + np.asarray(ref[1]),
           PAIR_VS_JAX)


# -- two gloo ranks against the port's unsharded results -----------------------

def test_two_ranks_rows_force_bitwise(ranks):
    """Kernel 1's row decomposition equals the square form bitwise; the
    plain f64 decomposition is within 1e-12 of the unsharded f64 force."""
    pos, _, mu = _inputs()["force"]
    p, m = torch.tensor(pos), torch.tensor(mu)
    ph, pl = cuda_nbody.split_f64(p, transpose=True)
    mh, ml = cuda_nbody.split_f64(m.reshape(1, -1))
    sq = cuda_nbody.pairwise_accel_df64(ph, pl, mh, ml)
    for k in range(2):
        assert torch.equal(torch.cat([r[k] for r in ranks["force_pair"]]), sq[k])
    _close(torch.cat(ranks["force_f64"]), nbody.pairwise_accel(p, m), 1e-12)


def test_two_ranks_scan_f_bitwise(ranks):
    """The row-sharded fused scan equals the unsharded fused scan bitwise,
    the velocity included."""
    inp = _inputs()["scan_f"]
    ref = _unsharded_f(_starts(_inputs())["scan_f"], inp[2], STEPS)
    _equal_carry(_cat_carry(ranks["scan_f"]), ref)


@pytest.mark.parametrize("precise", [False, True])
def test_two_ranks_scan_qf_bitwise(ranks, precise):
    """The row-sharded expansion engine equals the unsharded one
    (elm2_step_qf with kernel 3's square form) bitwise, in both modes."""
    mu = _inputs()["scan_qf"][2]
    mh, ml = cuda_nbody.split_f64(torch.tensor(mu).reshape(1, -1))
    c = _starts(_inputs())["scan_qf"]
    for _ in range(STEPS):
        c = ms.elm2_step_qf(get(QT12), lambda t, l: cuda_limbs.pairwise_accel_limbs_pair(
            *l, mh, ml), H, c, precise_sums=precise)
    c = c._replace(dy=ms.elm2_velocity_qf(get(QT12), c, H))
    _equal_carry(_cat_carry(ranks[f"scan_qf_{precise}"]), c)


def test_two_ranks_split_force_bitwise(ranks):
    """The row-sharded split mode: the refreshed strong set and exclusion
    table, and the force, equal the unsharded ones bitwise."""
    pos, _, mu = _inputs()["split"]
    p, m = torch.tensor(pos), torch.tensor(mu)
    idx = split.strong_pair_indices(p, m, k=SPLIT_K)
    mask = split.strong_pair_mask(idx, len(pos))
    got = [torch.cat([r[k] for r in ranks["split"]]) for k in range(3)]
    assert torch.equal(got[0], idx) and torch.equal(got[1], mask)
    assert torch.equal(got[2], cuda_split.pairwise_accel_split(p, m, idx, mask))


def test_two_ranks_ensemble_bitwise(ranks):
    """Members split over "data": each rank's scan equals the unsharded
    ensemble scan on its members bitwise."""
    mu = _inputs()["ensemble"][2]
    run, _ = sh.make_fused_ensemble_scan_f(get(QT12), mu, H, ENS_STEPS, device="cpu")
    _equal_carry(_cat_carry(ranks["ensemble"]), run(_starts(_inputs())["ensemble"]))


# -- two gloo ranks against the JAX package's row-sharded results --------------

def test_two_ranks_pair_force_matches_jax(ranks):
    import jax
    import jax.numpy as jnp
    from ephemeris_explorer_tpu.ops.pallas_nbody import split_f64 as jsplit

    jsh, mesh = _jax_mesh(1, 2)
    pos, _, mu = _inputs()["force"]
    ph, plo = jsplit(jnp.asarray(pos))
    rows = jax.NamedSharding(mesh, jax.P("model", None))
    mh, ml = jsplit(jnp.asarray(mu).reshape(1, -1))
    ah, al = jsh.pairwise_accel_rowsharded_pair(mesh, jax.device_put(ph, rows),
                                                jax.device_put(plo, rows), mh, ml,
                                                interpret=True, tile_rows=16, tile_cols=16)
    got = cuda_nbody.combine_f64(*(torch.cat([r[k] for r in ranks["force_pair"]])
                                   for k in range(2)))
    _close(got, np.asarray(ah, np.float64) + np.asarray(al), PAIR_VS_JAX)


def _jax_f_start(name):
    from ephemeris_explorer_tpu.integrators import get as jget
    from ephemeris_explorer_tpu.integrators.multistep import elm2_init, elm2_init_q
    from ephemeris_explorer_tpu.ops import nbody as jnbody
    import jax.numpy as jnp

    pos, vel, mu = _inputs()[name]
    mu_j = jnp.asarray(mu)
    init = elm2_init if name == "scan_f" else elm2_init_q
    return init(jget(QT12), lambda t, y: jnbody.pairwise_accel(y, mu_j), 0.0, jnp.asarray(pos),
                jnp.asarray(vel), H)


def test_two_ranks_scan_f_matches_jax(ranks):
    from ephemeris_explorer_tpu.integrators import get as jget

    jsh, mesh = _jax_mesh(1, 2)
    run, to_f = jsh.make_rowsharded_scan_f(mesh, jget(QT12), _inputs()["scan_f"][2], H, STEPS,
                                           interpret=True, tile_rows=8, tile_cols=16)
    ref = run(to_f(_jax_f_start("scan_f")))
    got = _cat_carry(ranks["scan_f"])
    _close(_head(got.ys), _head(ref.ys), SCAN_VS_JAX)


@pytest.mark.parametrize("precise", [False, True])
def test_two_ranks_scan_qf_matches_jax(ranks, precise):
    from ephemeris_explorer_tpu.integrators import get as jget

    jsh, mesh = _jax_mesh(1, 2)
    run, to_qf = jsh.make_rowsharded_scan_qf(mesh, jget(QT12), _inputs()["scan_qf"][2], H, STEPS,
                                             interpret=True, precise_sums=precise,
                                             tile_rows=8, tile_cols=16)
    ref = run(to_qf(_jax_f_start("scan_qf")))
    got = _cat_carry(ranks[f"scan_qf_{precise}"])
    _close(_head(got.ys), _head(ref.ys), SCAN_VS_JAX)


def test_two_ranks_split_force_matches_jax(ranks):
    import jax
    import jax.numpy as jnp

    jsh, mesh = _jax_mesh(1, 2)
    pos, _, mu = _inputs()["split"]
    refresh, force = jsh.make_rowsharded_split_force(mesh, mu, k=SPLIT_K, interpret=True,
                                                     tile_rows=8, tile_cols=16)
    p = jax.device_put(jnp.asarray(pos), jax.NamedSharding(mesh, jax.P("model", None)))
    idx, mask = refresh(p)
    got = [torch.cat([r[k] for r in ranks["split"]]) for k in range(3)]
    assert [set(r) for r in got[0].tolist()] == [set(r) for r in np.asarray(idx).tolist()]
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(mask))
    _close(got[2], force(p, idx, mask), SPLIT_VS_JAX)


def test_two_ranks_ensemble_matches_jax(ranks):
    from ephemeris_explorer_tpu.integrators import get as jget

    jsh, mesh = _jax_mesh(2, 1)
    pos, vel, mu = _inputs()["ensemble"]
    run, to_f = jsh.make_shardmap_ensemble_scan_f(mesh, jget(QT12), mu, H, ENS_STEPS,
                                                  interpret=True, tile_rows=8, tile_cols=8)
    ref = run(to_f(jsh.init_fused_ensemble_carry(jget(QT12), mu, 0.0, pos, vel, H)))
    _close(_head(_cat_carry(ranks["ensemble"]).ys), _head(ref.ys), SCAN_VS_JAX)


# -- entry points default to the card --------------------------------------------

def _entry_points():
    from ephemeris_explorer_tpu_torch.io import scene

    sc = scene.load_scene(Path(__file__).resolve().parent.parent / "systems"
                          / "sun_earth_moon_2433282.5")
    pos, vel, mu = _ensemble(1, 4, 0)
    tab = get(QT12)
    return {
        "NBodyPropagator": lambda: eph.NBodyPropagator(sc.state, sc.settings)._mu_dev,
        "generate_ephemeris": lambda: eph.generate_ephemeris(
            sc.state, sc.settings, eph.Duration.from_days(5.0)).pack(device=None).coeffs,
        "Ephemeris.pack": lambda: eph.generate_ephemeris(
            sc.state, sc.settings, eph.Duration.from_days(5.0), device="cpu").pack().coeffs,
        "init_fused_ensemble_carry": lambda: sh.init_fused_ensemble_carry(
            tab, mu, 0.0, pos, vel, H).ys,
        "make_fused_ensemble_scan": lambda: sh.make_fused_ensemble_scan(tab, mu, H, 1)(
            sh.init_fused_ensemble_carry(tab, mu, 0.0, pos, vel, H)).ys,
        "make_fused_ensemble_scan_f": lambda: sh.make_fused_ensemble_scan_f(tab, mu, H, 1)[0](
            ms.elm2_f_from(sh.init_fused_ensemble_carry(tab, mu, 0.0, pos, vel, H))).ys.hi,
        "make_mesh": lambda: sh.make_mesh(1, 1),
    }


@pytest.mark.parametrize("name", ["NBodyPropagator", "generate_ephemeris", "Ephemeris.pack",
                                  "init_fused_ensemble_carry", "make_fused_ensemble_scan",
                                  "make_fused_ensemble_scan_f", "make_mesh"])
def test_entry_point_defaults_to_the_card(name):
    """Without ``device`` an entry point runs on the card: without CUDA it
    raises rather than run on the CPU; with CUDA its tensors are on it."""
    call = _entry_points()[name]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    elif name == "make_mesh":
        pytest.skip("make_mesh needs a started process group (test_torch_cuda.py)")
    else:
        assert call().device.type == "cuda"


def test_import_leaves_jax_out():
    """Importing the scale-out layer never imports JAX or the JAX package."""
    import subprocess
    import sys

    code = (
        "import sys\n"
        "import ephemeris_explorer_tpu_torch.parallel.sharding\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'jaxlib'))\n"
        "       or m.split('.')[0] == 'ephemeris_explorer_tpu']\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=Path(__file__).resolve().parent.parent,
                   check=True)
