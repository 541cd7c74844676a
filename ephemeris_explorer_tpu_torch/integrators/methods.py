"""Named integration methods: the rebuilt `integration` crate method registry.

Mirrors the 25 named methods of the reference
(``integration/src/methods.rs:6-40``): fixed explicit RK,
embedded adaptive RK (first-order), embedded Nystrom (ERKN) and generalized
Nystrom (ERKNG), symplectic Nystrom (SRKN), and explicit linear multistep
methods of first (Adams-Bashforth) and second (Quinlan-Tremaine 12,
Stormer 13 + Cowell velocity) order.

Tableaux are stored as exact rationals in :mod:`.tableaux` and materialised
here as f64 numpy arrays (evaluated once at import).  Default starters for
multistep methods follow the reference: RK4 for AB2-4, RK4 at h/2 for AB5-6,
BlanesMoan6B at h/4 for QT12/Stormer13 (``methods.rs:29-40``).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from fractions import Fraction

import numpy as np

from .tableaux import COWELL, METHODS as _RAW


def _f(x) -> float:
    return float(x)


def _arr(xs) -> np.ndarray:
    return np.array([float(x) for x in xs], dtype=np.float64)


def _mat(rows, stages) -> np.ndarray:
    a = np.zeros((stages, stages), dtype=np.float64)
    for i, row in enumerate(rows):
        for j, v in enumerate(row):
            a[i, j] = float(v)
    return a


@dataclass(frozen=True)
class ERKTableau:
    """Explicit Runge-Kutta for y' = f(t, y)  (explicit.rs:14-36)."""

    name: str
    order: int
    fsal: bool
    a: np.ndarray  # (stages, stages) strictly lower triangular
    b: np.ndarray  # (stages,)
    c: np.ndarray  # (stages,)
    order_embedded: int | None = None
    e: np.ndarray | None = None  # b - b*, error coefficients

    @property
    def stages(self) -> int:
        return len(self.b)

    @property
    def lower_order(self) -> int:
        assert self.order_embedded is not None
        return min(self.order, self.order_embedded)


@dataclass(frozen=True)
class ERKNTableau:
    """Explicit RK-Nystrom for y'' = f(t, y)  (nystrom/explicit.rs:14-34)."""

    name: str
    order: int
    fsal: bool
    a: np.ndarray
    bp: np.ndarray
    bv: np.ndarray
    c: np.ndarray
    order_embedded: int | None = None
    ep: np.ndarray | None = None
    ev: np.ndarray | None = None

    @property
    def stages(self) -> int:
        return len(self.bp)

    @property
    def lower_order(self) -> int:
        return min(self.order, self.order_embedded)


@dataclass(frozen=True)
class ERKNGTableau:
    """Generalized Nystrom for y'' = f(t, y, y')  (explicit_generalized.rs)."""

    name: str
    order: int
    fsal: bool
    ap: np.ndarray
    av: np.ndarray
    bp: np.ndarray
    bv: np.ndarray
    c: np.ndarray
    order_embedded: int | None = None
    ep: np.ndarray | None = None
    ev: np.ndarray | None = None

    @property
    def stages(self) -> int:
        return len(self.bp)

    @property
    def lower_order(self) -> int:
        return min(self.order, self.order_embedded)


@dataclass(frozen=True)
class SRKNTableau:
    """Symplectic RK-Nystrom kick-drift coefficients (symplectic.rs:20-33)."""

    name: str
    fsal: bool
    a: np.ndarray  # drift weights
    b: np.ndarray  # kick weights
    c: np.ndarray  # cumulative sums of a (stage times), c[i] = sum(a[:i])

    @property
    def stages(self) -> int:
        return len(self.a)

    @property
    def order(self) -> int:
        # reference: ORDER = number of stages (symplectic.rs:43)
        return len(self.a)


@dataclass(frozen=True)
class ELMTableau:
    """Explicit linear multistep (first or second order)."""

    name: str
    kind: str  # "elm1" | "elm2"
    order: int
    alpha: np.ndarray          # (order+1,) integer alpha coefficients
    beta_n: np.ndarray         # (order+1,) integer beta numerators
    beta_d: float
    # precomputed step coefficients:
    c_y: np.ndarray = field(default=None)    # (order,)  -alpha[j+1]
    c_dy: np.ndarray = field(default=None)   # (order,)  beta_n[j+1]
    cowell_beta_n: np.ndarray | None = None  # (order,) velocity coefficients
    cowell_beta_d: float | None = None
    starter: str = "RK4"
    substeps: int = 1

    def __post_init__(self):
        object.__setattr__(self, "c_y", -self.alpha[1:].astype(np.float64))
        object.__setattr__(self, "c_dy", self.beta_n[1:].astype(np.float64))


def _build():
    reg: dict[str, object] = {}
    for name, spec in _RAW.items():
        kind = spec["kind"]
        if kind == "erk":
            stages = len(spec["b"])
            reg[name] = ERKTableau(
                name=name,
                order=spec["order"],
                fsal=spec["fsal"],
                a=_mat(spec["a"], stages),
                b=_arr(spec["b"]),
                c=_arr(spec["c"]),
                order_embedded=spec.get("order_embedded"),
                e=_arr(spec["e"]) if "e" in spec else None,
            )
        elif kind == "erkn":
            stages = len(spec["bp"])
            reg[name] = ERKNTableau(
                name=name,
                order=spec["order"],
                fsal=spec["fsal"],
                a=_mat(spec["a"], stages),
                bp=_arr(spec["bp"]),
                bv=_arr(spec["bv"]),
                c=_arr(spec["c"]),
                order_embedded=spec.get("order_embedded"),
                ep=_arr(spec["ep"]) if "ep" in spec else None,
                ev=_arr(spec["ev"]) if "ev" in spec else None,
            )
        elif kind == "erkng":
            stages = len(spec["bp"])
            reg[name] = ERKNGTableau(
                name=name,
                order=spec["order"],
                fsal=spec["fsal"],
                ap=_mat(spec["ap"], stages),
                av=_mat(spec["av"], stages),
                bp=_arr(spec["bp"]),
                bv=_arr(spec["bv"]),
                c=_arr(spec["c"]),
                order_embedded=spec.get("order_embedded"),
                ep=_arr(spec["ep"]) if "ep" in spec else None,
                ev=_arr(spec["ev"]) if "ev" in spec else None,
            )
        elif kind == "srkn":
            a = spec["a"]
            # exact cumulative stage times (symplectic.rs:28-32)
            c = []
            acc = Fraction(0)
            for ai in a:
                c.append(acc)
                acc += ai
            reg[name] = SRKNTableau(
                name=name, fsal=spec["fsal"], a=_arr(a), b=_arr(spec["b"]), c=_arr(c)
            )
        elif kind in ("elm1", "elm2"):
            order = spec["order"]
            kwargs = {}
            if kind == "elm2":
                cow = COWELL[order]
                kwargs["cowell_beta_n"] = _arr(cow["beta_n"])
                kwargs["cowell_beta_d"] = float(cow["beta_d"])
            # reference default starters (methods.rs:29-40)
            if name in ("QuinlanTremaine12", "Stormer13"):
                starter, substeps = "BlanesMoan6B", 4
            elif name in ("AdamsBashforth5", "AdamsBashforth6"):
                starter, substeps = "RK4", 2
            else:
                starter, substeps = "RK4", 1
            reg[name] = ELMTableau(
                name=name,
                kind=kind,
                order=order,
                alpha=_arr(spec["alpha"]),
                beta_n=_arr(spec["beta_n"]),
                beta_d=float(spec["beta_d"]),
                starter=starter,
                substeps=substeps,
                **kwargs,
            )
        else:  # pragma: no cover
            raise ValueError(kind)
    return reg


REGISTRY: dict[str, object] = _build()

# Adaptive (embedded) first-order methods available as spacecraft integrators
# (reference: flight_plan.rs:175-184).
ADAPTIVE_METHODS = (
    "CashKarp45",
    "DormandPrince54",
    "DormandPrince87",
    "Fehlberg45",
    "Tsitouras75",
    "Verner87",
    "Verner98",
    "Fine45",
)


def get(name: str):
    return REGISTRY[name]
