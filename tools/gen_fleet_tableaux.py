#!/usr/bin/env python3
"""Write kernel 14's compile-time tableaux, ``csrc/fleet_tableaux.cuh``.

    python3 tools/gen_fleet_tableaux.py

Each adaptive tableau (``integrators.ADAPTIVE_METHODS``) becomes a struct of
``constexpr`` arrays (c, a, b, e; the ERKNG tableau also av, bv, ev), each
coefficient the f64 value that ``integrators.methods`` evaluates from the
exact fraction of ``integrators/tableaux.py``, written as a hex-float literal
(Python's ``float.hex``), so that the header and the registry agree bit for
bit.  ``EET_FLEET_TABLEAUX`` lists them in ``ADAPTIVE_METHODS``' order, the
kernel's instance numbering (``ops.cuda_fleet.instances``).  Imports no JAX.
"""

from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
OUT = ROOT / "ephemeris_explorer_tpu_torch" / "csrc" / "fleet_tableaux.cuh"


def _vec(xs) -> str:
    return "{" + ", ".join(float(x).hex() for x in xs) + "}"


def _mat(a) -> str:
    # row s holds its s terms below the diagonal; C++ zero-fills the rest
    rows = [_vec(a[s, :s]) for s in range(a.shape[0])]
    return "{" + ",\n      ".join(rows) + "}"


def header() -> str:
    sys.path.insert(0, str(ROOT))
    from ephemeris_explorer_tpu_torch.integrators import ADAPTIVE_METHODS, get

    out = [
        "// Kernel 14's compile-time tableaux (csrc/fleet_scan.cu instances them): each",
        "// adaptive tableau (integrators/methods.py ADAPTIVE_METHODS), every coefficient",
        "// the f64 value integrators/methods.py evaluates from its exact fraction in",
        "// integrators/tableaux.py, as a hex-float literal.  ERK: c, a, b, e; ERKNG:",
        "// c, a (ap), av, b (bp), bv, e (ep), ev.  Written by",
        "// tools/gen_fleet_tableaux.py; do not edit by hand.",
        "",
        "#pragma once",
        "",
        "namespace tableau {",
    ]
    for name in ADAPTIVE_METHODS:
        tab = get(name)
        nystrom = hasattr(tab, "ap")
        s = tab.stages
        out += ["", f"struct {name} {{",
                f"  static constexpr int kStages = {s};",
                f"  static constexpr bool kNystrom = {'true' if nystrom else 'false'};",
                f"  static constexpr double kC[{s}] = {_vec(tab.c)};"]
        mats = (("kA", tab.ap), ("kAV", tab.av)) if nystrom else (("kA", tab.a),)
        vecs = ((("kB", tab.bp), ("kBV", tab.bv), ("kE", tab.ep), ("kEV", tab.ev)) if nystrom
                else (("kB", tab.b), ("kE", tab.e)))
        out += [f"  static constexpr double {k}[{s}][{s}] = {_mat(a)};" for k, a in mats]
        out += [f"  static constexpr double {k}[{s}] = {_vec(v)};" for k, v in vecs]
        out.append("};")
    out += ["", "}  // namespace tableau", "",
            "// the instances, in the order of eet_fleet_scan's `instance` argument",
            "#define EET_FLEET_TABLEAUX(X) " + " ".join(f"X({n})" for n in ADAPTIVE_METHODS), ""]
    return "\n".join(out)


def main() -> int:
    OUT.write_text(header())
    print(f"wrote {OUT.relative_to(ROOT)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
