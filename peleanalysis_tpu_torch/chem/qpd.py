"""Chemical-path-diagram (QPD) utilities -- Edge/Group machinery of the
reference's Tools/Util/util.{H,cpp} (species/element/reaction indexing, the
Edge class representing atom transfer between species through reactions,
util.H:8-97) re-implemented on a runtime mechanism instead of a compiled-in
Fuego mechanism.  Counterpart of ``peleanalysis_tpu/chem/qpd.py``: pure
Python, copied as it is.

Edges follow the reference's getEdges algorithm exactly
(util.cpp:542-686): stoichiometric coefficients are NETTED per species
(spectators/collision partners vanish), then

  * one tracked species on either side: all (reac, prod) pairs with
    w = min(c_r * n_r, c_p * n_p) tracked atoms;
  * two on each side (every H-abstraction): the group-difference "pick"
    assigns the primary pairing (smaller same-sign composition change,
    atomic-weight tie-break), min/remainder weights;
  * anything bigger is reported un-decomposable, like the reference.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .mechanism import atom_count


@dataclasses.dataclass
class Reaction:
    reactants: Dict[str, float]   # species -> stoich coeff
    products: Dict[str, float]
    reversible: bool = True
    label: str = ""

    def __repr__(self):
        lhs = " + ".join(f"{v:g} {k}" if v != 1 else k
                         for k, v in self.reactants.items())
        rhs = " + ".join(f"{v:g} {k}" if v != 1 else k
                         for k, v in self.products.items())
        arrow = "<=>" if self.reversible else "=>"
        return f"{lhs} {arrow} {rhs}"


def parse_reaction(line: str) -> Reaction:
    """Parse 'A + 2B <=> C + D' style reaction strings (third bodies (+M)
    and pressure-dependence markers are stripped)."""
    s = line.split("!")[0].strip()
    rev = "<=>" in s or ("=" in s and "=>" not in s)
    for arrow in ("<=>", "=>", "="):
        if arrow in s:
            lhs, rhs = s.split(arrow, 1)
            break
    else:
        raise ValueError(f"no arrow in reaction {line!r}")

    def side(txt):
        txt = re.sub(r"\(\+[^)]*\)", "", txt)
        out: Dict[str, float] = {}
        for term in txt.split("+"):
            term = term.strip()
            if not term or term.upper() == "M":
                continue
            m = re.match(r"^(\d+\.?\d*)\s*(.+)$", term)
            if m:
                coeff, name = float(m.group(1)), m.group(2).strip()
            else:
                coeff, name = 1.0, term
            out[name] = out.get(name, 0.0) + coeff
        return out

    return Reaction(side(lhs), side(rhs), rev, s)


class Edge:
    """Atom-transfer edge sp1 -> sp2 with a rate-weight list of
    (reaction index, atoms transferred per unit rate) (util.H:36-62)."""

    def __init__(self, sp1: str, sp2: str,
                 rwl: Optional[List[Tuple[int, float]]] = None):
        self.sp1 = sp1
        self.sp2 = sp2
        self.rwl: List[Tuple[int, float]] = list(rwl or [])

    def left(self) -> str:
        return self.sp1

    def right(self) -> str:
        return self.sp2

    def touches_sp(self, sp: str) -> bool:
        return sp in (self.sp1, self.sp2)

    def reverse(self) -> None:
        self.sp1, self.sp2 = self.sp2, self.sp1
        self.rwl = [(r, -w) for r, w in self.rwl]

    def equiv_sign(self, other: "Edge") -> int:
        """+1 same orientation, -1 reversed, 0 different edge (util.H:50)."""
        if (self.sp1, self.sp2) == (other.sp1, other.sp2):
            return 1
        if (self.sp1, self.sp2) == (other.sp2, other.sp1):
            return -1
        return 0

    def combine(self, other: "Edge", sgn: int) -> None:
        self.rwl.extend((r, sgn * w) for r, w in other.rwl)

    def key(self) -> Tuple[str, str]:
        return (self.sp1, self.sp2) if self.sp1 < self.sp2 \
            else (self.sp2, self.sp1)

    def __lt__(self, other: "Edge") -> bool:
        return (self.sp1, self.sp2) < (other.sp1, other.sp2)

    def __repr__(self):
        return f"Edge({self.sp1}->{self.sp2}, {self.rwl})"


class Group:
    """Element-count bag with the reference's Group ops (util.H:63-88)."""

    def __init__(self, elt_counts: Optional[Dict[str, int]] = None):
        self.counts = dict(elt_counts or {})

    def __sub__(self, other: "Group") -> "Group":
        out = dict(self.counts)
        for k, v in other.counts.items():
            out[k] = out.get(k, 0) - v
        return Group(out)

    def __mul__(self, n: int) -> "Group":
        return Group({k: v * n for k, v in self.counts.items()})

    def __getitem__(self, elem: str) -> int:
        return self.counts.get(elem, 0)

    def contains(self, elem: str) -> bool:
        return self.counts.get(elem, 0) != 0

    def same_sign(self) -> bool:
        vals = [v for v in self.counts.values() if v != 0]
        return all(v > 0 for v in vals) or all(v < 0 for v in vals)

    def size(self) -> int:
        return sum(abs(v) for v in self.counts.values())

    def awt(self) -> float:
        from .mechanism import ATOMIC_MASS
        return sum(ATOMIC_MASS[k.upper()] * v for k, v in
                   self.counts.items())


def _group_of(sp: str) -> Group:
    from .mechanism import parse_formula
    try:
        return Group({k: int(v) for k, v in parse_formula(sp).items()})
    except (ValueError, KeyError):
        return Group({})


def get_edges(reactions: Sequence[Reaction], tr_elt: str) -> List[Edge]:
    """All atom-transfer edges for the tracked element, combined across
    reactions -- the reference algorithm (getEdges, util.cpp:542-686):
    spectators netted, the reference's min/pick weights."""
    acc: Dict[Tuple[str, str], Edge] = {}

    def push(s1, s2, ir, w):
        if w == 0 or s1 == s2:
            return
        e = Edge(s1, s2, [(ir, float(w))])
        k = e.key()
        if k in acc:
            acc[k].combine(e, acc[k].equiv_sign(e))
        else:
            acc[k] = e

    def n_at(sp):
        return atom_count(sp, tr_elt)

    for ir, rxn in enumerate(reactions):
        # net stoichiometry: spectators/collision partners cancel
        # (util.cpp:546-558)
        net: Dict[str, float] = {}
        for s, c in rxn.reactants.items():
            net[s] = net.get(s, 0.0) - c
        for s, c in rxn.products.items():
            net[s] = net.get(s, 0.0) + c
        reac = {s: -c for s, c in net.items() if c < 0 and n_at(s) > 0}
        prod = {s: c for s, c in net.items() if c > 0 and n_at(s) > 0}
        LR, LP = len(reac), len(prod)
        if LR == 0 or LP == 0:
            continue
        if LR == 1 or LP == 1:            # util.cpp:581-596
            for spcr, cor in reac.items():
                for spcp, cop in prod.items():
                    push(spcr, spcp, ir,
                         min(cor * n_at(spcr), cop * n_at(spcp)))
            continue
        if LR == 2 and LP == 2:           # util.cpp:598-682
            (rs0, rc0), (rs1, rc1) = sorted(reac.items())  # std::map order
            (ps0, pc0), (ps1, pc1) = sorted(prod.items())
            b0 = _group_of(ps0) * int(pc0) - _group_of(rs0) * int(rc0)
            b1 = _group_of(ps1) * int(pc1) - _group_of(rs0) * int(rc0)
            pick = 0
            if b0.same_sign() and b1.same_sign():
                if b1.size() < b0.size():
                    pick = 1
                elif b1.size() == b0.size() and b0.awt() > b1.awt():
                    pick = 1
            elif b1.same_sign():
                pick = 1
            nR0 = rc0 * n_at(rs0)
            nR1 = rc1 * n_at(rs1)
            nP0 = pc0 * n_at(ps0)
            nP1 = pc1 * n_at(ps1)
            if pick == 0:
                push(rs0, ps0, ir, min(nR0, nP0))
                if nP0 < nR0:
                    push(rs0, ps1, ir, nR0 - nP0)
                push(rs1, ps1, ir, min(nR1, nP1))
                if nR0 < nP0:
                    push(rs1, ps0, ir, nP0 - nR0)
            else:
                push(rs0, ps1, ir, min(nR0, nP1))
                if nP1 < nR0:
                    push(rs0, ps0, ir, nR0 - nP1)
                push(rs1, ps0, ir, min(nR1, nP0))
                if nR0 < nP1:
                    push(rs1, ps1, ir, nP1 - nR0)
            continue
        print(f"Cannot decompose rxn: {ir} {LR} {LP}")
    return sorted(acc.values())


def edge_fluxes(edges: Sequence[Edge],
                rates: np.ndarray) -> Dict[Tuple[str, str], float]:
    """Net atom flux per edge given per-reaction net rates
    (rates [n_reactions], e.g. region-integrated from a plotfile's reaction
    rate components, the plotQPD evaluation)."""
    out = {}
    for e in edges:
        out[(e.sp1, e.sp2)] = float(sum(w * rates[r] for r, w in e.rwl))
    return out
