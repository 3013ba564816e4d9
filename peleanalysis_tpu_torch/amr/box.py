"""Integer index-space boxes and box arrays (the AMR grid skeleton).

TPU-native re-design of the AMReX ``Box`` / ``BoxArray`` concepts used
throughout the reference (e.g. PeleAnalysis Src/grad.cpp:151-164).  Unlike
the reference, boxes here are plain numpy integer arrays: all device-side
structures are *batched* (one padded array per level, see
``peleanalysis_tpu.amr.hierarchy``), and box metadata only drives host-side
index-map construction that is later consumed by jitted gathers.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, List, Sequence, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class Box:
    """A closed integer index-space box [lo, hi] (cell-centered)."""

    lo: Tuple[int, ...]
    hi: Tuple[int, ...]

    def __post_init__(self):
        object.__setattr__(self, "lo", tuple(int(x) for x in self.lo))
        object.__setattr__(self, "hi", tuple(int(x) for x in self.hi))
        if len(self.lo) != len(self.hi):
            raise ValueError(f"lo/hi rank mismatch: {self.lo} vs {self.hi}")

    @property
    def ndim(self) -> int:
        return len(self.lo)

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(h - l + 1 for l, h in zip(self.lo, self.hi))

    @property
    def size(self) -> int:
        return int(np.prod(self.shape))

    def grow(self, n: int) -> "Box":
        return Box(tuple(l - n for l in self.lo), tuple(h + n for h in self.hi))

    def shift(self, iv: Sequence[int]) -> "Box":
        return Box(
            tuple(l + s for l, s in zip(self.lo, iv)),
            tuple(h + s for h, s in zip(self.hi, iv)),
        )

    def coarsen(self, ratio) -> "Box":
        r = _ratio_tuple(ratio, self.ndim)
        lo = tuple(_floor_div(l, ri) for l, ri in zip(self.lo, r))
        hi = tuple(_floor_div(h, ri) for h, ri in zip(self.hi, r))
        return Box(lo, hi)

    def refine(self, ratio) -> "Box":
        r = _ratio_tuple(ratio, self.ndim)
        lo = tuple(l * ri for l, ri in zip(self.lo, r))
        hi = tuple((h + 1) * ri - 1 for h, ri in zip(self.hi, r))
        return Box(lo, hi)

    def intersect(self, other: "Box") -> "Box":
        lo = tuple(max(a, b) for a, b in zip(self.lo, other.lo))
        hi = tuple(min(a, b) for a, b in zip(self.hi, other.hi))
        return Box(lo, hi)

    def is_empty(self) -> bool:
        return any(h < l for l, h in zip(self.lo, self.hi))

    def contains(self, iv: Sequence[int]) -> bool:
        return all(l <= i <= h for l, i, h in zip(self.lo, iv, self.hi))

    def contains_box(self, other: "Box") -> bool:
        return all(sl <= ol for sl, ol in zip(self.lo, other.lo)) and all(
            oh <= sh for sh, oh in zip(self.hi, other.hi)
        )

    def __repr__(self) -> str:  # AMReX-style print, used in plotfile headers
        t = ",".join("0" for _ in self.lo)
        lo = ",".join(str(x) for x in self.lo)
        hi = ",".join(str(x) for x in self.hi)
        return f"(({lo}) ({hi}) ({t}))"


def _floor_div(a: int, b: int) -> int:
    return a // b if a >= 0 else -((-a + b - 1) // b)


def _ratio_tuple(ratio, ndim: int) -> Tuple[int, ...]:
    if np.isscalar(ratio):
        return (int(ratio),) * ndim
    r = tuple(int(x) for x in ratio)
    if len(r) != ndim:
        raise ValueError(f"ratio rank {len(r)} != {ndim}")
    return r


def parse_box(s: str) -> Box:
    """Parse an AMReX-printed box '((l,l,l) (h,h,h) (t,t,t))'."""
    parts = s.replace("(", " ").replace(")", " ").split()
    nums = [p for p in parts if p]
    if len(nums) not in (6, 9, 4, 2, 3):
        # general: 2 or 3 groups of ndim ints
        pass
    groups = [g for g in s.split(")") if g.strip()]
    vals = []
    for g in groups:
        g = g.replace("(", " ").strip()
        if not g:
            continue
        vals.append(tuple(int(x) for x in g.split(",")))
    lo, hi = vals[0], vals[1]
    return Box(lo, hi)


class BoxArray:
    """An ordered list of same-level boxes, with fast numpy views."""

    def __init__(self, boxes: Iterable[Box]):
        self.boxes: List[Box] = list(boxes)
        if not self.boxes:
            raise ValueError("empty BoxArray")
        self.ndim = self.boxes[0].ndim
        self.lo = np.array([b.lo for b in self.boxes], dtype=np.int64)
        self.hi = np.array([b.hi for b in self.boxes], dtype=np.int64)
        self.sizes = self.hi - self.lo + 1

    def __len__(self) -> int:
        return len(self.boxes)

    def __getitem__(self, i: int) -> Box:
        return self.boxes[i]

    def __iter__(self):
        return iter(self.boxes)

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, BoxArray)
            and len(self) == len(other)
            and np.array_equal(self.lo, other.lo)
            and np.array_equal(self.hi, other.hi)
        )

    @property
    def max_shape(self) -> Tuple[int, ...]:
        return tuple(int(x) for x in self.sizes.max(axis=0))

    def minimal_box(self) -> Box:
        return Box(tuple(self.lo.min(axis=0)), tuple(self.hi.max(axis=0)))

    def coarsen(self, ratio) -> "BoxArray":
        return BoxArray([b.coarsen(ratio) for b in self.boxes])

    def refine(self, ratio) -> "BoxArray":
        return BoxArray([b.refine(ratio) for b in self.boxes])

    def total_cells(self) -> int:
        return int(np.prod(self.sizes, axis=1).sum())


def decompose(domain: Box, max_grid_size: int) -> BoxArray:
    """Chop a domain box into boxes of at most max_grid_size per side.

    Mirrors the role of AMReX's ``BoxArray::maxSize`` used when tools build
    fresh layouts (reference: Src/grad.cpp:160-163).
    """
    ndim = domain.ndim
    splits = []
    for d in range(ndim):
        n = domain.shape[d]
        nchunks = (n + max_grid_size - 1) // max_grid_size
        # near-equal chunks
        base = n // nchunks
        rem = n % nchunks
        sizes = [base + (1 if i < rem else 0) for i in range(nchunks)]
        offs = np.cumsum([0] + sizes)
        splits.append([(domain.lo[d] + offs[i], domain.lo[d] + offs[i + 1] - 1) for i in range(nchunks)])
    boxes = []
    idx = [0] * ndim
    import itertools

    for combo in itertools.product(*[range(len(s)) for s in splits]):
        lo = tuple(splits[d][combo[d]][0] for d in range(ndim))
        hi = tuple(splits[d][combo[d]][1] for d in range(ndim))
        boxes.append(Box(lo, hi))
    return BoxArray(boxes)
