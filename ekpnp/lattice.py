"""Lattice definitions for the EK-PNP-3D solver.

Array representation of the velocity sets: instead of 27 unrolled scalar
direction variables (reference: LBM.cu:507-618), every lattice is a pair of
small constant arrays

    E   : (Q, 3) int   — integer direction vectors, ordered (ex, ey, ez)
    W   : (Q,)   float — quadrature weights
    OPP : (Q,)   int   — index of the opposite direction, OPP[0] == 0

so that all physics ops (equilibria, TRT even/odd split, streaming, moments)
vectorize over a leading direction axis and compile to large fused ops.

The primary lattice is D3Q27, matching the reference exactly:
  - ndir = 27            (reference LBM.h:102)
  - weights 8/27, 2/27, 1/54, 1/216   (reference LBM.h:109-112)
  - direction ordering extracted from the pull-streaming stencil
    (reference LBM.cu:1983-2008): index 0 rest; 1..6 axis; 7..18 face
    diagonals; 19..26 corners; opposites are the (odd, even) pairs
    (1,2), (3,4), ..., (25,26) — exactly the swaps used by bounce-back
    (LBM.cu:1862-1887) and the TRT split (LBM.cu:1148-1202).

A D3Q19 specialization is provided for the plain hydrodynamic configs
(BASELINE config 1); it shares the same code paths.

A D3Q7 lattice (rest + 6 axis directions, w0 = 1/4, ws = 1/8, cs^2 = 1/4)
is provided for the scalar advection-diffusion fields (ions, temperature):
a scalar field needs only up-to-second moment isotropy, which D3Q7
satisfies, at 7/27 of the HBM traffic of the reference's choice of reusing
the full hydrodynamic lattice for every field (LBM.cu:162-463).  Selected
via `RunConfig.scalar_lattice`; the default "same" is reference parity.
"""
from __future__ import annotations

import dataclasses
from functools import lru_cache

import numpy as np


@dataclasses.dataclass(frozen=True)
class Lattice:
    """A DdQq velocity set. Hashable (by name) so it can be a jit-static arg."""

    name: str
    E: np.ndarray  # (Q, 3) int8, columns (ex, ey, ez)
    W: np.ndarray  # (Q,) float64
    OPP: np.ndarray  # (Q,) int32

    def __post_init__(self):
        self.E.setflags(write=False)
        self.W.setflags(write=False)
        self.OPP.setflags(write=False)

    @property
    def Q(self) -> int:
        return int(self.E.shape[0])

    def __hash__(self):
        return hash(self.name)

    def __eq__(self, other):
        return isinstance(other, Lattice) and other.name == self.name

    # -- invariant helpers (used by tests) ------------------------------------
    def weight_sum(self) -> float:
        return float(self.W.sum())

    def first_moment(self) -> np.ndarray:
        return self.W @ self.E.astype(np.float64)

    def second_moment(self) -> np.ndarray:
        Ef = self.E.astype(np.float64)
        return np.einsum("q,qa,qb->ab", self.W, Ef, Ef)

    @property
    def cs2_lat(self) -> float:
        """Lattice-units sound speed squared: sum_i w_i e_ix^2
        (1/3 for D3Q27/D3Q19, 1/4 for D3Q7)."""
        return float(self.second_moment()[0, 0])


def _d3q27() -> Lattice:
    # Ordering transcribed from the reference streaming stencil
    # (LBM.cu:1983-2008): f1[x,d] pulls from x - E[d].
    E = np.array(
        [
            (0, 0, 0),  # 0  rest
            (+1, 0, 0),  # 1
            (-1, 0, 0),  # 2
            (0, +1, 0),  # 3
            (0, -1, 0),  # 4
            (0, 0, +1),  # 5
            (0, 0, -1),  # 6
            (+1, +1, 0),  # 7
            (-1, -1, 0),  # 8
            (+1, 0, +1),  # 9
            (-1, 0, -1),  # 10
            (0, +1, +1),  # 11
            (0, -1, -1),  # 12
            (+1, -1, 0),  # 13
            (-1, +1, 0),  # 14
            (+1, 0, -1),  # 15
            (-1, 0, +1),  # 16
            (0, +1, -1),  # 17
            (0, -1, +1),  # 18
            (+1, +1, +1),  # 19
            (-1, -1, -1),  # 20
            (+1, +1, -1),  # 21
            (-1, -1, +1),  # 22
            (+1, -1, +1),  # 23
            (-1, +1, -1),  # 24
            (-1, +1, +1),  # 25
            (+1, -1, -1),  # 26
        ],
        dtype=np.int8,
    )
    w0, ws, wa, wd = 8.0 / 27.0, 2.0 / 27.0, 1.0 / 54.0, 1.0 / 216.0
    W = np.array([w0] + [ws] * 6 + [wa] * 12 + [wd] * 8, dtype=np.float64)
    OPP = np.zeros(27, dtype=np.int32)
    for i in range(1, 27, 2):
        OPP[i] = i + 1
        OPP[i + 1] = i
    return Lattice("D3Q27", E, W, OPP)


def _d3q19() -> Lattice:
    # D3Q27 minus the 8 corner directions; standard D3Q19 weights.
    q27 = _d3q27()
    E = q27.E[:19].copy()
    w0, ws, wa = 1.0 / 3.0, 1.0 / 18.0, 1.0 / 36.0
    W = np.array([w0] + [ws] * 6 + [wa] * 12, dtype=np.float64)
    OPP = q27.OPP[:19].copy()
    return Lattice("D3Q19", E, W, OPP)


def _d3q7() -> Lattice:
    # Rest + 6 axis directions (D3Q27 ordering prefix); standard ADE weights
    # w0 = 1/4, ws = 1/8 giving cs^2 = 1/4.
    q27 = _d3q27()
    E = q27.E[:7].copy()
    W = np.array([1.0 / 4.0] + [1.0 / 8.0] * 6, dtype=np.float64)
    OPP = q27.OPP[:7].copy()
    return Lattice("D3Q7", E, W, OPP)


@lru_cache(maxsize=None)
def get_lattice(name: str) -> Lattice:
    name = name.upper()
    if name == "D3Q27":
        return _d3q27()
    if name == "D3Q19":
        return _d3q19()
    if name == "D3Q7":
        return _d3q7()
    raise ValueError(f"unknown lattice {name!r}; have D3Q27, D3Q19, D3Q7")


D3Q27 = get_lattice("D3Q27")
D3Q19 = get_lattice("D3Q19")
D3Q7 = get_lattice("D3Q7")
