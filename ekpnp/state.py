"""State pytrees for the EK-PNP-3D solver.

The reference uses 28 separately-allocated global device buffers with an SoA
layout and double-buffer pointer pairs f1/f2 (reference LBM.h:131-141,
main.cu:78-109).  Here the state is one functional pytree:

  - populations are (Q, Z, Y, X) arrays — direction-major so every direction
    is a contiguous (Z, Y, X) volume; the rest population is index 0 instead
    of a separate `*0` buffer (reference gpu_field0_index, LBM.cu:17-30),
  - double buffering is replaced by donation (`jax.jit(..., donate_argnums)`),
  - optional physics (ions / thermal) are `None` entries in the pytree so the
    plain-hydrodynamics configs carry no dead memory.

Axis order (Z, Y, X) keeps x contiguous, matching the reference's
x-fastest memory layout (reference LBM.h:182-185).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

Array = jax.Array


class State(NamedTuple):
    """Full simulation state after a step (pre-collision populations)."""

    f: Array                 # fluid populations, (Q, Z, Y, X)
    h: Optional[Array]       # (+) ion populations, or None if EK disabled
    hn: Optional[Array]      # (-) ion populations
    g: Optional[Array]       # temperature populations, or None
    phi: Optional[Array]     # electric potential, (Z, Y, X); E = -grad(phi)
    #   The electric field is NOT state: it is always the exact gradient of
    #   phi (reference gpu_efield, poisson.cu:40-69), so it is re-derived
    #   where needed — in-kernel from phi windows on the Pallas path,
    #   via ops.poisson.efield on the oracle path and at I/O cadence.
    t: Array                 # physical time, scalar


class Macro(NamedTuple):
    """Macroscopic fields, as saved by the reference collide kernel
    (reference LBM.cu:807-813): moments of the *pre-collision* populations
    with the half-force velocity correction and the z=0 wall extrapolation.
    """

    rho: Array               # (Z, Y, X)
    u: Array                 # (3, Z, Y, X) — (ux, uy, uz)
    charge: Optional[Array]  # (+) ion concentration
    chargen: Optional[Array]
    temp: Optional[Array]


def zeros_state(cfg, dtype=None) -> State:
    """Allocate an all-zero state (populations only; phi/E per physics)."""
    lat = cfg.lattice
    dtype = dtype or jnp.dtype(cfg.run.dtype)
    shape = (lat.Q,) + cfg.grid.shape
    shape_s = (cfg.scalar_lat.Q,) + cfg.grid.shape
    zeros = lambda s: jnp.zeros(s, dtype)
    ek = cfg.physics.enable_ek
    th = cfg.physics.enable_thermal
    return State(
        f=zeros(shape),
        h=zeros(shape_s) if ek else None,
        hn=zeros(shape_s) if ek and cfg.physics.two_species else None,
        g=zeros(shape_s) if th else None,
        phi=zeros(cfg.grid.shape) if ek else None,
        t=jnp.zeros((), dtype),
    )
