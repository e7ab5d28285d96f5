"""Diagnostics: ionic current, umax series, dimensionless groups, NaN guard.

The reference computes these on host after D2H copies (current: LBM.cu:
2674-2710 + main.cu:212-216; umax: LBM.cu:2712-2753); here they are jitted
device-side reductions — under sharding they become psum/pmax collectives.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from .config import Config
from .state import Macro


def wall_extrapolate(field):
    """Linear extrapolation of wall planes from the interior, as applied by
    every reference output path (LBM.cu:2527-2542): row 0 <- 2*[1]-[2],
    row NZ-1 <- 2*[NZ-2]-[NZ-3].  field: (..., Z, Y, X) along axis -3."""
    f0 = 2.0 * field[..., 1, :, :] - field[..., 2, :, :]
    f1 = 2.0 * field[..., -2, :, :] - field[..., -3, :, :]
    out = field.at[..., 0, :, :].set(f0)
    return out.at[..., -1, :, :].set(f1)


@partial(jax.jit, static_argnums=(0,))
def ionic_current(cfg: Config, charge, chargen, Ez):
    """I = K dz^2 sum_xy (c+ - c-) Ez at the upper plate, with wall
    extrapolation of the charges first (reference current(), LBM.cu:2674-2710).
    """
    p = cfg.physics
    c = wall_extrapolate(charge)
    cn = wall_extrapolate(chargen)
    upper = (c[-1] - cn[-1]) * Ez[-1]
    return jnp.sum(upper) * (p.K * cfg.grid.dz * cfg.grid.dz)


@jax.jit
def umax(u):
    """max of raw uz — faithfully the reference's record_umax semantics
    (LBM.cu:2735-2746: max of uz, not |u|; the reference's wall
    extrapolation before the max touches only ux/uy (copy-paste quirk,
    LBM.cu:2727-2733) and therefore never affects the result)."""
    return jnp.max(u[2])


@jax.jit
def velocity_magnitude_max(u):
    """The physically-useful variant: max |u|."""
    return jnp.sqrt(jnp.max(jnp.sum(u * u, axis=0)))


def check_finite(state) -> bool:
    """NaN/Inf guard over the whole state pytree (failure detection)."""
    leaves = [l for l in jax.tree_util.tree_leaves(state) if l is not None]
    ok = jnp.array(True)
    for l in leaves:
        ok = ok & jnp.all(jnp.isfinite(l))
    return bool(ok)


@partial(jax.jit, static_argnums=(0,))
def series_point(cfg: Config, state):
    """All per-cadence diagnostics in ONE device program returning five
    scalars — (umax_uz, umax_mag, current, mean_T, finite) — so the driver
    pays a single host roundtrip per event instead of one per quantity
    (the reference does three D2H array copies per event, main.cu:212-216)."""
    from .ops.collide import compute_macro
    from .ops.poisson import efield

    macro, _ = compute_macro(cfg, state)
    um = jnp.max(macro.u[2])
    umag = jnp.sqrt(jnp.max(jnp.sum(macro.u * macro.u, axis=0)))
    if cfg.physics.enable_ek:
        E = efield(cfg, state.phi)
        cur = ionic_current(cfg, macro.charge, macro.chargen, E[2])
    else:
        cur = jnp.zeros((), macro.rho.dtype)
    mean_t = (jnp.mean(macro.temp) if macro.temp is not None
              else jnp.zeros((), macro.rho.dtype))
    finite = jnp.array(True)
    for l in jax.tree_util.tree_leaves(state):
        finite = finite & jnp.all(jnp.isfinite(l))
    return um, umag, cur, mean_t, finite


def dimensionless_banner(cfg: Config) -> str:
    """Printable dimensionless-group report (reference compute_parameters,
    LBM.cu:2419-2446 + main.cu:40-53)."""
    d = cfg.physics.dimensionless(cfg.grid.lz)
    lines = [
        "EK-PNP-3D (JAX) — 3D electrokinetic flow with heat transfer",
        f"  domain (NX x NY x NZ): {cfg.grid.nx}x{cfg.grid.ny}x{cfg.grid.nz}",
        f"  M  = {d['M']:.6g}",
        f"  T  = {d['T']:.6g}",
        f"  C  = {d['C']:.6g}",
        f"  Fe = {d['Fe']:.6g}",
        f"  Ra = {cfg.physics.Ra:g}",
        f"  Pr = {d['Pr']:.6g}",
        f"  uwall = {cfg.physics.uw:g}",
        f"  external force = {cfg.physics.exf:g}",
        f"  dt = {cfg.dt:g} s",
    ]
    return "\n".join(lines)
