"""TRT collision for all four populations + Guo forcing + macro fields.

A vectorized re-design of the reference hot kernel `gpu_collide_save`
(reference LBM.cu:483-1846): the 4 x 27 unrolled scalar expressions become
batched array ops over a leading direction axis, letting XLA fuse the whole
collision into a handful of loops.  The algebra is identical:

  - moments of pre-collision populations           (LBM.cu:621-630)
  - body force: Coulomb + external + Boussinesq    (LBM.cu:632-637)
  - velocity with half-force correction            (LBM.cu:639-644)
  - z=0 wall macroscopic extrapolation             (LBM.cu:663-801)
  - equilibria (ion drift u + K E)                 (LBM.cu:830-1103)
  - Guo forcing populations                        (LBM.cu:1107-1145)
  - TRT even/odd split and update with source
    s± = 1 - dt ω±/2                               (LBM.cu:1148-1845)

Only the fluid population receives the force source term.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import jax.numpy as jnp

from ..config import Config
from ..state import Macro, State
from .equilibrium import feq, lattice_consts, moments, trt_split
from .poisson import efield


class PostCollision(NamedTuple):
    f: jnp.ndarray
    h: Optional[jnp.ndarray]
    hn: Optional[jnp.ndarray]
    g: Optional[jnp.ndarray]


def body_force(cfg: Config, charge, chargen, temp, E, dtype):
    """(Fx, Fy, Fz) as (3, Z, Y, X) — reference LBM.cu:632-637."""
    p = cfg.physics
    shape = cfg.grid.shape
    zeros = jnp.zeros(shape, dtype)
    if cfg.physics.enable_ek:
        q = dtype.type(p.convert_c_to_charge) * (charge - chargen)
        fx = q * (E[0] + dtype.type(p.ext_field)) + dtype.type(p.exf)
        fy = q * E[1]
        fz = q * E[2]
    else:
        fx = zeros + dtype.type(p.exf)
        fy = zeros
        fz = zeros
    if cfg.physics.enable_thermal:
        buoy = dtype.type(p.rho0 * p.Ra * p.nu * p.D)
        fz = fz + buoy * temp
    return jnp.stack([fx, fy, fz])


def perturbation_velocity(cfg: Config, dtype):
    """Convection-roll seeding pattern (reference LBM.cu:646-661).

    "square": reproduced verbatim from LBM.cu:651-654, including the
    reference's use of *dimensional* coordinates inside the trigonometric
    arguments.

    "hexagon": the reference carries a hexagonal planform as dead commented
    code (LBM.cu:655-661; it would not even compile — it uses `^` as a
    power operator).  Implemented here with the algebra corrected: the
    planform F = [2 cos(a x) cos(b y) + cos(2 b y)]/3 with a = 2pi/(sqrt3 L),
    b = 2pi/(3 L) is an eigenfunction of the horizontal Laplacian with
    k^2 = a^2 + b^2 = (2b)^2, so

        uz = (cos(2 pi z) - 1) F,
        ux = -(2 pi / k^2) sin(2 pi z) dF/dx,
        uy = -(2 pi / k^2) sin(2 pi z) dF/dy

    is exactly divergence-free (tests/test_physics.py pins this).
    """
    g = cfg.grid
    LL = cfg.run.LL
    two_pi = 2.0 * math.pi
    z = jnp.arange(g.nz, dtype=dtype)[:, None, None]
    y = jnp.arange(g.ny, dtype=dtype)[None, :, None]
    x = jnp.arange(g.nx, dtype=dtype)[None, None, :]
    xx = x * dtype.type(g.dx)
    yy = y * dtype.type(g.dy)
    zz = (z - 0.5) * dtype.type(g.dz)
    pattern = cfg.run.perturb_pattern
    if pattern == "square":
        uz = (jnp.cos(two_pi * zz) - 1.0) * jnp.cos(two_pi / LL * xx) * jnp.cos(two_pi / LL * yy)
        ux = 0.5 * LL * jnp.sin(two_pi * zz) * jnp.sin(two_pi / LL * xx) * jnp.cos(two_pi / LL * yy)
        uy = 0.5 * LL * jnp.sin(two_pi * zz) * jnp.sin(two_pi / LL * yy) * jnp.cos(two_pi / LL * xx)
    elif pattern == "hexagon":
        a = two_pi / (math.sqrt(3.0) * LL)
        b = two_pi / (3.0 * LL)
        k2 = a * a + b * b  # = (2b)^2 for every planform component
        F = (2.0 * jnp.cos(a * xx) * jnp.cos(b * yy) + jnp.cos(2.0 * b * yy)) / 3.0
        dFdx = -(2.0 * a / 3.0) * jnp.sin(a * xx) * jnp.cos(b * yy)
        dFdy = (-(2.0 * b / 3.0) * jnp.cos(a * xx) * jnp.sin(b * yy)
                - (2.0 * b / 3.0) * jnp.sin(2.0 * b * yy))
        uz = (jnp.cos(two_pi * zz) - 1.0) * F
        ux = -(two_pi / k2) * jnp.sin(two_pi * zz) * dFdx
        uy = -(two_pi / k2) * jnp.sin(two_pi * zz) * dFdy
    else:
        raise ValueError(f"unknown perturb_pattern {pattern!r}")
    shape = g.shape
    return jnp.stack(
        [jnp.broadcast_to(ux, shape), jnp.broadcast_to(uy, shape), jnp.broadcast_to(uz, shape)]
    )


def guo_force_pops(cfg: Config, u, F, dtype):
    """Guo forcing populations (reference LBM.cu:1107-1145):

    S_i = (w_i/cs^2) [ (e_i/CFL - u) . F + ((e_i.u)(e_i.F)) / (CFL^2 cs^2) ]
    """
    lat = cfg.lattice
    cs2 = cfg.cs2
    cfl = cfg.physics.cfl
    ex, ey, ez, w = lattice_consts(lat, dtype)
    inv_cfl = dtype.type(1.0 / cfl)
    eu = (ex * u[0] + ey * u[1] + ez * u[2]) * inv_cfl
    eF = (ex * F[0] + ey * F[1] + ez * F[2]) * inv_cfl
    cu = ex * inv_cfl - u[0][None]
    cv = ey * inv_cfl - u[1][None]
    cw = ez * inv_cfl - u[2][None]
    core = (cu * F[0][None] + cv * F[1][None] + cw * F[2][None]) + eu * eF * dtype.type(1.0 / cs2)
    return (w * dtype.type(1.0 / cs2)) * core


def _trt_update(lat, pops, eq, om_plus_dt, om_minus_dt, source=None, dt=None):
    fp, fm = trt_split(lat, pops)
    ep, em = trt_split(lat, eq)
    out = pops - (om_plus_dt * (fp - ep) + om_minus_dt * (fm - em))
    if source is not None:
        out = out + dt * source
    return out


def compute_macro(cfg: Config, state: State, perturb: bool = False, E=None):
    """Macroscopic fields + body force from pre-collision populations.

    Exactly the first half of gpu_collide_save (LBM.cu:621-801): moments,
    Coulomb/external/Boussinesq body force, velocity with half-force
    correction, and the z=0 wall macroscopic extrapolation.
    E = -grad(state.phi) is derived here when not passed in (it is no
    longer carried in State).  Returns (Macro, F).
    """
    lat = cfg.lattice
    p = cfg.physics
    dtype = state.f.dtype
    dt = dtype.type(p.dt(cfg.grid.dx))
    cfl = p.cfl

    # ---- moments of pre-collision populations (LBM.cu:621-630)
    rho, mom = moments(lat, state.f, cfl)
    if p.enable_ek:
        charge = jnp.sum(state.h, axis=0)
        # single-species mode (BASELINE config 2): chargen is identically 0
        chargen = (jnp.sum(state.hn, axis=0) if state.hn is not None
                   else jnp.zeros_like(charge))
    else:
        charge = chargen = None
    temp = jnp.sum(state.g, axis=0) if p.enable_thermal else None

    # ---- body force (LBM.cu:632-637)
    if p.enable_ek and E is None:
        E = efield(cfg, state.phi)
    F = body_force(cfg, charge, chargen, temp, E, dtype)

    # ---- velocity with half-force correction (LBM.cu:639-644)
    numer = mom + 0.5 * dt * F  # mom already divided by CFL in moments()
    u = numer / rho[None]

    if perturb:
        # convection-pattern seeding replaces u wholesale (LBM.cu:646-661)
        u = perturbation_velocity(cfg, dtype)
    else:
        # z=0 wall extrapolation: u(wall) = -numer(z=1)/rho(z=0)
        # (LBM.cu:663-801; note the reference's rhoinvm = 1/rho uses the
        # *local* wall density, LBM.cu:780 — reproduced)
        u_wall = -numer[:, 1] / rho[0][None]
        u = u.at[:, 0].set(u_wall)

    return Macro(rho=rho, u=u, charge=charge, chargen=chargen, temp=temp), F


def collide(cfg: Config, state: State, perturb: bool = False):
    """One TRT collision of all active populations.

    Returns (PostCollision, Macro).  Mirrors gpu_collide_save exactly; the
    wall handling that the reference does in separate kernels afterwards
    (bounce-back, scalar wall BCs) lives in boundary.py.
    """
    lat = cfg.lattice
    lat_s = cfg.scalar_lat      # scalar-transport lattice (ions, temperature)
    p = cfg.physics
    g = cfg.grid
    dtype = state.f.dtype
    dt = dtype.type(p.dt(g.dx))
    cs2 = cfg.cs2
    cs2_s = cfg.cs2_s
    cfl = p.cfl
    om = {k: dtype.type(v) for k, v in cfg.omegas().items()}

    E = efield(cfg, state.phi) if p.enable_ek else None
    macro, F = compute_macro(cfg, state, perturb, E=E)
    rho, u = macro.rho, macro.u
    charge, chargen, temp = macro.charge, macro.chargen, macro.temp

    # ---- equilibria (LBM.cu:830-1103)
    feq_f = feq(lat, rho, u, cfl, cs2)

    # ---- Guo forcing + TRT source on the fluid (LBM.cu:1107-1145,1660-1689)
    fpop = guo_force_pops(cfg, u, F, dtype)
    sp_, sm_ = trt_split(lat, fpop)
    s_plus = 1.0 - 0.5 * dt * om["omega_plus"]
    s_minus = 1.0 - 0.5 * dt * om["omega_minus"]
    source = s_plus * sp_ + s_minus * sm_

    f2 = _trt_update(
        lat, state.f, feq_f, dt * om["omega_plus"], dt * om["omega_minus"], source, dt
    )

    h2 = hn2 = g2 = None
    if p.enable_ek:
        K = dtype.type(p.K)
        Kn = dtype.type(p.Kn)
        feq_h = feq(lat_s, charge, u + K * E, cfl, cs2_s)
        h2 = _trt_update(lat_s, state.h, feq_h, dt * om["omega_c_plus"], dt * om["omega_c_minus"])
        if state.hn is not None:
            feq_hn = feq(lat_s, chargen, u + Kn * E, cfl, cs2_s)
            hn2 = _trt_update(
                lat_s, state.hn, feq_hn, dt * om["omega_cn_plus"], dt * om["omega_cn_minus"]
            )
    if p.enable_thermal:
        feq_g = feq(lat_s, temp, u, cfl, cs2_s)
        g2 = _trt_update(lat_s, state.g, feq_g, dt * om["omega_T_plus"], dt * om["omega_T_minus"])
        if p.joule != 0.0 and p.enable_ek:
            # Joule heating extension (BASELINE config 4): volumetric source
            # S = joule (c+ + c-) |E|^2 added to the temperature equation as
            # dt w_i S (simple first-order source; 0 by default = reference
            # parity, the reference has buoyancy only, LBM.cu:632-637)
            S = dtype.type(p.joule) * (charge + chargen) * jnp.sum(E * E, axis=0)
            g2 = g2 + dt * lat_s.W[:, None, None, None].astype(dtype) * S[None]

    return PostCollision(f=f2, h=h2, hn=hn2, g=g2), macro
