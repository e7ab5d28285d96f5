"""Fused collide + wall BC + push-stream kernel for the GPU (Pallas, Triton).

One program per (x-tile, y, z) row of nodes.  It reads every population of
its nodes once, takes the moments, E = -grad(phi) from a 7-point phi
stencil, the body force and the TRT collision of every field, applies the
fluid bounce-back and the scalar wall BCs, and writes each post-collision
population straight to the node it streams to (push form; every
destination is written exactly once).  It also emits the Poisson RHS of
rows z = 1..NZ-2 from the pre-collision ion moments.  One read and one
write per population is the step's minimum traffic; the plain XLA step
(collide, bounce-back, roll-and-stack stream) writes and re-reads the
post-collision set in between.

Directions are visited in a loop over opposite pairs (q, q+1), q odd — the
ordering of every lattice here (ekpnp/lattice.py) — with the pair's
direction vector, weight and moving-wall term read from small tables.  A
loop, not Python unrolling, keeps the Triton program small: unrolled over
all 108 populations of the all-D3Q27 configuration it took minutes to
compile.

Semantics are exactly those of `ekpnp.step.step` (the jnp oracle), in the
same operation order where it matters for round-off:
  - the z=0 wall velocity extrapolation needs numer at z=1, so the z=0 row
    also reads its z=1 neighbours;
  - the periodic x/y wraps and the z wrap of the fluid are index
    arithmetic; the wall rows of the scalar fields are written by the wall
    node itself (noflux, injection, temperature) or, for zerograd-top, by
    the z=NZ-2 row from its in-plane-shifted post-collision values.
"""
from __future__ import annotations

from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ..config import Config

# x-tile width and warps per program: one node per thread (measured on the
# H100, PERF.md).
_BX = 128
_NUM_WARPS = 4


def _pow2_at_least(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


def _consts(cfg: Config, dtype):
    """Every scalar constant of the step, rounded to `dtype` through the
    same expression order as ekpnp.ops (collide, boundary)."""
    p = cfg.physics
    t = dtype.type
    dt = t(p.dt(cfg.grid.dx))
    om = {k: t(v) for k, v in cfg.omegas().items()}
    c = dict(
        dt=dt,
        half_dt=0.5 * dt,
        inv_cfl=t(1.0 / p.cfl),
        inv_cs2=t(1.0 / cfg.cs2),
        feq_inv=t(1.0 / (cfg.cs2 * p.cfl)),
        inv_cs2_s=t(1.0 / cfg.cs2_s),
        feq_inv_s=t(1.0 / (cfg.cs2_s * p.cfl)),
        omp=dt * om["omega_plus"], omm=dt * om["omega_minus"],
        s_plus=1.0 - 0.5 * dt * om["omega_plus"],
        s_minus=1.0 - 0.5 * dt * om["omega_minus"],
        ocp=dt * om["omega_c_plus"], ocm=dt * om["omega_c_minus"],
        ocnp=dt * om["omega_cn_plus"], ocnm=dt * om["omega_cn_minus"],
        otp=dt * om["omega_T_plus"], otm=dt * om["omega_T_minus"],
        cc=t(p.convert_c_to_charge), ext=t(p.ext_field), exf=t(p.exf),
        buoy=t(p.rho0 * p.Ra * p.nu * p.D),
        K=t(p.K), Kn=t(p.Kn), joule=t(p.joule),
        kappa=t(p.convert_c_to_charge / p.eps),
        hx=t(0.5 / cfg.grid.dx), hy=t(0.5 / cfg.grid.dy),
        hz=t(0.5 / cfg.grid.dz),
        th2=t(2.0 * p.TH),
    )
    return {k: float(v) for k, v in c.items()}


def _tables(cfg: Config, lat, dtype):
    """Per-direction tables of a lattice: E (Q, 3) int32, W (Q,), and the
    upper-plate moving-wall term of the fluid (ops/boundary.py)."""
    p = cfg.physics
    if any(int(lat.OPP[q]) != q + 1 for q in range(1, lat.Q, 2)):
        raise ValueError(f"{lat.name}: opposite pairs must be (q, q+1), q odd")
    exq = lat.E[:, 0].astype(float)
    if p.compat_ref_multis and lat.Q > 3:
        exq = exq.copy()
        exq[3] += 1.0
    mw = (dtype.type(2.0 * p.rho0 * p.uw / cfg.cs2 / p.cfl)
          * np.asarray(lat.W, dtype) * np.asarray(exq, dtype))
    return (np.asarray(lat.E, np.int32), np.asarray(lat.W, dtype),
            np.asarray(mw, dtype))


@lru_cache(maxsize=None)
def build_push_step(cfg: Config, dtype_name: str, interpret: bool = False,
                    halo: bool = False):
    """The fused step as a function (f, h, hn, g, phi) -> (f1, h1, hn1, g1,
    rhs).  Absent fields are None in and out; rhs is None without EK.

    halo=True is the per-shard form of a y-slab mesh (parallel/halo.py):
    `cfg.grid.ny` is the shard's own row count, the populations arrive
    with one neighbour row on each side and phi with two, and y does not
    wrap — the programs of the two halo rows collide their nodes only to
    push into the shard's edge rows."""
    dtype = np.dtype(dtype_name)
    g = cfg.grid
    p = cfg.physics
    NZ, NY, NX = g.shape
    lat, lat_s = cfg.lattice, cfg.scalar_lat
    ek, th = p.enable_ek, p.enable_thermal
    two = ek and p.two_species
    cbc = p.charge_bc
    if cbc not in ("noflux", "injection", "zerograd-top"):
        raise ValueError(f"unknown charge_bc {cbc!r}")
    if NZ < 4:
        raise ValueError(f"nz={NZ}: the wall BCs need at least 4 z rows")
    C = _consts(cfg, dtype)
    tab_f = _tables(cfg, lat, dtype)
    tab_s = _tables(cfg, lat_s, dtype)[:2]
    BX = min(_BX, _pow2_at_least(NX))
    nxb = -(-NX // BX)
    NYP = NY + 2 if halo else NY   # population rows in, one program each
    fdt = jnp.dtype(dtype)

    def kernel(*refs):
        it = iter(refs)
        ef_ref, wf_ref, mw_ref, es_ref, ws_ref = (next(it) for _ in range(5))
        f_ref = next(it)
        h_ref = next(it) if ek else None
        hn_ref = next(it) if two else None
        g_ref = next(it) if th else None
        phi_ref = next(it) if ek else None
        fo = next(it)
        ho = next(it) if ek else None
        hno = next(it) if two else None
        go = next(it) if th else None
        rhs_ref = next(it) if ek else None

        xb, y, z = pl.program_id(0), pl.program_id(1), pl.program_id(2)
        x = xb * BX + jnp.arange(BX, dtype=jnp.int32)
        xm = x < NX
        xc = jnp.minimum(x, NX - 1)

        def wrap(i, n):
            return jnp.where(i >= n, i - n, jnp.where(i < 0, i + n, i))

        if halo:
            yo = y - 1                    # the shard row of this program
            own = (y >= 1) & (y <= NY)
            py, pyl, pyr = y + 1, y, y + 2  # phi rows (two-row halo)

            def dest_y(ey):
                d = yo + ey
                return jnp.clip(d, 0, NY - 1), (d >= 0) & (d < NY)
        else:
            yo, own = y, True
            py, pyl, pyr = y, wrap(y - 1, NY), wrap(y + 1, NY)

            def dest_y(ey):
                return wrap(y + ey, NY), True

        def ld(ref, idx, m=True, xi=None):
            return plgpu.load(ref.at[(*idx, xc if xi is None else xi)],
                              mask=xm & m, other=0.0)

        def dest_x(ex):
            # masked lanes get an out-of-range index: never dereferenced on
            # the GPU, and dropped by the interpreter's scatter
            return jnp.where(xm, wrap(x + ex, NX), NX + BX)

        def st(ref, idx, ex, val, m=True):
            plgpu.store(ref.at[(*idx, dest_x(ex))], val.astype(ref.dtype),
                        mask=xm & m)

        def direction(e_ref, w_ref, q):
            e = [plgpu.load(e_ref.at[q, a]) for a in range(3)]
            return e, [v.astype(fdt) for v in e], plgpu.load(w_ref.at[q])

        def dot(ef, v):
            return ef[0] * v[0] + ef[1] * v[1] + ef[2] * v[2]

        def total(ref, Q, zz, m):
            """Sum over the directions of one field's row zz."""
            return jax.lax.fori_loop(
                1, Q, lambda q, s: s + ld(ref, (q, zz, y), m),
                ld(ref, (0, zz, y), m))

        def terms(zz, m):
            """Moments, E and body force of row zz (masked by m)."""
            f0 = ld(f_ref, (0, zz, y), m)
            zero = jnp.zeros_like(f0)

            def mom_body(q, carry):
                rho, m0, m1, m2 = carry
                fq = ld(f_ref, (q, zz, y), m)
                _, ef, _ = direction(ef_ref, wf_ref, q)
                return (rho + fq, m0 + fq * ef[0], m1 + fq * ef[1],
                        m2 + fq * ef[2])

            rho, m0, m1, m2 = jax.lax.fori_loop(
                1, lat.Q, mom_body, (f0, zero, zero, zero))
            mom = [m0 * C["inv_cfl"], m1 * C["inv_cfl"], m2 * C["inv_cfl"]]
            charge = chargen = temp = E = None
            if ek:
                charge = total(h_ref, lat_s.Q, zz, m)
                chargen = total(hn_ref, lat_s.Q, zz, m) if two else None
                zc = jnp.clip(zz, 1, NZ - 2)
                xl, xr = wrap(xc - 1, NX), wrap(xc + 1, NX)
                E = [
                    (ld(phi_ref, (zz, py), m, xl) - ld(phi_ref, (zz, py), m, xr))
                    * C["hx"],
                    (ld(phi_ref, (zz, pyl), m) - ld(phi_ref, (zz, pyr), m))
                    * C["hy"],
                    (ld(phi_ref, (zc - 1, py), m)
                     - ld(phi_ref, (zc + 1, py), m)) * C["hz"],
                ]
            if th:
                temp = total(g_ref, lat_s.Q, zz, m)
            if ek:
                qc = C["cc"] * (charge - chargen if two else charge)
                F = [qc * (E[0] + C["ext"]) + C["exf"], qc * E[1], qc * E[2]]
            else:
                F = [zero + C["exf"], zero, zero]
            if th:
                F[2] = F[2] + C["buoy"] * temp
            numer = [mom[a] + C["half_dt"] * F[a] for a in range(3)]
            return rho, numer, F, charge, chargen, temp, E

        wall0 = z == 0
        top = z == NZ - 1
        # the z=0 wall velocity is extrapolated from numer at z=1
        _, numer1, *_ = terms(jnp.int32(1), wall0)
        rho, numer, F, charge, chargen, temp, E = terms(z, True)
        u = [jnp.where(wall0, -numer1[a] / rho, numer[a] / rho)
             for a in range(3)]

        if ek:
            rhs_row = -C["kappa"] * (charge - chargen if two else charge)
            st(rhs_ref, (jnp.clip(z - 1, 0, NZ - 3), jnp.clip(yo, 0, NY - 1)),
               0, rhs_row, (z >= 1) & (z <= NZ - 2) & own)

        def feq(w, ef, m, v, usq, inv):
            """w m (omusq + t (1 + t/2)), t = (e . v) inv
            (ops/equilibrium.feq)."""
            t = dot(ef, v) * inv
            return w * m * (usq + t * (1.0 + 0.5 * t))

        def trt(a, b, ea, eb, om_p, om_m):
            """Post-collision values of an opposite pair (a, b) with
            equilibria (ea, eb) (ops/collide._trt_update)."""
            ap, am = 0.5 * (a + b), 0.5 * (a - b)
            ep, em = 0.5 * (ea + eb), 0.5 * (ea - eb)
            return (a - (om_p * (ap - ep) + om_m * (am - em)),
                    b - (om_p * (ap - ep) + om_m * (em - am)))

        # ---- fluid: TRT + Guo source, bounce-back, push
        usq = 1.0 - 0.5 * (u[0] * u[0] + u[1] * u[1] + u[2] * u[2]) \
            * C["inv_cs2"]

        def guo(w, ef):
            """S = (w/cs2) [(e/CFL - u) . F + (e.u)(e.F)/(CFL^2 cs2)]."""
            core = ((ef[0] * C["inv_cfl"] - u[0]) * F[0]
                    + (ef[1] * C["inv_cfl"] - u[1]) * F[1]
                    + (ef[2] * C["inv_cfl"] - u[2]) * F[2]) \
                + (dot(ef, u) * C["inv_cfl"]) * (dot(ef, F) * C["inv_cfl"]) \
                * C["inv_cs2"]
            return (w * C["inv_cs2"]) * core

        def fluid(q, o, rest=False):
            e, ef, w = direction(ef_ref, wf_ref, q)
            fa, fb = ld(f_ref, (q, z, y)), ld(f_ref, (o, z, y))
            ea = feq(w, ef, rho, u, usq, C["feq_inv"])
            sa = guo(w, ef)
            if rest:
                a = trt(fa, fa, ea, ea, C["omp"], C["omm"])[0]
                a = a + C["dt"] * (C["s_plus"] * sa)
                out = ((q, fa, a, e),)
            else:
                nef = [-v for v in ef]
                eb = feq(w, nef, rho, u, usq, C["feq_inv"])
                sb = guo(w, nef)
                a, b = trt(fa, fb, ea, eb, C["omp"], C["omm"])
                sp, sm = 0.5 * (sa + sb), 0.5 * (sa - sb)
                a = a + C["dt"] * (C["s_plus"] * sp + C["s_minus"] * sm)
                b = b + C["dt"] * (C["s_plus"] * sp - C["s_minus"] * sm)
                out = ((q, fb, a, e), (o, fa, b, [-v for v in e]))
            for d, opp_pre, v, ed in out:
                # bounce-back from the pre-collision opposite population
                v = jnp.where(wall0, opp_pre,
                              jnp.where(top, opp_pre + plgpu.load(mw_ref.at[d]),
                                        v))
                yd, ok = dest_y(ed[1])
                st(fo, (d, wrap(z + ed[2], NZ), yd), ed[0], v, ok)

        fluid(0, 0, rest=True)

        @pl.loop(1, lat.Q, step=2)
        def _(q):
            fluid(q, q + 1)

        # ---- scalar fields: TRT, wall BCs, push
        def scalar(ref, out, m, vd, om_p, om_m, bc, extra=None, wall=None):
            us = 1.0 - 0.5 * (vd[0] * vd[0] + vd[1] * vd[1] + vd[2] * vd[2]) \
                * C["inv_cs2_s"]
            zg = bc == "zerograd-top"
            interior_src = jnp.logical_not(top) if zg else True
            hi = NZ - 1 if zg else NZ - 2
            yw = jnp.clip(yo, 0, NY - 1)

            def emit(d, v, r, w, ed):
                """Push direction d's post value v; the wall node's own
                row gets the BC of r, the post value opposite to d."""
                ex, ey, ez = ed
                zd = z + ez
                yd, ok = dest_y(ey)
                st(out, (d, wrap(zd, NZ), yd), ex, v,
                   (zd >= 1) & (zd <= hi) & interior_src & ok)
                if zg:
                    # upper plane := in-plane shift of row NZ-2 (all
                    # directions); down-going directions of row NZ-2 are
                    # re-sourced from that copied plane
                    near = (z == NZ - 2) & ok
                    st(out, (d, NZ - 1, yd), ex, v, near & (ez <= 0))
                    st(out, (d, NZ - 2, yd), ex, v, near & (ez < 0))
                if bc in ("noflux", "zerograd-top"):
                    lo_v, hi_v = r, r
                elif bc == "temperature":
                    lo_v, hi_v = -r + C["th2"] * w, -r
                else:  # injection: (c_lo, c_hi) plate levels
                    lo_v = -r + float(dtype.type(2.0 * wall[0])) * w
                    hi_v = -r + float(dtype.type(2.0 * wall[1])) * w
                st(out, (d, z, yw), 0, lo_v, wall0 & own)
                if not zg:
                    st(out, (d, z, yw), 0, hi_v, top & own)

            def pair(q, o, rest=False):
                e, ef, w = direction(es_ref, ws_ref, q)
                a, b = ld(ref, (q, z, y)), ld(ref, (o, z, y))
                ea = feq(w, ef, m, vd, us, C["feq_inv_s"])
                if rest:
                    a = trt(a, a, ea, ea, om_p, om_m)[0]
                    if extra is not None:
                        a = a + (C["dt"] * w) * extra
                    emit(q, a, a, w, e)
                    return
                eb = feq(w, [-v for v in ef], m, vd, us, C["feq_inv_s"])
                a, b = trt(a, b, ea, eb, om_p, om_m)
                if extra is not None:
                    a = a + (C["dt"] * w) * extra
                    b = b + (C["dt"] * w) * extra
                emit(q, a, b, w, e)
                emit(o, b, a, w, [-v for v in e])

            pair(0, 0, rest=True)

            @pl.loop(1, lat_s.Q, step=2)
            def _(q):
                pair(q, q + 1)

        if ek:
            vh = [u[a] + C["K"] * E[a] for a in range(3)]
            scalar(h_ref, ho, charge, vh, C["ocp"], C["ocm"], cbc,
                   wall=(p.charge0, p.charge1))
            if two:
                vn = [u[a] + C["Kn"] * E[a] for a in range(3)]
                scalar(hn_ref, hno, chargen, vn, C["ocnp"], C["ocnm"], cbc,
                       wall=(p.charge0n, p.charge1n))
        if th:
            joule = None
            if p.joule != 0.0 and ek:
                qsum = charge + chargen if two else charge
                joule = C["joule"] * qsum * (E[0] * E[0] + E[1] * E[1]
                                             + E[2] * E[2])
            scalar(g_ref, go, temp, u, C["otp"], C["otm"], "temperature",
                   extra=joule)

    shp = lambda Q: jax.ShapeDtypeStruct((Q, NZ, NY, NX), dtype)
    out_shape = [shp(lat.Q)]
    if ek:
        out_shape.append(shp(lat_s.Q))
    if two:
        out_shape.append(shp(lat_s.Q))
    if th:
        out_shape.append(shp(lat_s.Q))
    if ek:
        out_shape.append(jax.ShapeDtypeStruct((NZ - 2, NY, NX), dtype))
    call = pl.pallas_call(
        kernel,
        out_shape=out_shape,
        grid=(nxb, NYP, NZ),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=_NUM_WARPS,
                                             num_stages=1),
        interpret=interpret,
        name="ekpnp_push_step",
    )

    def fused(f, h, hn, gg, phi):
        tables = [jnp.asarray(t) for t in (*tab_f, *tab_s)]
        args = [a for a in (f, h, hn, gg, phi) if a is not None]
        outs = iter(call(*tables, *args))
        f1 = next(outs)
        h1 = next(outs) if ek else None
        hn1 = next(outs) if two else None
        g1 = next(outs) if th else None
        rhs = next(outs) if ek else None
        return f1, h1, hn1, g1, rhs

    return fused
