"""Spectral Poisson solver for the electric potential + E-field gradient.

A re-design of the reference cuFFT pipeline (poisson.cu:75-103): the
per-step cudaMalloc/Free and 5 separate kernels collapse into one pure
jitted function — odd extension, FFT, spectral divide, inverse FFT,
extraction and the E-field gradient all fuse under one `jit` with zero
host round-trips.

Math (identical to the reference):
  - RHS  = -convertCtoCharge (c+ - c-) / eps, with the Dirichlet plate
    potentials folded into rows z=1 and z=NZ-2 as -voltage/dz^2
    (odd_extension, poisson.cu:114-158)
  - odd mirror about z = NZ-1 onto the extended domain NE = 2(NZ-1): a
    DST-I-by-FFT so the periodic transform satisfies phi = voltage at both
    plates
  - spectral division by -mu with mu = (4/dz^2) sin^2(k_z dz/2) + kx^2 +
    ky^2 — 2nd-order finite-difference modified wavenumber in z, exact
    spectral in x,y; zero mode pinned mu(0,0,0) = 1 (gpu_derivative,
    poisson.cu:169-180)
  - extract interior slab, pin plate rows exactly to voltage/voltage2
    (odd_extract, poisson.cu:191-204).  `jnp.fft.ifftn` is normalized, so
    the reference's explicit 1/size disappears.
  - E = -grad(phi) by centered differences with periodic wrap, then
    one-sided copy of Ez at both walls (gpu_efield + gpu_bc,
    poisson.cu:40-69)
"""
from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from ..config import Config


def wavenumbers(cfg: Config, dtype=np.float64):
    """kx, ky (true spectral) and kz (extended domain) tables
    (reference main.cu:118-152)."""
    g = cfg.grid
    two_pi = 2.0 * np.pi
    kx = two_pi * np.fft.fftfreq(g.nx, d=g.dx).astype(dtype)
    ky = two_pi * np.fft.fftfreq(g.ny, d=g.dy).astype(dtype)
    kz = two_pi * np.fft.fftfreq(g.ne, d=g.dz).astype(dtype)
    return kx, ky, kz


def minus_laplacian_symbol(cfg: Config, dtype=np.float64):
    """mu(kz, ky, kx) on the extended grid, zero mode pinned to 1."""
    g = cfg.grid
    kx, ky, kz = wavenumbers(cfg, dtype)
    # (NE, NY, NX) via broadcasting
    mu = (
        ((4.0 / g.dz**2) * np.sin(kz * g.dz * 0.5) ** 2)[:, None, None]
        + (ky * ky)[None, :, None]
        + (kx * kx)[None, None, :]
    )
    mu[0, 0, 0] = 1.0
    return mu


def charge_rhs(cfg: Config, charge, chargen):
    """Charge RHS rows z = 1..NZ-2, -kappa (c+ - c-) (no plate folds)."""
    p = cfg.physics
    dtype = charge.dtype
    kappa = dtype.type(p.convert_c_to_charge / p.eps)
    return -kappa * (charge[1:-1] - chargen[1:-1])


def odd_extension(cfg: Config, rhs):
    """The odd-extended RHS (NE, NY, NX) from the charge RHS rows
    z = 1..NZ-2, with the Dirichlet plate potentials folded into rows 1
    and NZ-2 as -voltage/dz^2 (poisson.cu:114-158)."""
    p = cfg.physics
    g = cfg.grid
    dtype = rhs.dtype
    inv_dz2 = dtype.type(1.0 / (g.dz * g.dz))
    plane = jnp.zeros_like(rhs[0])
    top = jnp.concatenate(
        [
            plane[None],                                       # z = 0
            (rhs[0] - dtype.type(p.voltage) * inv_dz2)[None],  # z = 1
            rhs[1:-1],                                         # interior
            (rhs[-1] - dtype.type(p.voltage2) * inv_dz2)[None],  # z = NZ-2
            plane[None],                                       # z = NZ-1
        ],
        axis=0,
    )
    # mirror half: z in (NZ-1, NE) gets -top[NE - z]  (poisson.cu:143-157)
    mirror = -top[g.nz - 2 : 0 : -1]
    return jnp.concatenate([top, mirror], axis=0)


def _scaled_inv_symbol(cfg: Config, dtype, extra_scale: float):
    """-extra_scale / mu as three broadcastable 1-D factors combined inside
    the jit — XLA fuses the broadcasts into the consuming multiply, so the
    full-volume symbol never exists in device memory (unlike the
    reference's precomputed kx/ky/kz device tables, main.cu:118-152)."""
    g = cfg.grid
    kx, ky, _ = wavenumbers(cfg, np.float64)
    m = np.arange(1, g.nz - 1, dtype=np.float64)
    sz = (4.0 / g.dz**2) * np.sin(np.pi * m / g.ne) ** 2
    sz_j = jnp.asarray(sz, dtype)[:, None, None]
    ky2 = jnp.asarray(ky * ky, dtype)[None, :, None]
    kx2 = jnp.asarray(kx * kx, dtype)[None, None, :]
    return dtype.type(-extra_scale) / (sz_j + ky2 + kx2)


def lifting_profile(cfg: Config, dtype):
    """phi_L[z] = voltage + (voltage2 - voltage) z/(NZ-1): the discrete
    z-linear function matching the plate potentials.  Its second difference
    is exactly zero, so solving for psi = phi - phi_L with HOMOGENEOUS
    Dirichlet walls needs no +-voltage/dz^2 folds in the RHS — removing the
    ~1e13-magnitude boundary terms that would otherwise cancel in f32.
    Algebraically identical to the reference's folded RHS
    (poisson.cu:118-137)."""
    p = cfg.physics
    g = cfg.grid
    z = np.arange(g.nz, dtype=np.float64)
    prof = p.voltage + (p.voltage2 - p.voltage) * z / (g.nz - 1)
    return jnp.asarray(prof, dtype)[:, None, None]


def _poisson_phi_dst(cfg: Config, rhs, mesh=None):
    """Reduced solve, all-real dense transforms: DST-I in z (NZ-2 rows, a
    quarter of the odd-extended FFT work) + real Hartley transform in x,y
    (the symbol is even in kx and ky, so Hartley filtering equals DFT
    filtering).  Mathematically identical to the reference's odd-extension
    complex FFT (poisson.cu:75-103).  The plate potentials enter through
    the z-linear lifting function, every stage is one transpose-free
    matmul at HIGHEST precision, all normalizations (inverse DST 4/NE,
    inverse Hartley 1/(NY*NX)) fold into the one spectral multiply, and
    the final z-stage emits the wall rows, overwritten with the exact
    plate values."""
    from ..parallel.fft import dst_z, dst_z_padded, hartley2_xy

    g = cfg.grid
    p = cfg.physics
    dtype = rhs.dtype
    inv_sym = _scaled_inv_symbol(cfg, dtype, 4.0 / (g.ne * g.ny * g.nx))
    spec = hartley2_xy(dst_z(rhs), mesh) * inv_sym
    phi = dst_z_padded(hartley2_xy(spec, mesh)) + lifting_profile(cfg, dtype)
    zidx = jax.lax.broadcasted_iota(jnp.int32, (g.nz, 1, 1), 0)
    phi = jnp.where(zidx == 0, dtype.type(p.voltage), phi)
    phi = jnp.where(zidx == g.nz - 1, dtype.type(p.voltage2), phi)
    return phi


def solve_method(cfg: Config) -> str:
    """"fft": the odd-extension FFT solve (the reference's own algorithm;
    the f64 oracle); "matmul": the DST/Hartley solve.  "auto" takes the
    oracle on the CPU and the matmul solve on the GPU, where it measured
    faster than cuFFT at the same accuracy (PERF.md)."""
    m = cfg.run.fft_method
    if m in ("fft", "matmul"):
        return m
    if m != "auto":
        raise ValueError(f"unknown fft_method {m!r} (auto|fft|matmul)")
    return "fft" if jax.default_backend() == "cpu" else "matmul"


def poisson_phi_from_rhs(cfg: Config, rhs, mesh=None):
    """phi from the charge RHS rows z = 1..NZ-2 (`charge_rhs`, or the
    fused kernel's emitted RHS, pallas/push_step.py)."""
    if solve_method(cfg) == "fft":
        return _poisson_phi_ext(cfg, rhs, mesh)
    return _poisson_phi_dst(cfg, rhs, mesh)


def poisson_phi(cfg: Config, charge, chargen, mesh=None):
    """One potential solve, phi only (E is the exact gradient of phi and is
    derived where consumed — in-kernel on the kernel path, `efield` on the
    jnp path)."""
    return poisson_phi_from_rhs(cfg, charge_rhs(cfg, charge, chargen), mesh)


def poisson_solve(cfg: Config, charge, chargen, mesh=None):
    """(phi, E) convenience wrapper around poisson_phi + efield."""
    phi = poisson_phi(cfg, charge, chargen, mesh)
    return phi, efield(cfg, phi)


def _poisson_phi_ext(cfg: Config, rhs, mesh=None):
    """The reference's solve: odd extension, 3D FFT, spectral divide,
    inverse FFT, extraction.  With a mesh, the 3D transform runs as a
    distributed pencil FFT (parallel/fft.py) with all-to-all
    repartitions between 1D stages."""
    from ..parallel.fft import fft3

    g = cfg.grid
    p = cfg.physics
    dtype = rhs.dtype

    ext = odd_extension(cfg, rhs)
    mu = jnp.asarray(minus_laplacian_symbol(cfg, np.float64), dtype)

    method = "fft" if cfg.run.fft_method == "fft" else None
    spec = fft3(ext, mesh, method=method)
    spec = spec / (-mu)
    # The DC mode of the odd-extended RHS is exactly zero by symmetry; the
    # reference relies on that cancellation (pinning mu(0,0,0)=1 and passing
    # the coefficient through, poisson.cu:177).  In f32 the +-voltage/dz^2
    # boundary terms (~5e13) leave O(1e7) summation noise in the DC bin,
    # which mu=1 would turn into an O(100) constant offset in phi — so zero
    # it explicitly (mathematically identical, numerically stable).
    spec = spec.at[0, 0, 0].set(0.0)
    phi_ext = fft3(spec, mesh, inverse=True, method=method)

    phi = jnp.real(phi_ext[: g.nz]).astype(dtype)
    phi = phi.at[0].set(dtype.type(p.voltage))
    phi = phi.at[-1].set(dtype.type(p.voltage2))
    return phi


def efield(cfg: Config, phi):
    """E = -grad(phi), centered differences with periodic wrap
    (poisson.cu:40-56), then one-sided Ez copy at the walls (poisson.cu:57-69).
    """
    g = cfg.grid
    dtype = phi.dtype

    def grad(axis, d):
        return (jnp.roll(phi, 1, axis) - jnp.roll(phi, -1, axis)) * dtype.type(0.5 / d)

    Ex = grad(2, g.dx)
    Ey = grad(1, g.dy)
    Ez = grad(0, g.dz)
    Ez = Ez.at[0].set(Ez[1])
    Ez = Ez.at[-1].set(Ez[-2])
    return jnp.stack([Ex, Ey, Ez])
