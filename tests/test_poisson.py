"""Spectral Poisson solver verification (SURVEY.md §4.1-4.2).

The solver inverts the mixed discrete Laplacian: exact spectral in x,y and
2nd-order finite differences in z, with Dirichlet plates phi = voltage /
voltage2 folded into the RHS (reference poisson.cu:114-180).  We verify by
applying exactly that forward operator to the solution.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ekpnp import preset
from ekpnp.ops.pbe import pb_init
from ekpnp.ops.poisson import efield, poisson_solve


def forward_operator(cfg, phi):
    """FD Laplacian in z (interior rows), exact spectral Laplacian in x,y."""
    g = cfg.grid
    # spectral d2/dx2 + d2/dy2 via FFT of each z-plane
    kx = 2 * np.pi * np.fft.fftfreq(g.nx, d=g.dx)
    ky = 2 * np.pi * np.fft.fftfreq(g.ny, d=g.dy)
    k2 = (ky * ky)[:, None] + (kx * kx)[None, :]
    spec = np.fft.fftn(np.asarray(phi), axes=(1, 2))
    lap_xy = np.real(np.fft.ifftn(-k2[None] * spec, axes=(1, 2)))
    lap_z = np.zeros_like(lap_xy)
    p = np.asarray(phi)
    lap_z[1:-1] = (p[2:] - 2 * p[1:-1] + p[:-2]) / g.dz**2
    return lap_xy + lap_z


def test_manufactured_solution():
    cfg = preset("reference")
    g = cfg.grid
    p = cfg.physics
    rng = np.random.default_rng(0)
    charge = jnp.asarray(0.01 * (1 + 0.5 * rng.normal(size=g.shape)))
    chargen = jnp.asarray(0.01 * (1 + 0.5 * rng.normal(size=g.shape)))
    phi, E = poisson_solve(cfg, charge, chargen)

    # walls pinned exactly
    np.testing.assert_allclose(np.asarray(phi[0]), p.voltage, rtol=0, atol=1e-15)
    np.testing.assert_allclose(np.asarray(phi[-1]), p.voltage2, rtol=0, atol=1e-15)

    # interior satisfies the discrete equation lap(phi) = -kappa (c+ - c-)
    rhs = -(p.convert_c_to_charge / p.eps) * np.asarray(charge - chargen)
    lap = forward_operator(cfg, phi)
    scale = np.abs(rhs[1:-1]).max()
    np.testing.assert_allclose(lap[1:-1], rhs[1:-1], atol=1e-6 * scale)


def test_zero_charge_gives_uniform_potential():
    """With c+ = c- and equal plate voltages, phi = voltage everywhere."""
    cfg = preset("reference")
    c = jnp.full(cfg.grid.shape, 0.01)
    phi, E = poisson_solve(cfg, c, c)
    np.testing.assert_allclose(np.asarray(phi), cfg.physics.voltage, atol=1e-12)
    np.testing.assert_allclose(np.asarray(E), 0.0, atol=1e-6)


def test_efield_of_known_potential():
    cfg = preset("reference")
    g = cfg.grid
    x = np.arange(g.nx) * g.dx
    y = np.arange(g.ny) * g.dy
    z = np.arange(g.nz) * g.dz
    kx = 2 * np.pi / g.lx
    ky = 2 * np.pi / g.ly
    phi = np.sin(kx * x)[None, None, :] * np.cos(ky * y)[None, :, None] + 0 * z[:, None, None]
    E = np.asarray(efield(cfg, jnp.asarray(phi)))
    # centered-difference derivative of a sine: sin(k dx)/dx factor
    kx_eff = np.sin(kx * g.dx) / g.dx
    expect_Ex = -kx_eff * np.cos(kx * x)[None, None, :] * np.cos(ky * y)[None, :, None]
    np.testing.assert_allclose(E[0], np.broadcast_to(expect_Ex, phi.shape), atol=1e-8 * kx_eff)
    # Ez wall copy (poisson.cu:57-69)
    np.testing.assert_allclose(E[2][0], E[2][1], atol=0)
    np.testing.assert_allclose(E[2][-1], E[2][-2], atol=0)


def test_debye_huckel_double_layer():
    """PB init at low zeta matches the linearized (Debye-Hueckel) profile
    phi(z) = zeta cosh(kappa (z - L/2)) / cosh(kappa L/2)  (SURVEY.md §4.2)."""
    zeta = -1e-4  # |e zeta / kB T| ~ 4e-3 -> linear regime
    cfg = preset("reference", voltage=zeta, voltage2=zeta, pb_iters=2001)
    g, p = cfg.grid, cfg.physics
    phi0 = jnp.full(g.shape, zeta)
    phi, c, cn, E = jax.jit(pb_init, static_argnums=0)(cfg, phi0)
    prof = np.asarray(phi).mean(axis=(1, 2))

    kappa2 = 2.0 * p.convert_c_to_charge * p.chargeinf * p.electron / (
        p.kB * p.roomT * p.eps
    )
    kappa = np.sqrt(kappa2)
    L = g.lz
    z = np.arange(g.nz) * g.dz
    analytic = zeta * np.cosh(kappa * (z - L / 2)) / np.cosh(kappa * L / 2)
    np.testing.assert_allclose(prof, analytic, rtol=0, atol=2e-2 * abs(zeta))


def test_dst_hartley_matches_odd_extension_oracle():
    """The reduced all-real solve (DST-I in z + Hartley in x,y) must equal
    the reference-shaped odd-extension complex-FFT solve to roundoff."""
    from ekpnp.ops.poisson import (_poisson_phi_dst, _poisson_phi_ext,
                                   charge_rhs, efield)

    rng = np.random.default_rng(3)
    c = jnp.asarray(rng.random((9, 8, 16)))
    cn = jnp.asarray(rng.random((9, 8, 16)))
    cfg = preset("reference", nx=16, ny=8, nz=9)
    rhs = charge_rhs(cfg, c, cn)
    phi_h = _poisson_phi_dst(cfg, rhs)              # hartley (matmul) path
    phi_e = _poisson_phi_ext(cfg, rhs)              # odd-extension oracle
    E_h, E_e = efield(cfg, phi_h), efield(cfg, phi_e)
    scale = float(jnp.max(jnp.abs(phi_e)))
    np.testing.assert_allclose(np.asarray(phi_h), np.asarray(phi_e), atol=1e-14 * max(scale, 1))
    np.testing.assert_allclose(np.asarray(E_h), np.asarray(E_e), atol=1e-6)


@pytest.mark.parametrize("fft_method, expect", [
    ("auto", "fft"), ("fft", "fft"), ("matmul", "matmul")])
def test_solve_method_dispatch(fft_method, expect):
    """One solve per config on every path: `auto` is the odd-extension
    oracle on the CPU; the step's kernel path (poisson_phi_from_rhs) and
    the jnp path (poisson_phi) take the same solve."""
    from ekpnp.ops.poisson import (charge_rhs, poisson_phi,
                                   poisson_phi_from_rhs, solve_method)

    cfg = preset("reference", nx=16, ny=8, nz=9, fft_method=fft_method)
    assert solve_method(cfg) == expect
    rng = np.random.default_rng(4)
    c = jnp.asarray(rng.random((9, 8, 16)))
    cn = jnp.asarray(rng.random((9, 8, 16)))
    np.testing.assert_array_equal(
        np.asarray(poisson_phi_from_rhs(cfg, charge_rhs(cfg, c, cn))),
        np.asarray(poisson_phi(cfg, c, cn)))


def test_solve_method_rejects_unknown():
    from ekpnp.ops.poisson import solve_method

    with pytest.raises(ValueError, match="fft_method"):
        solve_method(preset("reference", fft_method="dct"))
