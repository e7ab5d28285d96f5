"""Reference bit-parity compatibility switches (round-2 verdict item 5).

Two catalogued reference quirks (SURVEY.md §7.4) are reproducible on demand:
  - the moving-wall `multis` term added to direction 3 (+y) at the upper
    plate despite e_3x = 0 (reference LBM.cu:1904),
  - the `i % N == 1` save/diagnostic cadence (reference main.cu:206,211).
Both default OFF; `--set compat=reference` enables both.
"""
import jax.numpy as jnp
import numpy as np

from ekpnp import preset
from ekpnp.ops.boundary import bounce_back_walls
from ekpnp.run import _next_multiple


def test_compat_flag_expansion():
    cfg = preset("reference", compat="reference")
    assert cfg.physics.compat_ref_multis
    assert cfg.run.compat_cadence
    cfg = preset("reference")
    assert not cfg.physics.compat_ref_multis
    assert not cfg.run.compat_cadence


def test_compat_multis_upper_plate_direction3():
    """compat on vs off differs ONLY in direction 3 at z = NZ-1, by exactly
    2 rho0 uw w_3 / (cs^2 CFL) (reference LBM.cu:1896,1904)."""
    uw = 0.37
    base = dict(nx=6, ny=4, nz=5, uw=uw, enable_ek=False,
                enable_thermal=False)
    cfg_std = preset("reference", **base)
    cfg_cmp = preset("reference", **base, compat_ref_multis=True)
    lat = cfg_std.lattice

    rng = np.random.default_rng(0)
    f_pre = jnp.asarray(rng.random((lat.Q,) + cfg_std.grid.shape))
    f_post = jnp.asarray(rng.random((lat.Q,) + cfg_std.grid.shape))

    out_std = np.asarray(bounce_back_walls(cfg_std, f_post, f_pre))
    out_cmp = np.asarray(bounce_back_walls(cfg_cmp, f_post, f_pre))

    multis = 2.0 * cfg_std.physics.rho0 * uw / cfg_std.cs2 \
        / cfg_std.physics.cfl * float(lat.W[3])
    diff = out_cmp - out_std
    np.testing.assert_allclose(diff[3, -1], multis, rtol=1e-12)
    diff[3, -1] = 0.0
    assert np.all(diff == 0.0), "compat flag leaked outside direction 3 wall row"


def test_compat_multis_identical_at_rest_wall():
    """uw = 0 (the reference default): compat flag is a strict no-op."""
    base = dict(nx=6, ny=4, nz=5, enable_ek=False, enable_thermal=False)
    cfg_std = preset("reference", **base)
    cfg_cmp = preset("reference", **base, compat_ref_multis=True)
    rng = np.random.default_rng(1)
    f_pre = jnp.asarray(rng.random((27,) + cfg_std.grid.shape))
    f_post = jnp.asarray(rng.random((27,) + cfg_std.grid.shape))
    np.testing.assert_array_equal(
        np.asarray(bounce_back_walls(cfg_std, f_post, f_pre)),
        np.asarray(bounce_back_walls(cfg_cmp, f_post, f_pre)),
    )


def test_compat_multis_fused_kernel_matches_oracle():
    """The fused kernel honors the quirk identically (interpret mode)."""
    from ekpnp.init import initialize
    from ekpnp.pallas.step import step_kernel
    from ekpnp.step import step

    cfg = preset("reference", nx=16, ny=8, nz=9, uw=0.5,
                 enable_ek=False, enable_thermal=False,
                 compat_ref_multis=True)
    state, _ = initialize(cfg)
    s_ref, s_pal = state, state
    for _ in range(3):
        s_ref, _ = step(cfg, s_ref)
        s_pal = step_kernel(cfg, s_pal, interpret=True)
    np.testing.assert_allclose(
        np.asarray(s_ref.f), np.asarray(s_pal.f), rtol=1e-11, atol=1e-13)


def _events(nsteps, n, off):
    out, d = [], 0
    while d < nsteps:
        d = _next_multiple(d, n, off)
        if d > nsteps:
            break
        if d % n == off:
            out.append(d)
    return out


def test_compat_cadence_schedule():
    """Reference fires after iteration i when i % N == 1 -> after 2, N+2,
    2N+2, ... completed steps (main.cu:206,211)."""
    # reference defaults: NSTEPS=1000, NSAVE=500, printCurrent=50
    assert _events(1000, 500, 2 % 500) == [2, 502]
    assert _events(1000, 50, 2 % 50) == [2 + 50 * k for k in range(20)]
    # default (non-compat) schedule unchanged
    assert _events(1000, 500, 0) == [500, 1000]
    assert _events(1000, 50, 0) == [50 * k for k in range(1, 21)]
