"""Fused GPU kernel (pallas/push_step.py) vs the jnp oracle, in Pallas
interpret mode on the CPU, f64.

The jnp path is the validated correctness oracle (analytic physics tests);
the kernel must reproduce it up to op-reordering round-off, from states
perturbed per population (conftest.perturbed_state).
"""
import jax.numpy as jnp
import numpy as np
import pytest

from ekpnp import preset
from ekpnp.pallas import push_step
from ekpnp.pallas.step import step_kernel
from ekpnp.step import step


def compare_kernel(cfg, perturbed, steps=2):
    s_ref = s_ker = perturbed(cfg)
    for _ in range(steps):
        s_ref, _ = step(cfg, s_ref)
        s_ker = step_kernel(cfg, s_ker, interpret=True)
    for name in ("f", "h", "hn", "g", "phi"):
        a, b = getattr(s_ref, name), getattr(s_ker, name)
        if a is None:
            assert b is None, name
            continue
        np.testing.assert_allclose(np.asarray(b), np.asarray(a), rtol=1e-11,
                                   atol=1e-13 * float(jnp.max(jnp.abs(a))),
                                   err_msg=name)
    assert float(s_ker.t) == float(s_ref.t)


_SMALL = dict(nx=16, ny=8, nz=9)
_CASES = {
    # (preset, overrides, steps)
    "full_coupled": ("reference", dict(_SMALL), 2),
    "full_coupled_longer_run": ("reference", dict(_SMALL, scalar_lattice="D3Q7"), 6),
    "fluid_only": ("reference", dict(_SMALL, enable_ek=False,
                                     enable_thermal=False, exf=1.0e6), 3),
    "fluid_thermal": ("reference", dict(_SMALL, enable_ek=False,
                                        scalar_lattice="D3Q7"), 3),
    "moving_wall": ("reference", dict(_SMALL, enable_ek=False,
                                      enable_thermal=False, uw=0.5), 3),
    "moving_wall_reference_multis": (
        "reference", dict(_SMALL, enable_ek=False, enable_thermal=False,
                          uw=0.5, compat_ref_multis=True), 2),
    "fluid_only_d3q19": ("poiseuille", dict(nx=16, ny=16, nz=9, exf=1e9), 2),
    "two_species_no_thermal": ("ek-pnp", dict(_SMALL, scalar_lattice="D3Q7"), 2),
    "single_species": ("ek-channel", dict(_SMALL, scalar_lattice="D3Q7"), 2),
    "d3q7_scalars": ("reference", dict(_SMALL, scalar_lattice="D3Q7"), 3),
    "d3q19_scalars": ("reference", dict(_SMALL, scalar_lattice="D3Q19"), 2),
    "d3q7_single_species_joule": ("ek-channel", dict(
        _SMALL, scalar_lattice="D3Q7", joule=1.0e4), 2),
    "joule_heating": ("reference", dict(_SMALL, scalar_lattice="D3Q7",
                                        joule=1.0e4), 3),
    "injection_bc": ("reference", dict(_SMALL, charge_bc="injection"), 2),
    "injection_bc_single_species_d3q7": ("ek-channel", dict(
        _SMALL, scalar_lattice="D3Q7", charge_bc="injection"), 3),
    "zerograd_top_bc": ("reference", dict(_SMALL, charge_bc="zerograd-top"), 2),
    "zerograd_top_d3q7": ("reference", dict(
        _SMALL, scalar_lattice="D3Q7", charge_bc="zerograd-top"), 3),
    "zerograd_top_single_species": ("ek-channel", dict(
        _SMALL, scalar_lattice="D3Q7", charge_bc="zerograd-top"), 2),
    "non_power_of_two_grid": ("reference", dict(
        nx=12, ny=5, nz=7, scalar_lattice="D3Q7"), 2),
    "fewest_z_rows": ("reference", dict(nx=8, ny=4, nz=4,
                                        scalar_lattice="D3Q7"), 2),
    "dirichlet_plates_differ": ("reference", dict(
        _SMALL, scalar_lattice="D3Q7", voltage2=2.0e-3), 2),
}


@pytest.mark.parametrize("case", sorted(_CASES))
def test_fused_kernel_matches_oracle(case, perturbed):
    name, overrides, steps = _CASES[case]
    compare_kernel(preset(name, **overrides), perturbed, steps)


def test_fused_reference_width(perturbed):
    """The reference's own 50 x 8 x 51 grid (LBM.h:32-36): 50 is no power
    of two, so the x tile carries masked lanes."""
    compare_kernel(preset("reference", scalar_lattice="D3Q7"), perturbed,
                   steps=1)


def test_fused_multi_tile_x(monkeypatch, perturbed):
    """Rows wider than one x tile: 20 nodes over 8-wide tiles — two full
    tiles plus a masked tail, with the periodic x wrap crossing tiles."""
    monkeypatch.setattr(push_step, "_BX", 8)
    push_step.build_push_step.cache_clear()
    try:
        compare_kernel(preset("reference", nx=20, ny=4, nz=6,
                              scalar_lattice="D3Q7"), perturbed, steps=2)
    finally:
        push_step.build_push_step.cache_clear()


def test_fused_rejects_too_few_z_rows():
    with pytest.raises(ValueError, match="nz=3"):
        push_step.build_push_step(preset("reference", nx=8, ny=4, nz=3),
                                  "float64", interpret=True)
