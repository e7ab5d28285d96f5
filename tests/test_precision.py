"""f32-vs-f64 precision envelope of the coupled step (round-4 verdict
item 8; SURVEY.md §2.5 precision-policy row).

The GPU production path runs f32 while the reference is all-double
(LBM.cu), so the f32 envelope is a first-class spec: these tests turn
the committed 1000-step observation (benchmarks/runs/README.md — current
6e-5 rel, umax ~9% low at the f32 resolution floor) into a regression
guard.  A lost compensation in the kernel or a precision regression in
the solve would widen these deltas and fail here.  The quantitative
table lives in PARITY.md ("precision envelope").

Measured at 200 steps of the reference config (CPU, jnp oracle path —
the GPU kernel equals it to 1e-11, test_pallas_fused.py):
    current:  2.0e-5 rel        umax_uz: 7.5e-7 abs (~14% rel: u ~ 5e-6
    mean T:   1.2e-4 rel        sits on the f32 floor near rho0=1000)
"""
import jax
import numpy as np
import pytest

from ekpnp import preset
from ekpnp.diagnostics import series_point
from ekpnp.init import initialize
from ekpnp.step import multi_step

NSTEPS = 200


@pytest.fixture(scope="module")
def envelope():
    out = {}
    for dt in ("float64", "float32"):
        cfg = preset("reference", dtype=dt)
        state, _ = initialize(cfg)
        state = multi_step(cfg, state, NSTEPS)
        um, umag, cur, mt, finite = (
            float(x) for x in jax.device_get(series_point(cfg, state)))
        assert finite
        out[dt] = dict(umax=um, umag=umag, current=cur, mean_t=mt)
    return out


def test_f32_current_within_envelope(envelope):
    """Ionic current is the integral observable the reference prints
    every cadence (LBM.cu:2718-2746): f32 must track f64 to ~1e-4."""
    a, b = envelope["float64"], envelope["float32"]
    rel = abs(a["current"] - b["current"]) / abs(a["current"])
    assert rel < 1e-4, f"current rel diff {rel:.2e} out of f32 envelope"


def test_f32_umax_at_resolution_floor(envelope):
    """Velocity extrema sit at the f32 resolution floor (~1e-6 absolute
    at u ~ 5e-6 near rho0 = 1000 arithmetic): the ABSOLUTE deviation is
    bounded even though the relative one is ~14%."""
    a, b = envelope["float64"], envelope["float32"]
    adiff = abs(a["umax"] - b["umax"])
    assert adiff < 2e-6, f"umax abs diff {adiff:.2e} above the f32 floor"
    assert abs(a["umax"] - b["umax"]) / abs(a["umax"]) < 0.25


def test_f32_mean_temperature_within_envelope(envelope):
    a, b = envelope["float64"], envelope["float32"]
    rel = abs(a["mean_t"] - b["mean_t"]) / abs(a["mean_t"])
    assert rel < 5e-4, f"mean T rel diff {rel:.2e} out of f32 envelope"


def test_f64_resolves_subfloor_transverse_flow(envelope):
    """Documents WHY f64 is the parity datum: the double layer drives
    ~1.6e-5 transverse flow that f64 resolves (|u|max >> max uz) while
    f32 flushes it below its floor (|u|max ~= max uz).  If this gap ever
    closes the envelope table in PARITY.md is stale."""
    a, b = envelope["float64"], envelope["float32"]
    assert a["umag"] > 2 * a["umax"]
    assert b["umag"] < 1.5 * b["umax"]
