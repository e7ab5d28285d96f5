"""Test harness: CPU backend, f64, 8 virtual devices for sharding tests.

The fake-backend strategy (SURVEY.md §4.4): XLA_FLAGS host-device-count
gives an 8-device CPU mesh so every distributed code path is exercised
without a multi-GPU host.  Must run before the first jax backend
initialization.
"""
import os

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
)

import jax

# JAX_PLATFORMS=cuda runs the `gpu`-marked tests on a card
jax.config.update("jax_platforms", os.environ.get("JAX_PLATFORMS") or "cpu")
jax.config.update("jax_enable_x64", True)

import pytest  # noqa: E402

# Tier markers (round-3 verdict item 7): file-level classification so
#   -m fast                 ~10-min gate (units, compat, golden, config, IO)
#   -m pallas               interpret-mode fused-kernel/sharding equality
#   -m physics              long physics integrations (onset brackets etc.)
# Full coverage = no -m flag (all three tiers; ~40-45 min, CLAUDE.md).
_TIER_FILES = {
    "test_pallas_fused": "pallas",
    "test_sharding": "pallas",
    "test_multihost": "pallas",
    "test_electroconvection": "physics",
    "test_rayleigh_benard": "physics",
}


def pytest_configure(config):
    config.addinivalue_line("markers", "fast: quick unit/compat tier (<10 min)")
    config.addinivalue_line(
        "markers", "pallas: interpret-mode Pallas/sharding equality tier")
    config.addinivalue_line(
        "markers", "physics: long physics-integration tier")
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU (skips elsewhere)")


def pytest_collection_modifyitems(config, items):
    for item in items:
        fname = item.nodeid.split("::")[0].rsplit("/", 1)[-1].removesuffix(".py")
        item.add_marker(getattr(pytest.mark, _TIER_FILES.get(fname, "fast")))


def perturbed_state(cfg, seed=0):
    """Cold-start state with every population (and phi) perturbed by seeded
    noise, so that a wrong direction, opposite or wrap shows up (a uniform
    PB state is symmetric in x and y)."""
    import jax.numpy as jnp
    import numpy as np

    from ekpnp.init import initialize

    state, _ = initialize(cfg)
    rng = np.random.default_rng(seed)

    def noisy(a, amp):
        if a is None:
            return None
        return a * (1 + amp * jnp.asarray(rng.standard_normal(a.shape)))

    return state._replace(f=noisy(state.f, 1e-3), h=noisy(state.h, 1e-3),
                          hn=noisy(state.hn, 1e-3), g=noisy(state.g, 1e-3),
                          phi=noisy(state.phi, 1e-2))


@pytest.fixture(scope="session")
def perturbed():
    return perturbed_state


@pytest.fixture(scope="session")
def eight_devices():
    devs = jax.devices("cpu")
    if len(devs) < 8:
        pytest.skip("need 8 virtual CPU devices")
    return devs[:8]


@pytest.fixture(autouse=True)
def _bound_xla_cpu_accumulation(request):
    """Free compiled executables after each interpret-heavy Pallas test.

    One process accumulating ~30+ large interpret-mode kernel compiles
    reproducibly segfaults the XLA CPU compiler on the NEXT compile
    (observed twice at the same position in full-file runs of
    test_pallas_fused; every subset run passes).  Dropping the executable
    caches between these tests keeps the process under the threshold;
    each test compiles its own configs anyway, so nothing shared is
    lost."""
    yield
    if "pallas" in request.node.nodeid or "sharding" in request.node.nodeid:
        jax.clear_caches()
