"""Which step path runs where, the compile-cache rule, the benchmark's peak
table, the production multi-step program on the kernel path, and the
card-only checks (marked `gpu`; they skip without an NVIDIA GPU)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ekpnp import preset
from ekpnp.parallel import mesh as pmesh
from ekpnp.step import step, step_path


@pytest.mark.parametrize("platform, nz, expect", [
    ("cpu", 9, "jnp"), ("gpu", 9, "kernel"), ("gpu", 4, "kernel"),
    ("gpu", 3, "jnp")])
def test_step_path_single_device(platform, nz, expect):
    cfg = preset("reference", nx=8, ny=8, nz=nz)
    assert step_path(cfg, platform=platform) == expect


@pytest.mark.parametrize("pencil, ny, n, expect", [
    (False, 16, 4, "kernel"),   # y-slab: the kernel per shard
    (False, 4, 4, "jnp"),       # one row per shard: no room for the phi halo
    (True, 16, 4, "jnp"),       # pencil: GSPMD over the jnp step
    (False, 16, 1, "kernel"),   # a one-device slab mesh
])
def test_step_path_on_meshes(eight_devices, pencil, ny, n, expect):
    cfg = preset("reference", nx=8, ny=ny, nz=9)
    mesh = pmesh.make_mesh(eight_devices[:n], pencil=pencil)
    assert step_path(cfg, mesh, platform="gpu") == expect
    assert step_path(cfg, mesh, platform="cpu") == "jnp"


@pytest.mark.parametrize("platform", ["rocm", "metal"])
def test_step_path_unknown_platform_raises(platform):
    with pytest.raises(RuntimeError, match="no step path"):
        step_path(preset("reference"), platform=platform)


def test_compile_cache_honours_env(monkeypatch, tmp_path):
    """With JAX_COMPILATION_CACHE_DIR set, the cache is that directory and
    nothing is set in code."""
    from ekpnp import compile_cache

    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda *a: calls.append(a))
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.enable() == str(tmp_path)
    assert calls == []


def test_compile_cache_default_in_checkout(monkeypatch):
    """Without it, the cache lands at the fixed <checkout>/.jax_cache."""
    import os

    from ekpnp import compile_cache

    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda *a: calls.append(a))
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    checkout = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    want = os.path.join(checkout, ".jax_cache")
    assert compile_cache.enable() == want
    assert calls == [("jax_compilation_cache_dir", want)]


def test_peak_table_known_and_unknown():
    from ekpnp.benchmark import peak_hbm_bandwidth

    assert peak_hbm_bandwidth("NVIDIA H100 80GB HBM3") == 3.35e12
    assert peak_hbm_bandwidth("NVIDIA H100 PCIe") == 2.0e12
    with pytest.raises(ValueError, match="no peak HBM bandwidth"):
        peak_hbm_bandwidth("cpu")


def test_coupled_byte_model():
    """560 B/node with D3Q7 scalars, 1,040 B/node all-D3Q27 (f32)."""
    from ekpnp.benchmark import coupled_bytes_per_node

    big = dict(nx=8, ny=8, nz=9, dtype="float32")
    assert coupled_bytes_per_node(
        preset("reference", scalar_lattice="D3Q7", **big)) == 560
    assert coupled_bytes_per_node(preset("reference", **big)) == 1040


def test_bench_refuses_the_cpu():
    from ekpnp.benchmark import main

    with pytest.raises(SystemExit, match="needs a GPU"):
        main(["--size", "8"])


def test_run_refuses_the_cpu_unless_asked(tmp_path):
    from ekpnp.run import main

    with pytest.raises(SystemExit, match="--platform cpu"):
        main(["run", "reference", "--steps", "2", "--outdir", str(tmp_path)])


def test_multi_step_on_kernel_path(monkeypatch, perturbed):
    """The production multi-step program (jit + scan unrolled by 2 +
    donation) with the kernel path taken, the kernel in interpret mode,
    over an odd step count, equals the step-by-step oracle."""
    import ekpnp.pallas.step as kstep
    import ekpnp.step as estep

    monkeypatch.setattr(estep, "step_path", lambda cfg, mesh=None: "kernel")
    kernel = kstep.step_kernel
    monkeypatch.setattr(
        kstep, "step_kernel",
        lambda cfg, s, mesh=None, interpret=False: kernel(cfg, s, mesh, True))
    jax.clear_caches()
    try:
        cfg = preset("ek-channel", nx=8, ny=4, nz=6, scalar_lattice="D3Q7",
                     charge_bc="injection")
        state = perturbed(cfg, seed=2)
        ref = state
        for _ in range(3):
            ref, _ = step(cfg, ref)
        out = estep.multi_step(cfg, jax.tree_util.tree_map(jnp.copy, state), 3)
    finally:
        jax.clear_caches()
    for name in ("f", "h", "phi"):
        np.testing.assert_allclose(np.asarray(getattr(out, name)),
                                   np.asarray(getattr(ref, name)),
                                   rtol=1e-11, atol=1e-15, err_msg=name)
    assert out.hn is None and out.g is None


@pytest.fixture
def gpu():
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU: JAX_PLATFORMS=cuda python -m "
                    "pytest -m gpu tests/")
    return jax.devices()[0]


@pytest.mark.gpu
@pytest.mark.parametrize("scalar_lattice", ["D3Q7", "same"])
def test_gpu_kernel_matches_jnp_step(gpu, scalar_lattice, perturbed):
    """The compiled kernel on the card against the jnp step, f32."""
    cfg = preset("reference", nx=64, ny=32, nz=33, dtype="float32",
                 scalar_lattice=scalar_lattice)
    assert step_path(cfg) == "kernel"
    from ekpnp.pallas.step import step_kernel

    state = jax.tree_util.tree_map(
        lambda a: a.astype(jnp.float32), perturbed(cfg, seed=3))
    a = step(cfg, state)[0]
    b = step_kernel(cfg, state)
    for name in ("f", "h", "hn", "g", "phi"):
        x, y = np.asarray(getattr(a, name)), np.asarray(getattr(b, name))
        assert np.max(np.abs(x - y)) <= 64 * 1.2e-7 * np.max(np.abs(x)), name
