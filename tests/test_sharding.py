"""Distributed tests on the virtual 8-device CPU mesh (SURVEY.md §4.4).

Single-chip vs N-chip equality: identical initial state stepped on one
device and on a slab/pencil mesh must agree to f64 roundoff (reduction
order may differ inside collectives)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ekpnp import preset
from ekpnp.init import initialize
from ekpnp.parallel import mesh as pmesh
from ekpnp.step import step


@pytest.mark.parametrize("pencil", [False, True])
def test_single_vs_multichip_equality(eight_devices, pencil):
    cfg = preset("reference", nx=16, ny=8, nz=17, fft_method="matmul")
    state, _ = initialize(cfg)

    # single device, 3 steps (same spectral backend as the sharded run)
    s1 = state
    for _ in range(3):
        s1, m1 = step(cfg, s1)

    # 8 virtual devices, same program
    m = pmesh.make_mesh(eight_devices, pencil=pencil)
    sharded = pmesh.shard_state(cfg, m, state)
    step_fn = pmesh.make_sharded_step(cfg, m)
    s8 = sharded
    for _ in range(3):
        s8, m8 = step_fn(s8)

    tols = dict(atol=1e-14, rtol=1e-12)
    for a, b, name in [
        (s1.f, s8.f, "f"),
        (s1.h, s8.h, "h"),
        (s1.hn, s8.hn, "hn"),
        (s1.g, s8.g, "g"),
        (s1.phi, s8.phi, "phi"),
    ]:
        np.testing.assert_allclose(
            np.asarray(a),
            np.asarray(b),
            err_msg=name,
            **tols,
        )


def test_sharded_multi_step_runs(eight_devices):
    cfg = preset("reference", nx=16, ny=8, nz=17)
    state, _ = initialize(cfg)
    m = pmesh.make_mesh(eight_devices)
    sharded = pmesh.shard_state(cfg, m, state)
    run = pmesh.make_sharded_multi_step(cfg, m, 5)
    out = run(sharded)
    assert np.isfinite(np.asarray(out.f)).all()


def test_indivisible_mesh_rejected(eight_devices):
    cfg = preset("reference", nx=16, ny=12, nz=17)
    m = pmesh.make_mesh(eight_devices)
    state, _ = initialize(cfg)
    with pytest.raises(ValueError, match="not divisible"):
        pmesh.shard_state(cfg, m, state)


def _oracle(cfg, state, steps):
    for _ in range(steps):
        state, _ = step(cfg, state)
    return state


def _assert_state_close(a, b, names=("f", "h", "hn", "g", "phi")):
    for name in names:
        x, y = getattr(a, name), getattr(b, name)
        if x is None:
            assert y is None, name
            continue
        np.testing.assert_allclose(
            np.asarray(y), np.asarray(x), rtol=1e-11,
            atol=1e-13 * float(jnp.max(jnp.abs(x))), err_msg=name)


def _halo_vs_oracle(cfg, devices, perturbed, steps=2):
    """The kernel per y-shard (parallel/halo.py, interpret mode) through
    the multi-step chunk (jit + scan + donation + stable shardings) must
    equal the single-device jnp oracle."""
    from ekpnp.parallel import halo as phalo

    state = perturbed(cfg, seed=1)
    ref = _oracle(cfg, state, steps)   # before the sharded run donates
    m = pmesh.make_mesh(devices, pencil=False)
    assert phalo.supports_halo_step(cfg, m)
    run = phalo.make_halo_multi_step(cfg, m, steps, interpret=True)
    out = run(pmesh.shard_state(cfg, m, state))
    _assert_state_close(ref, out)


def test_halo_shardmap_matches_single_pallas(eight_devices, perturbed):
    cfg = preset("reference", nx=16, ny=8, nz=9)
    _halo_vs_oracle(cfg, eight_devices[:4], perturbed)


def test_halo_shardmap_injection_bc(eight_devices, perturbed):
    """Charge-injection Dirichlet BC (reference LBM.cu:2231-2292): the wall
    anti-bounce-back happens per shard inside the kernel."""
    cfg = preset("reference", nx=16, ny=8, nz=9, scalar_lattice="D3Q7",
                 charge_bc="injection")
    _halo_vs_oracle(cfg, eight_devices[:4], perturbed)


def test_halo_shardmap_d3q7_scalars(eight_devices, perturbed):
    """Mixed per-field lattices (D3Q27 fluid + D3Q7 scalars): the exchanged
    halo rows have per-field direction counts."""
    cfg = preset("reference", nx=16, ny=16, nz=9, scalar_lattice="D3Q7")
    _halo_vs_oracle(cfg, eight_devices[:4], perturbed)


def test_halo_shardmap_single_species(eight_devices, perturbed):
    """Single-species layout: the inactive hn field is absent from the
    exchanged pytree."""
    cfg = preset("ek-channel", nx=16, ny=8, nz=9, scalar_lattice="D3Q7")
    _halo_vs_oracle(cfg, eight_devices[:2], perturbed)


def test_halo_shardmap_zerograd_top(eight_devices, perturbed):
    cfg = preset("reference", nx=16, ny=8, nz=9, scalar_lattice="D3Q7",
                 charge_bc="zerograd-top")
    _halo_vs_oracle(cfg, eight_devices[:4], perturbed)


def test_halo_shardmap_fluid_moving_wall(eight_devices, perturbed):
    cfg = preset("reference", nx=16, ny=8, nz=9, enable_ek=False,
                 enable_thermal=False, uw=0.5)
    _halo_vs_oracle(cfg, eight_devices[:4], perturbed, steps=3)


def test_halo_multi_step_chunk_matches_single(eight_devices, perturbed):
    """Two rows per shard (the fewest the two-row phi halo allows), Joule
    heating, 3 steps — odd, so the scan's unroll-by-2 has a remainder."""
    cfg = preset("reference", nx=16, ny=16, nz=9, scalar_lattice="D3Q7",
                 joule=1.0e4)
    _halo_vs_oracle(cfg, eight_devices, perturbed, steps=3)


@pytest.mark.parametrize("mesh_shape", [(2, 2), (2, 4)])
def test_pencil_gspmd_chunk_matches_single(eight_devices, mesh_shape,
                                           perturbed):
    """Pencil meshes run the jnp step under GSPMD, through the production
    multi-step chunk, with mixed lattices and the injection BC."""
    cfg = preset("reference", nx=16, ny=8, nz=9, fft_method="matmul",
                 scalar_lattice="D3Q7", charge_bc="injection")
    state = perturbed(cfg, seed=1)
    ref = _oracle(cfg, state, 2)   # before the sharded run donates
    n = mesh_shape[0] * mesh_shape[1]
    m = pmesh.make_mesh(eight_devices[:n], pencil=True)
    assert dict(m.shape) == {"y": mesh_shape[0], "x": mesh_shape[1]}
    out = pmesh.make_sharded_multi_step(cfg, m, 2)(
        pmesh.shard_state(cfg, m, state))
    for name in ("f", "h", "hn", "g", "phi"):
        np.testing.assert_allclose(np.asarray(getattr(out, name)),
                                   np.asarray(getattr(ref, name)),
                                   rtol=1e-12, atol=1e-14, err_msg=name)


def test_sharded_checkpoint_mesh_elastic(eight_devices, tmp_path):
    """A per-shard checkpoint saved on one mesh layout restores bit-exactly
    onto a DIFFERENT layout (io/checkpoint.py load_sharded stitches each
    requested block from the overlapping saved pieces): 4-way slab ->
    (2,2) pencil -> single device."""
    from ekpnp.io.checkpoint import load_sharded, save_sharded

    cfg = preset("reference", nx=16, ny=8, nz=9, fft_method="matmul")
    state, _ = initialize(cfg)
    m4 = pmesh.make_mesh(eight_devices[:4], pencil=False)
    s4 = pmesh.shard_state(cfg, m4, state)
    ck = str(tmp_path / "elastic.ckpt")
    save_sharded(ck, cfg, s4)

    ref = {n: np.asarray(getattr(state, n)) for n in
           ("f", "h", "hn", "g", "phi")}
    for target in (pmesh.make_mesh(eight_devices[:4], pencil=True),
                   pmesh.make_mesh(eight_devices[:1])):
        back = load_sharded(ck, cfg, target)
        for name, want in ref.items():
            got = np.asarray(getattr(back, name))
            assert np.array_equal(got, want), \
                f"{name} not bit-exact restoring onto {dict(target.shape)}"
        assert float(back.t) == float(state.t)
