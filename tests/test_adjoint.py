"""End-to-end differentiability of the coupled solver (a capability the
CUDA reference does not have: it has no adjoint path at all).

The whole step chain (TRT collide -> wall BCs -> stream -> scalar BCs ->
spectral Poisson solve) is pure jnp, so `jax.grad` delivers exact adjoint
sensitivities through the full electro-thermo-hydrodynamic coupling.
Validated here against central finite differences in f64.
"""
import jax
import jax.numpy as jnp
import numpy as np

from ekpnp import preset
from ekpnp.init import state_from_macro
from ekpnp.state import Macro
from ekpnp.step import step

NSTEPS = 3


def _cfg():
    return preset("reference", nx=8, ny=4, nz=9, dtype="float64")


def _loss_fn(cfg):
    shape = cfg.grid.shape
    dtype = jnp.float64

    def loss(charge0):
        macro = Macro(
            rho=jnp.full(shape, 1000.0, dtype),
            u=jnp.zeros((3,) + shape, dtype),
            charge=charge0,
            chargen=jnp.full(shape, 0.01, dtype),
            temp=jnp.full(shape, 0.5, dtype),
        )
        state = state_from_macro(
            cfg, macro, jnp.zeros(shape, dtype), jnp.zeros((3,) + shape, dtype), 0.0
        )
        macro_out = None
        for _ in range(NSTEPS):
            state, macro_out = step(cfg, state)
        # an observable touching both the flow (via Coulomb forcing) and
        # the transported charge: kinetic energy + charge second moment
        return jnp.sum(macro_out.u**2) * 1e6 + jnp.sum(macro_out.charge**2)

    return loss


def test_grad_through_coupled_steps_matches_finite_difference():
    cfg = _cfg()
    shape = cfg.grid.shape
    rng = np.random.default_rng(0)
    charge0 = jnp.asarray(0.01 + 1e-3 * rng.standard_normal(shape))
    direction = jnp.asarray(rng.standard_normal(shape))
    direction = direction / jnp.linalg.norm(direction)

    loss = jax.jit(_loss_fn(cfg))
    val, grad = jax.value_and_grad(loss)(charge0)
    assert np.isfinite(float(val))
    assert np.isfinite(np.asarray(grad)).all()

    # directional derivative vs central finite difference
    eps = 1e-6
    fd = (float(loss(charge0 + eps * direction))
          - float(loss(charge0 - eps * direction))) / (2 * eps)
    ad = float(jnp.vdot(grad, direction))
    assert abs(ad - fd) <= 1e-5 * max(1.0, abs(fd)), (ad, fd)


def test_grad_through_pallas_fast_path_matches_oracle():
    """Production-path differentiability: step_kernel_diff is the fused
    GPU kernel forward (interpret mode here) with a custom_vjp whose
    backward runs the jnp-oracle adjoint.  Its jax.grad must equal the
    pure-jnp chain's grad (the two forwards agree to ~1e-11, so the
    adjoints do too)."""
    from ekpnp.ops.collide import compute_macro
    from ekpnp.pallas.step import step_kernel_diff

    cfg = preset("reference", nx=16, ny=8, nz=9, dtype="float64",
                 fft_method="matmul")
    shape = cfg.grid.shape
    dtype = jnp.float64
    rng = np.random.default_rng(3)
    charge0 = jnp.asarray(0.01 + 1e-3 * rng.standard_normal(shape))

    def make_loss(pallas):
        def loss(c0):
            macro = Macro(
                rho=jnp.full(shape, 1000.0, dtype),
                u=jnp.zeros((3,) + shape, dtype),
                charge=c0,
                chargen=jnp.full(shape, 0.01, dtype),
                temp=jnp.full(shape, 0.5, dtype),
            )
            state = state_from_macro(
                cfg, macro, jnp.zeros(shape, dtype),
                jnp.zeros((3,) + shape, dtype), 0.0)
            for _ in range(2):
                if pallas:
                    state = step_kernel_diff(cfg, state, None, True)
                else:
                    state, _ = step(cfg, state)
            macro_out, _ = compute_macro(cfg, state)
            return (jnp.sum(macro_out.u ** 2) * 1e6
                    + jnp.sum(macro_out.charge ** 2))

        return loss

    val_p, grad_p = jax.value_and_grad(make_loss(True))(charge0)
    val_o, grad_o = jax.value_and_grad(make_loss(False))(charge0)
    assert np.isclose(float(val_p), float(val_o), rtol=1e-10)
    g_p, g_o = np.asarray(grad_p), np.asarray(grad_o)
    assert np.isfinite(g_p).all() and np.abs(g_p).max() > 0
    np.testing.assert_allclose(g_p, g_o, rtol=1e-7, atol=1e-12)


def test_jvp_linearization_is_consistent():
    # forward-mode through the same chain (jvp), checked against grad
    cfg = _cfg()
    shape = cfg.grid.shape
    rng = np.random.default_rng(1)
    charge0 = jnp.asarray(0.01 + 1e-3 * rng.standard_normal(shape))
    direction = jnp.asarray(rng.standard_normal(shape))

    loss = _loss_fn(cfg)
    _, jvp_val = jax.jvp(loss, (charge0,), (direction,))
    grad = jax.grad(loss)(charge0)
    assert np.isclose(float(jvp_val), float(jnp.vdot(grad, direction)),
                      rtol=1e-10, atol=1e-12)
