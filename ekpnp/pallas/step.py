"""Timestep built on the fused GPU kernel (pallas/push_step.py).

Same semantics as ekpnp.step.step (the jnp oracle): the kernel does
collide + bounce-back + stream + scalar wall BCs and emits the Poisson
RHS, and the spectral solve turns that RHS into the next potential.
"""
from __future__ import annotations

from functools import partial

import jax

from ..config import Config
from ..ops.poisson import poisson_phi_from_rhs
from ..state import State
from .push_step import build_push_step


def step_kernel(cfg: Config, state: State, mesh=None,
                interpret: bool = False) -> State:
    """One fused timestep."""
    p = cfg.physics
    fused = build_push_step(cfg, state.f.dtype.name, interpret)
    f1, h1, hn1, g1, rhs = fused(state.f, state.h, state.hn, state.g,
                                 state.phi)
    phi = state.phi
    if p.enable_ek:
        phi = poisson_phi_from_rhs(cfg, rhs, mesh)
    dt = state.t.dtype.type(p.dt(cfg.grid.dx))
    return State(f=f1, h=h1, hn=hn1, g=g1, phi=phi, t=state.t + dt)


@partial(jax.custom_vjp, nondiff_argnums=(0, 2, 3))
def step_kernel_diff(cfg: Config, state: State, mesh=None,
                     interpret: bool = False) -> State:
    """Differentiable production step: the forward pass is the fused
    kernel; the backward pass is the exact VJP of the jnp-oracle step,
    which the kernel equals to round-off (tests/test_kernel.py)."""
    return step_kernel(cfg, state, mesh=mesh, interpret=interpret)


def _diff_fwd(cfg, state, mesh, interpret):
    # custom_vjp passes fwd the primal's argument order (nondiff args in
    # place); bwd gets the nondiff args first
    return step_kernel(cfg, state, mesh=mesh, interpret=interpret), state


def _diff_bwd(cfg, mesh, interpret, state, ct):
    from ..step import step as oracle_step

    def fwd(s):
        new, _ = oracle_step(cfg, s, mesh=mesh)
        return new

    _, vjp = jax.vjp(fwd, state)
    return vjp(ct)


step_kernel_diff.defvjp(_diff_fwd, _diff_bwd)
