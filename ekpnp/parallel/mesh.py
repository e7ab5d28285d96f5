"""Device mesh + sharding specs for slab/pencil domain decomposition.

Decomposition of the (Q, Z, Y, X) state over mesh axes:
  - slab:   1-D mesh ("y",) over the spanwise direction.  Y is fully
    periodic with no wall boundary conditions and no odd-extension folding
    (both live on z, which stays local to every device), so the only
    communication is the 1-deep streaming halo and the FFT repartition.
  - pencil: 2-D mesh ("y", "x") for pod-scale runs.

The z axis deliberately stays unsharded: the reference's wall physics
(bounce-back LBM.cu:1848-1961, ion/thermal BCs LBM.cu:2095-2416, the z=0
macroscopic extrapolation LBM.cu:663-801) and the Poisson odd extension
(poisson.cu:114-158) all couple z rows; keeping them on-device makes every
wall update collective-free.  JAX also requires sharded extents to divide
evenly — y/x are powers of two in all BASELINE configs while NZ is 2^k + 1.

GSPMD: `jax.jit` with these shardings over the pure jnp step; XLA inserts
collective-permutes for the streaming rolls and all-to-alls for the
sharded-axis transforms of the spectral solve.
"""
from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..state import Macro, State


def make_mesh(devices: Optional[Sequence] = None, pencil: bool = False) -> Mesh:
    devices = list(devices if devices is not None else jax.devices())
    n = len(devices)
    if pencil:
        # near-square factorization for a ("y", "x") mesh
        yf = int(np.sqrt(n))
        while n % yf:
            yf -= 1
        return Mesh(np.array(devices).reshape(yf, n // yf), ("y", "x"))
    return Mesh(np.array(devices), ("y",))


def _axes(mesh: Mesh) -> tuple[Optional[str], Optional[str]]:
    yax = "y" if "y" in mesh.axis_names else None
    xax = "x" if "x" in mesh.axis_names else None
    return yax, xax


def check_divisibility(cfg, mesh: Mesh) -> None:
    yax, xax = _axes(mesh)
    if yax and cfg.grid.ny % mesh.shape[yax]:
        raise ValueError(
            f"ny={cfg.grid.ny} not divisible by mesh y-extent {mesh.shape[yax]}"
        )
    if xax and cfg.grid.nx % mesh.shape[xax]:
        raise ValueError(
            f"nx={cfg.grid.nx} not divisible by mesh x-extent {mesh.shape[xax]}"
        )


def pop_spec(mesh: Mesh) -> P:
    """Populations (Q, Z, Y, X): shard Y (and X for pencil)."""
    yax, xax = _axes(mesh)
    return P(None, None, yax, xax)


def scalar_spec(mesh: Mesh) -> P:
    """Scalar fields (Z, Y, X)."""
    yax, xax = _axes(mesh)
    return P(None, yax, xax)


def vector_spec(mesh: Mesh) -> P:
    """Vector fields (3, Z, Y, X)."""
    yax, xax = _axes(mesh)
    return P(None, None, yax, xax)


def state_shardings(cfg, mesh: Mesh) -> State:
    """A State-shaped pytree of NamedShardings."""
    ns = lambda spec: NamedSharding(mesh, spec)
    ek = cfg.physics.enable_ek
    th = cfg.physics.enable_thermal
    pop = ns(pop_spec(mesh))
    return State(
        f=pop,
        h=pop if ek else None,
        hn=pop if ek and cfg.physics.two_species else None,
        g=pop if th else None,
        phi=ns(scalar_spec(mesh)) if ek else None,
        t=ns(P()),
    )


def macro_shardings(cfg, mesh: Mesh) -> Macro:
    ns = lambda spec: NamedSharding(mesh, spec)
    ek = cfg.physics.enable_ek
    th = cfg.physics.enable_thermal
    return Macro(
        rho=ns(scalar_spec(mesh)),
        u=ns(vector_spec(mesh)),
        charge=ns(scalar_spec(mesh)) if ek else None,
        chargen=ns(scalar_spec(mesh)) if ek else None,
        temp=ns(scalar_spec(mesh)) if th else None,
    )


def shard_state(cfg, mesh: Mesh, state: State) -> State:
    """Place an existing state onto the mesh."""
    check_divisibility(cfg, mesh)
    shardings = state_shardings(cfg, mesh)
    return jax.tree_util.tree_map(
        lambda x, s: jax.device_put(x, s) if x is not None else None,
        state,
        shardings,
        is_leaf=lambda x: x is None,
    )


def make_sharded_step(cfg, mesh: Mesh, perturb: bool = False):
    """jit-compiled jnp step with explicit in/out shardings (GSPMD path)."""
    from ..step import step

    check_divisibility(cfg, mesh)
    st_sh = state_shardings(cfg, mesh)
    mac_sh = macro_shardings(cfg, mesh)
    return jax.jit(
        lambda s: step(cfg, s, perturb=perturb, mesh=mesh),
        in_shardings=(st_sh,),
        out_shardings=(st_sh, mac_sh),
        donate_argnums=(0,),
    )


def make_sharded_multi_step(cfg, mesh: Mesh, n: int):
    """n steps under one jit with stable shardings, on the path
    `ekpnp.step.step_path` picks: the kernel per shard of a y-slab mesh
    (parallel/halo.py), or the jnp step partitioned by XLA (GSPMD), with
    collective-permutes for the streaming shifts and all-to-alls for the
    spectral solve."""
    from ..step import step, step_path

    if step_path(cfg, mesh) == "kernel":
        from .halo import make_halo_multi_step

        return make_halo_multi_step(cfg, mesh, n)
    check_divisibility(cfg, mesh)
    st_sh = state_shardings(cfg, mesh)

    def run(s):
        # unroll=2 so buffers ping-pong without carry copies — see
        # ekpnp.step.multi_step
        def body(carry, _):
            new, _ = step(cfg, carry, mesh=mesh)
            return new, None

        out, _ = jax.lax.scan(body, s, None, length=n, unroll=2)
        return out

    return jax.jit(run, in_shardings=(st_sh,), out_shardings=st_sh, donate_argnums=(0,))
