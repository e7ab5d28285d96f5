"""One fused timestep (the reference hot path, main.cu:189-224).

Order is the reference's exactly (stream_collide_save LBM.cu:465-481 then
fast_Poisson main.cu:198):

  collide (TRT, all fields) -> fluid bounce-back at walls -> pull stream
  (periodic) -> ion no-flux + temperature Dirichlet wall BCs -> spectral
  Poisson solve for phi, E (consumed by the *next* step's collide)

Everything is one pure function of (Config static, State) -> (State, Macro);
under `jax.jit` with donated state the double-buffer pointer swap of the
reference becomes an in-place update.
"""
from __future__ import annotations

from functools import partial

import jax

from .config import Config
from .ops.boundary import bounce_back_walls, scalar_wall_bcs
from .ops.collide import collide
from .ops.poisson import poisson_phi
from .ops.stream import stream
from .state import Macro, State


def step_path(cfg: Config, mesh=None, platform: str | None = None) -> str:
    """The one place that decides which step runs.

    "jnp": the XLA-compiled jnp step below (the oracle; every platform
    runs it, and GSPMD partitions it over any mesh).  "kernel": the fused
    Pallas/Triton kernel (pallas/push_step.py), which only the GPU
    compiles — on one device, or per shard of a y-slab mesh
    (parallel/halo.py).  An unknown platform is an error, never a silent
    fallback."""
    platform = platform or jax.default_backend()
    if platform == "cpu":
        return "jnp"
    if platform != "gpu":
        raise RuntimeError(
            f"no step path for platform {platform!r} (supported: cpu, gpu)")
    if cfg.grid.nz < 4:   # the kernel's wall BCs need 4 z rows
        return "jnp"
    if mesh is not None:
        from .parallel.halo import supports_halo_step

        return "kernel" if supports_halo_step(cfg, mesh) else "jnp"
    return "kernel"


def step(cfg: Config, state: State, perturb: bool = False, mesh=None) -> tuple[State, Macro]:
    p = cfg.physics
    lat = cfg.lattice
    lat_s = cfg.scalar_lat

    post, macro = collide(cfg, state, perturb=perturb)

    # fluid wall bounce-back uses pre-collision populations (LBM.cu:1848-1961)
    f2 = bounce_back_walls(cfg, post.f, state.f)

    f1 = stream(lat, f2)
    h1 = hn1 = g1 = None
    phi = state.phi

    if p.enable_ek:
        cbc = p.charge_bc
        post_h, post_hn = post.h, post.hn
        if cbc == "zerograd-top":
            # zero charge gradient at the upper plate: the post-collision
            # wall plane is replaced by its interior neighbor BEFORE
            # streaming (the reference's commented-out variant sits inside
            # gpu_boundary, i.e. pre-stream, LBM.cu:1929-1958); streaming
            # then pulls the copied values and the post-stream wall fix
            # applies at the lower plate only
            post_h = post_h.at[:, -1].set(post_h[:, -2])
            if post_hn is not None:
                post_hn = post_hn.at[:, -1].set(post_hn[:, -2])

        def ion_bcs(streamed, post_k, wall):
            if cbc == "noflux":
                return scalar_wall_bcs(cfg, streamed, post_k, "noflux")
            if cbc == "injection":
                return scalar_wall_bcs(cfg, streamed, post_k, "injection",
                                       wall=wall)
            if cbc == "zerograd-top":
                return scalar_wall_bcs(cfg, streamed, post_k, "zerograd-top")
            raise ValueError(f"unknown charge_bc {cbc!r}")

        h1 = ion_bcs(stream(lat_s, post_h), post_h,
                     (p.charge0, p.charge1))
        if post_hn is not None:
            hn1 = ion_bcs(stream(lat_s, post_hn), post_hn,
                          (p.charge0n, p.charge1n))
        phi = poisson_phi(cfg, macro.charge, macro.chargen, mesh)

    if p.enable_thermal:
        g1 = stream(lat_s, post.g)
        g1 = scalar_wall_bcs(cfg, g1, post.g, "temperature")

    dt = state.t.dtype.type(p.dt(cfg.grid.dx))
    new = State(f=f1, h=h1, hn=hn1, g=g1, phi=phi, t=state.t + dt)
    return new, macro


def production_step(cfg: Config, state: State, mesh=None) -> State:
    """One step on the path `step_path` picks for this process."""
    if step_path(cfg) == "kernel":
        from .pallas.step import step_kernel_diff

        return step_kernel_diff(cfg, state, mesh, False)
    return step(cfg, state, mesh=mesh)[0]


@partial(jax.jit, static_argnums=(0, 2), donate_argnums=(1,))
def step_jit(cfg: Config, state: State, perturb: bool = False) -> State:
    """One jitted step; the one-shot perturbed first step always runs the
    jnp step (the convection seed replaces u inside its collide)."""
    if perturb:
        return step(cfg, state, perturb=True)[0]
    return production_step(cfg, state)


@partial(jax.jit, static_argnums=(0, 2), donate_argnums=(1,))
def multi_step(cfg: Config, state: State, n: int) -> State:
    """Run n steps inside one compiled loop (lax.scan over the step).

    Macroscopic fields are recomputable from the returned state with
    `ekpnp.ops.collide.compute_macro` — the reference instead stores them
    every step (LBM.cu:807-813); here the inner loop carries populations
    only, saving HBM traffic.

    The scan is unrolled x2 so the buffers ping-pong between two
    allocations without a carry copy (the reference's f1/f2 pointer swap,
    main.cu:192, as buffer assignment)."""
    def body(carry, _):
        return production_step(cfg, carry), None

    state, _ = jax.lax.scan(body, state, None, length=n, unroll=2)
    return state
