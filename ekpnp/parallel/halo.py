"""Kernel path on a y-slab mesh: the fused GPU kernel per shard under
shard_map.

GSPMD cannot partition a Pallas call, so on a ("y",) mesh each device runs
the kernel (pallas/push_step.py, halo=True) on its own y-range:

  - before the kernel, each shard receives one population row from each
    y-neighbour and two phi rows (the centred Ey difference of a halo row
    reaches one row further), passed around the mesh ring with
    `jax.lax.ppermute` — NCCL on the GPU;
  - the halo rows' programs collide those nodes only to push into the
    shard's edge rows, so no post-kernel fix-up exchange exists;
  - the spectral Poisson solve runs outside the shard_map under GSPMD
    (parallel/fft.py inserts the all-to-all repartitions).

Pencil ("y", "x") meshes run the GSPMD jnp step (parallel/mesh.py).
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from ..config import Config
from ..state import State
from .mesh import check_divisibility, state_shardings


def supports_halo_step(cfg: Config, mesh: Mesh) -> bool:
    """A y-slab mesh whose shards hold at least the two phi halo rows."""
    if "x" in mesh.axis_names or "y" not in mesh.axis_names:
        return False
    n = mesh.shape["y"]
    return cfg.grid.ny % n == 0 and cfg.grid.ny // n >= 2


def _halo_rows(a, k: int, n: int):
    """`a` (..., Y_local, X) with k rows of each y-neighbour on each side
    (periodic around the mesh ring)."""
    prev = [(i, (i + 1) % n) for i in range(n)]   # my last rows -> next
    nxt = [(i, (i - 1) % n) for i in range(n)]    # my first rows -> prev
    lo = jax.lax.ppermute(a[..., -k:, :], "y", prev)
    hi = jax.lax.ppermute(a[..., :k, :], "y", nxt)
    return jnp.concatenate([lo, a, hi], axis=-2)


def step_halo(cfg: Config, state: State, mesh: Mesh,
              interpret: bool = False) -> State:
    """One timestep on a y-slab mesh: halo exchange + per-shard kernel
    under shard_map, then the GSPMD spectral Poisson solve."""
    from ..ops.poisson import poisson_phi_from_rhs
    from ..pallas.push_step import build_push_step

    if not supports_halo_step(cfg, mesh):
        raise ValueError(f"mesh {dict(mesh.shape)} is not a y-slab with "
                         f">= 2 rows per shard of ny={cfg.grid.ny}")
    n = mesh.shape["y"]
    p = cfg.physics
    cfg_l = dataclasses.replace(
        cfg, grid=dataclasses.replace(cfg.grid, ny=cfg.grid.ny // n))
    fused = build_push_step(cfg_l, state.f.dtype.name, interpret, halo=True)
    names = [k for k in ("f", "h", "hn", "g") if getattr(state, k) is not None]
    pop = P(None, None, "y", None)
    sc = P(None, "y", None)

    def local(*args):
        pops = dict(zip(names, (_halo_rows(a, 1, n) for a in args[:len(names)])))
        phi = _halo_rows(args[-1], 2, n) if p.enable_ek else None
        out = fused(pops["f"], pops.get("h"), pops.get("hn"), pops.get("g"),
                    phi)
        return tuple(o for o in out if o is not None)

    args = [getattr(state, k) for k in names]
    in_specs = [pop] * len(names)
    if p.enable_ek:
        args.append(state.phi)
        in_specs.append(sc)
    out_specs = [pop] * len(names) + ([sc] if p.enable_ek else [])
    outs = jax.shard_map(local, mesh=mesh, in_specs=tuple(in_specs),
                         out_specs=tuple(out_specs), check_vma=False)(*args)
    new = dict(zip(names, outs))
    phi = state.phi
    if p.enable_ek:
        phi = poisson_phi_from_rhs(cfg, outs[-1], mesh)
    dt = state.t.dtype.type(p.dt(cfg.grid.dx))
    return State(f=new["f"], h=new.get("h"), hn=new.get("hn"), g=new.get("g"),
                 phi=phi, t=state.t + dt)


def make_halo_multi_step(cfg: Config, mesh: Mesh, n: int,
                         interpret: bool = False):
    """n kernel steps on a y-slab mesh under one jit with stable
    shardings (unroll=2 so buffers ping-pong, as ekpnp.step.multi_step)."""
    check_divisibility(cfg, mesh)
    st_sh = state_shardings(cfg, mesh)

    def run(s):
        body = lambda c, _: (step_halo(cfg, c, mesh, interpret), None)
        return jax.lax.scan(body, s, None, length=n, unroll=2)[0]

    return jax.jit(run, in_shardings=(st_sh,), out_shardings=st_sh,
                   donate_argnums=(0,))
