#!/usr/bin/env python3
"""Benchmark harness for one GPU — prints one JSON line per mode:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N,
   "platform": ..., "device_kind": ..., "device_count": N, ...}

Default mode `coupled` measures the full coupled EK-PNP-thermal step (TRT
collide + stream + wall BCs + spectral Poisson solve, f32) at 256^3 with
D3Q7 scalar lattices, then — in the same process, after the first
variant's buffers are freed — the reference-parity variant with every
field on D3Q27, and carries both in the one line.

vs_baseline = measured MLUPS / roofline MLUPS, where roofline = peak HBM
bandwidth / minimum bytes per node per step:
  population directions x (1 read + 1 write) x itemsize
  + macro scalars (rho, u, c+, c-, T, phi w + E r)         ~  48 B
  + Poisson transform passes over the volume               ~ 128 B
(c.f. the reference's own bandwidth accounting, main.cu:236-245, which
counts only the fluid field).  The peak comes from `_PEAK_HBM_BW`, keyed
by the device kind; a device not in the table is an error.

The reported value is the median of --reps timed windows, and the line
carries their spread ((max - min) / median).  The benchmark needs a GPU:
it never falls back to the CPU.
"""
import argparse
import json
import sys
import time

# device_kind -> (peak HBM bytes/s, source)
_PEAK_HBM_BW = {
    "NVIDIA H100 80GB HBM3": (3.35e12, "NVIDIA H100 datasheet, SXM5 80 GB"),
    "NVIDIA H100 PCIe": (2.0e12, "NVIDIA H100 datasheet, PCIe 80 GB"),
}


def peak_hbm_bandwidth(device_kind: str) -> float:
    """Peak HBM bandwidth [B/s] of a device kind; an unknown kind is an
    error, never a default."""
    if device_kind not in _PEAK_HBM_BW:
        raise ValueError(
            f"no peak HBM bandwidth for device kind {device_kind!r}; add it "
            f"to ekpnp.benchmark._PEAK_HBM_BW with its source")
    return _PEAK_HBM_BW[device_kind][0]


def coupled_bytes_per_node(cfg) -> int:
    """The byte model of the module docstring for the coupled step."""
    import numpy as np

    dsize = np.dtype(cfg.run.dtype).itemsize
    n_scalar = (2 if cfg.physics.two_species else 1) + 1
    dirs = cfg.lattice.Q + n_scalar * cfg.scalar_lat.Q
    return dirs * 2 * dsize + 48 + 128


def _median(xs):
    xs = sorted(xs)
    n = len(xs)
    return xs[n // 2] if n % 2 else 0.5 * (xs[n // 2 - 1] + xs[n // 2])


def _device_fields():
    import jax

    dev = jax.devices()[0]
    return {"platform": dev.platform, "device_kind": dev.device_kind,
            "device_count": len(jax.devices())}


def _bench_state(cfg):
    """A uniform coupled state (rho0, c+- = 0.01, T = 0.5, phi = 0)."""
    import jax.numpy as jnp

    from ekpnp.init import state_from_macro
    from ekpnp.state import Macro

    ek = cfg.physics.enable_ek
    dtype = jnp.dtype(cfg.run.dtype)
    shape = cfg.grid.shape
    macro = Macro(
        rho=jnp.full(shape, 1000.0, dtype),
        u=jnp.zeros((3,) + shape, dtype),
        charge=jnp.full(shape, 0.01, dtype) if ek else None,
        chargen=jnp.full(shape, 0.01, dtype) if ek else None,
        temp=jnp.full(shape, 0.5, dtype) if cfg.physics.enable_thermal else None,
    )
    phi = jnp.zeros(shape, dtype) if ek else None
    E = jnp.zeros((3,) + shape, dtype) if ek else None
    return state_from_macro(cfg, macro, phi, E, 0.0)


def time_steps(cfg, steps: int, reps: int):
    """Median seconds per step over `reps` windows of `steps` steps of the
    production multi-step program, and the windows' spread."""
    import jax
    import jax.numpy as jnp

    from ekpnp.step import multi_step

    state = jax.block_until_ready(_bench_state(cfg))
    # compile + warm-up with the same static step count as the timed run
    state = multi_step(cfg, state, steps)
    float(jnp.sum(state.f[0, 0, 0]))
    windows = []
    for _ in range(max(1, reps)):
        t0 = time.perf_counter()
        state = multi_step(cfg, state, steps)
        float(jnp.sum(state.f[0, 0, 0]))  # full sync
        windows.append(time.perf_counter() - t0)
    if not bool(jnp.all(jnp.isfinite(state.f))):
        raise RuntimeError("non-finite populations after the timed windows")
    med = _median(windows)
    return med / steps, (max(windows) - min(windows)) / med


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=256, help="cubic grid edge")
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--reps", type=int, default=9,
                    help="timed windows; the reported value is their median")
    ap.add_argument("--mode", choices=["coupled", "fluid", "poisson", "pbinit"],
                    default="coupled")
    ap.add_argument("--dtype", default="float32")
    args = ap.parse_args(argv)

    import jax
    import jax.numpy as jnp

    from ekpnp import preset
    from ekpnp.compile_cache import enable as _enable_cache

    if jax.default_backend() != "gpu":
        raise SystemExit(f"ekpnp bench needs a GPU; JAX's default backend "
                         f"is {jax.default_backend()!r}")
    _enable_cache()
    dev = _device_fields()
    n = args.size
    grid = dict(nx=n, ny=n, nz=n + 1, dtype=args.dtype)

    if args.mode == "poisson":
        # BASELINE.json: the Poisson solve's ms/step is a first-class metric
        from ekpnp.ops.poisson import poisson_phi_from_rhs, solve_method

        cfg = preset("reference", **grid)
        rhs = jnp.ones((cfg.grid.nz - 2,) + cfg.grid.shape[1:],
                       jnp.dtype(args.dtype))
        solve = jax.jit(lambda r: poisson_phi_from_rhs(cfg, r, None))
        jax.block_until_ready(solve(rhs))
        pt = []
        for _ in range(max(1, args.reps)):
            t0 = time.perf_counter()
            for _ in range(args.steps):
                phi = solve(rhs)
            jax.block_until_ready(phi)
            pt.append((time.perf_counter() - t0) / args.steps)
        ms = _median(pt) * 1e3
        # roofline: ~10 field-sized passes at peak HBM bandwidth
        floor_ms = (10 * cfg.grid.num_nodes * jnp.dtype(args.dtype).itemsize
                    / peak_hbm_bandwidth(dev["device_kind"]) * 1e3)
        print(json.dumps({
            "metric": f"spectral Poisson solve ms/step at {n}^3 "
                      f"({args.dtype}, {solve_method(cfg)})",
            "value": round(ms, 4), "unit": "ms",
            "vs_baseline": round(floor_ms / ms, 4), **dev}))
        return 0

    if args.mode == "pbinit":
        # Cost + convergence of the 501-iteration Poisson-Boltzmann
        # double-layer initialization (reference LBM.cu:89-106) of the
        # ek-pnp-thermal deployment, whose spacing resolves the reference
        # channel (config.py)
        from ekpnp.init import initialize

        cfg = preset("ek-pnp-thermal", **grid)
        t0 = time.perf_counter()
        state, _, res = initialize(cfg, with_residual=True)
        jax.block_until_ready(state.f)
        first_s = time.perf_counter() - t0
        del state
        t0 = time.perf_counter()
        state, _, res = initialize(cfg, with_residual=True)
        resv = float(res)
        elapsed = time.perf_counter() - t0
        iters = cfg.physics.pb_iters
        print(json.dumps({
            "metric": f"PB double-layer init at {n}^3 ({iters} iters, "
                      f"{args.dtype})",
            "value": round(elapsed, 4), "unit": "s", "vs_baseline": 0,
            "ms_per_iteration": round(elapsed / iters * 1e3, 4),
            "final_relative_update": resv,
            "first_call_s": round(first_s, 2), **dev}))
        return 0

    peak = peak_hbm_bandwidth(dev["device_kind"])
    if args.mode == "fluid":
        cfg = preset("reference", enable_ek=False, enable_thermal=False, **grid)
        per_step, spread = time_steps(cfg, args.steps, args.reps)
        mlups = cfg.grid.num_nodes / per_step / 1e6
        roofline = peak / (cfg.lattice.Q * 2 * jnp.dtype(args.dtype).itemsize) / 1e6
        print(json.dumps({
            "metric": f"MLUPS fluid-only step at {n}^3 ({args.dtype})",
            "value": round(mlups, 1), "unit": "MLUPS",
            "vs_baseline": round(mlups / roofline, 4),
            "spread": round(spread, 4), "windows": args.reps, **dev}))
        return 0

    out = None
    for scal in ("D3Q7", "same"):
        cfg = preset("reference", scalar_lattice=scal, **grid)
        per_step, spread = time_steps(cfg, args.steps, args.reps)
        jax.clear_caches()  # drop this variant's executables before the next
        mlups = cfg.grid.num_nodes / per_step / 1e6
        roofline = peak / coupled_bytes_per_node(cfg) / 1e6
        if out is None:
            out = {
                "metric": f"MLUPS full coupled EK-PNP-thermal step at {n}^3 "
                          f"({args.dtype}, scalars D3Q7)",
                "value": round(mlups, 1), "unit": "MLUPS",
                "vs_baseline": round(mlups / roofline, 4),
                "spread": round(spread, 4), "windows": args.reps,
            }
        else:
            out["ref_parity_all_d3q27_mlups"] = round(mlups, 1)
            out["ref_parity_vs_roofline"] = round(mlups / roofline, 4)
            out["ref_parity_spread"] = round(spread, 4)

    # the standalone solve cost (BASELINE.md: Poisson ms/step first-class)
    from ekpnp.ops.poisson import poisson_phi_from_rhs

    rhs = jnp.zeros((cfg.grid.nz - 2,) + cfg.grid.shape[1:],
                    jnp.dtype(args.dtype))
    solve = jax.jit(lambda r: poisson_phi_from_rhs(cfg, r, None))
    jax.block_until_ready(solve(rhs))
    pt = []
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(40):
            p_ = solve(rhs)
        jax.block_until_ready(p_)
        pt.append((time.perf_counter() - t0) / 40)
    out["poisson_ms"] = round(_median(pt) * 1e3, 4)
    print(json.dumps({**out, **dev}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
