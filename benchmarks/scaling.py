#!/usr/bin/env python3
"""Weak-scaling harness (BASELINE north star: >= 75% efficiency at 2+ hosts).

Constant per-device workload: the y-extent grows with the device count, so
each chip always owns base-ny rows.  Prints one JSON line per device count
with MLUPS, MLUPS/device, and efficiency vs the single-device run.

It measures the multi-device path (`make_sharded_multi_step`) of the
machine it runs on: on several GPUs of one host, a device measurement; with
--cpu, the same program over the virtual
--xla_force_host_platform_device_count mesh — functional validation of the
scaling path, not a performance number.

Usage:
    python benchmarks/scaling.py [--base-ny 64] [--size 128] [--steps 10]
                                 [--devices 1 2 4 8] [--pencil] [--f64]
Multi-host: launch under `jax.distributed` (one process per host); every
process runs this same SPMD program.
"""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--base-ny", type=int, default=64, help="y rows per device")
    ap.add_argument("--size", type=int, default=128, help="nx and nz-1 extents")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--devices", type=int, nargs="*", default=None)
    ap.add_argument("--pencil", action="store_true")
    ap.add_argument("--f64", action="store_true")
    ap.add_argument("--cpu", action="store_true", help="force the CPU backend")
    args = ap.parse_args()

    if args.cpu:
        ndev_wanted = max(args.devices or [8])
        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "")
            + f" --xla_force_host_platform_device_count={ndev_wanted}"
        )

    import jax
    import jax.numpy as jnp

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    if args.f64:
        jax.config.update("jax_enable_x64", True)

    from ekpnp import preset
    from ekpnp.init import state_from_macro
    from ekpnp.parallel import mesh as pmesh
    from ekpnp.state import Macro

    all_devs = jax.devices()
    counts = args.devices or sorted({1, 2, len(all_devs)} & set(
        n for n in (1, 2, 4, 8, 16, 32) if n <= len(all_devs)))
    counts = [n for n in counts if n <= len(all_devs)]

    dtype_s = "float64" if args.f64 else "float32"
    dtype = jnp.dtype(dtype_s)
    backend = jax.default_backend()
    base = None

    for n in counts:
        ny = args.base_ny * n
        cfg = preset(
            "reference", nx=args.size, ny=ny, nz=args.size + 1,
            dtype=dtype_s, fft_method="matmul",
        )
        shape = cfg.grid.shape
        macro = Macro(
            rho=jnp.full(shape, 1000.0, dtype),
            u=jnp.zeros((3,) + shape, dtype),
            charge=jnp.full(shape, 0.01, dtype),
            chargen=jnp.full(shape, 0.01, dtype),
            temp=jnp.full(shape, 0.5, dtype),
        )
        state = state_from_macro(
            cfg, macro, jnp.zeros(shape, dtype),
            jnp.zeros((3,) + shape, dtype), 0.0)

        mesh = pmesh.make_mesh(all_devs[:n], pencil=args.pencil)
        state = pmesh.shard_state(cfg, mesh, state)
        run = pmesh.make_sharded_multi_step(cfg, mesh, args.steps)

        state = run(state)
        jax.block_until_ready(state.f)
        # re-shard a fresh copy for the timed run (run() donated the state)
        state2 = pmesh.shard_state(cfg, mesh, state_from_macro(
            cfg, macro, jnp.zeros(shape, dtype),
            jnp.zeros((3,) + shape, dtype), 0.0))
        t0 = time.perf_counter()
        state2 = run(state2)
        float(jnp.sum(state2.f[0, 0, 0]))
        dt = (time.perf_counter() - t0) / args.steps
        mlups = cfg.grid.num_nodes / dt / 1e6
        per_dev = mlups / n
        if base is None:
            base = per_dev
        print(json.dumps({
            "devices": n,
            "grid": list(shape),
            "mlups": round(mlups, 2),
            "mlups_per_device": round(per_dev, 2),
            "weak_scaling_efficiency": round(per_dev / base, 4),
            "platform": backend,
            "device_kind": all_devs[0].device_kind,
        }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
