#!/usr/bin/env python3
"""Smoke test of ekpnp on NVIDIA GPUs: the coupled EK-PNP-thermal step runs
on the card through the normal entry points and agrees with the plain
references.

    python chip_smoke.py          # one GPU: phases 1-4
    python chip_smoke.py --four   # four GPUs of one host: phase 1, then
                                  # `pod` on a 4-card slab mesh and a 2x2
                                  # pencil mesh against one card

All phases run in this one process (one process per card).  A failing
phase raises, so the script exits non-zero; the last line of standard
output is one JSON object, {"ok": true, "device": {...}}, printed only
when every phase passed.

  1. the card (nvidia-smi name and power limit), jax.devices() and the
     compile-cache directory; exits non-zero unless JAX's default backend
     is "gpu".
  2. the production step (the fused kernel, pallas/push_step.py) against
     the plain jnp step, and the GPU Poisson solve against the f64 CPU
     oracle, at 256x256x257 in f32.
  3. `ekpnp run ek-pnp-thermal` in process: PB initialization, save and
     current cadence; data.dat, umax.dat, series.csv and data_end.npz
     exist and are finite; MLUPS.
  4. compiled.memory_analysis() of the production multi-step program.
"""
import argparse
import contextlib
import io
import json
import os
import re
import subprocess
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
EPS32 = float(np.finfo(np.float32).eps)
# Kernel vs jnp step: the two sum each node's up-to-27-term moments and
# the collision's terms in different orders (and contract different
# multiply-adds), so each step may differ by a few tens of f32 ulps of the
# field's scale; the bound allows 64 ulps per step.
STEP_ULPS = 64
# GPU Poisson solve (f32, every matmul at HIGHEST) vs the f64 oracle: three
# dense transforms of length <= 256 each accumulate ~sqrt(n) round-offs.
POISSON_TOL = 1e-5


def _card():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip()


def _seeded_state(cfg, seed):
    """A coupled state with smooth 3D structure plus seeded noise in every
    population (so every direction carries its own value)."""
    import jax.numpy as jnp

    from ekpnp.init import state_from_macro
    from ekpnp.state import Macro

    dtype = jnp.float32
    nz, ny, nx = cfg.grid.shape
    z = jnp.arange(nz, dtype=dtype)[:, None, None] / nz
    y = jnp.arange(ny, dtype=dtype)[None, :, None] / ny
    x = jnp.arange(nx, dtype=dtype)[None, None, :] / nx
    wave = (jnp.sin(2 * jnp.pi * x) * jnp.cos(2 * jnp.pi * y)
            * jnp.sin(jnp.pi * z))
    shape = cfg.grid.shape
    macro = Macro(
        rho=jnp.full(shape, 1000.0, dtype) * (1 + 1e-4 * wave),
        u=jnp.stack([1e-4 * wave, -5e-5 * wave, jnp.zeros(shape, dtype)]),
        charge=jnp.full(shape, 0.01, dtype) * (1 + 0.1 * wave),
        chargen=jnp.full(shape, 0.01, dtype) * (1 - 0.1 * wave),
        temp=jnp.full(shape, 0.5, dtype) * (1 + 0.1 * wave),
    )
    phi = (cfg.physics.voltage * (1 + 0.1 * wave)).astype(dtype)
    st = state_from_macro(cfg, macro, phi, jnp.zeros((3,) + shape, dtype), 0.0)
    rng = np.random.default_rng(seed)

    def noisy(a):
        if a is None:
            return None
        n = rng.standard_normal(a.shape[:2], dtype=np.float32)
        return a * (1 + 1e-3 * jnp.asarray(n)[:, :, None, None])

    return st._replace(f=noisy(st.f), h=noisy(st.h), hn=noisy(st.hn),
                       g=noisy(st.g))


def _compare(a, b, tol, tag):
    """Max |a - b| / max |b| per field, on the devices of `a` (b is moved
    to a's sharding); raise past `tol` or on a non-finite value."""
    import jax
    import jax.numpy as jnp

    @jax.jit
    def stats(x, y):
        return (jnp.max(jnp.abs(x - y)), jnp.max(jnp.abs(y)),
                jnp.all(jnp.isfinite(x)) & jnp.all(jnp.isfinite(y)))

    worst = 0.0
    for name in ("f", "h", "hn", "g", "phi"):
        x, y = getattr(a, name), getattr(b, name)
        if y is None:
            continue
        d, s, finite = stats(x, jax.device_put(y, x.sharding))
        if not bool(finite):
            raise SystemExit(f"{tag}: non-finite {name}")
        err = float(d) / float(s)
        worst = max(worst, err)
        print(f"  {tag} {name}: max rel err {err:.3e} (tol {tol:.3e})")
    if worst > tol:
        raise SystemExit(f"{tag}: max rel err {worst:.3e} > tol {tol:.3e}")


def _jnp_steps(cfg, state, n):
    """n steps of the plain jnp step (the reference the kernel must match)."""
    import jax

    from ekpnp.step import step

    def run(s):
        return jax.lax.scan(lambda c, _: (step(cfg, c)[0], None), s, None,
                            length=n)[0]

    return jax.jit(run)(state)


def phase_kernel(steps=4):
    from ekpnp import preset
    from ekpnp.step import multi_step, step_path

    for scal in ("D3Q7", "same"):
        cfg = preset("ek-pnp-thermal", scalar_lattice=scal)
        print(f"phase 2: {step_path(cfg)} step vs plain jnp step, "
              f"ek-pnp-thermal {cfg.grid.shape} f32, scalars "
              f"{cfg.scalar_lat.name}, {steps} steps (the step has no "
              f"matmul; the Poisson matmuls run at HIGHEST in both)")
        ref = _jnp_steps(cfg, _seeded_state(cfg, 0), steps)
        out = multi_step(cfg, _seeded_state(cfg, 0), steps)
        _compare(out, ref, STEP_ULPS * steps * EPS32, f"kernel[{scal}]")
        del out, ref


def phase_poisson():
    import jax
    import jax.numpy as jnp

    from ekpnp import preset
    from ekpnp.ops.poisson import poisson_phi, solve_method

    cfg = preset("ek-pnp-thermal")
    nz, ny, nx = cfg.grid.shape
    rng = np.random.default_rng(1)
    z = np.arange(nz)[:, None, None] / (nz - 1)
    base = 0.01 * (1 + 0.2 * np.cosh(8 * (z - 0.5)) / np.cosh(4.0))
    c = base * (1 + 0.05 * rng.standard_normal((nz, ny, nx)))
    cn = base[::-1] * (1 + 0.05 * rng.standard_normal((nz, ny, nx)))
    phi = np.asarray(jax.jit(lambda a, b: poisson_phi(cfg, a, b))(
        jnp.asarray(c, jnp.float32), jnp.asarray(cn, jnp.float32)), np.float64)
    cpu = jax.devices("cpu")[0]
    cfg64 = preset("ek-pnp-thermal", dtype="float64", fft_method="fft")
    with jax.enable_x64(True), jax.default_device(cpu):
        ref = np.asarray(jax.jit(lambda a, b: poisson_phi(cfg64, a, b))(
            jnp.asarray(c), jnp.asarray(cn)))
    err = float(np.max(np.abs(phi - ref)) / np.max(np.abs(ref)))
    print(f"phase 2: Poisson solve '{solve_method(cfg)}' (f32, HIGHEST) vs "
          f"f64 CPU odd-extension FFT oracle at {cfg.grid.shape}: max rel err "
          f"{err:.3e} (tol {POISSON_TOL:.1e})")
    if not np.isfinite(phi).all() or err > POISSON_TOL:
        raise SystemExit("phase 2: Poisson solve outside its tolerance")


def _finite_text(path):
    """True when a text output holds no nan/inf token."""
    with open(path, "rb") as f:
        tail = b""
        while True:
            chunk = f.read(1 << 26)
            if not chunk:
                return True
            buf = (tail + chunk).lower()
            if b"nan" in buf or b"inf" in buf:
                return False
            tail = chunk[-3:]


def phase_run(card):
    from ekpnp.run import main as ekpnp_main

    with tempfile.TemporaryDirectory(dir=ROOT, prefix=".smoke_run_") as out:
        argv = ["run", "ek-pnp-thermal", "--steps", "40", "--set",
                "nsave=20", "print_current=10", "--outdir", out]
        print(f"phase 3: ekpnp {' '.join(argv[:-1])} <tmpdir>", flush=True)
        buf = io.StringIO()

        class _Tee(io.TextIOBase):
            def write(self, s):
                sys.__stdout__.write(s)
                return buf.write(s)

        with contextlib.redirect_stdout(_Tee()):
            rc = ekpnp_main(argv)
        if rc != 0:
            raise SystemExit(f"phase 3: ekpnp run exited {rc}")
        for name in ("data.dat", "umax.dat", "series.csv"):
            path = os.path.join(out, name)
            if not os.path.exists(path) or not _finite_text(path):
                raise SystemExit(f"phase 3: {name} missing or not finite")
        with np.load(os.path.join(out, "data_end.npz")) as z:
            for k in z.files:
                if not np.isfinite(z[k]).all():
                    raise SystemExit(f"phase 3: data_end.npz[{k}] not finite")
        m = re.search(r"speed: ([0-9.]+) \(Mlups\)", buf.getvalue())
        if m is None:
            raise SystemExit("phase 3: no speed line in the run's output")
        print(f"phase 3: ekpnp run ek-pnp-thermal ok: {m.group(1)} MLUPS "
              f"(timed loop incl. save/current cadence) on {card}")


def phase_memory():
    import jax

    from ekpnp import preset
    from ekpnp.step import multi_step

    cfg = preset("ek-pnp-thermal")
    st = jax.eval_shape(lambda: _seeded_state(cfg, 0))
    comp = multi_step.lower(cfg, st, 10).compile()
    print(f"phase 4: memory_analysis of multi_step(ek-pnp-thermal, 10): "
          f"{comp.memory_analysis()}")


def phase_four(steps=3):
    import jax

    from ekpnp import preset
    from ekpnp.parallel import mesh as pmesh
    from ekpnp.step import multi_step

    devs = jax.devices()
    if len(devs) != 4:
        raise SystemExit(f"--four needs 4 GPUs, JAX sees {len(devs)}")
    cfg = preset("pod")
    print(f"four: pod {cfg.grid.shape} f32, {steps} steps; one card first")
    with jax.default_device(devs[0]):
        one = multi_step(cfg, _seeded_state(cfg, 2), steps)
    tol = STEP_ULPS * steps * EPS32
    for pencil in (False, True):
        mesh = pmesh.make_mesh(devs, pencil=pencil)
        with jax.default_device(devs[0]):
            st = pmesh.shard_state(cfg, mesh, _seeded_state(cfg, 2))
        out = pmesh.make_sharded_multi_step(cfg, mesh, steps)(st)
        tag = f"{'pencil' if pencil else 'slab'} {dict(mesh.shape)}"
        _compare(out, one, tol, tag)
        del out, st


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card slab/pencil check")
    args = ap.parse_args(argv)

    import jax

    if jax.default_backend() != "gpu":
        print(f"chip_smoke: JAX's default backend is "
              f"{jax.default_backend()!r}, not 'gpu'", file=sys.stderr)
        return 1
    card = _card()
    from ekpnp.compile_cache import enable

    print(card)
    print(f"phase 1: devices {jax.devices()}; compile cache {enable()}")
    if args.four:
        phase_four()
    else:
        phase_kernel()
        phase_poisson()
        phase_run(card.splitlines()[0])
        phase_memory()
    print(card)
    dev = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
