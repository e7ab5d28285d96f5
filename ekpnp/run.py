"""CLI runner — the reference's main() as a non-interactive command
(reference main.cu:19-296; the interactive scanf restart prompt at
main.cu:158-164 becomes the --resume flag).

Usage:
    python -m ekpnp run <preset> [--steps N] [--set key=value ...]
                        [--resume ckpt.npz] [--outdir DIR] [--precision f32|f64]
    python -m ekpnp info <preset>
    python -m ekpnp bench [--size N] [--steps N]   (see ekpnp/benchmark.py)

Outputs, mirroring the reference run artifacts:
    out/data.dat      tecplot zones every NSAVE steps
    out/umax.dat      (t, max uz) series every printCurrent steps
    out/series.csv    structured time series (t, umax, |u|max, current, <T>)
    out/data_end.npz  checkpoint (macroscopic fields; restart is lossy by
                      reference semantics)
    out/data_end.dat  reference-layout ASCII checkpoint (cross-compatible)
"""
from __future__ import annotations

import argparse
import ast
import os
import queue
import sys
import threading
import time


class _AsyncIO:
    """Single-worker FIFO I/O pipeline: save-cadence dumps (tecplot zones,
    scalar snapshots, checkpoints) run on a writer thread, overlapping the
    device-to-host fetch and ASCII formatting with the next compute chunk.
    The reference instead blocks the GPU loop on full D2H copies + writes
    every NSAVE steps (main.cu:206-209).  FIFO order keeps zone order."""

    def __init__(self):
        # deep enough that frequent small series events queue behind an
        # in-flight field dump without blocking the dispatch loop
        self._q = queue.Queue(maxsize=8)
        self._err = None
        self._t = threading.Thread(target=self._loop, daemon=True)
        self._t.start()

    def _loop(self):
        while True:
            item = self._q.get()
            try:
                if item is None:
                    return
                item()
            except Exception as e:  # surfaced on the next submit/close
                self._err = e
            finally:
                self._q.task_done()

    def submit(self, fn):
        if self._err:
            raise self._err
        self._q.put(fn)

    def close(self):
        self._q.put(None)
        self._t.join()
        if self._err:
            raise self._err


class _NonFinite(RuntimeError):
    """Raised on the writer thread by the finite guard; surfaces at the
    next submit/close (at worst one extra chunk runs before abort)."""

    def __init__(self, step):
        super().__init__(f"non-finite state detected at step {step}")
        self.step = step


def _next_multiple(done, n, off):
    """Smallest e > done with e % n == off (the I/O event schedule: off = 0
    normally; off = 2 % n under RunConfig.compat_cadence, reproducing the
    reference's `i % N == 1` post-iteration check, main.cu:206,211)."""
    return ((done - off) // n + 1) * n + off


def _parse_overrides(pairs):
    out = {}
    for pair in pairs or []:
        if "=" not in pair:
            raise SystemExit(f"--set expects key=value, got {pair!r}")
        k, v = pair.split("=", 1)
        # booleans first, case-insensitively: ast.literal_eval only knows
        # Python True/False, so `--set flag=false` would otherwise survive
        # as the truthy string "false" and silently ENABLE the flag
        # (round-4 advisor finding)
        if v.lower() in ("true", "false"):
            out[k] = v.lower() == "true"
            continue
        try:
            out[k] = ast.literal_eval(v)
        except (ValueError, SyntaxError):
            out[k] = v
    return out


def build_config(args):
    from .config import from_file, preset

    overrides = _parse_overrides(args.set)
    if args.steps is not None:
        overrides["nsteps"] = args.steps
    if args.precision:
        overrides["dtype"] = {"f32": "float32", "f64": "float64"}[args.precision]
    if args.outdir:
        overrides["outdir"] = args.outdir
    if args.preset.endswith((".yaml", ".yml", ".json")) or os.path.isfile(args.preset):
        return from_file(args.preset, **overrides)
    return preset(args.preset, **overrides)


def cmd_merge(args):
    """Assemble per-shard field dumps (a --mesh/--distributed run's
    fields_NNNNNN.shards/) into the single-file artifacts: data.dat
    tecplot zones + data_end.dat/.npz — byte-identical to what a
    non-sharded run writes (io/fields.py)."""
    from .io.fields import merge_run_dir

    cfg = build_config(args)
    n = merge_run_dir(args.rundir, cfg, vtk=args.vtk)
    print(f"merged {n} zones -> {os.path.join(args.rundir, 'data.dat')} "
          f"(+ data_end.dat, data_end.npz)")
    return 0


def cmd_info(args):
    from .diagnostics import dimensionless_banner

    cfg = build_config(args)
    print(dimensionless_banner(cfg))
    return 0


def cmd_run(args):
    from .compile_cache import enable as _enable_cache

    if args.platform:
        import jax

        jax.config.update("jax_platforms", args.platform)
    if args.distributed:
        # multi-host runtime (SURVEY.md §2.5): every host runs this same
        # program; coordinator/process env comes from the cluster launcher
        import jax

        jax.distributed.initialize()
    import jax

    if jax.default_backend() == "cpu" and args.platform != "cpu":
        raise SystemExit("ekpnp run: JAX found no GPU; pass --platform cpu "
                         "to run on the CPU")
    _enable_cache()
    # On the GPU the default precision is f32 (the production dtype); an
    # explicit --precision or --set dtype=... always wins.  The f64 CPU
    # path remains the reference-parity validation mode.
    if (args.precision is None
            and "dtype" not in _parse_overrides(args.set)
            and jax.default_backend() != "cpu"):
        args.precision = "f32"

    cfg = build_config(args)
    if cfg.run.dtype == "float64":
        jax.config.update("jax_enable_x64", True)

    import jax.numpy as jnp

    from .diagnostics import dimensionless_banner, series_point
    from .init import initialize
    from .io import checkpoint as ckpt
    from .io import tecplot
    from .ops.collide import compute_macro
    from .step import multi_step, step_jit, step_path

    print(dimensionless_banner(cfg))
    print(f"  timesteps: {cfg.run.nsteps}  save every: {cfg.run.nsave}")
    print(f"  dtype: {cfg.run.dtype}  lattice: {cfg.run.lattice}"
          f"  scalars: {cfg.scalar_lat.name}"
          f"  step path: {step_path(cfg)}")
    print(f"  devices: {jax.devices()}")

    outdir = cfg.run.outdir
    os.makedirs(outdir, exist_ok=True)

    mesh = None
    if args.mesh:
        from .parallel import mesh as pmesh

        devs = jax.devices()
        if args.mesh_devices:
            devs = devs[: args.mesh_devices]
        mesh = pmesh.make_mesh(devs, pencil=(args.mesh == "pencil"))
        print(f"  mesh: {dict(mesh.shape)} over {len(devs)} devices")

    state = None
    if args.resume:
        if ckpt.is_sharded_checkpoint(args.resume):
            print(f"Restoring from {args.resume} (lossless per-shard "
                  f"resume, no gather; mesh-elastic)...")
            if mesh is None:
                # meshless resume: stitch onto one device (mesh-elastic)
                from .parallel import mesh as pmesh

                m1 = pmesh.make_mesh(jax.devices()[:1])
                state = ckpt.load_sharded(args.resume, cfg, m1)
            else:
                state = ckpt.load_sharded(args.resume, cfg, mesh)
        elif ckpt.is_full_checkpoint(args.resume):
            print(f"Restoring from {args.resume} (lossless full-state resume)...")
            state = ckpt.load_full_npz(args.resume, cfg)
        elif args.resume.endswith(".dat"):
            print(f"Restoring from {args.resume} (populations re-equilibrated)...")
            state = ckpt.load_reference_ascii(args.resume, cfg)
        else:
            print(f"Restoring from {args.resume} (populations re-equilibrated)...")
            state = ckpt.load_npz(args.resume, cfg)
        resumed_sharded = ckpt.is_sharded_checkpoint(args.resume)
    else:
        resumed_sharded = False
        print("Initializing (PB double-layer relaxation)...")
        t_init = time.perf_counter()
        state, _, pb_res = initialize(cfg, with_residual=True)
        jax.block_until_ready(state.f)
        if pb_res is not None:
            print(f"  PB init: {cfg.physics.pb_iters} iterations in "
                  f"{time.perf_counter() - t_init:.2f} s, final relative "
                  f"update {float(pb_res):.3e} (tune with --set pb_iters=N)")

    if mesh is not None and not resumed_sharded:
        state = pmesh.shard_state(cfg, mesh, state)

    macro_fn = jax.jit(compute_macro, static_argnums=(0,))
    from .ops.poisson import efield

    efield_jit = jax.jit(efield, static_argnums=(0,))
    # one compiled program per cadence event — eager series_point is
    # dozens of op-by-op dispatches
    series_fn = jax.jit(series_point, static_argnums=(0,))

    def efield_now(st):
        """E = -grad(phi) for I/O and diagnostics (E is not state)."""
        if not cfg.physics.enable_ek:
            return None
        return efield_jit(cfg, st.phi)

    macro, _ = macro_fn(cfg, state)
    E_io = efield_now(state)

    # sharded runs dump per-shard field files instead of gathering every
    # zone through one process (reference gathers on its one GPU,
    # LBM.cu:2492-2565; at BASELINE config-5 scale that is ~1.5 GB x 14
    # ASCII columns per zone through process 0).  `ekpnp merge` rebuilds
    # the byte-identical data.dat offline (io/fields.py).
    sharded_io = mesh is not None
    if sharded_io:
        from .io.fields import save_fields_sharded

        fout = None
        print(f"  field dumps: per-shard (fields_NNNNNN.shards/); run "
              f"`ekpnp merge {args.preset} {outdir}` for data.dat")

        def _zone_sharded(d, macro, phi, E, t):
            save_fields_sharded(
                os.path.join(outdir, f"fields_{d:06d}.shards"),
                cfg, macro, phi, E, t)
    else:
        fout = open(os.path.join(outdir, "data.dat"), "w")
    fumax = open(os.path.join(outdir, "umax.dat"), "w")
    fcsv = open(os.path.join(outdir, "series.csv"), "w")
    fcsv.write("step,t,umax_uz,umax_mag,current,mean_T\n")
    if sharded_io:
        _zone_sharded(0, macro, state.phi, E_io, float(state.t))
    else:
        tecplot.write_zone(fout, cfg, macro, state.phi, E_io, float(state.t),
                           first=True)
    aio = _AsyncIO()

    nsteps = cfg.run.nsteps
    nsave = max(1, cfg.run.nsave)
    ncur = max(1, cfg.run.print_current)
    # I/O event schedule offsets (see _next_multiple)
    save_off = 2 % nsave if cfg.run.compat_cadence else 0
    cur_off = 2 % ncur if cfg.run.compat_cadence else 0

    _adv_cache = {}

    def _compile_advance(st, n):
        """AOT-compile the n-step program (no execution, state untouched)."""
        if mesh is None:
            fn = multi_step.lower(cfg, st, n).compile()
        else:
            from .parallel.mesh import make_sharded_multi_step

            fn = make_sharded_multi_step(cfg, mesh, n).lower(st).compile()
        _adv_cache[n] = fn
        return fn

    def advance(st, n):
        fn = _adv_cache.get(n) or _compile_advance(st, n)
        return fn(st)

    # warm up compilation outside the timed loop (reference times kernels
    # only, main.cu:185-186): run one step — seeding the convection pattern
    # if configured (reference perturb flag, LBM.h:18: a one-shot applied on
    # the first collide; never applied on restarts) — then AOT-compile every
    # distinct chunk size the cadence schedule will request (compile-only,
    # state untouched)
    perturb0 = bool(cfg.run.perturb_first_step) and not args.resume
    if mesh is None:
        state = step_jit(cfg, state, perturb0)
    else:
        from .parallel.mesh import make_sharded_step

        state, _ = make_sharded_step(cfg, mesh, perturb=perturb0)(state)
    jax.block_until_ready(state.f)
    done = 1

    chunks = set()
    d = done
    while d < nsteps:
        nxt = min(_next_multiple(d, nsave, save_off),
                  _next_multiple(d, ncur, cur_off), nsteps)
        chunks.add(nxt - d)
        d = nxt
    for chunk in sorted(chunks):
        _compile_advance(state, chunk)
    # compile the diagnostics program pre-t0 too (it does not modify state)
    jax.device_get(series_fn(cfg, state))

    if args.profile:
        jax.profiler.start_trace(args.profile)

    t0 = time.perf_counter()
    steps_warm = done  # step(s) already run before t0 (compile warm-up)
    while done < nsteps:
        # run to the next I/O event inside one compiled scan
        next_event = min(_next_multiple(done, nsave, save_off),
                         _next_multiple(done, ncur, cur_off), nsteps)
        chunk = next_event - done
        state = advance(state, chunk)
        done = next_event

        if done % ncur == cur_off or done == nsteps:
            # one device program per event; the blocking host roundtrip
            # moves to the writer thread so the dispatch pipeline stays
            # deep.  The outputs are fresh (non-donated) arrays except state.t,
            # which the next chunk's donation would invalidate — copy it.
            vals = series_fn(cfg, state)
            t_arr, d_now = jnp.copy(state.t), done

            def _series(vals=vals, t_arr=t_arr, d=d_now):
                um, umag, cur, mean_t, finite = (
                    float(x) for x in jax.device_get(vals))
                t_now = float(t_arr)
                fumax.write(f"{t_now:10.6f} {um:10.6f}\n")
                fcsv.write(f"{d},{t_now:.9e},{um:.9e},{umag:.9e},"
                           f"{cur:.9e},{mean_t:.9e}\n")
                print(
                    f"Iteration: {d}, physical time: {t_now:g}, "
                    f"Current = {cur:g}, umax = {um:g}"
                )
                if not finite:
                    raise _NonFinite(d)

            try:
                aio.submit(_series)
            except _NonFinite as e:
                print(f"ERROR: {e}; aborting", file=sys.stderr)
                return 2

        if done % nsave == save_off and done < nsteps:
            # async dump: snapshot device buffers that survive the next
            # chunk's donation (macro/E are fresh arrays; phi and t need
            # copies), then let the writer thread fetch + format + write
            # while the next chunk computes — no main-thread sync
            macro, _ = macro_fn(cfg, state)
            E_sv = efield_now(state)
            phi_sv = jnp.copy(state.phi) if state.phi is not None else None
            t_sv, d_sv = jnp.copy(state.t), done

            def _dump(macro=macro, phi=phi_sv, E=E_sv, t=t_sv, d=d_sv):
                t = float(t)
                if sharded_io:
                    # per-shard npz: each process fetches + writes only
                    # its addressable shards (still on the writer thread)
                    _zone_sharded(d, macro, phi, E, t)
                    return
                tecplot.write_zone(fout, cfg, macro, phi, E, t)
                if args.save_scalars:
                    from .io.scalars import save_scalars

                    save_scalars(outdir, d, cfg, macro, phi, E)
                if args.vtk:
                    from .io.vtk import write_vtk

                    write_vtk(
                        os.path.join(outdir, f"fields{d:06d}.vtk"),
                        cfg, macro, phi, E, t,
                    )

            try:
                aio.submit(_dump)
            except _NonFinite as e:
                print(f"ERROR: {e}; aborting", file=sys.stderr)
                return 2

    jax.block_until_ready(state.f)
    runtime = time.perf_counter() - t0
    if args.profile:
        jax.profiler.stop_trace()
        print(f"  profiler trace written to {args.profile}")
    # only steps after t0 are timed: the warm-up step runs before t0
    # (round-1 verdict: dividing by all nsteps flattered MLUPS by ~0.1%)
    steps_timed = nsteps - steps_warm
    nodes_updated = steps_timed * cfg.grid.num_nodes
    mlups = nodes_updated / (1e6 * runtime) if runtime > 0 else 0.0

    try:
        aio.close()  # drain pending dumps + events before the final zone
    except _NonFinite as e:
        print(f"ERROR: {e}; aborting", file=sys.stderr)
        return 2
    macro, _ = macro_fn(cfg, state)
    E_io = efield_now(state)
    if sharded_io:
        _zone_sharded(nsteps, macro, state.phi, E_io, float(state.t))
    else:
        tecplot.write_zone(fout, cfg, macro, state.phi, E_io, float(state.t))
    if args.vtk and not sharded_io:
        from .io.vtk import write_vtk

        write_vtk(
            os.path.join(outdir, f"fields{nsteps:06d}.vtk"),
            cfg, macro, state.phi, E_io, float(state.t),
        )
    if fout is not None:
        fout.close()
    fumax.close()
    fcsv.close()

    if not sharded_io:
        # sharded runs: data_end.dat/.npz come from `ekpnp merge` (these
        # writers materialize global arrays; io/fields.py)
        ckpt.save_npz(
            os.path.join(outdir, "data_end.npz"), cfg, macro, state.phi,
            E_io, float(state.t)
        )
        ckpt.save_reference_ascii(
            os.path.join(outdir, "data_end.dat"), cfg, macro, state.phi,
            E_io, float(state.t)
        )
    if args.checkpoint_full:
        if mesh is not None:
            # sharded runs: lossless per-shard directory, no global gather
            # (each process writes only its addressable shards; resume with
            # --resume out/state_end.ckpt --mesh ...)
            ckpt.save_sharded(os.path.join(outdir, "state_end.ckpt"),
                              cfg, state)
        else:
            ckpt.save_full_npz(os.path.join(outdir, "state_end.npz"),
                               cfg, state)

    print(" ----- performance information -----")
    print(f"           timesteps: {nsteps} ({steps_timed} timed; "
          f"{steps_warm} in compile warm-up)")
    print(f"       clock runtime: {runtime:.3f} (s)")
    print(f"               speed: {mlups:.2f} (Mlups)")
    # actual per-node traffic: every active field's directions, read+write
    # (the reference's own printout counts only the fluid field,
    # main.cu:236-245 — a catalogued quirk, SURVEY.md §7.4)
    nsc = ((2 if cfg.physics.two_species else 1) if cfg.physics.enable_ek
           else 0) + (1 if cfg.physics.enable_thermal else 0)
    dirs = cfg.lattice.Q + nsc * cfg.scalar_lat.Q
    dsize = jnp.dtype(cfg.run.dtype).itemsize
    gib = nodes_updated * dirs * 2 * dsize / (1024.0 ** 3) / runtime
    print(f"           bandwidth: {gib:.1f} (GiB/s), all-field population "
          f"traffic")
    return 0


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] == "bench":
        # delegate everything after "bench" (argparse REMAINDER cannot
        # capture leading options)
        from .benchmark import main as bench_main

        return bench_main(argv[1:])
    ap = argparse.ArgumentParser(prog="ekpnp", description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)

    def common(p):
        p.add_argument(
            "preset",
            help="reference|poiseuille|ek-channel|ek-pnp|ek-pnp-thermal|pod, "
                 "or a YAML/JSON config file (optional `preset:` key + "
                 "field overrides, flat or grouped under grid/physics/run)")
        p.add_argument("--steps", type=int, default=None)
        p.add_argument("--set", nargs="*", metavar="key=value")
        p.add_argument("--precision", choices=["f32", "f64"], default=None)
        p.add_argument("--outdir", default=None)

    p_run = sub.add_parser("run", help="run a simulation")
    common(p_run)
    p_run.add_argument("--resume", default=None, help="checkpoint (.npz or .dat)")
    p_run.add_argument("--platform", default=None, help="jax platform override (cpu)")
    p_run.add_argument(
        "--mesh", choices=["slab", "pencil"], default=None,
        help="shard the domain over the local devices (slab: y, pencil: y+x)")
    p_run.add_argument(
        "--mesh-devices", type=int, default=0,
        help="number of devices for --mesh (default: all)")
    p_run.add_argument(
        "--distributed", action="store_true",
        help="multi-host: jax.distributed.initialize() from the cluster env "
             "(one identical SPMD process per host)")
    p_run.add_argument(
        "--profile", default=None, metavar="DIR",
        help="capture a jax.profiler trace of the timed loop into DIR")
    p_run.add_argument(
        "--vtk", action="store_true",
        help="also write binary VTK (STRUCTURED_POINTS) snapshots "
             "fieldsNNNNNN.vtk at every save step (same fields and wall "
             "extrapolation as the tecplot zones)")
    p_run.add_argument(
        "--checkpoint-full", action="store_true",
        help="also write state_end.npz — a lossless full-population "
             "checkpoint; --resume from it continues bit-identically "
             "(the reference's restart is lossy, LBM.cu:2567-2671)")
    p_run.add_argument(
        "--save-scalars", action="store_true",
        help="per-scalar binary dumps nameNNNN.bin at every save step "
             "(reference save_scalar, LBM.cu:2454-2490)")
    p_run.set_defaults(fn=cmd_run)

    p_info = sub.add_parser("info", help="print configuration banner")
    common(p_info)
    p_info.set_defaults(fn=cmd_info)

    p_merge = sub.add_parser(
        "merge", help="assemble a sharded run's per-shard field dumps "
        "(fields_NNNNNN.shards/) into data.dat + data_end.dat/.npz")
    common(p_merge)
    p_merge.add_argument("rundir", help="the sharded run's --outdir")
    p_merge.add_argument(
        "--vtk", action="store_true",
        help="also write fieldsNNNNNN.vtk per dump (the --vtk snapshots a "
             "non-sharded run would have produced)")
    p_merge.set_defaults(fn=cmd_merge)

    sub.add_parser(
        "bench", help="one-GPU MLUPS / Poisson benchmark (JSON lines); all "
        "further flags go to ekpnp.benchmark", add_help=False)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
