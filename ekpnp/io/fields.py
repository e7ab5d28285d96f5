"""Per-shard save-cadence field dumps + offline merge.

The reference's tecplot writer gathers every field into one host's RAM
before formatting (save_data_tecplot, LBM.cu:2492-2565 — fine on its one
GPU).  At BASELINE config-5 scale (512x256x256 multi-host) that gather
moves ~1.5 GB x 14 ASCII columns through process 0 per zone, so sharded
runs instead dump `fields_NNNNNN.shards/shard_<pid>.npz` at each save
event: every process writes ONLY its addressable shards, keyed by their
global start offsets (the same format as io/checkpoint.save_sharded), and
`ekpnp merge` assembles the reference-layout data.dat offline — merged
output is byte-identical to what a single process would have written
(tests/test_multihost.py).

No process ever materializes a global array on the dump path: under a
multi-host mesh `np.asarray(global_array)` raises in JAX (shards are not
all addressable), so the 2-process test would fail loudly on any gather.
"""
from __future__ import annotations

import glob
import json
import os

import numpy as np

from ..config import Config
from ..state import Macro

_FIELDS = ("rho", "u", "charge", "chargen", "temp", "phi", "E")


def save_fields_sharded(dirpath: str, cfg: Config, macro: Macro, phi, E,
                        t: float) -> None:
    """Write this process's shards of the save-cadence fields (macro +
    phi + E) to `dirpath`/shard_<pid>.npz; process 0 writes meta.json."""
    import jax

    os.makedirs(dirpath, exist_ok=True)
    pid = jax.process_index()
    payload = {}

    def put(name, arr):
        if arr is None:
            return
        for s in arr.addressable_shards:
            if s.replica_id != 0:
                continue
            off = [sl.start or 0 for sl in s.index]
            payload[f"{name}@{'_'.join(map(str, off))}"] = np.asarray(s.data)

    put("rho", macro.rho)
    put("u", macro.u)
    put("charge", macro.charge)
    put("chargen", macro.chargen)
    put("temp", macro.temp)
    put("phi", phi)
    put("E", E)
    # UNCOMPRESSED by default: deflate of a ~100 MB+ shard on the host
    # CPU runs for seconds inside the timed loop's async writer and
    # starves the dispatch thread.  EKPNP_COMPRESS_FIELDS=1 opts back in
    # where disk is the scarcer resource.
    save = (np.savez_compressed
            if os.environ.get("EKPNP_COMPRESS_FIELDS") == "1" else np.savez)
    save(os.path.join(dirpath, f"shard_{pid}.npz"), **payload)
    if pid == 0:
        g = cfg.grid
        meta = {"grid": [g.nx, g.ny, g.nz], "t": float(t),
                "nprocs": jax.process_count()}
        with open(os.path.join(dirpath, "meta.json"), "w") as f:
            json.dump(meta, f)


def _assemble(dirpath: str, cfg: Config):
    """Read every shard file of one dump dir and stitch the global numpy
    fields (offline merge — this IS allowed to materialize globals)."""
    with open(os.path.join(dirpath, "meta.json")) as f:
        meta = json.load(f)
    g = cfg.grid
    if tuple(meta["grid"]) != (g.nx, g.ny, g.nz):
        raise ValueError(f"dump grid {tuple(meta['grid'])} != config grid "
                         f"{(g.nx, g.ny, g.nz)}")
    shapes = {
        "rho": g.shape, "u": (3,) + g.shape, "charge": g.shape,
        "chargen": g.shape, "temp": g.shape, "phi": g.shape,
        "E": (3,) + g.shape,
    }
    out, filled = {}, {}
    for p in sorted(glob.glob(os.path.join(dirpath, "shard_*.npz"))):
        with np.load(p) as fl:
            for key in fl.files:
                name, off_s = key.split("@")
                off = tuple(int(v) for v in off_s.split("_"))
                data = fl[key]
                if name not in out:
                    out[name] = np.empty(shapes[name], data.dtype)
                    filled[name] = np.zeros(shapes[name], bool)
                dst = tuple(slice(o, o + s) for o, s in zip(off, data.shape))
                out[name][dst] = data
                filled[name][dst] = True
    for name, mask in filled.items():
        if not mask.all():
            raise ValueError(
                f"dump {dirpath} does not cover field {name} — missing "
                f"shard files? (cross-host merge needs all shard_*.npz "
                f"in one place)")
    macro = Macro(rho=out.get("rho"), u=out.get("u"),
                  charge=out.get("charge"), chargen=out.get("chargen"),
                  temp=out.get("temp"))
    return macro, out.get("phi"), out.get("E"), float(meta["t"])


def list_dump_dirs(outdir: str) -> list[str]:
    """fields_NNNNNN.shards dump dirs under a run dir, in step order."""
    dirs = glob.glob(os.path.join(outdir, "fields_*.shards"))
    return sorted(dirs, key=lambda d: int(
        os.path.basename(d)[len("fields_"):-len(".shards")]))


def merge_run_dir(outdir: str, cfg: Config, data_path: str = None,
                  end_path: str = None, end_npz_path: str = None,
                  vtk: bool = False) -> int:
    """Assemble every per-shard dump under `outdir` into the single-file
    artifacts a non-sharded run writes: reference-layout tecplot zones
    (data.dat) and, from the LAST dump, the 12-column data_end.dat +
    data_end.npz checkpoints; vtk=True also writes fieldsNNNNNN.vtk per
    dump (the --vtk artifacts a non-sharded run would have produced).
    Returns the number of zones written."""
    from .checkpoint import save_npz, save_reference_ascii
    from .tecplot import write_zone

    dirs = list_dump_dirs(outdir)
    if not dirs:
        raise ValueError(f"no fields_*.shards dumps under {outdir}")
    data_path = data_path or os.path.join(outdir, "data.dat")
    with open(data_path, "w") as fout:
        for i, d in enumerate(dirs):
            macro, phi, E, t = _assemble(d, cfg)
            write_zone(fout, cfg, macro, phi, E, t, first=(i == 0))
            if vtk:
                from .vtk import write_vtk

                step = os.path.basename(d)[len("fields_"):-len(".shards")]
                write_vtk(os.path.join(outdir, f"fields{step}.vtk"),
                          cfg, macro, phi, E, t)
    # final-state checkpoints in the reference's lossy semantics
    if end_path is None:
        end_path = os.path.join(outdir, "data_end.dat")
    if end_npz_path is None:
        end_npz_path = os.path.join(outdir, "data_end.npz")
    save_reference_ascii(end_path, cfg, macro, phi, E, t)
    save_npz(end_npz_path, cfg, macro, phi, E, t)
    return len(dirs)
