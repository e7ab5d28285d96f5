"""End-to-end production run of the reference's actual experiment
(round-4 verdict item 3): `ekpnp run reference --steps 1000` — the
canonical perturbed ETHD microchannel case (reference main.cu:189-224
with LBM.h:122 NSTEPS=1000, perturb LBM.h:18) — through the real CLI in
a subprocess, exercising D1-D11 as one production loop: init + PB
relaxation, perturbed first step, AOT chunk scans, the async writer,
tecplot zones, umax.dat, series.csv, both checkpoints, and the final
perf report.

The series tail is pinned against the committed artifact of the same run
(benchmarks/runs/reference_r4/): f64 CPU is deterministic, so any drift
in the tail means a physics regression somewhere in the loop.
"""
import csv
import os
import subprocess
import sys

import numpy as np
import pytest

# step -> (umax_uz, umax_mag, current) from the committed run artifact
# benchmarks/runs/reference_r4/series.csv (f64 CPU, perturbed, 1000 steps)
_PINNED_TAIL = {
    900: (5.199975618e-06, 3.227607422e-05, 3.876292858e-18),
    950: (5.200272947e-06, 3.250047060e-05, 3.876425318e-18),
    1000: (5.200554956e-06, 3.268748869e-05, 3.876603747e-18),
}


def test_reference_experiment_end_to_end(tmp_path):
    outdir = tmp_path / "ref1000"
    r = subprocess.run(
        [sys.executable, "-m", "ekpnp", "run", "reference",
         "--steps", "1000", "--platform", "cpu", "--precision", "f64",
         "--checkpoint-full", "--set", "perturb_first_step=True",
         "--outdir", str(outdir)],
        capture_output=True, text=True, timeout=900,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    )
    assert r.returncode == 0, f"CLI run failed:\n{r.stdout[-4000:]}\n{r.stderr[-2000:]}"

    # production loop artifacts all present
    for fname in ("data.dat", "umax.dat", "series.csv", "data_end.npz",
                  "data_end.dat", "state_end.npz"):
        assert (outdir / fname).exists(), f"missing artifact {fname}"
    assert "speed:" in r.stdout and "Current =" in r.stdout

    # three tecplot zones: initial, step-500 cadence dump, final
    with open(outdir / "data.dat") as f:
        nzones = sum(1 for line in f if line.startswith("ZONE"))
    assert nzones == 3, f"expected 3 tecplot zones, got {nzones}"

    with open(outdir / "series.csv") as f:
        rows = {int(row["step"]): row for row in csv.DictReader(f)}
    for step, (uz, mag, cur) in _PINNED_TAIL.items():
        row = rows[step]
        np.testing.assert_allclose(float(row["umax_uz"]), uz, rtol=1e-8,
                                   err_msg=f"umax_uz at step {step}")
        np.testing.assert_allclose(float(row["umax_mag"]), mag, rtol=1e-8,
                                   err_msg=f"umax_mag at step {step}")
        np.testing.assert_allclose(float(row["current"]), cur, rtol=1e-8,
                                   err_msg=f"current at step {step}")
