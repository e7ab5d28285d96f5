"""Config system: presets, overrides, YAML/JSON config files."""
import pytest

from ekpnp import preset
from ekpnp.config import from_file


def test_preset_overrides_reject_unknown_key():
    with pytest.raises(ValueError, match="unknown config field"):
        preset("reference", not_a_field=1)


def test_yaml_config_file(tmp_path):
    p = tmp_path / "run.yaml"
    p.write_text(
        "preset: poiseuille\n"
        "grid:\n  nx: 16\n  ny: 8\n"
        "run:\n  nsteps: 7\n"
        "exf: 2.5e-4\n"   # flat key lands in the right section
    )
    cfg = from_file(str(p))
    assert (cfg.grid.nx, cfg.grid.ny) == (16, 8)
    assert cfg.run.nsteps == 7
    assert cfg.physics.exf == pytest.approx(2.5e-4)
    assert cfg.run.lattice == "D3Q19"  # poiseuille preset base preserved


def test_json_config_file_and_kw_priority(tmp_path):
    p = tmp_path / "run.json"
    p.write_text('{"preset": "reference", "nx": 12, "nsteps": 9}')
    cfg = from_file(str(p), nsteps=3)
    assert cfg.grid.nx == 12
    assert cfg.run.nsteps == 3  # CLI-style kwarg wins over the file


def test_config_file_rejects_non_mapping(tmp_path):
    p = tmp_path / "bad.yaml"
    p.write_text("- 1\n- 2\n")
    with pytest.raises(ValueError, match="mapping"):
        from_file(str(p))


def test_cli_accepts_config_file(tmp_path, capsys):
    p = tmp_path / "run.yaml"
    p.write_text("preset: reference\nnx: 10\n")
    from ekpnp.run import main

    assert main(["info", str(p)]) == 0
    out = capsys.readouterr().out
    assert "10" in out


def test_parse_overrides_bool_coercion():
    """--set flag=false must DISABLE the flag (round-4 advisor finding:
    ast.literal_eval only knows Python True/False, so lowercase spellings
    survived as truthy strings and switched boolean options ON)."""
    from ekpnp.run import _parse_overrides

    out = _parse_overrides([
        "a=true", "b=false", "c=True", "d=False", "e=TRUE",
        "f=1", "g=0.5", "h=text",
    ])
    assert out["a"] is True and out["c"] is True and out["e"] is True
    assert out["b"] is False and out["d"] is False
    assert out["f"] == 1 and out["g"] == 0.5 and out["h"] == "text"


def test_cli_finite_guard_aborts_with_rc2(tmp_path):
    """The finite guard (SURVEY §5 failure detection; PARITY D10) must
    abort a diverging run with exit code 2 — it now raises through the
    async writer thread (run.py _NonFinite), so this pins the rewired
    escape path end-to-end."""
    import subprocess
    import sys

    r = subprocess.run(
        [sys.executable, "-m", "ekpnp", "run", "reference", "--steps", "6",
         "--platform", "cpu", "--precision", "f64",
         "--set", "exf=1e38", "nx=8", "ny=8", "nz=9", "print_current=2",
         "--outdir", str(tmp_path)],
        capture_output=True, text=True, timeout=300)
    assert r.returncode == 2, r.stdout[-2000:] + r.stderr[-2000:]
    assert "non-finite state detected" in r.stderr
