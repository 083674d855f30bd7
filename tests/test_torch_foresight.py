"""Twin tests of the port's Foresight (``repro_torch.foresight``: CBench,
PAT, Cinema, the §V-D guideline) against the JAX package's
(``repro.foresight``), on ``nyx_fields(n=32)`` with ``device="cpu"``, and
the port's two examples.

Held: CBench ratios and bitrates exactly, PSNR/MSE/MRE/max error within
1e-6 relative, reconstructions bitwise; Cinema files byte for byte; the
guideline's picks and overall ratio, and the gates' P(k) and halo
deviations; PAT's SLURM text up to module names.  Both packages pick the
``core`` backends on the CPU.  A PW_REL case is the port's one stated
exception to bitwise reconstructions (``torch.log``/``torch.exp`` may differ
from XLA's by one ulp): its ratio is exact, its values within one ulp.
"""

import importlib.util
import json
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.foresight import cbench as jcbench
from repro.foresight import cinema as jcinema
from repro.foresight import guideline as jguide
from repro.foresight import pat as jpat
from repro_torch import foresight
from repro_torch.analysis import spectrum
from repro_torch.data import cosmo
from repro_torch.foresight import cbench, cinema, guideline, pat

ROOT = Path(__file__).resolve().parents[1]
SPEC = {"cases": [
    {"compressor": "tpu-sz", "fields": ["baryon_density", "vx"],
     "configs": [{"eb": 200.0}, {"eb": 20.0}]},
    {"compressor": "tpu-zfp", "fields": ["baryon_density", "vx"],
     "configs": [{"rate": 4}, {"rate": 8}]},
]}
EXACT = ("compressor", "field", "config", "ratio", "bitrate")
CLOSE = ("psnr", "mse", "mre", "max_abs_err")


@pytest.fixture(scope="module")
def nyx_small():
    return cosmo.nyx_fields(n=32)


@pytest.fixture(scope="module")
def sweeps(nyx_small):
    return (jcbench.run_sweep(SPEC, nyx_small, keep_reconstruction=True),
            cbench.run_sweep(SPEC, nyx_small, keep_reconstruction=True, device="cpu"))


def test_package_exports_all_four():
    assert foresight.__all__ == ["cbench", "cinema", "guideline", "pat"]
    assert foresight.guideline is guideline and foresight.pat is pat


# ------------------------------------------------------------------ CBench --


def _case_ids():
    return [f"{c['compressor']}-{f}-{k}" for c in SPEC["cases"] for f in c["fields"]
            for k in range(len(c["configs"]))]


@pytest.mark.parametrize("i", range(len(_case_ids())), ids=_case_ids())
def test_cbench_case_equals_reference(sweeps, i):
    j, t = sweeps[0][i], sweeps[1][i]
    for k in EXACT:
        assert getattr(t, k) == getattr(j, k), k
    for k in CLOSE:
        assert getattr(t, k) == pytest.approx(getattr(j, k), rel=1e-6), k
    np.testing.assert_array_equal(t.reconstructed, j.reconstructed)
    assert t.reconstructed.dtype == np.float32
    assert t.compress_s > 0 and t.decompress_s > 0 and t.throughput_c_mbs > 0


def test_cbench_pw_rel_case_within_one_ulp_of_reference(nyx_small):
    f = nyx_small["temperature"]
    j = jcbench.run_case("tpu-sz", "temperature", f, {"pw_rel": 1e-2})
    t = cbench.run_case("tpu-sz", "temperature", f, {"pw_rel": 1e-2}, device="cpu")
    assert (t.ratio, t.bitrate) == (j.ratio, j.bitrate)
    for k in CLOSE:
        assert getattr(t, k) == pytest.approx(getattr(j, k), rel=1e-6), k
    assert (np.abs(t.reconstructed - j.reconstructed) <= np.spacing(np.abs(j.reconstructed))).all()


def test_sweep_runs_and_reports(nyx_small):
    spec = {"cases": [{"compressor": "tpu-sz", "fields": ["baryon_density"],
                       "configs": [{"eb": 200.0}, {"eb": 20.0}]},
                      {"compressor": "tpu-zfp", "fields": ["baryon_density"],
                       "configs": [{"rate": 8}]}]}
    res = cbench.run_sweep(spec, nyx_small, device="cpu")
    assert len(res) == 3
    sz_loose, sz_tight, zfp8 = res
    assert sz_loose.ratio > sz_tight.ratio and sz_tight.psnr > sz_loose.psnr
    assert zfp8.ratio == 4.0
    assert all(r.reconstructed is None and r.throughput_c_mbs > 0 for r in res)


def test_results_serializable_as_reference(nyx_small, tmp_path):
    res = [cbench.run_case("tpu-sz", "vx", nyx_small["vx"], {"eb": 1e5}, device="cpu")]
    ref = [jcbench.run_case("tpu-sz", "vx", nyx_small["vx"], {"eb": 1e5})]
    cbench.save_results(res, tmp_path / "t.json")
    jcbench.save_results(ref, tmp_path / "j.json")
    rows, jrows = (json.loads((tmp_path / n).read_text()) for n in ("t.json", "j.json"))
    assert list(rows[0]) == list(jrows[0])
    assert rows[0]["compressor"] == "tpu-sz" and rows[0]["ratio"] == jrows[0]["ratio"]


def test_run_case_without_a_card_raises(nyx_small):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        cbench.run_case("tpu-sz", "vx", nyx_small["vx"], {"eb": 1e5})
    with pytest.raises(RuntimeError, match="CUDA"):
        cbench.run_case("tpu-zfp", "vx", nyx_small["vx"], {"rate": 8}, device="cuda")


# ------------------------------------------------------------------ Cinema --


def _cinema(mod, sweep, fields, path):
    db = mod.CinemaDatabase(path, name="twin")
    for r in sweep:
        k, ratio = spectrum.pk_ratio(fields[r.field], r.reconstructed)
        db.add_case({"compressor": r.compressor, "field": r.field, "config": str(r.config),
                     "cr": r.ratio, "psnr_db": r.psnr, "bitrate": r.bitrate},
                    curves={"pk_ratio": (k, ratio)} if r.compressor == "tpu-sz" else None)
    return db.write()


def test_cinema_files_byte_equal(sweeps, nyx_small, tmp_path):
    _cinema(jcinema, sweeps[0], nyx_small, tmp_path / "jax")
    _cinema(cinema, sweeps[1], nyx_small, tmp_path / "torch")
    names = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "torch").iterdir())
    assert {"data.csv", "info.json", "case_0000_pk_ratio.json"} <= set(names)
    for n in names:
        assert (tmp_path / "jax" / n).read_bytes() == (tmp_path / "torch" / n).read_bytes(), n


def test_cinema_layout(tmp_path):
    db = cinema.CinemaDatabase(tmp_path / "db")
    db.add_case({"compressor": "tpu-sz", "field": "vx", "ratio": 5.0},
                curves={"pk_ratio": ([1, 2, 3], [1.0, 0.99, 1.01])})
    db.add_case({"compressor": "tpu-zfp", "field": "vx", "ratio": 8.0})
    lines = db.write().read_text().strip().splitlines()
    assert len(lines) == 3  # header + 2 rows
    art = json.loads((tmp_path / "db" / "case_0000_pk_ratio.json").read_text())
    assert art["y"][1] == 0.99
    with pytest.raises(ValueError):
        cinema.CinemaDatabase(tmp_path / "empty").write()


# --------------------------------------------------------------- guideline --


@pytest.mark.parametrize("compressor,configs", [
    ("tpu-sz", [{"eb": 0.5}, {"eb": 50.0}, {"eb": 5000.0}]),
    ("tpu-zfp", [{"rate": 4}, {"rate": 8}, {"rate": 16}]),
], ids=["sz", "zfp"])
def test_best_fit_equals_reference(nyx_small, compressor, configs):
    fields = {k: nyx_small[k] for k in ("baryon_density", "vx", "temperature")}
    j = jguide.best_fit_per_field(fields, compressor, configs, pk_tol=0.01)
    t = guideline.best_fit_per_field(fields, compressor, configs, pk_tol=0.01, device="cpu")
    assert t.overall_ratio == j.overall_ratio
    for name in fields:
        a, b = t.field_results[name], j.field_results[name]
        assert (a.config, a.compressor, a.ratio, a.passed) == (b.config, b.compressor, b.ratio,
                                                               b.passed)
        assert a.worst_pk_dev == b.worst_pk_dev and a.psnr == pytest.approx(b.psnr, rel=1e-6)
        assert t.config_for(name) == j.config_for(name)


def test_picks_max_ratio_passing_config(nyx_small):
    fields = {"baryon_density": nyx_small["baryon_density"]}
    configs = [{"eb": 0.5}, {"eb": 50.0}, {"eb": 5000.0}]
    fit = guideline.best_fit_per_field(fields, "tpu-sz", configs, pk_tol=0.01, device="cpu")
    pick = fit.field_results["baryon_density"]
    assert pick.passed and pick.ratio >= 1.0
    assert fit.overall_ratio == pytest.approx(pick.ratio, rel=1e-6)
    for cfg in configs:  # no other passing config beats it
        r = cbench.run_case("tpu-sz", "baryon_density", fields["baryon_density"], cfg,
                            device="cpu")
        ok, _ = spectrum.pk_gate(fields["baryon_density"], r.reconstructed)
        assert not ok or r.ratio <= pick.ratio


def test_evaluate_gates_equal_reference(nyx_small):
    """P(k) deviations over Nyx fields and the FoF halo deviation over a
    perturbed HACC snapshot (grid 32), as the reference computes them."""
    rng = np.random.default_rng(0)
    orig = {k: nyx_small[k] for k in ("baryon_density", "vx")}
    recon = {k: v + rng.normal(scale=1e-3 * v.std(), size=v.shape).astype(np.float32)
             for k, v in orig.items()}
    snap = cosmo.hacc_particles(grid=32)
    pos = snap.positions()
    pos_r = (pos + rng.uniform(-0.05, 0.05, pos.shape)) % snap.box
    got = guideline.evaluate_gates(orig, recon, particles=(pos, pos_r, snap.box))
    want = jguide.evaluate_gates(orig, recon, particles=(pos, pos_r, snap.box))
    assert got == want
    assert got[1] > 0 and got[2] > 0


def test_gate_rejects_destructive_config(nyx_small):
    f = nyx_small["baryon_density"]
    noisy = f + np.random.default_rng(0).normal(scale=f.std(), size=f.shape).astype(np.float32)
    ok, dev, _ = guideline.evaluate_gates({"d": f}, {"d": noisy})
    assert not ok and dev > 0.01
    assert (ok, dev) == jguide.evaluate_gates({"d": f}, {"d": noisy})[:2]


def test_checkpoint_gate():
    loss = lambda p: float(np.sum(p["w"] ** 2))  # noqa: E731
    p = {"w": np.ones(10, np.float32)}
    ok, delta = guideline.checkpoint_gate(loss, p, {"w": p["w"] * 1.00001}, tol=1e-3)
    assert ok and delta < 1e-3
    assert (ok, delta) == jguide.checkpoint_gate(loss, p, {"w": p["w"] * 1.00001}, tol=1e-3)
    assert not guideline.checkpoint_gate(loss, p, {"w": p["w"] * 2}, tol=1e-3)[0]


@pytest.mark.parametrize("ratios", [[], [3.0], [3.0, 3.01, 3.02], [2.0, 2.5, 3.4, 4.0]])
def test_rate_quality_feedback_equals_reference(ratios):
    traj = [{"step": i, "ratio": r} for i, r in enumerate(ratios)] + [{"step": 99}]
    assert guideline.rate_quality_feedback(traj) == jguide.rate_quality_feedback(traj)


# --------------------------------------------------------------------- PAT --


def test_local_execution_with_dependencies():
    wf = pat.Workflow("demo")
    wf.add(pat.Job("gen", fn=lambda: 21))
    wf.add(pat.Job("double", fn=lambda gen: gen * 2, depends_on=["gen"]))
    assert wf.run_local()["double"] == 42


def test_cycle_and_unknown_dependency_rejected():
    wf = pat.Workflow("bad")
    wf.add(pat.Job("a", fn=lambda: 1))
    wf.jobs["a"].depends_on.append("a")
    with pytest.raises(ValueError):
        wf.run_local()
    with pytest.raises(ValueError):
        pat.Workflow("w").add(pat.Job("x", fn=lambda: 0, depends_on=["nope"]))


def _workflow(mod, sweep_fn, gate_fn):
    wf = mod.Workflow("cosmo")
    wf.add(mod.Job("cbench", fn=sweep_fn, nodes=1))
    wf.add(mod.Job("spectra", command="python -m benchmarks.power_spectrum",
                   depends_on=["cbench"], nodes=2, time_limit="02:00:00"))
    wf.add(mod.Job("gate", fn=gate_fn, depends_on=["cbench", "spectra"], partition="gpu"))
    return wf


def test_slurm_text_equals_reference_up_to_module_names(tmp_path):
    tw = _workflow(pat, cbench.run_sweep, guideline.best_fit_per_field)
    jw = _workflow(jpat, jcbench.run_sweep, jguide.best_fit_per_field)
    ts = tw.write_submission_script(tmp_path / "t" / "submit.sh")
    js = jw.write_submission_script(tmp_path / "j" / "submit.sh")
    assert "sbatch --parsable" in ts.read_text()
    assert subprocess.run(["bash", "-n", str(ts)]).returncode == 0

    def norm(text, root):
        return text.replace(str(root), "ROOT").replace("repro_torch.", "repro.")

    assert norm(ts.read_text(), tmp_path / "t") == norm(js.read_text(), tmp_path / "j")
    for job in ("cbench", "spectra", "gate"):
        t = (tmp_path / "t" / "cosmo_jobs" / f"{job}.sbatch").read_text()
        j = (tmp_path / "j" / "cosmo_jobs" / f"{job}.sbatch").read_text()
        assert norm(t, None) == j
    gate = (tmp_path / "t" / "cosmo_jobs" / "gate.sbatch").read_text()
    assert "python -m repro_torch.foresight.guideline # best_fit_per_field" in gate
    assert "--dependency=afterok:${JOB_CBENCH}:${JOB_SPECTRA}" in gate


# ---------------------------------------------------------------- examples --


def _example(name):
    spec = importlib.util.spec_from_file_location(name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_quickstart_example_runs_on_the_cpu(capsys):
    out = _example("torch_quickstart").main(["--device", "cpu", "--n", "32"])
    assert set(out) == {"tpu-sz", "tpu-zfp"} and out["tpu-zfp"][0] == 4.0
    assert "pk-ratio gate" in capsys.readouterr().out


def test_workflow_example_runs_into_a_directory(tmp_path):
    res = _example("torch_foresight_workflow").main(
        ["--device", "cpu", "--out", str(tmp_path), "--n", "32"])
    assert (tmp_path / "submit_all.sh").exists()
    assert (tmp_path / "foresight-demo_jobs" / "cbench-sweep.sbatch").exists()
    rows = (tmp_path / "cinema_db" / "data.csv").read_text().strip().splitlines()
    assert len(rows) == 1 + len(res["cbench-sweep"]) == 10
    assert res["cinema"] == tmp_path / "cinema_db" / "data.csv"
