"""The port's quality ledger (``qaig_tpu_torch/scripts/{quality_run,
sampling_sweep,quality_bf16_ab,render_quality}.py``) against the JAX
side's scripts (``scripts/*.py``), on the CPU.

- The dataset: both ``make_dataset``s at seed 0, 32x32, 6 images: the PNG
  pixels are bit-equal, decoded by ``utils/png.py::decode`` and by PIL.
- Evaluation: ``QualityEval.psnr_recon`` / ``.psnr_quantized`` against
  the JAX side's on 6 images of 16x16 (latents of 4x4 under a 2-layer
  autoencoder), one seeded autoencoder and two codebooks written by
  ``qaig_tpu`` and read by the port through ``convert.py``: within 1e-3 dB
  (both round to 3 decimals, so one unit of the last digit is within
  it).  The JAX side's BMU runs as its own CPU tests run it
  (``scripts/quality_run.py``'s jitted function).
- The helpers, over the same fixture directories: equal results.
- Rendering: over one report, the port's ledger has the JAX renderer's
  headings and table rows, apart from the title and the rows and lines
  labelled with the reference (``qaig_tpu, <device>``) that it adds.
- End to end: ``--smoke --device cpu`` in a new process carries
  ``tests/test_quality_run.py``'s schema asserts; ``--stop-after
  codebooks`` too; a second ``--resume`` invocation retrains nothing; the
  sweep and the A/B consume the runs.
"""

import importlib.util
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from qaig_tpu_torch.scripts import quality_bf16_ab, quality_run
from qaig_tpu_torch.scripts import render_quality, sampling_sweep
from qaig_tpu_torch.utils import png

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
from test_torch_port_models import random_params  # noqa: E402
from test_torch_port_stages import AE_CFG  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parents[1]
LABEL = "qaig_tpu, TPU v5 lite"
# the smoke runs in new processes: few threads, as the tests run beside
# other workers
ENV = dict(os.environ, OMP_NUM_THREADS="2")


def _jax_script(name):
    """``scripts/<name>.py`` loaded from its file (``scripts/`` on the
    path only while it runs its imports)."""
    spec = importlib.util.spec_from_file_location(
        f"jax_side_{name}", REPO / "scripts" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def jax_quality():
    return _jax_script("quality_run")


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


# ---------------------------------------------------------------------------
# the dataset
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def datasets(tmp_path_factory, jax_quality):
    root = tmp_path_factory.mktemp("datasets")
    mine = quality_run.make_dataset(root / "port", 6, 0, size=32)
    theirs = jax_quality.make_dataset(root / "jax", 6, 0, size=32)
    return root, mine, theirs


@pytest.mark.parametrize("decoder", ["png", "pil"])
def test_dataset_pixels_equal_jax(datasets, decoder):
    from PIL import Image

    def pixels(path, how):
        if how == "png":
            return png.decode(pathlib.Path(path).read_bytes())
        with Image.open(path) as image:
            return np.asarray(image.convert("RGB"))

    _, (manifest, paths), (jax_manifest, jax_paths) = datasets
    assert len(paths) == len(jax_paths) == 6
    for mine, theirs in zip(paths, jax_paths):
        assert pathlib.Path(mine).name == pathlib.Path(theirs).name
        want = pixels(theirs, "pil")
        assert want.shape == (32, 32, 3) and want.std() > 0
        np.testing.assert_array_equal(pixels(mine, decoder), want)
    rows = json.loads(pathlib.Path(manifest).read_text())
    jax_rows = json.loads(pathlib.Path(jax_manifest).read_text())
    assert ([r["image_fpath"] for r in rows["_default"].values()]
            == [str(p) for p in paths])
    assert rows["_default"].keys() == jax_rows["_default"].keys()


# ---------------------------------------------------------------------------
# evaluation
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def eval_files(datasets):
    """(eval manifest, autoencoder checkpoint, [HR, LR] codebooks), all
    written by ``qaig_tpu``, and the JAX autoencoder and parameters the
    checkpoint holds."""
    import jax
    from qaig_tpu.train.autoencoder import build_autoencoder, checkpoint_dict
    from qaig_tpu.train.optim import make_adam
    from qaig_tpu.utils.checkpoint import save_model

    root = datasets[0] / "eval"
    manifest, _ = quality_run.make_dataset(root, 6, 1, size=16)
    model, cfg = build_autoencoder(AE_CFG)
    # 3x the convolutions' scale: the decoder's output follows its latent,
    # so each codebook's PSNR differs from the reconstruction's
    params = jax.tree_util.tree_map(
        lambda x: np.asarray(x) * (3 if np.ndim(x) > 1 else 1),
        random_params(model.init, 9))
    tx = make_adam(1e-3, 50_000)
    assert save_model(checkpoint_dict(cfg, params, tx.init(params),
                                      global_steps=4), root, "ae.pt")
    rng = np.random.default_rng(12)
    books = []
    for name, patch, k in (("cb_hr", 2, 16), ("cb_lr", 4, 8)):
        codes = rng.uniform(-0.9, 0.9, (k, 4 * patch * patch))
        assert save_model({"patch_dim": (patch, patch), "image_dim": (4, 4),
                           "image_C": 4, "num_embeddings": k,
                           "neighbourhood_range": 1,
                           "checkpoint": {"codebook":
                                          codes.astype(np.float32)}},
                          root, f"{name}.pt")
        books.append(root / "models_checkpoint" / f"{name}.pt")
    return (manifest, root / "models_checkpoint" / "ae.pt", books,
            (model, params))


@pytest.mark.parametrize("what", ["recon", "hr", "lr"])
def test_quality_eval_matches_jax(eval_files, jax_quality, monkeypatch,
                                  what):
    from qaig_tpu.train import common as jax_common
    from qaig_tpu.utils import load_model as jax_load
    from qaig_tpu_torch.train import common
    from qaig_tpu_torch.utils.checkpoint import load_model

    monkeypatch.syspath_prepend(str(REPO / "scripts"))  # its eval_quality
    manifest, ae_path, books, (jae, jparams) = eval_files
    cpu = torch.device("cpu")
    ae, _ = common.autoencoder_from_checkpoint(load_model(str(ae_path))[1],
                                               cpu)
    # 2 batches of 3 images (one shape: one XLA compile a function)
    mine = quality_run.QualityEval(manifest, cpu, batch_size=3)
    theirs = jax_quality.QualityEval(manifest, batch_size=3)
    if what == "recon":
        got, want = mine.psnr_recon(ae), theirs.psnr_recon(jae, jparams)
    else:
        path = str(books[0 if what == "hr" else 1])
        cb = common.codebook_from_checkpoint(load_model(path)[1], cpu)
        jcb, jcb_params = jax_common.codebook_from_checkpoint(
            jax_load(path)[1])
        got = mine.psnr_quantized(ae, cb)
        want = theirs.psnr_quantized(jae, jparams, jcb, jcb_params)
        assert abs(want - theirs.psnr_recon(jae, jparams)) > 0.01
    assert np.isfinite(want)
    assert round(abs(got - want), 6) <= 1e-3, (got, want)


# ---------------------------------------------------------------------------
# the helpers
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def stage_dir(tmp_path_factory):
    """A trainer's output directory: metrics.jsonl (a torn line, CE and
    recon losses), preview pairs (one of another size), checkpoints."""
    from PIL import Image
    d = tmp_path_factory.mktemp("stage")
    rng = np.random.default_rng(3)
    lines = [json.dumps({"step": s, "ce_loss": float(v),
                         "recon_loss": float(v) / 2})
             for s, v in enumerate(rng.uniform(0, 5, 41), start=1)]
    lines.insert(7, '{"step": 8, "ce_lo')
    lines.append(json.dumps({"step": 42, "lr": 1e-4}))
    (d / "metrics.jsonl").write_text("\n".join(lines) + "\n")
    (d / "images").mkdir()
    for step, side in ((0, 12), (10, 12), (20, 10), (100, 12)):
        for name in ("high_res_recon", "ground_truth"):
            px = rng.integers(0, 256, (side, side, 3), dtype=np.uint8)
            Image.fromarray(px).save(d / "images" / f"{name}_{step}.jpg")
    (d / "images" / "high_res_recon_30.jpg").write_bytes(
        (d / "images" / "high_res_recon_10.jpg").read_bytes())
    (d / "models_checkpoint").mkdir()
    for step in (0, 100, 20, 40):
        (d / "models_checkpoint" / f"model_{step}.pt").write_bytes(b"x")
    (d / "models_checkpoint" / "codebook_5.pt").write_bytes(b"x")
    return d


def _eval_cache_log(module, path):
    cache = module.EvalCache(path)
    log = [cache.get("ae/model_0")]
    cache.put("ae/model_0", 12.5)
    cache.put("cb_p2/codebook_0", 14.25)
    cache.put("cb_p2/codebook_10", 15.0)
    cache.drop_prefix("cb_p2/")
    cache.drop_prefix("missing/")
    again = module.EvalCache(path)
    log += [again.data, again.get("ae/model_0"),
            json.loads(pathlib.Path(path).read_text())]
    return log


HELPERS = {
    "ce_max_last_half": lambda m, d, tmp: [
        m.ce_max_last_half(d, n) for n in (1, 20, 40, 84, 200)]
    + [m.ce_max_last_half(tmp, 10)],
    "loss_curve": lambda m, d, tmp: [
        m.loss_curve(d, key, every=e) for key in ("ce_loss", "recon_loss")
        for e in (1, 7, 10, 50)] + [m.loss_curve(tmp, "ce_loss")],
    "preview_psnr": lambda m, d, tmp: [m.preview_psnr(d),
                                       m.preview_psnr(tmp)],
    "checkpoints": lambda m, d, tmp: [
        [p.name for p in m.checkpoints(d)],
        [p.name for p in m.checkpoints(d, prefix="codebook")],
        [p.name for p in m.checkpoints(tmp)]],
    "stage_trained": lambda m, d, tmp: [
        m.stage_trained(d, "model", steps, every)
        for steps, every in ((41, 20), (42, 20), (43, 20), (41, 10),
                             (101, 100), (100, 100), (1, 5))]
    + [m.stage_trained(tmp, "model", 1, 1)],
    "EvalCache": lambda m, d, tmp: _eval_cache_log(m, tmp / "cache.json"),
    "token_diversity": None,
}


@pytest.mark.parametrize("name", list(HELPERS))
def test_helpers_equal_jax(name, stage_dir, jax_quality, tmp_path):
    if name == "token_diversity":
        jax_sweep = _jax_script("sampling_sweep")
        rng = np.random.default_rng(5)
        cases = [rng.integers(0, 4, (6, 10)), np.zeros((3, 5), np.int64),
                 rng.integers(0, 512, (25, 64)),
                 np.repeat(rng.integers(0, 3, (2, 7)), 3, axis=0)]
        got = [sampling_sweep.token_diversity(torch.from_numpy(c).numpy())
               for c in cases]
        want = [jax_sweep.token_diversity(c) for c in cases]
        assert got == want
        assert got[1] == (0.333, 0.0)
        return
    mine, theirs = tmp_path / "mine", tmp_path / "theirs"
    mine.mkdir(), theirs.mkdir()
    got = HELPERS[name](quality_run, stage_dir, mine)
    want = HELPERS[name](jax_quality, stage_dir, theirs)
    assert got == want
    assert any(v not in (None, [], False) for v in got), got


# ---------------------------------------------------------------------------
# end to end: --smoke, --resume, --stop-after, the sweep and the A/B
# ---------------------------------------------------------------------------

def _command(module, *argv):
    return [sys.executable, "-m", f"qaig_tpu_torch.scripts.{module}", *argv]


def _finish(proc, timeout=300):
    stdout, stderr = proc.communicate(timeout=timeout)
    assert proc.returncode == 0, stdout[-3000:] + stderr[-3000:]
    return stdout


def _run(module, *argv):
    return _finish(subprocess.Popen(
        _command(module, *argv), cwd=REPO, env=ENV, text=True,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE))


@pytest.fixture(autouse=True, scope="module")
def background_runs(tmp_path_factory):
    """The ``--smoke`` run and the ``--stop-after codebooks`` run, started
    in new processes before the first test, so that they overlap the
    in-process comparisons; a test that needs one waits for it."""
    runs = {}
    for name, extra in (("smoke", ()),
                        ("stop", ("--stop-after", "codebooks")),
                        ("coarsest", ("--stop-after", "codebooks",
                                      "--cb-patches", "p4"))):
        out = tmp_path_factory.mktemp(name)
        runs[name] = (out, subprocess.Popen(
            _command("quality_run", "--smoke", *extra, "--out-dir",
                     str(out), "--device", "cpu"),
            cwd=REPO, env=ENV, text=True, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE))
    yield runs
    for _, proc in runs.values():
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


@pytest.fixture(scope="module")
def smoke_run(background_runs):
    out, proc = background_runs["smoke"]
    return out, _finish(proc)


def test_smoke_run_schema(smoke_run):
    """``tests/test_quality_run.py::test_quality_run_smoke``'s asserts."""
    out, stdout = smoke_run
    last = json.loads(stdout.strip().splitlines()[-1])
    assert last["quality_json"] == str(out / "quality.json")
    report = json.loads((out / "quality.json").read_text())
    assert report["device"] == report["backend"] == "cpu"
    assert report["memory"] == []
    stages = report["stages"]
    assert set(report["stage_seconds"]) >= set(stages)

    assert "autoencoder" in stages
    assert any(k.startswith("codebook_") for k in stages)
    assert "transformer_base" in stages
    assert any(k.startswith("transformer_casc") for k in stages)
    assert "generation" in stages

    ae = stages["autoencoder"]
    assert len(ae["psnr_trajectory"]) >= 2
    assert all(isinstance(p["psnr_recon_db"], float)
               for p in ae["psnr_trajectory"])
    assert len(ae["loss_curve"]) >= 2
    for key, st in stages.items():
        if key.startswith("codebook_"):
            assert len(st["psnr_trajectory"]) >= 2
        if key.startswith("transformer_"):
            assert len(st["loss_curve"]) >= 2

    for key, st in stages.items():
        if key.startswith("codebook_"):
            pr = st["prune"]
            assert 1 <= pr["kept"] <= pr["of"]
            assert pathlib.Path(pr["checkpoint"]).exists()
            assert isinstance(pr["psnr_quantized_db_after"], float)

    exp = next(iter(report["experiments"].values()))
    assert len(exp["psnr_trajectory"]) >= 2
    assert exp["num_embeddings"] == 2 * exp["baseline_k"]

    last_tf = [k for k in stages if k.startswith("transformer_casc")][-1]
    assert stages[last_tf]["stability"]["ema_decay"] > 0
    assert stages[last_tf]["stability"]["grad_clip"] > 0
    assert stages[last_tf]["ce_max_last_half"] is not None
    assert isinstance(stages[last_tf]["preview_psnr"], list)
    assert stages["transformer_base"]["stability"] is None

    assert pathlib.Path(stages["generation"]["grid"]).exists()
    grids = out / "grids"
    assert (grids / "generated_final.jpg").exists()
    assert (grids / "dataset_sample.png").exists()
    # the last cascade stage saved its EMA weights beside the model
    from qaig_tpu_torch.utils.checkpoint import load_model
    ckpt = load_model(stages[last_tf]["checkpoint"])[1]
    assert ckpt.get("model_ema") is not None


def test_resume_retrains_nothing(smoke_run):
    out, _ = smoke_run
    before = json.loads((out / "quality.json").read_text())
    mtimes = {p: p.stat().st_mtime_ns
              for p in out.rglob("models_checkpoint/*.pt")}
    assert len(mtimes) >= 10
    stdout = _run("quality_run", "--smoke", "--resume", "--out-dir",
                  str(out), "--device", "cpu")
    assert stdout.count("resume:") >= 8, stdout  # every stage skipped
    assert "retraining from scratch" not in stdout
    assert {p: p.stat().st_mtime_ns
            for p in out.rglob("models_checkpoint/*.pt")} == mtimes
    resumed = json.loads((out / "quality.json").read_text())
    assert resumed["stages"]["autoencoder"]["psnr_trajectory"] == \
        before["stages"]["autoencoder"]["psnr_trajectory"]
    assert set(resumed["stages"]) == set(before["stages"])
    assert "--resume" in resumed["argv"]


def test_sweep_ab_and_render_on_the_smoke_run(smoke_run, tmp_path,
                                              jax_quality):
    out, _ = smoke_run
    sweep = sampling_sweep.main(["--qrun-dir", str(out), "--num-images",
                                 "4", "--temperatures", "2.0", "--device",
                                 "cpu"])
    assert set(sweep["settings"]) == {"config", "single_path", "beams_t2"}
    for rec in sweep["settings"].values():
        assert 0 <= rec["unique_frac"] <= 1
        assert pathlib.Path(rec["grid"]).exists()
    assert sweep["settings"]["single_path"]["num_beam"] == {"0": 1, "1": 1}
    assert json.loads((out / "sweep.json").read_text()) == sweep

    ab = quality_bf16_ab.main(["--qrun-dir", str(out), "--steps", "3",
                               "--batch", "4", "--device", "cpu"])
    for tag in ("fp32", "bf16"):
        assert np.isfinite(ab[tag]["final_ce"])
        assert pathlib.Path(ab[tag]["checkpoint"]).exists()
    assert ab["final_ce_delta"] == round(
        ab["bf16"]["final_ce"] - ab["fp32"]["final_ce"], 4)

    doc = tmp_path / "Q.md"
    render_quality.main(["--report", str(out / "quality.json"), "--doc",
                         str(doc), "--grids-dir", str(tmp_path / "g")])
    text = doc.read_text()
    for must in ("prune", "Side experiment", "Sampling knobs",
                 "max CE, 2nd half", "bf16 mixed-precision A/B"):
        assert must in text, must
    for name in ("quality.json", "bf16_ab.json", "sweep.json",
                 "generated_final.jpg", "sweep_config.jpg"):
        assert (tmp_path / "g" / name).exists(), name


def test_stop_after_codebooks(background_runs, tmp_path):
    """``tests/test_quality_run.py::test_quality_run_stop_after_codebooks``'s
    asserts; the renderer refuses the partial run."""
    run_dir, proc = background_runs["stop"]
    _finish(proc)
    report = json.loads((run_dir / "quality.json").read_text())
    assert report["stopped_after"] == "codebooks"
    stages = report["stages"]
    assert "autoencoder" in stages
    assert any(k.startswith("codebook_") for k in stages)
    assert not any(k.startswith("transformer_") for k in stages)
    assert (run_dir / "tf_base.json").exists()
    for key, st in stages.items():
        if key.startswith("codebook_"):
            assert pathlib.Path(st["checkpoint"]).exists()
    with pytest.raises(SystemExit, match="partial run"):
        render_quality.main(["--report", str(run_dir / "quality.json"),
                             "--doc", str(tmp_path / "Q.md")])


def test_coarsest_codebook_subset_skips_the_k_experiment(background_runs):
    """``--cb-patches`` naming only the coarsest codebook, with the K
    experiment on: the run finishes (the experiment sits beside the finest
    codebook, which this subset does not train, so it is skipped) and the
    report holds that one codebook and no experiment."""
    run_dir, proc = background_runs["coarsest"]
    _finish(proc)
    report = json.loads((run_dir / "quality.json").read_text())
    assert report["stopped_after"] == "codebooks"
    assert [k for k in report["stages"] if k.startswith("codebook_")] == [
        "codebook_p4"]
    assert "experiments" not in report
    assert not (run_dir / "cb_p1_k32").exists()


def test_unknown_codebook_name_is_a_parser_error(tmp_path):
    """An unknown ``--cb-patches`` name exits non-zero before any stage
    runs, naming the unknown name (a known one beside it is no excuse)."""
    proc = subprocess.run(
        _command("quality_run", "--smoke", "--stop-after", "codebooks",
                 "--cb-patches", "p2,p3", "--out-dir", str(tmp_path / "q"),
                 "--device", "cpu"),
        cwd=REPO, env=ENV, text=True, capture_output=True, timeout=120)
    assert proc.returncode == 2, proc.stdout + proc.stderr
    assert "unknown codebook name(s) p3" in proc.stderr, proc.stderr
    assert "p2" not in proc.stderr.split("unknown codebook name(s)")[1] \
        .split("(")[0]
    assert not (tmp_path / "q").exists()


# ---------------------------------------------------------------------------
# rendering against the JAX renderer
# ---------------------------------------------------------------------------

def _headings_and_tables(text):
    return [line for line in text.splitlines()
            if line.startswith(("#", "|"))]


@pytest.mark.parametrize("which", ["ledger", "smoke"])
def test_render_matches_jax_renderer(which, tmp_path, smoke_run):
    import shutil
    if which == "ledger":
        # QUALITY.md's own report, A/B and sweep, with grids
        run = tmp_path / "run"
        (run / "grids").mkdir(parents=True)
        for name in ("quality.json", "bf16_ab.json", "sweep.json"):
            shutil.copyfile(REPO / "docs" / "quality" / name, run / name)
        for grid in ("generated_final.jpg", "dataset_sample.png"):
            shutil.copyfile(REPO / "docs" / "quality" / grid,
                            run / "grids" / grid)
        report = run / "quality.json"
    else:
        report = smoke_run[0] / "quality.json"
    jax_render = _jax_script("render_quality")
    saved = sys.argv
    sys.argv = ["render_quality.py", "--report", str(report), "--doc",
                str(tmp_path / "jax.md"), "--grids-dir",
                str(tmp_path / "jax_grids")]
    try:
        jax_render.main()
    finally:
        sys.argv = saved
    render_quality.main(["--report", str(report), "--doc",
                         str(tmp_path / "port.md"), "--grids-dir",
                         str(tmp_path / "port_grids")])
    want = _headings_and_tables((tmp_path / "jax.md").read_text())
    text = (tmp_path / "port.md").read_text()
    got = _headings_and_tables(text)
    assert got[0] != want[0]  # the title names the port
    assert [line for line in got[1:] if LABEL not in line] == want[1:]
    body = text.split("- **Reproduce**")[1]
    assert "python -m qaig_tpu_torch.scripts.quality_run" in body
    ref = json.loads((REPO / "docs" / "quality" / "quality.json")
                     .read_text())
    labelled = [line for line in text.splitlines() if LABEL in line]
    if which == "ledger":
        # every reported quantity has its reference beside it: 6 AE
        # checkpoints and the loss curve, 4 codebooks, the K experiment,
        # 3 transformers and their previews, 2 A/B rows and the delta, 5
        # sweep settings, and the intro's label
        assert len(labelled) == 6 + 1 + 4 + 1 + 3 + 3 + 2 + 1 + 5 + 1
        for row in labelled:
            # quality numbers only: the A/B rows carry no reference time
            assert "351.0" not in row and "161.4" not in row
        assert f"| 500, {LABEL} | 24.401 |" in labelled
        assert str(ref["stages"]["codebook_p2"]["prune"][
            "psnr_quantized_db_after"]) in "".join(labelled)
    else:
        # at smoke scale the stages shared by name (p4, p2, base) get
        # their reference rows; the AE's steps (0, 10) only step 0
        assert f"| 0, {LABEL} | 12.661 |" in labelled
        assert any(row.startswith(f"| p2 (2×2), {LABEL}") for row in labelled)
        assert any(row.startswith(f"| base, {LABEL}") for row in labelled)


@pytest.mark.parametrize("module", [quality_run, sampling_sweep,
                                    quality_bf16_ab],
                         ids=["quality_run", "sampling_sweep",
                              "quality_bf16_ab"])
def test_device_cuda_needs_a_card(module, smoke_run, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    argv = (["--smoke", "--out-dir", str(tmp_path)]
            if module is quality_run else ["--qrun-dir", str(smoke_run[0])])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        module.main(argv)
    assert not (tmp_path / "quality.json").exists()
