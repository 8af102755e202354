"""``python -m qaig_tpu_torch.scripts.eval_quality`` (the port's mean-PSNR
tool) against ``scripts/eval_quality.py``, on the CPU.

A tiny autoencoder (``tests/test_torch_port_stages.py``'s: 2 layers, 8-16
channels, 4x4x4 latents) with seeded weights (the convolutions' at 3x
``random_params``' scale, so that the decoder's output follows its latent
and each codebook's PSNR differs from the autoencoder's by > 0.01 dB) and
two codebooks (HR: 2x2 patches, K 16; LR: one 4x4 patch, K 8), all
written by ``qaig_tpu`` and read by the port through ``convert.py``, over
a handful of 16x16 PNGs whose rows use every filter.  ``qaig_tpu``'s
script runs as ``tests/test_pipeline.py`` runs it (loaded from its file,
``main()`` under a patched ``sys.argv``, stdout captured); the port's as
a module in a new process, and in-process for its call counts.

Tolerance: the printed PSNRs within 1e-3 dB.  Both tools print them
rounded to 3 decimals, so one unit of the last digit is within it; the
unrounded values differ by float32 rounding in the convolutions
(~1e-5 dB).  ``psnr_db`` itself is equal to ``qaig_tpu``'s.
"""

import importlib.util
import io
import json
import subprocess
import sys
from contextlib import redirect_stdout
from pathlib import Path

import numpy as np
import pytest
import torch

from qaig_tpu_torch.utils import png

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_port_models import random_params  # noqa: E402
from test_torch_port_stages import AE_CFG  # noqa: E402

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def fixture_files(tmp_path_factory):
    """(dataset manifest, autoencoder checkpoint, [HR, LR] codebooks)."""
    import jax
    from qaig_tpu.train.autoencoder import build_autoencoder, checkpoint_dict
    from qaig_tpu.train.optim import make_adam
    from qaig_tpu.utils.checkpoint import save_model
    from qaig_tpu_torch.data.manifest import write_manifest

    root = tmp_path_factory.mktemp("eval_quality")
    rng = np.random.default_rng(12)
    rows = []
    for i in range(7):
        path = root / f"{i}.png"
        yy, xx = np.mgrid[0:16, 0:16]
        pixels = (yy[..., None] * 9 + xx[..., None] * 5 * (i + 1)
                  + rng.integers(0, 30, (16, 16, 3)))
        path.write_bytes(png.encode((pixels % 256).astype(np.uint8),
                                       [i % 5, 4, 3, 1, 2]))
        rows.append({"image_fpath": str(path), "labels": []})
    dataset = write_manifest(root / "dataset.json", rows)
    model, cfg = build_autoencoder(AE_CFG)
    params = jax.tree_util.tree_map(
        lambda x: np.asarray(x) * (3 if np.ndim(x) > 1 else 1),
        random_params(model.init, 9))
    tx = make_adam(1e-3, 50_000)
    assert save_model(checkpoint_dict(cfg, params, tx.init(params),
                                      global_steps=4), root, "ae.pt")
    ae = root / "models_checkpoint" / "ae.pt"
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
    return dataset, ae, books


def _argv(files, extra=()):
    dataset, ae, books = files
    argv = ["--device", "cpu", "--dataset-path", str(dataset),
            "--model-path", str(ae)]
    for book in books:
        argv += ["--codebook-path", str(book)]
    return argv + list(extra)


def _reference(argv):
    spec = importlib.util.spec_from_file_location(
        "eval_quality", REPO / "scripts" / "eval_quality.py")
    eval_quality = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(eval_quality)
    saved = sys.argv
    sys.argv = ["eval_quality.py", *argv]
    buf = io.StringIO()
    try:
        with redirect_stdout(buf):
            eval_quality.main()
    finally:
        sys.argv = saved
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def _within(got, want, tol=1e-3):
    """Printed values (3 decimals) within ``tol`` dB."""
    return round(abs(got - want), 6) <= tol


@pytest.mark.parametrize("extra", [[], ["--batch-size", "2",
                                        "--max-images", "5"]],
                         ids=["defaults", "ragged_batches"])
def test_port_json_matches_qaig_tpu(fixture_files, extra):
    want = _reference(_argv(fixture_files, extra))
    proc = subprocess.run(
        [sys.executable, "-m", "qaig_tpu_torch.scripts.eval_quality",
         *_argv(fixture_files, extra)], cwd=REPO, capture_output=True,
        text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    lines = proc.stdout.strip().splitlines()
    assert len(lines) == 1, proc.stdout
    got = json.loads(lines[0])
    assert got.keys() == want.keys()
    assert got["num_images"] == want["num_images"] == (5 if extra else 7)
    assert _within(got["psnr_recon_db"], want["psnr_recon_db"]), (got, want)
    assert got["psnr_quantized_db"].keys() == want["psnr_quantized_db"].keys()
    assert len(got["psnr_quantized_db"]) == 2
    for name, value in want["psnr_quantized_db"].items():
        assert np.isfinite(value)
        assert abs(value - want["psnr_recon_db"]) > 0.01
        assert _within(got["psnr_quantized_db"][name], value), (got, want)


def test_one_bmu_call_a_batch_a_codebook(fixture_files, monkeypatch,
                                         capsys):
    """In-process: the images come through ``load_batch`` (the native
    batch decoder), one ``get_patches_bmu`` a batch and a codebook, and
    the printed line rounds the returned values."""
    from qaig_tpu_torch.data.image_dataset import ImageDataset
    from qaig_tpu_torch.models.codebook import Codebook
    from qaig_tpu_torch.scripts import eval_quality

    calls = {"bmu": [], "load_batch": 0}
    bmu, load_batch = Codebook.get_patches_bmu, ImageDataset.load_batch

    def counted_bmu(self, x, reshape=False):
        calls["bmu"].append((self.num_embeddings, x.shape[0]))
        return bmu(self, x, reshape=reshape)

    def counted_load(self, indices, num_threads):
        calls["load_batch"] += 1
        return load_batch(self, indices, num_threads)
    monkeypatch.setattr(Codebook, "get_patches_bmu", counted_bmu)
    monkeypatch.setattr(ImageDataset, "load_batch", counted_load)
    result = eval_quality.main(_argv(fixture_files, ["--batch-size", "3"]))
    assert calls["load_batch"] == 3
    assert calls["bmu"] == [(16, 3), (8, 3), (16, 3), (8, 3), (16, 1),
                            (8, 1)]
    printed = json.loads(capsys.readouterr().out.strip())
    assert printed["num_images"] == result["num_images"] == 7
    assert printed["psnr_recon_db"] == round(result["psnr_recon_db"], 3)


def test_psnr_equals_qaig_tpu_and_cuda_needs_a_card(fixture_files):
    from qaig_tpu_torch.scripts import eval_quality
    spec = importlib.util.spec_from_file_location(
        "eval_quality", REPO / "scripts" / "eval_quality.py")
    reference = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(reference)
    rng = np.random.default_rng(0)
    clean = rng.uniform(-1, 1, (4, 3, 8, 8)).astype(np.float32)
    recon = clean + rng.normal(0, 0.05, clean.shape).astype(np.float32)
    assert eval_quality.psnr_db(clean, recon) == reference.psnr_db(clean,
                                                                   recon)
    assert eval_quality.psnr_db(clean, clean) == reference.psnr_db(clean,
                                                                   clean)
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    argv = _argv(fixture_files)
    argv[argv.index("cpu")] = "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        eval_quality.main(argv)
