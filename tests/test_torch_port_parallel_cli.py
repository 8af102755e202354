"""The port's entry points over 2 gloo processes on the CPU
(``--multihost --device cpu``), the loader's per-data-coordinate slices,
the background checkpoint write (``--checkpoint-backend pickle-async``)
and the CLIs' parallel flags against ``qaig_tpu``'s.

The 2-process runs start together once per module (``file://``
rendezvous in a temporary directory, one torch thread a process): the
transformer trainer data-parallel (its checkpoints written in the
background), tensor-parallel and pipelined; the feature-map and pruning
stages; generation data-parallel through the CLI and tensor-parallel at
greedy.  Only rank 0 writes; the losses (rtol 1e-5) and the tokens
(exactly) equal a 1-process run's; a 2-process checkpoint loads in
``qaig_tpu`` and resumes in the port.  Sizes are those of
``tests/test_torch_port_train.py`` (2 decoder layers, in_dim 32, hidden
48; codebooks of K 8 and 11 over 2x8x8 latents).
"""

import functools
import json
import os
import pickle
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
LR_K, HR_K = 8, 11
LATENT = (2, 8, 8)

GENERATE = """
import sys, torch
torch.set_num_threads(1)
from qaig_tpu_torch.infer import decode, generate
decode._categorical = lambda logits, draw: logits.argmax(dim=-1)
args = dict(device="cpu", config_path=sys.argv[1], decoder_path=sys.argv[2],
            num_images=4, seed=3, out_dir=sys.argv[3],
            num_model_shards=int(sys.argv[4]))
if len(sys.argv) > 6:
    args.update(multihost=True, coordinator_address=sys.argv[5],
                num_processes=2, process_id=int(sys.argv[6]))
torch.save(generate.run(args), sys.argv[3] + f"/tokens_{sys.argv[-1]}.pt")
"""


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _latents(n, seed):
    return np.random.default_rng(seed).standard_normal(
        (n,) + LATENT).astype(np.float32)


def _write_fixture(root):
    """Feature maps, 16x16 PNGs, an autoencoder, LR (patch 4) and HR
    (patch 2) codebooks, a windowed cascade config and a 2-stage
    generation config, with the port's writers."""
    from qaig_tpu_torch.convert import to_jax_state
    from qaig_tpu_torch.data.manifest import write_manifest
    from qaig_tpu_torch.models.codebook import Codebook
    from qaig_tpu_torch.models.conv_nets import (Autoencoder,
                                                 AutoencoderConfig)
    from qaig_tpu_torch.models.core import init_parameters
    from qaig_tpu_torch.models.transformer import (Transformer,
                                                   TransformerConfig)
    from qaig_tpu_torch.utils import png
    from qaig_tpu_torch.utils.checkpoint import save_model

    gen = torch.Generator().manual_seed(18)
    rows, images = [], []
    for i, x in enumerate(_latents(8, 15)):
        path = root / f"fmap_{i}.npy"
        np.save(path, x)
        rows.append({"fmap_path": str(path), "image_path": ""})
        image = root / f"image_{i}.png"
        image.write_bytes(png.encode(np.random.default_rng(i).integers(
            0, 256, (16, 16, 3), dtype=np.uint8)))
        images.append({"image_fpath": str(image), "labels": []})
    fmaps = write_manifest(root / "all_dataset.json", rows)
    image_manifest = write_manifest(root / "images.json", images)
    ae_cfg = dict(num_layers=1, image_channel=3, min_channel=8,
                  max_channel=16, latent_channel=LATENT[0],
                  hidden_activation_type="silu",
                  use_final_enc_activation=True,
                  encoder_activation_type="silu",
                  use_final_dec_activation=True,
                  decoder_activation_type="tanh")
    ae = init_parameters(Autoencoder(AutoencoderConfig(**ae_cfg)), gen)
    save_model(dict(ae_cfg, model=to_jax_state(ae)), root, "ae.pt")
    for name, patch, k in (("lr", (4, 4), LR_K), ("hr", (2, 2), HR_K)):
        cb = Codebook(patch_dim=patch, image_dim=LATENT[1:],
                      image_channel=LATENT[0], num_embeddings=k).init(gen)
        save_model({"patch_dim": patch, "image_dim": LATENT[1:],
                    "image_C": LATENT[0], "num_embeddings": k,
                    "neighbourhood_range": 2,
                    "checkpoint": to_jax_state(cb)}, root, f"{name}.pt")
    tf = {"model_lr": 1e-3, "use_sliding_window": True, "sliding_window": 8,
          "num_enc_layers": 1, "num_dec_layers": 2, "self_attn_heads": 4,
          "cross_attn_heads": 4, "in_dim": 32, "hidden_dim": 48,
          "hidden_activation": "silu"}
    (root / "tf.json").write_text(json.dumps(tf))
    (root / "ae.json").write_text(json.dumps(dict(ae_cfg, model_lr=1e-3)))
    (root / "cb.json").write_text(json.dumps({
        "model_lr": 1e-3, "image_H": 8, "image_W": 8, "image_C": 2,
        "patch_H": 2, "patch_W": 2, "num_embeddings": HR_K,
        "neighbourhood_step": 2}))
    ckpt = root / "models_checkpoint"
    stages = {}   # stage 1's encoder reads stage 0's HR tokens
    for i, (base, lr, lr_k) in enumerate(((True, "lr", LR_K),
                                          (False, "hr", HR_K))):
        hr_k = HR_K
        cfg = TransformerConfig(
            use_encoder=not base, use_pos_cond=not base,
            num_enc_layers=0 if base else 1, num_dec_layers=2,
            num_enc_embedding=1 if base else lr_k,
            num_dec_embedding=lr_k + hr_k if base else hr_k + 1,
            self_attn_heads=4, cross_attn_heads=0 if base else 4,
            in_dim=32, out_dim=hr_k + 1, hidden_dim=48)
        model = init_parameters(Transformer(cfg), gen)
        save_model({"train_base_model": base, "use_sliding_window": not base,
                    "sliding_window": None if base else 8,
                    "num_enc_layers": None if base else 1,
                    "num_enc_embedding": None if base else lr_k,
                    "num_dec_embedding": cfg.num_dec_embedding,
                    "num_dec_layers": 2, "self_attn_heads": 4,
                    "cross_attn_heads": None if base else 4,
                    "transformer_in_dim": 32, "transformer_out_dim": hr_k + 1,
                    "transformer_hidden_dim": 48, "hidden_activation": "silu",
                    "model": to_jax_state(model)}, root, f"tf{i}.pt")
        stages[str(i)] = {"model_path": str(ckpt / f"tf{i}.pt"),
                          "lr_codebook_path": str(ckpt / f"{lr}.pt"),
                          "hr_codebook_path": str(ckpt / "hr.pt"),
                          "temperature": 1.0, "num_beam": 2,
                          "beam_width": 4}
    (root / "gen.json").write_text(json.dumps(stages))
    return {"fmaps": fmaps, "images": image_manifest,
            "ae": ckpt / "ae.pt", "lr": ckpt / "lr.pt", "hr": ckpt / "hr.pt",
            "tf": root / "tf.json", "gen": root / "gen.json",
            "ae_config": root / "ae.json", "cb_config": root / "cb.json"}


def _train_argv(paths, out, *extra):
    return ["--device", "cpu", "--dataset-path", str(paths["fmaps"]),
            "--decoder-path", str(paths["ae"]),
            "--lr-codebook-path", str(paths["lr"]),
            "--hr-codebook-path", str(paths["hr"]),
            "--config-path", str(paths["tf"]), "--out-dir", str(out),
            "--batch-size", "4", "--test-num-sample", "2",
            "--checkpoint-step", "2", "--max-steps", "3",
            "--ema-decay", "0.9", "--grad-clip", "0.5", *extra]


def _spawn(root, name, argv_of_rank, module=None, code=None):
    """The 2 processes of one run; ``argv_of_rank(rank, rendezvous)``."""
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(REPO))
    rendezvous = f"file://{root}/rendezvous_{name}"
    head = (["-m", module] if module else ["-c", code])
    return [subprocess.Popen(
        [sys.executable, *head, *argv_of_rank(rank, rendezvous)], cwd=REPO,
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for rank in range(2)]


def _multihost(rank, rendezvous):
    return ["--multihost", "--coordinator-address", rendezvous,
            "--num-processes", "2", "--process-id", str(rank)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every 2-process run, started together; {name: (processes, its
    output directory)} and the fixture's paths."""
    root = tmp_path_factory.mktemp("parallel_cli")
    paths = _write_fixture(root)
    started = {}

    def start(name, module, argv, code=None):
        out = root / name
        out.mkdir()
        started[name] = (_spawn(root, name, lambda r, rv: argv(out, r, rv),
                                module=module, code=code), out)

    train = "qaig_tpu_torch.cli.train_quantized_transformer"
    start("train_dp2", train, lambda out, r, rv: _train_argv(
        paths, out, "--checkpoint-backend", "pickle-async",
        "--keep-checkpoints", "1", "--grad-accum", "2",
        *_multihost(r, rv)))
    start("train_tp2", train, lambda out, r, rv: _train_argv(
        paths, out, "--num-model-shards", "2", *_multihost(r, rv)))
    start("train_pp2", train, lambda out, r, rv: _train_argv(
        paths, out, "--num-pipeline-stages", "2", *_multihost(r, rv)))
    front = ["--device", "cpu", "--batch-size", "4", "--max-steps", "3",
             "--checkpoint-step", "2"]
    start("ae_zero2", "qaig_tpu_torch.cli.train_autoencoder",
          lambda out, r, rv: front + [
              "--dataset-path", str(paths["images"]), "--config-path",
              str(paths["ae_config"]), "--zero-opt", "--checkpoint-backend",
              "pickle-async", "--out-dir", str(out), *_multihost(r, rv)])
    start("cb_dp2", "qaig_tpu_torch.cli.train_codebook",
          lambda out, r, rv: front + [
              "--dataset-path", str(paths["fmaps"]), "--decoder-path",
              str(paths["ae"]), "-c", str(paths["cb_config"]), "--out-dir",
              str(out), *_multihost(r, rv)])
    start("fmap", "qaig_tpu_torch.cli.generate_fmap_dataset",
          lambda out, r, rv: [
              "--device", "cpu", "--dataset-path", str(paths["images"]),
              "--model-path", str(paths["ae"]), "--batch-size", "4",
              "--out-dir", str(out), *_multihost(r, rv)])
    start("prune", "qaig_tpu_torch.cli.prune_codebook", lambda out, r, rv: [
        "--device", "cpu", "--dataset-path", str(paths["fmaps"]),
        "--codebook-path", str(paths["hr"]), "--prune-threshold", "1",
        "--checkpoint-backend", "pickle-async", "--out-dir", str(out),
        *_multihost(r, rv)])
    start("generate_dp2", "qaig_tpu_torch.cli.generate_images",
          lambda out, r, rv: [
              "--device", "cpu", "--config-path", str(paths["gen"]),
              "--decoder-path", str(paths["ae"]), "--num-images", "4",
              "--seed", "3", "--out-dir", str(out), *_multihost(r, rv)])
    start("generate_tp2", None, lambda out, r, rv: [
        str(paths["gen"]), str(paths["ae"]), str(out), "2", rv, str(r)],
        code=GENERATE)
    yield started, paths, root
    for procs, _ in started.values():
        for p in procs:
            if p.poll() is None:
                p.kill()


def _finished(runs, name):
    """The run's output directory once both processes exited 0."""
    procs, out = runs[0][name]
    for p in procs:
        text, _ = p.communicate(timeout=420)
        assert p.returncode == 0, text[-4000:]
    return out


# ---------------------------------------------------------------------------
# the trainer
# ---------------------------------------------------------------------------

def _losses(out):
    return [json.loads(line)["ce_loss"]
            for line in (out / "metrics.jsonl").read_text().splitlines()]


@pytest.fixture(scope="module")
def one_process(runs, tmp_path_factory):
    """The same training run in one process (this one)."""
    from qaig_tpu_torch.cli import train_quantized_transformer as cli
    out = tmp_path_factory.mktemp("one_process")
    cli.main(_train_argv(runs[1], out))
    return out


@pytest.mark.parametrize("name", ["train_dp2", "train_tp2", "train_pp2"])
def test_two_process_training_matches_one_process(name, runs, one_process):
    """Data-parallel (with --grad-accum 2; its checkpoints written in the
    background, one kept), tensor-parallel and pipelined training, all
    with EMA and a global-norm clip: only rank 0 writes the log, the
    metrics, the previews and the checkpoints; the losses equal the
    1-process run's, and the checkpoints hold the full model and its EMA
    copy."""
    from qaig_tpu_torch.utils.checkpoint import load_model
    out = _finished(runs, name)
    np.testing.assert_allclose(_losses(out), _losses(one_process),
                               rtol=1e-5)
    log = (out / "Quantized Transformer.log").read_text()
    assert log.count("Cum. Steps: 1 ") == 1   # rank 0's lines only
    assert "Process 0 of 2: gloo on cpu" in log
    mesh = {"train_dp2": "data=2 x model=1", "train_tp2": "data=1 x model=2",
            "train_pp2": "data=1 x model=1 x pipe=2 (microbatches=2)"}[name]
    assert f"Mesh: {mesh}" in log
    # the data-parallel run keeps 1 checkpoint besides the one whose
    # background write was pending when it pruned
    names = sorted(p.name for p in (out / "models_checkpoint").iterdir())
    assert names == ["model_0.pt", "model_2.pt"]
    assert (out / "images" / "high_res_recon_2.jpg").exists()
    ok, ckpt = load_model(out / "models_checkpoint" / "model_2.pt")
    ok_ref, ref = load_model(one_process / "models_checkpoint"
                             / "model_2.pt")
    assert ok and ok_ref and ckpt["global_steps"] == 2
    for entry in ("model", "model_ema"):
        for key, value in ref[entry].items():
            assert ckpt[entry][key].shape == value.shape, key
            np.testing.assert_allclose(ckpt[entry][key], value, atol=1e-5,
                                       err_msg=f"{entry} {key}")


def test_two_process_checkpoint_loads_in_jax_and_resumes_in_port(
        runs, tmp_path):
    """The tensor-parallel run's checkpoint (gathered from both ranks'
    shards) restores into ``qaig_tpu``'s model and optimizer without a
    skipped leaf, and the port resumes from it."""
    import shutil
    from qaig_tpu.models.transformer import Transformer, TransformerConfig
    from qaig_tpu.train.common import restore_model_state, restore_opt_state
    from qaig_tpu.train.optim import make_adam
    from qaig_tpu.utils.checkpoint import load_model as jax_load
    import jax
    from qaig_tpu_torch.train import transformer

    out = _finished(runs, "train_tp2")
    ok, ckpt = jax_load(out / "models_checkpoint" / "model_2.pt")
    assert ok
    jm = Transformer(TransformerConfig(
        use_encoder=True, use_pos_cond=True, num_enc_layers=1,
        num_dec_layers=2, num_enc_embedding=LR_K,
        num_dec_embedding=HR_K + 1, self_attn_heads=4, cross_attn_heads=4,
        in_dim=32, out_dim=HR_K + 1, hidden_dim=48))
    params = jm.init(jax.random.PRNGKey(0))
    params = restore_model_state(jm, params, ckpt["model"],
                                 logging=pytest.fail)
    tx = make_adam(1e-3, 50_000)
    state = restore_opt_state(jm, params, tx.init(params),
                              ckpt["model_optimizer"], logging=pytest.fail)
    assert int(state[0].count) == 3
    restore_model_state(jm, params, ckpt["model_ema"], logging=pytest.fail)
    resumed = tmp_path / "resumed"
    shutil.copytree(out / "models_checkpoint",
                    resumed / "models_checkpoint")
    args = dict(device="cpu", dataset_path=str(runs[1]["fmaps"]),
                decoder_path=str(runs[1]["ae"]),
                lr_codebook_path=str(runs[1]["lr"]),
                hr_codebook_path=str(runs[1]["hr"]),
                config_path=str(runs[1]["tf"]), out_dir=str(resumed),
                batch_size=4, test_num_sample=2, checkpoint_step=2,
                max_steps=5, auto_resume=True, skip_preview=True,
                ema_decay=0.9)
    transformer.run(args)
    log = (resumed / "Quantized Transformer.log").read_text()
    assert "Resuming at global step 3." in log
    assert "Could not restore" not in log
    assert [json.loads(line)["step"] for line in
            (resumed / "metrics.jsonl").read_text().splitlines()] == [4, 5]


@pytest.mark.parametrize("name", ["ae_zero2", "cb_dp2"])
def test_two_process_front_trainers_write_once(name, runs):
    """The autoencoder (ZeRO-1, its checkpoints written in the background)
    and the codebook, data-parallel: rank 0 alone logs and writes the
    grids and the checkpoints, which hold the full model."""
    from qaig_tpu_torch.train import common
    from qaig_tpu_torch.utils.checkpoint import load_model
    out = _finished(runs, name)
    prefix, project, grid = {
        "ae_zero2": ("model", "Autoencoder", "recon"),
        "cb_dp2": ("codebook", "Codebook", "quant_image_plot")}[name]
    log = (out / f"{project}.log").read_text()
    assert log.count("Cum. Steps: 1 ") == 1 and "Mesh: data=2" in log
    losses = [json.loads(line)["recon_loss"]
              for line in (out / "metrics.jsonl").read_text().splitlines()]
    assert len(losses) == 3 and np.isfinite(losses).all()
    assert sorted(p.name for p in (out / "models_checkpoint").iterdir()) \
        == [f"{prefix}_0.pt", f"{prefix}_2.pt"]
    assert (out / "images" / f"{grid}_2.jpg").exists()
    ok, ckpt = load_model(out / "models_checkpoint" / f"{prefix}_2.pt")
    assert ok and ckpt["global_steps"] == 2
    device = torch.device("cpu")
    if name == "ae_zero2":
        common.autoencoder_from_checkpoint(ckpt, device, logging=pytest.fail)
    else:
        common.codebook_from_checkpoint(ckpt, device, logging=pytest.fail)
    assert int(np.asarray(ckpt["model_optimizer"][0][0])) == 3


# ---------------------------------------------------------------------------
# the single-writer stages and generation
# ---------------------------------------------------------------------------

def test_two_process_fmap_stage_writes_once(runs, tmp_path):
    """Rank 0 encodes and writes; rank 1 returns at the barrier; the
    latents and the manifest equal a 1-process run's."""
    from qaig_tpu_torch.data.fmap_dataset import FeatureMapDataset
    from qaig_tpu_torch.train import fmap
    out = _finished(runs, "fmap")
    paths = runs[1]
    want = fmap.run({"device": "cpu", "dataset_path": str(paths["images"]),
                     "model_path": str(paths["ae"]), "batch_size": 4,
                     "out_dir": str(tmp_path)})
    got, ref = (FeatureMapDataset(out / "all_dataset.json"),
                FeatureMapDataset(want))
    assert len(got) == len(ref) == 8
    for i in range(8):
        np.testing.assert_array_equal(got[i], ref[i])


def test_two_process_prune_stage_writes_once(runs):
    from qaig_tpu_torch.utils.checkpoint import load_model
    out = _finished(runs, "prune")
    ok, ckpt = load_model(out / "models_checkpoint" / "pruned_codebook.pt")
    assert ok and 1 <= ckpt["num_embeddings"] <= HR_K
    assert [p.name for p in (out / "models_checkpoint").iterdir()] == [
        "pruned_codebook.pt"]


def test_two_process_generation_matches_one_process(runs, tmp_path):
    """Each rank decodes 2 of the 4 images (its rows of every draw); rank 0
    gathers, decodes and writes the grids, which equal a 1-process run's
    byte for byte."""
    from qaig_tpu_torch.cli import generate_images
    out = _finished(runs, "generate_dp2")
    paths = runs[1]
    generate_images.main(["--device", "cpu", "--config-path",
                          str(paths["gen"]), "--decoder-path",
                          str(paths["ae"]), "--num-images", "4", "--seed",
                          "3", "--out-dir", str(tmp_path)])
    for name in ("recon_model_Cond", "recon_model_0", "recon_model_1"):
        assert (out / "images" / f"{name}.jpg").read_bytes() == \
            (tmp_path / "images" / f"{name}.jpg").read_bytes(), name


def test_two_process_tensor_parallel_generation_matches_greedy(runs,
                                                               tmp_path):
    """``--num-model-shards 2``: every stage's MLPs split over both ranks;
    at greedy both ranks' tokens equal a 1-process run's."""
    out = _finished(runs, "generate_tp2")
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(REPO))
    paths = runs[1]
    subprocess.run([sys.executable, "-c", GENERATE, str(paths["gen"]),
                    str(paths["ae"]), str(tmp_path), "1", "single"],
                   cwd=REPO, env=env, check=True, timeout=300)
    want = torch.load(tmp_path / "tokens_single.pt")
    for rank in range(2):
        got = torch.load(out / f"tokens_{rank}.pt")
        assert got.shape == (4, 16)
        torch.testing.assert_close(got, want, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# the loader and the background checkpoint write
# ---------------------------------------------------------------------------

def test_loader_slices_by_data_coordinate(tmp_path):
    """The ranks of one data coordinate load the same rows; the data
    coordinates' slices tile ``qaig_tpu``'s global batches in order."""
    from qaig_tpu.data import DataLoader as JaxLoader
    from qaig_tpu.data import FeatureMapDataset as JaxDataset
    from qaig_tpu_torch.data.fmap_dataset import FeatureMapDataset
    from qaig_tpu_torch.data.loader import DataLoader

    manifest = _write_fixture(tmp_path)["fmaps"]
    ref = [np.asarray(b) for b in JaxLoader(JaxDataset(manifest),
                                            batch_size=4, seed=5)]
    slices = [list(DataLoader(FeatureMapDataset(manifest), batch_size=4,
                              seed=5, process_index=d, process_count=2))
              for d in (0, 1)]
    for i, batch in enumerate(ref):
        np.testing.assert_array_equal(
            np.concatenate([slices[0][i], slices[1][i]]), batch)
    with pytest.raises(ValueError, match="not divisible by 3 processes"):
        DataLoader(FeatureMapDataset(manifest), batch_size=4,
                   process_count=3)


def _codebook(seed):
    from qaig_tpu_torch.models.codebook import Codebook
    return Codebook(patch_dim=(2, 2), image_dim=LATENT[1:],
                    image_channel=LATENT[0], num_embeddings=HR_K).init(
        torch.Generator().manual_seed(seed))


def _state(seed, snapshot=True, model=None):
    """A codebook checkpoint as the trainer hands it to ``save_model``:
    the dict, or with ``snapshot`` a function that builds it from host
    copies of the parameters."""
    from qaig_tpu_torch.train import codebook, common
    model = model if model is not None else _codebook(seed)
    params, _ = common.gather_training_state(model, snapshot=snapshot)
    build = functools.partial(codebook.checkpoint_dict, model, seed,
                              params=params)
    return build if snapshot else build()


def test_async_save_is_byte_equal_to_the_synchronous_one(tmp_path):
    """The trainers' synchronous save converts as it goes, the background
    one from host snapshots taken before the save returns: the same
    bytes, whatever the steps do to the parameters meanwhile."""
    from qaig_tpu_torch.utils import checkpoint
    model = _codebook(1)
    assert checkpoint.save_model(_state(1, snapshot=False, model=model),
                                 tmp_path, "sync.pt")
    assert checkpoint.save_model(_state(1, model=model), tmp_path,
                                 "async.pt", backend="pickle-async")
    with torch.no_grad():   # the next step updates in place
        for p in model.parameters():
            p.add_(1.0)
    assert checkpoint.wait_pending_saves()
    folder = tmp_path / "models_checkpoint"
    assert (folder / "sync.pt").read_bytes() == \
        (folder / "async.pt").read_bytes()
    assert sorted(p.name for p in folder.iterdir()) == ["async.pt",
                                                        "sync.pt"]
    with pytest.raises(ValueError, match="pickle or pickle-async"):
        checkpoint.save_model(_state(1), tmp_path, "x.pt", backend="orbax")


def test_async_saves_one_in_flight_never_pruned_while_pending(
        tmp_path, monkeypatch):
    """A write in flight blocks the next save until it ends; discovery
    and retention skip it until it lands; a failed write shows at the
    join."""
    from qaig_tpu_torch.train import common
    from qaig_tpu_torch.utils import checkpoint

    for n in (1, 2):
        assert checkpoint.save_model(_state(n), tmp_path, f"model_{n}.pt")
    release = threading.Event()
    write = checkpoint._write

    def held(state, path):
        release.wait(30)
        write(state, path)
    monkeypatch.setattr(checkpoint, "_write", held)
    assert checkpoint.save_model(_state(3), tmp_path, "model_3.pt",
                                 backend="pickle-async")
    folder = tmp_path / "models_checkpoint"
    assert checkpoint.pending_paths() == {str(folder / "model_3.pt")}
    assert common.find_latest_checkpoint(tmp_path) == (folder / "model_2.pt",
                                                       2)
    common.prune_checkpoints(tmp_path, 1)
    assert sorted(p.name for p in folder.iterdir()) == ["model_2.pt"]

    second = threading.Thread(target=checkpoint.save_model, args=(
        _state(4), tmp_path, "model_4.pt"), kwargs={"backend":
                                                    "pickle-async"})
    second.start()
    time.sleep(0.3)
    assert second.is_alive()   # waiting for the write in flight
    release.set()
    second.join(30)
    assert checkpoint.wait_pending_saves()
    assert sorted(p.name for p in folder.iterdir()) == [
        "model_2.pt", "model_3.pt", "model_4.pt"]
    with open(folder / "model_3.pt", "rb") as f:
        assert pickle.load(f)["global_steps"] == 3

    def failing(state, path):
        raise OSError("disk full")
    monkeypatch.setattr(checkpoint, "_write", failing)
    assert checkpoint.save_model(_state(5), tmp_path, "model_5.pt",
                                 backend="pickle-async")
    messages = []
    assert not checkpoint.wait_pending_saves(logging=messages.append)
    assert "disk full" in messages[0]


def test_trainer_joins_the_background_write_and_raises_on_failure(
        runs, tmp_path, monkeypatch):
    """``pickle-async`` in the trainer: the run returns with no write in
    flight and the last checkpoint on disk; a failed write makes the run
    raise, as ``qaig_tpu``'s does."""
    from qaig_tpu_torch.train import transformer
    from qaig_tpu_torch.utils import checkpoint

    paths = runs[1]
    args = dict(device="cpu", dataset_path=str(paths["fmaps"]),
                decoder_path=str(paths["ae"]),
                lr_codebook_path=str(paths["lr"]),
                hr_codebook_path=str(paths["hr"]),
                config_path=str(paths["tf"]), batch_size=4,
                checkpoint_step=1, max_steps=2, skip_preview=True,
                checkpoint_backend="pickle-async")
    transformer.run(dict(args, out_dir=str(tmp_path / "ok")))
    assert not checkpoint.pending_paths()
    assert sorted(p.name for p in (tmp_path / "ok" / "models_checkpoint")
                  .iterdir()) == ["model_0.pt", "model_1.pt"]

    def failing(state, path):
        raise OSError("disk full")
    monkeypatch.setattr(checkpoint, "_write", failing)
    with pytest.raises(RuntimeError, match="saving model checkpoint"):
        transformer.run(dict(args, max_steps=1,
                             out_dir=str(tmp_path / "failed")))


# ---------------------------------------------------------------------------
# flags
# ---------------------------------------------------------------------------

def test_generate_cli_flags_match_jax_cli(monkeypatch):
    """Every flag of ``qaig_tpu``'s generation CLI but the XLA-only two,
    with its name, type, default and required-ness (``--device`` narrows
    its choices)."""
    import argparse
    from qaig_tpu.cli import generate_images as jax_cli
    from qaig_tpu_torch.cli import generate_images as cli

    class Captured(Exception):
        pass

    def capture(self, *a, **kw):
        raise Captured(self)

    tables = []
    with monkeypatch.context() as patch:
        patch.setattr(argparse.ArgumentParser, "parse_args", capture)
        for main in (jax_cli.main, lambda: cli.main([])):
            with pytest.raises(Captured) as info:
                main()
            tables.append({a.dest: a for a in info.value.args[0]._actions
                           if a.dest != "help"})
    theirs, mine = tables
    assert set(mine) == set(theirs) - {"compilation_cache_dir",
                                       "compiler_options"}
    for dest, action in mine.items():
        other = theirs[dest]
        assert action.option_strings == other.option_strings, dest
        assert action.required == other.required, dest
        assert type(action) is type(other), dest
        if dest == "device":
            assert set(action.choices) < set(other.choices), dest
            continue
        assert action.default == other.default, dest
        assert getattr(action.type, "__name__", action.type) == \
            getattr(other.type, "__name__", other.type), dest


def test_fused_generation_refuses_a_sharded_mesh():
    from qaig_tpu_torch.infer import generate
    with pytest.raises(ValueError, match="requires unsharded generation"):
        generate.use_fused(True, torch.device("cpu"), sharded=True)
    assert generate.use_fused(None, torch.device("cuda"),
                              sharded=True) is False


def test_mesh_refuses_idle_processes(monkeypatch, caplog):
    """``make_mesh_for_batch`` logs ``qaig_tpu``'s warning and raises
    where processes would idle; a single-process run has a 1x1 mesh with
    no groups."""
    from qaig_tpu_torch.parallel import comm, mesh

    one = mesh.make_mesh_for_batch(8)
    assert one.shape == {"data": 1, "model": 1} and not one.distributed
    monkeypatch.setattr(comm, "world_size", lambda: 4)
    with pytest.raises(ValueError, match="cannot sit idle"):
        mesh.make_mesh_for_batch(3)
    assert "chips idle" in caplog.text
    with pytest.raises(ValueError, match="needs 8 processes, have 4"):
        mesh.make_mesh(n_data=4, n_model=2)


def test_mesh_warms_every_group_before_any_capture(tmp_path, monkeypatch):
    """``make_mesh`` runs a collective on each axis group and on the
    default group (the global-norm clip's all-reduce over every rank), so
    NCCL creates no communicator inside a train step's CUDA-graph
    capture; ``comm.shutdown`` leaves the group and a later run joins
    anew."""
    from qaig_tpu_torch.parallel import comm, mesh

    warmed, warm = [], mesh._warm
    monkeypatch.setattr(mesh, "_warm", lambda group, device: (
        warmed.append(group), warm(group, device)))
    for attempt in (1, 2):
        comm.init({"multihost": True, "num_processes": 1, "process_id": 0,
                   "coordinator_address":
                       f"file://{tmp_path}/rendezvous_{attempt}"},
                  torch.device("cpu"), logging=lambda *_: None)
        try:
            one = mesh.make_mesh(n_model=1)
            assert warmed == [None, one.group("data"), one.group("model")]
        finally:
            comm.shutdown()
        assert not comm.active() and \
            not torch.distributed.is_initialized()
        warmed.clear()


def test_parallel_arg_validation_matches_jax():
    """``validate_parallel_args`` gives ``qaig_tpu``'s results and
    messages, except that bf16 with both pipeline and tensor parallelism
    is allowed (``qaig_tpu`` refuses it on the CPU only: an XLA:CPU
    limit)."""
    from qaig_tpu.models.transformer import TransformerConfig as JaxConfig
    from qaig_tpu.train.transformer import validate_parallel_args as ref
    from qaig_tpu_torch.models.transformer import TransformerConfig
    from qaig_tpu_torch.train.transformer import validate_parallel_args

    kw = dict(use_encoder=False, num_dec_layers=4, num_dec_embedding=17,
              self_attn_heads=2, in_dim=16, out_dim=17, hidden_dim=32,
              hidden_activation="silu")
    cfg, jcfg = TransformerConfig(**kw), JaxConfig(**kw)
    cases = [
        (8, {}), (8, {"num_pipeline_stages": 2}),
        (8, {"num_pipeline_stages": 2, "num_model_shards": 2,
             "num_microbatches": 4}),
        (8, {"num_pipeline_stages": 2, "bf16": True}),
        (8, {"num_model_shards": 2, "zero_opt": True}),
        (8, {"grad_accum": 4, "num_model_shards": 2}),
        (8, {"num_pipeline_stages": 2, "zero_opt": True}),
        (9, {"grad_accum": 4}), (8, {"grad_accum": 2,
                                     "num_pipeline_stages": 2}),
        (8, {"grad_accum": 0}), (8, {"num_model_shards": 3}),
        (8, {"num_pipeline_stages": 3}), (9, {"num_pipeline_stages": 2}),
        (8, {"num_pipeline_stages": 2, "num_microbatches": 0}),
        (8, {"num_pipeline_stages": 0})]
    for batch, args in cases:
        try:
            want = ref(jcfg, batch, args)
        except ValueError as e:
            with pytest.raises(ValueError) as info:
                validate_parallel_args(cfg, batch, args)
            assert str(info.value) == str(e), args
        else:
            assert validate_parallel_args(cfg, batch, args) == want, args
    assert validate_parallel_args(cfg, 8, {
        "num_pipeline_stages": 2, "num_model_shards": 2,
        "bf16": True}) == (2, 2, 2)


def test_pipeline_validation_messages():
    """``pipelined_apply``'s checks, on the global batch, with
    ``qaig_tpu``'s messages."""
    from qaig_tpu_torch.parallel.pipeline import validate
    validate(4, 2, 8, 2, 2)
    for args, message in (
            ((3, 2, 8, 2, 2), "num_dec_layers 3 not divisible by pipe=2"),
            ((4, 2, 8, 3, 2), "batch 8 not divisible by num_microbatches 3"),
            ((4, 2, 8, 8, 2), "microbatch 1 not divisible by the mesh data "
                              "axis 2")):
        with pytest.raises(ValueError, match=message):
            validate(*args)
