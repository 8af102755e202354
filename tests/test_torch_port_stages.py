"""The front of the pipeline in the PyTorch port (``qaig_tpu_torch``)
against ``qaig_tpu``, on the CPU: the FC encoder and the autoencoder, the
PNG/JPEG image dataset and the loader's order, one autoencoder and one
codebook train step, the feature-map stage, pruning, checkpoints in both
directions, the four CLIs' flags, the TF32 setting of every entry point,
and the stages' runs (retention, auto-resume).

Small sizes: 16x16x3 images, an autoencoder of 2 layers with 8-16
channels and latent 4 (4x4 latents), codebooks of K 16 over 2x2 patches.
Inputs and parameters come from ``np.random.default_rng`` in the shapes of
``qaig_tpu``'s trees and cross through ``qaig_tpu_torch.convert``.
Tolerances: PNG pixels, manifests, loader order, BMU counts and kept rows
exact; JPEG pixels within 2 units (PIL's and OpenCV's IDCTs may round
apart); encoder and autoencoder outputs and latents atol 1e-5; float32
train steps: loss rtol 1e-5, gradients atol 1e-5, parameters after one
Adam step atol 1e-6; bf16 autoencoder step: loss rtol 1e-3 and gradients
within 5e-2 of the largest, with every convolution's input and weight
dtype equal on both sides (``qaig_tpu``'s bf16 CPU convolutions round
more: its bf16 step lies up to 4.7% of the largest gradient from its own
float32 step, the port's 0.2% from its own, so the two bf16 steps differ
by about what ``qaig_tpu``'s bf16 rounding costs; the dtype trace is what
tells the precisions apart).
"""

import argparse
import json
import struct
import sys
import zlib
from pathlib import Path

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import optax
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_port_models import random_params  # noqa: E402

AE_CFG = {"model_lr": 1e-3, "image_channel": 3, "min_channel": 8,
          "max_channel": 16, "num_layers": 2, "latent_channel": 4,
          "hidden_activation_type": "silu",
          "use_final_enc_activation": True, "encoder_activation_type": "tanh",
          "use_final_dec_activation": True, "decoder_activation_type": "tanh"}
CB_CFG = {"model_lr": 1e-2, "image_H": 4, "image_W": 4, "image_C": 4,
          "patch_H": 2, "patch_W": 2, "num_embeddings": 16,
          "neighbourhood_step": 2}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU ops here are tiny: one intra-op thread keeps them
    from competing with the suite's other workers for every core."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(x):
    return torch.from_numpy(np.array(x))


def _flat(tree):
    from qaig_tpu.utils.checkpoint import flatten_tree
    return {k: np.asarray(v) for k, v in flatten_tree(
        jax.tree_util.tree_map(np.asarray, tree)).items()}


def _no_skips(msg):
    raise AssertionError(f"restore skipped a parameter: {msg}")


def _ae_pair(seed, **overrides):
    """(JAX autoencoder, its params, the port's on the same weights)."""
    from qaig_tpu.models.conv_nets import Autoencoder as JaxAutoencoder
    from qaig_tpu.train.autoencoder import build_autoencoder as jax_build
    from qaig_tpu_torch.convert import load_jax_state
    from qaig_tpu_torch.train.autoencoder import build_autoencoder

    cfg = dict(AE_CFG, **overrides)
    jm, _ = jax_build(cfg)
    assert isinstance(jm, JaxAutoencoder)
    params = random_params(jm.init, seed)
    tm, _ = build_autoencoder(cfg)
    load_jax_state(tm, jax.tree_util.tree_map(np.asarray, params),
                   logging=_no_skips)
    return jm, params, tm


def _images(n, seed, size=16):
    return (np.random.default_rng(seed).uniform(-1, 1, (n, 3, size, size))
            .astype(np.float32))


def _write_pngs(root, n, seed=0, size=16):
    from qaig_tpu_torch.data.manifest import write_manifest
    from qaig_tpu_torch.utils import png
    root = Path(root)
    (root / "imgs").mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n):
        path = root / "imgs" / f"{i}.png"
        path.write_bytes(png.encode(rng.integers(0, 256, (size, size, 3),
                                                 dtype=np.uint8)))
        rows.append({"image_fpath": str(path), "labels": []})
    return write_manifest(root / "dataset.json", rows)


# ---------------------------------------------------------------------------
# models
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("final", [(True, True), (False, False)],
                         ids=["final_acts", "fallback_acts"])
def test_encoder_and_autoencoder_match_jax(final):
    """Latents, reconstructions and the full forward on the same converted
    weights; with the final activations off, the configs fall back to
    silu / tanh as ``qaig_tpu``'s ``build_autoencoder`` does."""
    jm, params, tm = _ae_pair(3, use_final_enc_activation=final[0],
                              use_final_dec_activation=final[1])
    assert tm.cfg == type(tm.cfg)(**vars(jm.cfg))
    x = _images(2, 4)
    tm.requires_grad_(False)
    z = tm.get_latent(_t(x))
    assert z.shape == (2, 4, 4, 4)
    np.testing.assert_allclose(z.numpy(), np.asarray(jm.get_latent(
        params, jnp.asarray(x))), atol=1e-5)
    np.testing.assert_allclose(
        tm.recon_image(z).numpy(),
        np.asarray(jm.recon_image(params, jnp.asarray(z.numpy()))),
        atol=1e-5)
    np.testing.assert_allclose(tm(_t(x)).numpy(), np.asarray(
        jm.apply(params, jnp.asarray(x))), atol=1e-5)
    from qaig_tpu_torch.convert import mapping
    assert set(mapping(tm)) == set(_flat(params))


# ---------------------------------------------------------------------------
# data: PNG / JPEG decoding, the loader's order
# ---------------------------------------------------------------------------

def _write_kind(path, kind, rng):
    import cv2
    from PIL import Image
    from qaig_tpu_torch.utils import png
    rgb = rng.integers(0, 256, (11, 13, 3), dtype=np.uint8)
    if kind == "filters":
        path.write_bytes(png.encode(rgb, [0, 1, 2, 3, 4]))
    elif kind == "gray":
        Image.fromarray(rgb[:, :, 0]).save(path)
    elif kind == "gray_1bit":
        Image.fromarray(rgb[:, :, 0] > 127).save(path)
    elif kind == "gray_alpha":
        Image.fromarray(rgb[:, :, :2].copy(), "LA").save(path)
    elif kind == "rgb":
        Image.fromarray(rgb).save(path)
    elif kind == "rgba":
        Image.fromarray(np.concatenate([rgb, rgb[:, :, :1]], 2),
                        "RGBA").save(path)
    elif kind == "palette":
        Image.fromarray(rgb).convert("P", palette=Image.ADAPTIVE,
                                     colors=16).save(path)
    elif kind == "palette_alpha":
        Image.fromarray(rgb).convert("P", palette=Image.ADAPTIVE,
                                     colors=200).save(path, transparency=3)
    elif kind == "rgb_16bit":
        cv2.imwrite(str(path), rng.integers(0, 65536, (11, 13, 3),
                                            dtype=np.uint16))
    elif kind == "gray_16bit":
        cv2.imwrite(str(path), rng.integers(0, 65536, (11, 13),
                                            dtype=np.uint16))


PNG_KINDS = ["filters", "gray", "gray_1bit", "gray_alpha", "rgb", "rgba",
             "palette", "palette_alpha", "rgb_16bit", "gray_16bit"]


@pytest.mark.parametrize("kind", PNG_KINDS)
def test_png_decode_equals_qaig_tpu_image_dataset(kind, tmp_path):
    """The port's PNG path against ``qaig_tpu``'s ``ImageDataset``
    (``cv2.imread``): equal arrays, BGR, [-1, 1], CHW float32."""
    from qaig_tpu.data import ImageDataset as JaxImageDataset
    from qaig_tpu_torch.data.image_dataset import ImageDataset
    from qaig_tpu_torch.data.manifest import write_manifest

    path = tmp_path / f"{kind}.png"
    _write_kind(path, kind, np.random.default_rng(len(kind)))
    manifest = write_manifest(tmp_path / "d.json",
                              [{"image_fpath": str(path), "labels": []}])
    got, got_path = ImageDataset(manifest, return_filepaths=True)[0]
    want = JaxImageDataset(manifest)[0]
    assert got.dtype == np.float32 and got.shape == (3, 11, 13)
    assert got_path == str(path)
    np.testing.assert_array_equal(got, want)


def test_png_decoder_refuses_interlaced_and_corrupt_files(tmp_path):
    from qaig_tpu_torch.utils import png

    data = bytearray(png.encode(np.zeros((4, 4, 3), np.uint8)))
    header = data[16:29]
    interlaced = bytearray(data)
    interlaced[16:29] = header[:12] + b"\x01"
    interlaced[29:33] = struct.pack(">I", zlib.crc32(
        b"IHDR" + bytes(interlaced[16:29])) & 0xFFFFFFFF)
    with pytest.raises(ValueError, match="interlaced"):
        png.decode(bytes(interlaced))
    corrupt = bytearray(data)
    corrupt[20] ^= 1
    with pytest.raises(ValueError, match="CRC"):
        png.decode(bytes(corrupt))
    with pytest.raises(ValueError, match="not a PNG"):
        png.decode(b"GIF89a" + bytes(data[6:]))


def test_jpeg_goes_through_pil_and_needs_it(tmp_path, monkeypatch):
    from PIL import Image
    from qaig_tpu.data import ImageDataset as JaxImageDataset
    from qaig_tpu_torch.data.image_dataset import ImageDataset
    from qaig_tpu_torch.data.manifest import write_manifest

    ramp = np.add.outer(np.arange(32), np.arange(32))[:, :, None]
    rgb = (ramp * np.array([3, 5, 7]) % 256).astype(np.uint8)
    Image.fromarray(rgb).save(tmp_path / "a.jpg", quality=90)
    manifest = write_manifest(tmp_path / "d.json", [
        {"image_fpath": str(tmp_path / "a.jpg"), "labels": []}])
    got = ImageDataset(manifest)[0]
    want = JaxImageDataset(manifest)[0]
    assert np.abs(got - want).max() <= 2 / 127.5 + 1e-6
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(IOError, match="JPEG needs PIL"):
        ImageDataset(manifest)[0]


@pytest.mark.parametrize("shuffle", [True, False])
@pytest.mark.parametrize("drop_remainder", [True, False])
def test_loader_order_matches_jax(shuffle, drop_remainder, tmp_path):
    """Same seed, same batches over two epochs, ``(image, path)`` items
    batched into ``(array, list)``."""
    from qaig_tpu.data import DataLoader as JaxLoader
    from qaig_tpu.data import ImageDataset as JaxImageDataset
    from qaig_tpu_torch.data.image_dataset import ImageDataset
    from qaig_tpu_torch.data.loader import DataLoader

    manifest = _write_pngs(tmp_path, 11)
    kw = dict(batch_size=4, shuffle=shuffle, seed=3,
              drop_remainder=drop_remainder)
    port = DataLoader(ImageDataset(manifest, return_filepaths=True), **kw)
    ref = JaxLoader(JaxImageDataset(manifest, return_filepaths=True), **kw)
    assert len(port) == len(ref) == (2 if drop_remainder else 3)
    for _ in range(2):
        got, want = list(port), list(ref)
        assert len(got) == len(want) == len(port)
        for (g_img, g_paths), (w_img, w_paths) in zip(got, want):
            assert isinstance(g_paths, list) and g_paths == w_paths
            np.testing.assert_array_equal(g_img, w_img)


# ---------------------------------------------------------------------------
# one train step of each trainer
# ---------------------------------------------------------------------------

def _jax_ae_step(jm, params, batch, tx, bf16=False):
    from qaig_tpu.train.autoencoder import make_train_step as jax_step
    new, _, loss = jax_step(jm, tx, bf16=bf16)(
        params, tx.init(params), jnp.asarray(batch))
    return float(loss), _flat(new)


def _port_ae_step(tm, batch, optimizer, scheduler=None, bf16=False):
    from qaig_tpu_torch.convert import to_jax_state
    from qaig_tpu_torch.train.autoencoder import make_train_step
    tm.requires_grad_(True)
    loss = make_train_step(tm, optimizer, bf16=bf16,
                           scheduler=scheduler)(_t(batch))
    assert all(p.dtype == torch.float32 for p in tm.parameters())
    return float(loss), to_jax_state(tm)


def _conv_dtypes(monkeypatch, core, trace, weight):
    """Record (input dtype, weight dtype) of every convolution of
    ``core``; ``weight`` reads the weight of a layer's parameters."""
    for name in ("conv2d", "conv_transpose2d"):
        fn = getattr(core, name)

        def wrapped(p, x, *a, _fn=fn, **kw):
            trace.append((str(x.dtype).split(".")[-1],
                          str(weight(p).dtype).split(".")[-1]))
            return _fn(p, x, *a, **kw)
        monkeypatch.setattr(core, name, wrapped)


@pytest.mark.parametrize("bf16", [False, True], ids=["float32", "bf16"])
def test_autoencoder_step_matches_jax(bf16, monkeypatch):
    """One step with SGD(lr=1) on both sides (old minus new parameters are
    the gradients), then one Adam step of each package's optimizer."""
    from qaig_tpu.models import core as jax_core
    from qaig_tpu.train.optim import make_adam as jax_adam
    from qaig_tpu_torch.convert import to_jax_state
    from qaig_tpu_torch.models import core
    from qaig_tpu_torch.train import optim

    jm, params, tm = _ae_pair(5)
    batch = _images(4, 6)
    old = _flat(params)
    jax_trace, port_trace = [], []
    with monkeypatch.context() as m:
        _conv_dtypes(m, jax_core, jax_trace, lambda p: p["w"])
        jax_loss, jax_new = _jax_ae_step(jm, params, batch, optax.sgd(1.0),
                                         bf16=bf16)
        _conv_dtypes(m, core, port_trace, lambda p: p.weight)
        loss, new = _port_ae_step(tm, batch,
                                  torch.optim.SGD(tm.parameters(), lr=1.0),
                                  bf16=bf16)
    kind = "bfloat16" if bf16 else "float32"
    assert len(jax_trace) == 13   # 6 encoder + 7 decoder layers
    assert port_trace == jax_trace == [(kind, kind)] * 13
    want = {k: old[k] - v for k, v in jax_new.items()}
    got = {k: old[k] - v for k, v in new.items()}
    assert set(got) == set(want)
    if bf16:
        np.testing.assert_allclose(loss, jax_loss, rtol=1e-3)
        scale = max(float(np.abs(g).max()) for g in want.values())
        for name, grad in want.items():
            np.testing.assert_allclose(got[name], grad, rtol=0,
                                       atol=5e-2 * scale, err_msg=name)
        return
    np.testing.assert_allclose(loss, jax_loss, rtol=1e-5)
    for name, grad in want.items():
        np.testing.assert_allclose(got[name], grad, atol=1e-5, err_msg=name)

    jm, params, tm = _ae_pair(5)
    _, jax_new = _jax_ae_step(jm, params, batch, jax_adam(1e-3, 2))
    optimizer, scheduler = optim.make_adam(tm.parameters(), 1e-3, 2)
    _, new = _port_ae_step(tm, batch, optimizer, scheduler)
    for name, value in jax_new.items():
        np.testing.assert_allclose(new[name], value, atol=1e-6,
                                   err_msg=name)
    assert to_jax_state(tm).keys() == jax_new.keys()


def _cb_pair(seed):
    from qaig_tpu.models.codebook import Codebook as JaxCodebook
    from qaig_tpu_torch.models.codebook import Codebook

    kw = dict(patch_dim=(2, 2), image_dim=(4, 4), image_channel=4,
              num_embeddings=16, init_neighbour_range=8)
    codes = np.random.default_rng(seed).standard_normal(
        (16, 16)).astype(np.float32)
    cb = Codebook(**kw)
    with torch.no_grad():
        cb.codebook.copy_(_t(codes))
    return JaxCodebook(**kw), {"codebook": jnp.asarray(codes)}, cb


@pytest.mark.parametrize("nrange", [8, 1.0])
def test_codebook_step_matches_jax(nrange):
    from qaig_tpu.train.codebook import make_train_step as jax_step
    from qaig_tpu.train.optim import make_adam as jax_adam
    from qaig_tpu_torch.train import optim
    from qaig_tpu_torch.train.codebook import make_train_step

    batch = np.random.default_rng(8).standard_normal(
        (4, 4, 4, 4)).astype(np.float32)
    for kind in ("sgd", "adam"):
        jcb, params, cb = _cb_pair(7)
        before = np.asarray(params["codebook"]).copy()   # params are donated
        tx = optax.sgd(1.0) if kind == "sgd" else jax_adam(1e-2, 2)
        new, _, jax_loss = jax_step(jcb, tx)(
            params, tx.init(params), jnp.asarray(batch),
            jnp.asarray(nrange, jnp.float32))
        if kind == "sgd":
            optimizer, scheduler = torch.optim.SGD([cb.codebook], lr=1.0), None
        else:
            optimizer, scheduler = optim.make_adam([cb.codebook], 1e-2, 2)
        old = cb.codebook.detach().clone()
        loss = make_train_step(cb, optimizer, scheduler)(_t(batch),
                                                         float(nrange))
        np.testing.assert_allclose(float(loss), float(jax_loss), rtol=1e-5)
        if kind == "sgd":
            np.testing.assert_allclose(
                (old - cb.codebook.detach()).numpy(),
                before - np.asarray(new["codebook"]), atol=1e-5)
        else:
            np.testing.assert_allclose(cb.codebook.detach().numpy(),
                                       np.asarray(new["codebook"]),
                                       atol=1e-6)


# ---------------------------------------------------------------------------
# the stages end to end: fmap, prune, checkpoints both ways
# ---------------------------------------------------------------------------

def _jax_ae_checkpoint(root, seed=9, **overrides):
    """An autoencoder checkpoint written by ``qaig_tpu``; returns (path,
    params)."""
    from qaig_tpu.train.autoencoder import build_autoencoder as jax_build
    from qaig_tpu.train.autoencoder import checkpoint_dict
    from qaig_tpu.train.optim import make_adam as jax_adam
    from qaig_tpu.utils.checkpoint import save_model as jax_save

    jm, cfg = jax_build(dict(AE_CFG, **overrides))
    params = random_params(jm.init, seed)
    tx = jax_adam(1e-3, 50_000)
    ckpt = checkpoint_dict(cfg, params, tx.init(params), global_steps=4)
    assert jax_save(ckpt, root, "jax_ae.pt")
    return Path(root) / "models_checkpoint" / "jax_ae.pt", params


@pytest.mark.parametrize("quirk", [False, True],
                         ids=["same_flags", "dec_flag_gates_encoder"])
def test_fmap_stage_matches_jax(quirk, tmp_path):
    """Both packages' ``fmap.run`` over the same PNGs and checkpoint: the
    same manifest rows (paths relative to each output folder), in the same
    order, and latents within 1e-5.  ``dec_flag_gates_encoder``: the
    checkpoint turns the encoder's final activation off and the
    decoder's on, and both packages apply it (the reference quirk)."""
    from qaig_tpu.data.manifest import Manifest as JaxManifest
    from qaig_tpu.train import fmap as jax_fmap
    from qaig_tpu_torch.data.manifest import Manifest
    from qaig_tpu_torch.train import fmap

    manifest = _write_pngs(tmp_path, 11)
    overrides = {"use_final_enc_activation": False} if quirk else {}
    ckpt, params = _jax_ae_checkpoint(tmp_path, **overrides)
    outs = {}
    for name, run in (("jax", jax_fmap.run), ("port", fmap.run)):
        out = tmp_path / name
        path = run({"device": "cpu", "dataset_path": manifest,
                    "model_path": ckpt, "out_dir": out, "batch_size": 4,
                    "num_files_folder": 4})
        rows = (JaxManifest if name == "jax" else Manifest)(path).rows
        outs[name] = (out, rows)
    (jout, jrows), (pout, prows) = outs["jax"], outs["port"]
    assert len(prows) == len(jrows) == 11
    for p, j in zip(prows, jrows):
        assert p["image_path"] == j["image_path"]
        assert (Path(p["fmap_path"]).relative_to(pout)
                == Path(j["fmap_path"]).relative_to(jout))
        assert Path(p["fmap_path"]).suffix == ""
        got, want = np.load(p["fmap_path"]), np.load(j["fmap_path"])
        assert got.shape == (4, 4, 4) and got.dtype == np.float32
        np.testing.assert_allclose(got, want, atol=1e-5)
    assert sorted(q.name for q in pout.iterdir() if q.is_dir()) == \
        ["0", "1", "2"]
    if quirk:   # tanh on the encoder: every latent inside (-1, 1)
        latents = np.stack([np.load(p["fmap_path"]) for p in prows])
        assert np.abs(latents).max() < 1.0


def _write_fmaps(root, n=10, seed=10):
    from qaig_tpu_torch.data.manifest import write_manifest
    root = Path(root)
    root.mkdir(parents=True, exist_ok=True)
    rows = []
    for i, x in enumerate(np.random.default_rng(seed).standard_normal(
            (n, 4, 4, 4)).astype(np.float32)):
        np.save(root / f"{i}.npy", x)
        rows.append({"fmap_path": str(root / f"{i}.npy"), "image_path": ""})
    return write_manifest(root / "all_dataset.json", rows)


def test_prune_matches_jax_and_checkpoints_cross(tmp_path):
    """Both packages' ``prune.run`` on a ``qaig_tpu`` codebook: the same
    counts (the last partial batch included), the same kept rows; each
    package reads the other's ``pruned_codebook.pt``."""
    from qaig_tpu.train import common as jax_common
    from qaig_tpu.train import prune as jax_prune
    from qaig_tpu.train.codebook import checkpoint_dict as jax_ckpt
    from qaig_tpu.utils.checkpoint import load_model as jax_load
    from qaig_tpu.utils.checkpoint import save_model as jax_save
    from qaig_tpu_torch.train import common, prune
    from qaig_tpu_torch.utils.checkpoint import load_model

    jcb, params, cb = _cb_pair(11)
    jcb.neighbourhood_range = 3
    assert jax_save(jax_ckpt(jcb, params, 7), tmp_path, "cb.pt")
    dataset = _write_fmaps(tmp_path / "fmaps")
    args = {"device": "cpu", "dataset_path": dataset, "batch_size": 3,
            "codebook_path": tmp_path / "models_checkpoint" / "cb.pt",
            "prune_threshold": 3}
    new_jax, new_params = jax_prune.run(dict(args, out_dir=tmp_path / "j"))
    new = prune.run(dict(args, out_dir=tmp_path / "p"))
    assert new.num_embeddings == new_jax.num_embeddings
    assert 0 < new.num_embeddings < 16
    np.testing.assert_array_equal(new.codebook.detach().numpy(),
                                  np.asarray(new_params["codebook"]))

    counts = prune.usage_histogram(cb, _loader(dataset))
    want = jax_prune.usage_histogram(jcb, params, _loader(dataset, jax=True))
    np.testing.assert_array_equal(counts, want)
    assert counts.sum() == 10 * 4

    ok, ckpt = jax_load(tmp_path / "p" / "models_checkpoint"
                        / "pruned_codebook.pt")
    assert ok and ckpt["global_steps"] == 7 and "model_optimizer" not in ckpt
    model, restored = jax_common.codebook_from_checkpoint(ckpt,
                                                          logging=_no_skips)
    np.testing.assert_array_equal(np.asarray(restored["codebook"]),
                                  new.codebook.detach().numpy())
    assert model.neighbourhood_range == 3
    ok, ckpt = load_model(tmp_path / "j" / "models_checkpoint"
                          / "pruned_codebook.pt")
    assert ok
    back = common.codebook_from_checkpoint(ckpt, "cpu", logging=_no_skips)
    np.testing.assert_array_equal(back.codebook.numpy(),
                                  np.asarray(new_params["codebook"]))


def _loader(dataset, jax=False):
    if jax:
        from qaig_tpu.data import DataLoader, FeatureMapDataset
    else:
        from qaig_tpu_torch.data.fmap_dataset import FeatureMapDataset
        from qaig_tpu_torch.data.loader import DataLoader
    return DataLoader(FeatureMapDataset(dataset), batch_size=3, shuffle=True,
                      seed=0, drop_remainder=False)


def _jax_ae_config_matches(ckpt, jm):
    """The checkpoint describes ``jm``'s config, as ``qaig_tpu``'s
    ``autoencoder_from_checkpoint`` reads it."""
    from qaig_tpu.models.conv_nets import AutoencoderConfig
    assert AutoencoderConfig(**{k: ckpt[k] for k in vars(jm.cfg)}) == jm.cfg


@pytest.mark.parametrize("stage", ["autoencoder", "codebook"])
def test_checkpoints_cross_load_both_ways(stage, tmp_path):
    """A checkpoint the port writes after one Adam step restores in
    ``qaig_tpu`` (model and optax state), and one ``qaig_tpu`` writes
    restores in the port (model, Adam moments and update count)."""
    from qaig_tpu.train import common as jax_common
    from qaig_tpu.train.optim import make_adam as jax_adam
    from qaig_tpu.utils.checkpoint import load_model as jax_load
    from qaig_tpu.utils.checkpoint import save_model as jax_save
    from qaig_tpu_torch.convert import to_jax_state, to_optax_state
    from qaig_tpu_torch.train import autoencoder, codebook, common, optim
    from qaig_tpu_torch.utils.checkpoint import (flatten_tree, load_model,
                                                 save_model)

    if stage == "autoencoder":
        jm, params, tm = _ae_pair(12)
        batch = _images(4, 13)
    else:
        jm, params, tm = _cb_pair(12)
        batch = np.random.default_rng(13).standard_normal(
            (4, 4, 4, 4)).astype(np.float32)
    tm.requires_grad_(True)
    optimizer, scheduler = optim.make_adam(tm.parameters(), 1e-3, 50_000)
    if stage == "autoencoder":
        autoencoder.make_train_step(tm, optimizer,
                                    scheduler=scheduler)(_t(batch))
        ckpt = autoencoder.checkpoint_dict(tm.cfg, tm, optimizer,
                                           global_steps=0)
    else:
        codebook.make_train_step(tm, optimizer, scheduler)(_t(batch), 8.0)
        ckpt = codebook.checkpoint_dict(tm, 0, optimizer)
    assert save_model(ckpt, tmp_path, "port.pt")

    ok, loaded = jax_load(tmp_path / "models_checkpoint" / "port.pt")
    assert ok
    tx = jax_adam(1e-3, 50_000)
    if stage == "autoencoder":
        # autoencoder_from_checkpoint's body, on the pair's parameters
        # (its eager init compiles every random draw: ~18 s on the CPU)
        _jax_ae_config_matches(loaded, jm)
        jparams = jax_common.restore_model_state(jm, params, loaded["model"],
                                                 logging=_no_skips)
    else:
        jm, jparams = jax_common.codebook_from_checkpoint(loaded,
                                                          logging=_no_skips)
    for name, value in to_jax_state(tm).items():
        np.testing.assert_array_equal(_flat(jparams)[name], value)
    restored = jax_common.restore_opt_state(jm, jparams, tx.init(jparams),
                                            loaded["model_optimizer"],
                                            logging=_no_skips)
    assert int(restored[0].count) == 1 and int(restored[1].count) == 1
    flat = _flat(restored)
    written = flatten_tree(to_optax_state(tm, optimizer))
    for key, value in written.items():
        np.testing.assert_array_equal(flat[key], np.asarray(value),
                                      err_msg=key)

    # qaig_tpu writes (after two Adam updates), the port reads
    state = tx.init(jparams)
    rng = np.random.default_rng(14)
    for _ in range(2):
        grads = jax.tree_util.tree_map(
            lambda p: jnp.asarray(rng.standard_normal(p.shape), jnp.float32),
            jparams)
        _, state = jax.jit(tx.update)(grads, state, jparams)
    loaded["model_optimizer"] = state
    assert jax_save(loaded, tmp_path, "jax.pt")
    ok, back = load_model(tmp_path / "models_checkpoint" / "jax.pt")
    assert ok
    if stage == "autoencoder":
        model, _ = common.autoencoder_from_checkpoint(back, "cpu",
                                                      logging=_no_skips)
    else:
        model = common.codebook_from_checkpoint(back, "cpu",
                                                logging=_no_skips)
    model.requires_grad_(True)
    optimizer, scheduler = optim.make_adam(model.parameters(), 1e-3, 2)
    common.restore_optimizer(model, optimizer, scheduler,
                             back["model_optimizer"], logging=_no_skips)
    assert scheduler.last_epoch == 2
    got = flatten_tree(to_optax_state(model, optimizer))
    want = _flat(state)
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_array_equal(np.asarray(got[key]), want[key],
                                      err_msg=key)


# ---------------------------------------------------------------------------
# the trainers' runs
# ---------------------------------------------------------------------------

def test_autoencoder_run_retention_resume_and_grids(tmp_path):
    """Three float32 steps with retention and a profile window, then an
    auto-resumed bf16 run that continues the step numbering; ``qaig_tpu``
    reads the checkpoint."""
    from qaig_tpu.train import common as jax_common
    from qaig_tpu.utils.checkpoint import load_model as jax_load
    from qaig_tpu_torch.train import autoencoder

    config = tmp_path / "ae.json"
    config.write_text(json.dumps(AE_CFG))
    out = tmp_path / "out"
    args = {"device": "cpu", "dataset_path": _write_pngs(tmp_path, 9),
            "config_path": config, "out_dir": out, "batch_size": 4,
            "checkpoint_step": 2, "keep_checkpoints": 1, "auto_resume": True}
    autoencoder.run(dict(args, max_steps=3, profile_start=1,
                         profile_steps=1, profile_dir=tmp_path / "prof"))
    assert (tmp_path / "prof" / "trace_1.json").exists()
    ckpts = out / "models_checkpoint"
    assert sorted(p.name for p in ckpts.iterdir()) == ["model_2.pt"]
    for name in ("ground_truth", "recon"):
        for step in (0, 2):
            assert (out / "images" / f"{name}_{step}.jpg").exists()
    ok, ckpt = jax_load(ckpts / "model_2.pt")
    assert ok and ckpt["global_steps"] == 2
    assert int(np.asarray(ckpt["model_optimizer"][0][0])) == 3
    jm, params, _ = _ae_pair(0)
    _jax_ae_config_matches(ckpt, jm)
    jax_common.restore_model_state(jm, params, ckpt["model"],
                                   logging=_no_skips)

    autoencoder.run(dict(args, max_steps=5, bf16=True))
    log = (out / "Autoencoder.log").read_text()
    assert "Auto-resume: continuing from" in log
    assert "Resuming at global step 3." in log
    lines = (out / "metrics.jsonl").read_text().splitlines()
    assert [json.loads(x)["step"] for x in lines] == [1, 2, 3, 4, 5]
    assert all(np.isfinite(json.loads(x)["recon_loss"]) for x in lines)
    assert sorted(p.name for p in ckpts.iterdir()) == ["model_4.pt"]


def test_codebook_run_replays_the_boundary_decrement(tmp_path):
    """An uninterrupted 4-step run against 2 steps plus an auto-resumed
    run: the resumed run starts at step 2, replays the neighbourhood
    decrement that followed checkpoint 1, and logs the same ranges."""
    from qaig_tpu_torch.convert import to_jax_state
    from qaig_tpu_torch.models.conv_nets import ConvNetConfig, FCDecoder
    from qaig_tpu_torch.models.core import init_parameters
    from qaig_tpu_torch.train import codebook
    from qaig_tpu_torch.utils.checkpoint import load_model, save_model

    dec_cfg = {k: AE_CFG[k] for k in ("num_layers", "image_channel",
                                      "min_channel", "max_channel",
                                      "latent_channel",
                                      "hidden_activation_type")}
    decoder = init_parameters(FCDecoder(ConvNetConfig(**dec_cfg)),
                              torch.Generator().manual_seed(0))
    save_model(dict(AE_CFG, model={f"fc_decoder.{k}": v for k, v in
                                   to_jax_state(decoder).items()}),
               tmp_path, "dec.pt")
    config = tmp_path / "cb.json"
    config.write_text(json.dumps(CB_CFG))
    args = {"device": "cpu", "dataset_path": _write_fmaps(tmp_path / "f"),
            "decoder_path": tmp_path / "models_checkpoint" / "dec.pt",
            "config_path": config, "batch_size": 3, "checkpoint_step": 1,
            "auto_resume": True}
    ranges = {}
    for name, steps in (("whole", [4]), ("resumed", [2, 4])):
        out = tmp_path / name
        for max_steps in steps:
            codebook.run(dict(args, out_dir=out, max_steps=max_steps))
        ranges[name] = [(json.loads(x)["step"],
                         json.loads(x)["neighbourhood_range"])
                        for x in (out / "metrics.jsonl").read_text()
                        .splitlines()]
        for n in range(4):
            assert (out / "images" / f"quant_image_plot_{n}.jpg").exists()
    assert ranges["whole"] == ranges["resumed"] == [(1, 8), (2, 8), (3, 7),
                                                     (4, 7)]
    assert "Resuming at global step 2." in (tmp_path / "resumed"
                                            / "Codebook.log").read_text()
    ok, ckpt = load_model(tmp_path / "resumed" / "models_checkpoint"
                          / "codebook_3.pt")
    assert ok and ckpt["neighbourhood_range"] == 7
    assert int(np.asarray(ckpt["model_optimizer"][0][0])) == 4


# ---------------------------------------------------------------------------
# the CLIs
# ---------------------------------------------------------------------------

# flags of the JAX CLIs that the port leaves out: XLA's
LEFT_OUT = {"compilation_cache_dir", "compiler_options"}
STAGE_CLIS = ["train_autoencoder", "generate_fmap_dataset", "train_codebook",
              "prune_codebook"]


@pytest.mark.parametrize("name", STAGE_CLIS)
def test_cli_flags_match_jax_cli(name, monkeypatch):
    """Every other flag has the JAX CLI's option strings (``-c`` too),
    type, default and required-ness; ``--device`` narrows its choices to
    what the port runs and defaults to ``cuda``; ``--checkpoint-backend``
    trades the orbax ones for ``pickle-async``."""
    import importlib
    jax_cli = importlib.import_module(f"qaig_tpu.cli.{name}")
    cli = importlib.import_module(f"qaig_tpu_torch.cli.{name}")

    class Captured(Exception):
        pass

    def capture(self, *a, **kw):
        raise Captured(self)

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", capture)
    tables = []
    for main in (jax_cli.main, lambda: cli.main([])):
        with pytest.raises(Captured) as info:
            main()
        tables.append({a.dest: a for a in info.value.args[0]._actions
                       if a.dest != "help"})
    theirs, mine = tables
    assert set(mine) == set(theirs) - LEFT_OUT
    for dest, action in mine.items():
        other = theirs[dest]
        assert action.option_strings == other.option_strings, dest
        assert action.required == other.required, dest
        assert type(action) is type(other), dest
        if dest == "device":
            assert set(action.choices) < set(other.choices), dest
            assert action.default == "cuda"
            continue
        if dest == "checkpoint_backend":   # orbax imports JAX
            assert set(action.choices) & set(other.choices) == {"pickle"}
            assert set(action.choices) == {"pickle", "pickle-async"}
        assert action.default == other.default, dest
        assert getattr(action.type, "__name__", action.type) == \
            getattr(other.type, "__name__", other.type), dest


ENTRY_POINTS = {
    "train_autoencoder": ["--dataset-path", "d.json", "--config-path", "c",
                          "--out-dir", "o"],
    "generate_fmap_dataset": ["--dataset-path", "d.json", "--model-path",
                              "m.pt", "--out-dir", "o"],
    "train_codebook": ["--dataset-path", "d.json", "--decoder-path", "d.pt",
                       "-c", "c", "--out-dir", "o"],
    "prune_codebook": ["--dataset-path", "d.json", "--codebook-path", "c.pt",
                       "--out-dir", "o"],
    "train_quantized_transformer": [
        "--dataset-path", "d.json", "--decoder-path", "d.pt",
        "--lr-codebook-path", "l.pt", "--hr-codebook-path", "h.pt",
        "--config-path", "c", "--out-dir", "o"],
    "generate_images": ["--config-path", "CONFIG", "--decoder-path", "d.pt",
                        "--out-dir", "o"],
    "serve_generation": ["--config-path", "CONFIG", "--decoder-path",
                         "d.pt"],
    "probe_mlp_fused": None,
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_every_entry_point_turns_tf32_off(name, tmp_path, monkeypatch):
    """After each CLI's (and the probe's) device setup, float32 matmuls and
    cuDNN convolutions run without TF32, whatever the process had set."""
    import importlib
    from qaig_tpu_torch.train import common

    class Stop(Exception):
        pass

    seen = []
    select = common.select_device

    def checked(device):
        out = select(device)
        seen.append((torch.backends.cuda.matmul.allow_tf32,
                     torch.backends.cudnn.allow_tf32, out.type))
        raise Stop

    monkeypatch.setattr(common, "select_device", checked)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.chdir(tmp_path)
    (tmp_path / "CONFIG").write_text("{}")
    with pytest.raises(Stop):
        if ENTRY_POINTS[name] is None:
            module = importlib.import_module(f"qaig_tpu_torch.scripts.{name}")
            module.main(device="cpu")
        else:
            module = importlib.import_module(f"qaig_tpu_torch.cli.{name}")
            module.main(ENTRY_POINTS[name] + ["--device", "cpu"])
    assert seen == [(False, False, "cpu")]
