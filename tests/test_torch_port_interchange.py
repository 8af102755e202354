"""The PyTorch port's interchange with the reference's torch checkpoints
(``qaig_tpu_torch/utils/{checkpoint,torch_compat,torch_export,
torch_optim}.py``, ``cli/export_torch.py``), held against ``qaig_tpu``'s,
on the CPU in float32 at a small size.

The reference-layout archives are written here by ``qaig_tpu``'s own
exporter (``export_state_dict`` / ``export_checkpoint`` + ``torch.save``)
from numpy-seeded parameters: nothing is downloaded.  For an autoencoder,
an FC decoder (read from the autoencoder's archive, prefixes and all), a
codebook and a transformer in base and windowed-cascade form:

* a ``.pt`` archive loaded through either package's ``load_model`` and
  ``*_from_checkpoint`` gives the same parameters, bit for bit (compared
  in the JAX layout through ``convert.to_jax_state``);
* the port's ``export_state_dict`` and its export CLI (with an optax Adam
  state after 3 updates) write what ``qaig_tpu``'s write, key for key and
  array for array;
* that Adam state, exported by ``qaig_tpu``, imports into the port's Adam;
  the port exports it back unchanged, and one more update on each side
  gives parameters within 1e-6 (float32 Adam arithmetic in another order,
  as ``tests/test_torch_port_train.py`` holds it);
* a cascade written as ``.pt`` archives gives the port's greedy tokens
  equal to ``qaig_tpu``'s.
"""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_port_generate import (INIT_TOKENS,  # noqa: E402
                                      _write_jax_checkpoints)
from test_torch_port_generate import greedy  # noqa: E402,F401  (fixture)
from test_torch_port_models import random_params  # noqa: E402

KINDS = ["autoencoder", "fc_decoder", "codebook", "transformer_base",
         "transformer_cascade"]
AE_CFG = {"num_layers": 2, "image_channel": 3, "min_channel": 8,
          "max_channel": 16, "latent_channel": 4,
          "hidden_activation_type": "silu",
          "use_final_enc_activation": True, "encoder_activation_type": "tanh",
          "use_final_dec_activation": True, "decoder_activation_type": "tanh"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _no_skips(msg):
    raise AssertionError(f"restore skipped a parameter: {msg}")


def _flat(tree):
    from qaig_tpu.utils.checkpoint import flatten_tree
    return {k: np.asarray(v) for k, v in flatten_tree(
        jax.tree_util.tree_map(np.asarray, tree)).items()}


def _transformer_meta(base):
    """A transformer checkpoint's hyperparameters (base, or a cascade
    stage with a sliding window of 8) and the JAX model they describe."""
    from qaig_tpu.models.transformer import Transformer, TransformerConfig
    meta = {"train_base_model": base, "use_sliding_window": not base,
            "sliding_window": None if base else 8,
            "num_enc_layers": None if base else 1, "num_dec_layers": 2,
            "num_enc_embedding": None if base else 10,
            "num_dec_embedding": 22 if base else 13, "self_attn_heads": 4,
            "cross_attn_heads": None if base else 4,
            "transformer_in_dim": 32, "transformer_out_dim": 13,
            "transformer_hidden_dim": 48, "hidden_activation": "silu"}
    cfg = TransformerConfig(
        use_encoder=not base, use_pos_cond=not base,
        num_enc_layers=0 if base else 1, num_dec_layers=2,
        num_enc_embedding=1 if base else 10,
        num_dec_embedding=meta["num_dec_embedding"], self_attn_heads=4,
        cross_attn_heads=0 if base else 4, in_dim=32, out_dim=13,
        hidden_dim=48)
    return meta, Transformer(cfg)


def _native(kind, seed=1):
    """(JAX model, its numpy-seeded params, a ``qaig_tpu``-schema
    checkpoint dict holding them).  The FC decoder's checkpoint is its
    autoencoder's."""
    from qaig_tpu.models.codebook import Codebook
    from qaig_tpu.train.autoencoder import build_autoencoder
    if kind in ("autoencoder", "fc_decoder"):
        model, _ = build_autoencoder(dict(AE_CFG, model_lr=1e-3))
        params = random_params(model.init, seed)
        return model, params, dict(AE_CFG, model=_flat(params))
    if kind == "codebook":
        model = Codebook(patch_dim=(2, 2), image_dim=(4, 4), image_channel=4,
                         num_embeddings=16, init_neighbour_range=3)
        codes = np.random.default_rng(seed).standard_normal(
            (16, 16)).astype(np.float32)
        params = {"codebook": jnp.asarray(codes)}
        return model, params, {
            "patch_dim": (2, 2), "image_dim": (4, 4), "image_C": 4,
            "num_embeddings": 16, "neighbourhood_range": 3,
            "global_steps": 7, "checkpoint": _flat(params)}
    meta, model = _transformer_meta(kind == "transformer_base")
    params = random_params(model.init, seed)
    return model, params, dict(meta, global_steps=7, model=_flat(params))


def _jax_loaded(kind, ckpt):
    """``qaig_tpu``'s model and parameters from a checkpoint dict."""
    from qaig_tpu.infer.generate import transformer_from_checkpoint
    from qaig_tpu.train import common
    if kind == "autoencoder":
        return common.autoencoder_from_checkpoint(ckpt)[:2]
    if kind == "fc_decoder":
        return common.decoder_from_checkpoint(ckpt)[:2]
    if kind == "codebook":
        return common.codebook_from_checkpoint(ckpt)
    return transformer_from_checkpoint(ckpt)[:2]


def _port_loaded(kind, ckpt):
    """The port's module from a checkpoint dict, on the CPU."""
    from qaig_tpu_torch.infer.generate import transformer_from_checkpoint
    from qaig_tpu_torch.train import common
    cpu = torch.device("cpu")
    if kind == "autoencoder":
        return common.autoencoder_from_checkpoint(ckpt, cpu)[0]
    if kind == "fc_decoder":
        return common.decoder_from_checkpoint(ckpt, cpu)[0]
    if kind == "codebook":
        return common.codebook_from_checkpoint(ckpt, cpu)
    return transformer_from_checkpoint(ckpt, cpu)[0]


def _export_target(kind, model, params):
    """The (JAX model, params) a kind exports: the decoder alone for the
    FC decoder."""
    if kind == "fc_decoder":
        return model.decoder, params["fc_decoder"]
    return model, params


def _write_reference(kind, tmp_path, seed=1):
    """A reference-layout ``.pt`` archive of a kind's checkpoint, written
    by ``qaig_tpu``'s exporter; returns (its path, the params)."""
    from qaig_tpu.utils.torch_export import export_checkpoint
    model, params, ckpt = _native(kind, seed)
    path = tmp_path / f"{kind}.pt"
    export_checkpoint(model, ckpt, path, logging=lambda msg: None)
    return path, params


def _equal_states(got, want):
    assert set(got) == set(want)
    for key, value in want.items():
        np.testing.assert_array_equal(np.asarray(got[key]), value,
                                      err_msg=key)


@pytest.mark.parametrize("kind", KINDS)
def test_reference_archive_loads_like_qaig_tpu(kind, tmp_path):
    """Either package's ``load_model`` + ``*_from_checkpoint`` of the same
    ``.pt`` archive: the same parameters, bit for bit, equal to the
    exported ones."""
    from qaig_tpu.utils.checkpoint import load_model as jax_load
    from qaig_tpu_torch.convert import to_jax_state
    from qaig_tpu_torch.utils.checkpoint import load_model

    path, params = _write_reference(kind, tmp_path)
    with open(path, "rb") as f:
        assert f.read(2) == b"PK"
    ok, theirs = jax_load(path)
    assert ok
    _, jparams = _jax_loaded(kind, theirs)
    ok, mine = load_model(path)
    assert ok and set(mine) == set(theirs)
    assert isinstance(next(iter(mine.get("model", mine.get("checkpoint"))
                                .values())), np.ndarray)
    got = to_jax_state(_port_loaded(kind, mine))
    want = _flat(jparams)
    _equal_states(got, want)
    exported = _flat(params["fc_decoder"] if kind == "fc_decoder"
                     else params)
    _equal_states(got, exported)


def _adam_after(model, params, updates=3, seed=5):
    """``qaig_tpu``'s Adam (lr 1e-3, halving every 50k) after ``updates``
    updates on numpy-seeded gradients: (params, state, optimizer, rng)."""
    from qaig_tpu.train.optim import make_adam
    import optax
    tx = make_adam(1e-3, 50_000)
    state = tx.init(params)
    rng = np.random.default_rng(seed)
    for _ in range(updates):
        grads = jax.tree_util.tree_map(
            lambda p: jnp.asarray(rng.standard_normal(p.shape)
                                  .astype(np.float32)), params)
        step, state = tx.update(grads, state, params)
        params = optax.apply_updates(params, step)
    return params, state, tx, rng


def _equal_adam(got, want):
    assert got["param_groups"] == want["param_groups"]
    assert set(got["state"]) == set(want["state"])
    for idx, entry in want["state"].items():
        assert set(got["state"][idx]) == set(entry)
        for key, value in entry.items():
            assert torch.equal(torch.as_tensor(got["state"][idx][key]),
                               torch.as_tensor(value)), (idx, key)


def _equal_archives(got, want):
    assert set(got) == set(want)
    for key, value in want.items():
        if key == "model_optimizer" and value is not None:
            _equal_adam(got[key], value)
        elif isinstance(value, dict):
            assert set(got[key]) == set(value), key
            for name, v in value.items():
                assert torch.equal(torch.as_tensor(got[key][name]),
                                   torch.as_tensor(v)), (key, name)
        else:
            assert got[key] == value, key


@pytest.mark.parametrize("kind", KINDS)
def test_export_matches_qaig_tpu(kind, tmp_path):
    """``export_state_dict`` of the port's module equals ``qaig_tpu``'s of
    the same parameters; ``python -m qaig_tpu_torch.cli.export_torch``'s
    ``run`` writes the archive ``qaig_tpu``'s export CLI writes from the
    same pickle checkpoint (with an optax Adam state after 3 updates), and
    ``--no-optim`` leaves the optimizer out of both."""
    from qaig_tpu.cli import export_torch as jax_cli
    from qaig_tpu.utils.checkpoint import save_model
    from qaig_tpu.utils.torch_export import export_state_dict as jax_export
    from qaig_tpu_torch.cli import export_torch as cli
    from qaig_tpu_torch.utils.torch_export import export_state_dict

    model, params, ckpt = _native(kind)
    module = _port_loaded(kind, ckpt)
    want = jax_export(*_export_target(kind, model, params))
    got = export_state_dict(module)
    assert list(got) == list(want)
    for name, value in want.items():
        assert got[name].dtype == torch.float32
        assert torch.equal(got[name], value), name

    if kind == "fc_decoder":
        return   # its checkpoint is the autoencoder's, exported above
    params, state, _, _ = _adam_after(model, params)
    key = "checkpoint" if "checkpoint" in ckpt else "model"
    save_model(dict(ckpt, **{key: _flat(params)}, model_optimizer=state),
               tmp_path, "native.pt")
    native = tmp_path / "models_checkpoint" / "native.pt"
    for no_optim in (False, True):
        outs = []
        for name, run in (("jax", jax_cli.run), ("port", cli.run)):
            out = tmp_path / f"{name}_{no_optim}.pt"
            run({"model_path": native, "out_path": out, "lr": 2e-4,
                 "no_optim": no_optim})
            outs.append(torch.load(out, map_location="cpu",
                                   weights_only=False))
        _equal_archives(outs[1], outs[0])
        assert (outs[1]["model_optimizer"] is None) == no_optim


@pytest.mark.parametrize("kind", KINDS)
def test_reference_adam_state_round_trips(kind):
    """A reference Adam state (``qaig_tpu``'s ``export_adam_state`` after 3
    optax updates) imports into the port's Adam through
    ``restore_optimizer`` at update count 3, exports back unchanged, and
    one more update on the same gradients gives ``qaig_tpu``'s parameters
    within 1e-6."""
    import optax
    from qaig_tpu.utils.torch_optim import export_adam_state as jax_export
    from qaig_tpu_torch import convert
    from qaig_tpu_torch.train import common, optim
    from qaig_tpu_torch.utils.torch_optim import export_adam_state

    model, params, ckpt = _native(kind)
    jmodel, jparams = _export_target(kind, model, params)
    jparams, state, tx, rng = _adam_after(jmodel, jparams)
    reference = jax_export(jmodel, state, learning_rate=1e-3)
    module = _port_loaded(kind, ckpt)
    convert.load_jax_state(module, _flat(jparams), logging=_no_skips)
    module.requires_grad_(True)
    opt, sched = optim.make_adam(module.parameters(), 1e-3, 50_000)
    common.restore_optimizer(module, opt, sched, reference,
                             logging=pytest.fail)
    assert sched.last_epoch == 3
    _equal_adam(export_adam_state(module, opt, learning_rate=1e-3),
                reference)

    grads = jax.tree_util.tree_map(
        lambda p: jnp.asarray(rng.standard_normal(p.shape)
                              .astype(np.float32)), jparams)
    step, _ = tx.update(grads, state, jparams)
    want = _flat(optax.apply_updates(jparams, step))
    table = convert.mapping(module)
    named = dict(module.named_parameters())
    for path, grad in _flat(grads).items():
        name, layout = table[path]
        named[name].grad = torch.from_numpy(np.ascontiguousarray(
            convert._to_torch_layout(grad, layout)))
    opt.step()
    got = convert.to_jax_state(module)
    assert set(got) == set(want)
    for path, value in want.items():
        np.testing.assert_allclose(got[path], value, rtol=0, atol=1e-6,
                                   err_msg=path)


def test_greedy_tokens_from_reference_archives(greedy, tmp_path,
                                               monkeypatch):
    """A two-stage cascade (autoencoder, three codebooks, two
    transformers) exported to ``.pt`` archives by ``qaig_tpu``'s CLI: the
    port's ``generate.run`` on the CPU gives ``qaig_tpu``'s greedy tokens
    from the same archives."""
    from qaig_tpu.cli import export_torch as jax_cli
    from qaig_tpu.infer import generate as jax_generate
    from qaig_tpu_torch.infer import generate

    args = _write_jax_checkpoints(tmp_path)
    ckpt = tmp_path / "models_checkpoint"
    for path in sorted(ckpt.glob("*.pt")):
        jax_cli.run({"model_path": path, "out_path": ckpt / f"ref_{path.name}",
                     "no_optim": True})
    config = json.loads(Path(args["config_path"]).read_text())
    for stage in config.values():
        for key in ("model_path", "lr_codebook_path", "hr_codebook_path"):
            stage[key] = str(ckpt / ("ref_" + Path(stage[key]).name))
    (tmp_path / "ref.json").write_text(json.dumps(config))
    args = dict(args, config_path=str(tmp_path / "ref.json"),
                decoder_path=str(ckpt / "ref_ae.pt"))
    monkeypatch.setattr(jax.random, "randint",
                        lambda *a, **kw: jnp.asarray(INIT_TOKENS, jnp.int32))
    monkeypatch.setattr(generate, "_random_tokens",
                        lambda shape, high, generator: torch.from_numpy(
                            INIT_TOKENS.copy()))
    want = jax_generate.run(dict(args, device="cpu",
                                 out_dir=str(tmp_path / "jax_out")))
    got = generate.run(dict(args, device="cpu",
                            out_dir=str(tmp_path / "port_out")))
    assert got.shape == (2, 16)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_torch_archive_load_runs_no_pickled_code(tmp_path):
    from qaig_tpu_torch.utils.checkpoint import load_model

    ran = []
    hyper = {"global_steps": np.int64(3), "loss": np.float32(0.25),
             "mean": np.arange(4, dtype=np.float16), "name": ("a", None),
             "model": {"w": torch.ones(2, 3)}}
    torch.save(hyper, tmp_path / "plain.pt")
    ok, got = load_model(tmp_path / "plain.pt", logging=lambda m: None)
    assert ok and got["global_steps"] == 3 and got["name"] == ("a", None)
    np.testing.assert_array_equal(got["mean"], hyper["mean"])
    np.testing.assert_array_equal(got["model"]["w"], np.ones((2, 3)))

    class Payload:
        def __reduce__(self):
            return (ran.append, ("ran",))

    torch.save({"model": {}, "x": Payload()}, tmp_path / "code.pt")
    ok, got = load_model(tmp_path / "code.pt", logging=lambda m: None)
    assert (ok, got, ran) == (False, None, [])
