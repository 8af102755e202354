"""Generation parity of the PyTorch port (``qaig_tpu_torch.infer``) with
``qaig_tpu``, on the CPU in float32, plus the port's import hygiene.

Sampling is patched to argmax on both sides (the ``tests/test_decode.py``
pattern: ``jax.random.categorical`` there, the port's module-level
``_categorical`` here), so rollouts must give identical tokens: a base
stage, an encoder stage with a sliding window (window 8: a crossing segment
with 3 cached steps; window 9: with none), an int8 prefix, and a whole
cascade read from checkpoints that ``qaig_tpu`` wrote.  A segment as wide as
the window takes both packages' tile-everything path.
"""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_port_models import make_pair, random_params  # noqa: E402

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU ops here are tiny: one intra-op thread keeps them
    from competing with the suite's other workers for every core."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def greedy(monkeypatch):
    from qaig_tpu_torch.infer import decode as port_decode
    monkeypatch.setattr(
        jax.random, "categorical",
        lambda key, logits, axis=-1, **kw: jnp.argmax(logits, axis=axis))
    monkeypatch.setattr(port_decode, "_categorical",
                        lambda logits, generator: logits.argmax(dim=-1))


def _rollouts(quantized_prefix=False, window=None, use_encoder=True,
              steps=16, num_beam=3, beam_width=4, seed=0, **engine_kw):
    from qaig_tpu.infer.decode import DecodeEngine as JaxEngine
    from qaig_tpu.infer.decode import SamplerSettings as JaxSettings
    from qaig_tpu_torch.infer.decode import DecodeEngine, SamplerSettings

    use_pos = window is not None
    jm, params, tm = make_pair(seed=seed, use_encoder=use_encoder,
                               use_pos_cond=use_pos, out_dim=17,
                               num_dec_embedding=17)
    rng = np.random.default_rng(seed)
    n = 2
    init = np.full((n, 1), 16) if use_encoder else rng.integers(0, 16,
                                                                (n, 1))
    x_enc = rng.integers(0, 8, (n, 4)) if use_encoder else None
    kw = dict(temperature=1.0, end_token=16, end_mode="mask",
              pos_offset=1 if use_pos else 0)
    want = JaxEngine(jm, quantized_prefix=quantized_prefix,
                     **engine_kw).rollout_generate(
        params, jnp.asarray(init), steps, jax.random.PRNGKey(3),
        JaxSettings(**kw), num_beam=num_beam, beam_width=beam_width,
        x_enc=None if x_enc is None else jnp.asarray(x_enc),
        sliding_window=window)
    got = DecodeEngine(tm, quantized_prefix=quantized_prefix, **engine_kw) \
        .rollout_generate(torch.from_numpy(init), steps, torch.Generator(),
                          SamplerSettings(**kw), num_beam=num_beam,
                          beam_width=beam_width,
                          x_enc=None if x_enc is None
                          else torch.from_numpy(x_enc),
                          sliding_window=window)
    assert got.shape == (n, steps)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_base_stage_rollout_tokens_match_jax(greedy):
    _rollouts(use_encoder=False)


@pytest.mark.parametrize("window,beam_width", [(8, 4), (9, 4), (4, 4)])
def test_windowed_encoder_stage_rollout_tokens_match_jax(greedy, window,
                                                         beam_width):
    """window 8: a crossing segment with 3 cached steps; 9: with none;
    4: beam_width == window takes the tile-everything path."""
    _rollouts(window=window, beam_width=beam_width)


def test_int8_prefix_rollout_tokens_match_jax(greedy):
    _rollouts(quantized_prefix=True)


@pytest.mark.parametrize("case", ["flat", "flat_falls_back", "flat_int8",
                                  "legacy_windowed"])
def test_engine_options_match_jax(greedy, monkeypatch, case):
    """``flat_decode`` (bw 8: the flat kernel's plain version on every
    rollout step; bw 4: routed back to the slot-minor path, as in JAX),
    ``flat_decode`` with an int8 prefix, and ``legacy_windowed_rollouts``
    on a windowed stage give ``qaig_tpu``'s tokens (its flat kernel in the
    Pallas interpreter)."""
    from qaig_tpu_torch.ops import decode_attention as da

    calls = []
    flat = da.shared_prefix_attention_fused_flat

    def counting(*a, **kw):
        calls.append(kw.get("k_scale") is not None)
        return flat(*a, **kw)
    monkeypatch.setattr(da, "shared_prefix_attention_fused_flat", counting)
    if case == "legacy_windowed":
        _rollouts(window=8, beam_width=4, legacy_windowed_rollouts=True)
        assert calls == []
        return
    bw = 4 if case == "flat_falls_back" else 8
    _rollouts(quantized_prefix=case == "flat_int8", beam_width=bw,
              flat_decode=True)
    # 2 decoder layers x 16 rollout steps, each through the flat kernel
    want = [] if bw == 4 else [case == "flat_int8"] * 32
    assert calls == want


def test_single_path_generate_matches_jax(greedy):
    """The single-path engine through the hybrid cached -> windowed
    decode."""
    from qaig_tpu.infer.decode import DecodeEngine as JaxEngine
    from qaig_tpu.infer.decode import SamplerSettings as JaxSettings
    from qaig_tpu_torch.infer.decode import DecodeEngine, SamplerSettings

    jm, params, tm = make_pair(seed=4, use_encoder=True, use_pos_cond=True,
                               out_dim=17, num_dec_embedding=17)
    rng = np.random.default_rng(4)
    init = np.full((2, 1), 16)
    x_enc = rng.integers(0, 8, (2, 4))
    kw = dict(end_token=16, end_mode="replace_zero")
    want = JaxEngine(jm).generate(params, jnp.asarray(init), 10,
                                  jax.random.PRNGKey(0), JaxSettings(**kw),
                                  x_enc=jnp.asarray(x_enc),
                                  sliding_window=6)
    got = DecodeEngine(tm).generate(torch.from_numpy(init), 10,
                                    torch.Generator(), SamplerSettings(**kw),
                                    x_enc=torch.from_numpy(x_enc),
                                    sliding_window=6)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# checkpoint round trip: qaig_tpu writes, both packages generate
# ---------------------------------------------------------------------------

LR_K, MID_K, HR_K = 6, 10, 12
INIT_TOKENS = np.array([[3], [1]], dtype=np.int64)


def _write_jax_checkpoints(tmp_path):
    from qaig_tpu.models.conv_nets import Autoencoder, AutoencoderConfig
    from qaig_tpu.models.transformer import Transformer, TransformerConfig
    from qaig_tpu.utils.checkpoint import flatten_tree, save_model

    def flat(params):
        return {k: np.asarray(v) for k, v in flatten_tree(params).items()}

    ae_cfg = dict(num_layers=1, image_channel=3, min_channel=8,
                  max_channel=16, latent_channel=2,
                  hidden_activation_type="silu",
                  use_final_enc_activation=True,
                  encoder_activation_type="tanh",
                  use_final_dec_activation=True,
                  decoder_activation_type="tanh")
    ae = Autoencoder(AutoencoderConfig(**ae_cfg))
    save_model(dict(ae_cfg, model=flat(random_params(ae.init, 1))),
               tmp_path, "ae.pt")

    rng = np.random.default_rng(2)
    for name, patch, k in (("cb_a", 4, LR_K), ("cb_b", 2, MID_K),
                           ("cb_c", 1, HR_K)):
        codes = rng.uniform(-0.5, 0.5, (k, 2 * patch * patch))
        save_model({"patch_dim": (patch, patch), "image_dim": (4, 4),
                    "image_C": 2, "num_embeddings": k,
                    "neighbourhood_range": 1,
                    "checkpoint": {"codebook": codes.astype(np.float32)}},
                   tmp_path, f"{name}.pt")

    stages = {
        "tf0": dict(train_base_model=True, use_sliding_window=False,
                    sliding_window=None, num_enc_layers=None,
                    num_enc_embedding=None, num_dec_embedding=LR_K + MID_K,
                    cross_attn_heads=None, transformer_out_dim=MID_K + 1),
        "tf1": dict(train_base_model=False, use_sliding_window=True,
                    sliding_window=8, num_enc_layers=1,
                    num_enc_embedding=MID_K, num_dec_embedding=HR_K + 1,
                    cross_attn_heads=4, transformer_out_dim=HR_K + 1),
    }
    for i, (name, meta) in enumerate(stages.items()):
        meta.update(num_dec_layers=2, self_attn_heads=4,
                    transformer_in_dim=32, transformer_hidden_dim=48,
                    hidden_activation="silu")
        cfg = TransformerConfig(
            use_encoder=not meta["train_base_model"],
            use_pos_cond=meta["use_sliding_window"],
            num_enc_layers=meta["num_enc_layers"] or 0,
            num_dec_layers=2, num_enc_embedding=meta["num_enc_embedding"] or 1,
            num_dec_embedding=meta["num_dec_embedding"], self_attn_heads=4,
            cross_attn_heads=meta["cross_attn_heads"] or 0, in_dim=32,
            out_dim=meta["transformer_out_dim"], hidden_dim=48)
        params = random_params(Transformer(cfg).init, 10 + i)
        save_model(dict(meta, model=flat(params)), tmp_path, f"{name}.pt")

    ckpt = tmp_path / "models_checkpoint"
    config = {
        "0": {"model_path": str(ckpt / "tf0.pt"),
              "lr_codebook_path": str(ckpt / "cb_a.pt"),
              "hr_codebook_path": str(ckpt / "cb_b.pt"), "temperature": 1.0,
              "num_beam": 2, "beam_width": 2},
        "1": {"model_path": str(ckpt / "tf1.pt"),
              "lr_codebook_path": str(ckpt / "cb_b.pt"),
              "hr_codebook_path": str(ckpt / "cb_c.pt"), "temperature": 1.0,
              "num_beam": 2, "beam_width": 4},
    }
    (tmp_path / "gen.json").write_text(json.dumps(config))
    return {"config_path": str(tmp_path / "gen.json"),
            "decoder_path": str(ckpt / "ae.pt"), "num_images": 2, "seed": 0}


def test_checkpoint_round_trip_generation_matches_jax(greedy, tmp_path,
                                                      monkeypatch):
    """``qaig_tpu`` writes the pickles; the port's ``run(device="cpu")``
    yields the same tokens as ``qaig_tpu``'s ``run`` at greedy."""
    from qaig_tpu.infer import generate as jax_generate
    from qaig_tpu_torch.infer import generate

    args = _write_jax_checkpoints(tmp_path)
    monkeypatch.setattr(jax.random, "randint",
                        lambda *a, **kw: jnp.asarray(INIT_TOKENS, jnp.int32))
    monkeypatch.setattr(generate, "_random_tokens",
                        lambda shape, high, generator: torch.from_numpy(
                            INIT_TOKENS.copy()))
    recorded = {"jax": [], "port": []}
    for key, module in (("jax", jax_generate), ("port", generate)):
        orig = module.generate_stage_tokens

        def recording(*a, _orig=orig, _key=key, **kw):
            out = _orig(*a, **kw)
            recorded[_key].append(np.asarray(out))
            return out
        monkeypatch.setattr(module, "generate_stage_tokens", recording)

    want = jax_generate.run(dict(args, device="cpu",
                                 out_dir=str(tmp_path / "jax_out")))
    got = generate.run(dict(args, device="cpu",
                            out_dir=str(tmp_path / "port_out")))
    assert [t.shape for t in recorded["port"]] == [(2, 4), (2, 16)]
    for mine, theirs in zip(recorded["port"], recorded["jax"]):
        np.testing.assert_array_equal(mine, theirs)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (tmp_path / "port_out" / "images" / "recon_model_1.jpg").exists()


# ---------------------------------------------------------------------------
# entry points and import hygiene
# ---------------------------------------------------------------------------

def test_device_cuda_without_a_gpu_raises():
    from qaig_tpu_torch.train.common import select_device
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        select_device("cuda")
    assert select_device("cpu").type == "cpu"


def test_port_imports_neither_jax_nor_qaig_tpu():
    """Importing every module of the port pulls in no ``jax``, nothing of
    ``qaig_tpu`` and none of the JAX side's ``scripts/`` (checked in a
    fresh interpreter)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import qaig_tpu_torch\n"
        "for m in pkgutil.walk_packages(qaig_tpu_torch.__path__, "
        "'qaig_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'qaig_tpu', 'flax', 'optax', 'scripts', "
        "'eval_quality', 'quality_run', 'render_quality', "
        "'sampling_sweep', 'quality_bf16_ab'))\n"
        "print(sorted(m for m in sys.modules "
        "if m.startswith('qaig_tpu_torch.')), bad)\n"
        "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.count("'qaig_tpu_torch.") >= 20, proc.stdout
    for name in ("serve", "infer.pipeline", "infer.row_keys",
                 "cli.serve_generation", "ops.decode_attention",
                 "ops.mlp_fused", "scripts.probe_mlp_fused", "utils.png",
                 "data.image_dataset", "train.autoencoder", "train.fmap",
                 "train.codebook", "train.prune", "cli.train_autoencoder",
                 "cli.generate_fmap_dataset", "cli.train_codebook",
                 "cli.prune_codebook", "utils.torch_compat",
                 "utils.torch_export", "utils.torch_optim",
                 "cli.export_torch", "parallel.comm", "parallel.mesh",
                 "parallel.sharding", "parallel.pipeline",
                 "parallel.local", "cli._args", "native",
                 "scripts.eval_quality", "data.fmap_dataset", "data.loader",
                 "scripts.quality_run", "scripts.render_quality",
                 "scripts.sampling_sweep", "scripts.quality_bf16_ab"):
        assert f"'qaig_tpu_torch.{name}'" in proc.stdout, name
