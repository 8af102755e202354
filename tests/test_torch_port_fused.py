"""Fused cascade generation in the PyTorch port (``generate._run_fused``,
``CascadePipeline._fused_program``, ``infer/graphs.py``) on the CPU, where
the fused cascade runs eagerly, against ``qaig_tpu`` and against the port's
own dispatched loop, on the two-stage checkpoints of
``tests/test_fused_generation.py`` (written by ``qaig_tpu``).

* At greedy (sampling patched to argmax on both sides), the fused cascade
  gives ``qaig_tpu``'s dispatched tokens and its per-stage images (atol
  1e-5 in float32).
* At temperature 1 it gives the port's dispatched tokens and images from
  one seed: the same generator draws in the same order.
* ``CascadePipeline.generate(fused=True)`` equals ``fused=False`` under
  row keys; ``fused=True`` with ``init_tokens`` raises.
* The CLI flags, the default path on each device, ``--profile-dir``, and
  the capturable categorical draw against ``torch.multinomial``.

The graph runner itself, and the graphs on the card, are tested in
``tests/test_torch_port_graphs.py``, which imports no JAX.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_fused_generation import _ckpts  # noqa: E402

INIT_TOKENS = np.array([[3], [1]], dtype=np.int64)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    return _ckpts(tmp_path_factory.mktemp("fused_ckpts"))


@pytest.fixture
def greedy(monkeypatch):
    from qaig_tpu_torch.infer import decode as port_decode
    monkeypatch.setattr(
        jax.random, "categorical",
        lambda key, logits, axis=-1, **kw: jnp.argmax(logits, axis=axis))
    monkeypatch.setattr(port_decode, "_categorical",
                        lambda logits, generator: logits.argmax(dim=-1))


def _args(paths, out, num_images, **kw):
    return dict(config_path=paths["config"], decoder_path=paths["decoder"],
                out_dir=str(out), num_images=num_images, seed=3, **kw)


def _recording(monkeypatch, module):
    """The images ``module.run`` saves, by grid name."""
    saved = {}
    save = module.save_images

    def recording(images, name, dest, **kw):
        saved[name] = np.asarray(images)
        return save(images, name, dest, **kw)
    monkeypatch.setattr(module, "save_images", recording)
    return saved


@pytest.mark.parametrize("num_images", [1, 2])
def test_fused_cascade_matches_jax_greedy(greedy, paths, tmp_path,
                                          monkeypatch, num_images):
    """The port's fused cascade on the CPU against ``qaig_tpu``'s
    dispatched loop: equal tokens, and equal conditioning and per-stage
    images within float32 rounding of the convolutions (atol 1e-5)."""
    from qaig_tpu.infer import generate as jax_generate
    from qaig_tpu_torch.infer import generate

    init = INIT_TOKENS[:num_images]
    monkeypatch.setattr(jax.random, "randint",
                        lambda *a, **kw: jnp.asarray(init, jnp.int32))
    monkeypatch.setattr(generate, "_random_tokens",
                        lambda shape, high, generator: torch.from_numpy(
                            init.copy()))
    want_saved = _recording(monkeypatch, jax_generate)
    saved = _recording(monkeypatch, generate)
    want = jax_generate.run(_args(paths, tmp_path / "jax", num_images,
                                  device="cpu", fused=False))
    got = generate.run(_args(paths, tmp_path / "port", num_images,
                             device="cpu", fused=True))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert set(saved) == set(want_saved) == {
        "recon_model_Cond", "recon_model_0", "recon_model_1"}
    for name, images in want_saved.items():
        np.testing.assert_allclose(saved[name], images, atol=1e-5,
                                   err_msg=name)


@pytest.mark.parametrize("num_images", [1, 2])
def test_fused_cascade_matches_dispatched_at_temperature_one(
        paths, tmp_path, monkeypatch, capsys, num_images):
    """At temperature 1 (the config's) and one seed, the fused cascade and
    the dispatched loop draw the same tokens: the stage-0 grid, then each
    stage's rollout, from one generator in one order.  Only the fused run
    announces itself."""
    from qaig_tpu_torch.infer import generate

    saved = _recording(monkeypatch, generate)
    fused = generate.run(_args(paths, tmp_path / "fused", num_images,
                               device="cpu", fused=True))
    assert "Fused single-dispatch cascade: 2 stages" in \
        capsys.readouterr().out
    fused_saved = dict(saved)
    dispatched = generate.run(_args(paths, tmp_path / "dispatched",
                                    num_images, device="cpu"))
    assert "Fused single-dispatch" not in capsys.readouterr().out
    assert fused.shape == (num_images, 16)
    np.testing.assert_array_equal(fused.numpy(), dispatched.numpy())
    for name, images in saved.items():
        np.testing.assert_array_equal(fused_saved[name], images)
    for out in ("fused", "dispatched"):
        for grid in ("recon_model_Cond", "recon_model_0", "recon_model_1"):
            assert (tmp_path / out / "images" / f"{grid}.jpg").exists()


def test_fused_cache_reuses_the_loaded_cascade(paths, tmp_path,
                                               monkeypatch):
    """With a cache, a second call loads nothing and re-seeds the kept
    generator: the same seed gives the same tokens, another seed others."""
    from qaig_tpu_torch.infer import generate

    cache = {}
    first = generate.run(_args(paths, tmp_path / "a", 2, device="cpu",
                               fused=True), cache=cache)
    stages = cache["replicas"][0]["stages"]

    def no_load(*a, **kw):
        raise AssertionError("the cached cascade was loaded again")
    monkeypatch.setattr(generate, "_load_stage", no_load)
    again = generate.run(_args(paths, tmp_path / "b", 2, device="cpu",
                               fused=True), cache=cache)
    other = generate.run(dict(_args(paths, tmp_path / "c", 2, device="cpu",
                                    fused=True), seed=4), cache=cache)
    assert cache["replicas"][0]["stages"] is stages
    np.testing.assert_array_equal(first.numpy(), again.numpy())
    assert not torch.equal(first, other)


def _pipeline(paths):
    import json
    from qaig_tpu_torch.infer.pipeline import CascadePipeline
    config = json.loads(Path(paths["config"]).read_text())
    return CascadePipeline.from_config(config, paths["decoder"],
                                       logging=lambda m: None, device="cpu")


@pytest.mark.parametrize("rows,temperature", [(1, None), (2, None),
                                              (2, 0.7)])
def test_pipeline_fused_matches_dispatched(paths, rows, temperature):
    """Under row keys at temperature > 0, the fused program and the
    dispatched loop give the same images and tokens."""
    pipe = _pipeline(paths)
    img, tok = pipe.generate(rows, seed=5, temperature=temperature,
                             fused=True)
    want_img, want_tok = pipe.generate(rows, seed=5,
                                       temperature=temperature, fused=False)
    assert tok.shape == (rows, 16) and img.dtype == torch.float32
    np.testing.assert_array_equal(tok.numpy(), want_tok.numpy())
    np.testing.assert_array_equal(img.numpy(), want_img.numpy())


def test_pipeline_fused_rejects_init_tokens(paths):
    pipe = _pipeline(paths)
    with pytest.raises(ValueError, match="fused"):
        pipe.generate(2, init_tokens=INIT_TOKENS, fused=True)


def test_pipeline_default_path_by_device(paths, monkeypatch):
    """``fused=None`` takes the dispatched loop on the CPU and the fused
    program on CUDA when no ``init_tokens`` are given (the choice only:
    the CUDA pipeline's program is a stub here)."""
    pipe = _pipeline(paths)
    calls = []

    def program(num_images, temperature):
        calls.append((num_images, temperature))
        return lambda row_keys: ("fused", row_keys.shape)
    monkeypatch.setattr(pipe, "_fused_program", program)
    assert pipe.generate(2, seed=1)[1].shape == (2, 16)
    assert calls == []
    pipe.device = torch.device("cuda", 0)
    assert pipe.generate(2, seed=1) == ("fused", (2, 2))
    assert calls == [(2, None)]
    with pytest.raises(ValueError, match="fused"):
        pipe.generate(2, init_tokens=INIT_TOKENS, fused=True)


@pytest.mark.parametrize("fused,device,want", [
    (None, "cpu", False), (None, "cuda", True), (True, "cpu", True),
    (False, "cuda", False)])
def test_generate_default_path_by_device(fused, device, want):
    from qaig_tpu_torch.infer import generate
    assert generate.use_fused(fused, torch.device(device)) is want


@pytest.mark.parametrize("argv,want", [([], None), (["--fused"], True),
                                       (["--no-fused"], False)])
def test_cli_fused_flags(argv, want, monkeypatch):
    """``--fused`` / ``--no-fused`` reach ``generate.run`` as JAX's CLI
    passes them (None by default), with ``--profile-dir``."""
    from qaig_tpu_torch.cli import generate_images
    from qaig_tpu_torch.infer import generate

    seen = []
    monkeypatch.setattr(generate, "run", seen.append)
    generate_images.main(["--config-path", "c.json", "--decoder-path",
                          "d.pt", "--out-dir", "o", "--profile-dir", "t",
                          *argv])
    assert seen[0]["fused"] is want
    assert str(seen[0]["profile_dir"]) == "t"


def test_cli_fused_flags_exclude_each_other(capsys):
    from qaig_tpu_torch.cli import generate_images
    with pytest.raises(SystemExit):
        generate_images.main(["--config-path", "c.json", "--decoder-path",
                              "d.pt", "--out-dir", "o", "--fused",
                              "--no-fused"])
    assert "not allowed with argument" in capsys.readouterr().err


def test_profile_dir_writes_a_trace(paths, tmp_path):
    from qaig_tpu_torch.infer import generate
    generate.run(_args(paths, tmp_path / "out", 1, device="cpu", fused=True,
                       profile_dir=str(tmp_path / "trace")))
    assert (tmp_path / "trace" / "trace_0.json").stat().st_size > 0


@pytest.mark.parametrize("shape", [(4, 9), (64, 513), (3, 17)])
def test_categorical_draws_what_multinomial_draws(shape):
    """The capturable draw, argmax(p / E) with E ~ Exp(1), gives
    ``torch.multinomial(softmax, 1)``'s tokens from the same generator
    state and leaves the generator in the same state."""
    from qaig_tpu_torch.infer.decode import _categorical

    logits = torch.randn(*shape, generator=torch.Generator().manual_seed(3))
    for seed in (0, 7):
        g1 = torch.Generator().manual_seed(seed)
        g2 = torch.Generator().manual_seed(seed)
        want = torch.multinomial(torch.softmax(logits, dim=-1), 1,
                                 generator=g1)[:, 0]
        assert torch.equal(_categorical(logits, g2), want)
        assert torch.equal(g1.get_state(), g2.get_state())
