"""Transformer-training parity of the PyTorch port (``qaig_tpu_torch``) with
``qaig_tpu``, on the CPU in float32, at a small size (2 layers, in_dim 32,
4 heads of dim 8; codebooks of K 8 and 11 over 2x8x8 latents).

Inputs come from ``np.random.default_rng``; model parameters are drawn in
the shapes of ``qaig_tpu``'s init tree and cross through
``qaig_tpu_torch.convert``.  Tolerances: BMU indices, token sequences,
windows and batches exact; codebook quantization atol 1e-5; logits atol
1e-4 (float32 through several layers, reduction order differs); attention
gradients atol 1e-5; one train step's loss rtol 1e-5 and gradients atol
1e-5, and in bf16 rtol 1e-3 and atol 3e-2 of the largest gradient, with
the dtype of every stage equal; Adam parameters atol 1e-6 (float32 update
arithmetic in another order).
"""

import argparse
import dataclasses
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import optax
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_port_models import make_pair  # noqa: E402

LR_K, HR_K = 8, 11
LATENT = (2, 8, 8)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU ops here are tiny: one intra-op thread keeps them
    from competing with the suite's other workers for every core."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _j(x):
    return jnp.asarray(np.asarray(x))


def _flat_jax(tree):
    from qaig_tpu.utils.checkpoint import flatten_tree
    return {k: np.asarray(v) for k, v in flatten_tree(
        jax.tree_util.tree_map(np.asarray, tree)).items()}


def _codebook_pair(patch, k, seed):
    """(JAX codebook, its params, port codebook) on the same codes."""
    from qaig_tpu.models.codebook import Codebook as JaxCodebook
    from qaig_tpu_torch.models.codebook import Codebook

    kw = dict(patch_dim=patch, image_dim=LATENT[1:], image_channel=LATENT[0],
              num_embeddings=k, init_neighbour_range=3)
    jcb = JaxCodebook(**kw)
    codes = np.random.default_rng(seed).standard_normal(
        (k, jcb.embedding_dim)).astype(np.float32)
    cb = Codebook(**kw)
    with torch.no_grad():
        cb.codebook.copy_(_t(codes))
    return jcb, {"codebook": _j(codes)}, cb


def _latents(n, seed):
    return np.random.default_rng(seed).standard_normal(
        (n,) + LATENT).astype(np.float32)


# ---------------------------------------------------------------------------
# BMU and codebook
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["ragged", "exact_tile", "duplicated"])
def test_bmu_reference_matches_jax_kernel_and_xla(case, rng):
    """The plain version against ``fused_bmu`` in interpret mode and the
    XLA path, index for index (the shapes of ``tests/test_bmu_kernel.py``;
    duplicated codes must give the first index)."""
    from qaig_tpu.ops.bmu import bmu_argmin_xla, fused_bmu
    from qaig_tpu_torch.ops.bmu import bmu_argmin, bmu_argmin_reference

    m, d, k = {"ragged": (300, 16, 64), "exact_tile": (512, 8, 32),
               "duplicated": (200, 16, 48)}[case]
    patches = rng.standard_normal((m, d)).astype(np.float32)
    codes = rng.standard_normal((k, d)).astype(np.float32)
    if case == "duplicated":
        codes = np.concatenate([codes[:16]] * 3)
    got = bmu_argmin_reference(_t(patches), _t(codes)).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(fused_bmu(_j(patches), _j(codes), interpret=True)))
    np.testing.assert_array_equal(
        got, np.asarray(bmu_argmin_xla(_j(patches), _j(codes))))
    np.testing.assert_array_equal(bmu_argmin(_t(patches), _t(codes)).numpy(),
                                  got)
    if case == "duplicated":
        assert got.max() < 16


def test_near_tie_rule_allows_only_tied_rows_to_differ():
    """The rule both the card's kernel tests and ``chip_smoke.py`` hold
    ``fused_bmu`` to: codes 1 and 2 tie for the first patch, code 0 wins
    the second clearly."""
    from qaig_tpu_torch.ops.bmu import bmu_argmin_reference, near_tie_agreement

    codes = torch.tensor([[0.0, 0.0], [1.0, 0.0], [1.0, 0.0]])
    patches = torch.tensor([[0.9, 0.0], [0.1, 0.0]])
    want = bmu_argmin_reference(patches, codes)
    assert want.tolist() == [1, 0]
    assert near_tie_agreement(patches, codes, torch.tensor([2, 0]), want) \
        == {"near_tie_rows": 1, "differing_rows": 1, "max_gap": 0.0}
    with pytest.raises(AssertionError, match="on 1 clear rows"):
        near_tie_agreement(patches, codes, torch.tensor([1, 1]), want)
    with pytest.raises(AssertionError, match="outside the near-tie margin"):
        near_tie_agreement(patches, codes, torch.tensor([0, 0]), want)
    one = torch.zeros(2, dtype=torch.long)   # K = 1: every row is clear
    assert near_tie_agreement(patches, codes[:1], one, one) == {
        "near_tie_rows": 0, "differing_rows": 0, "max_gap": 0.0}


@pytest.mark.parametrize("use_gaussian", [True, False])
def test_codebook_training_half_matches_jax(use_gaussian):
    from qaig_tpu.models.codebook import (
        gaussian_neighbourhood as jax_gaussian)
    from qaig_tpu_torch.models.codebook import gaussian_neighbourhood

    jcb, jparams, cb = _codebook_pair((2, 2), HR_K, seed=1)
    x = _latents(3, seed=2)
    np.testing.assert_array_equal(
        cb.get_patches_bmu(_t(x), reshape=True).numpy(),
        np.asarray(jcb.get_patches_bmu(jparams, _j(x), reshape=True)))
    for r in (None, 1.5):
        np.testing.assert_allclose(
            cb.get_quantized_patches(_t(x), use_gaussian=use_gaussian,
                                     neighbourhood_range=r).detach().numpy(),
            np.asarray(jcb.get_quantized_patches(
                jparams, _j(x), use_gaussian=use_gaussian,
                neighbourhood_range=r)), atol=1e-5)
        np.testing.assert_allclose(
            cb(_t(x), use_gaussian=use_gaussian,
               neighbourhood_range=r).detach().numpy(),
            np.asarray(jcb.apply(jparams, _j(x), use_gaussian=use_gaussian,
                                 neighbourhood_range=r)), atol=1e-5)
    bmu = np.array([0, 3, 10, 5])
    np.testing.assert_allclose(
        gaussian_neighbourhood(_t(bmu), HR_K, 2.5).numpy(),
        np.asarray(jax_gaussian(_j(bmu), HR_K, 2.5)), atol=1e-5)
    # d/d(codebook) of the quantized patches; the BMU carries none
    w = np.random.default_rng(3).standard_normal(
        (3, 16, cb.embedding_dim)).astype(np.float32)
    (cb.get_quantized_patches(_t(x), use_gaussian=use_gaussian)
     * _t(w)).sum().backward()
    want = jax.grad(lambda p: jnp.sum(jcb.get_quantized_patches(
        p, _j(x), use_gaussian=use_gaussian) * _j(w)))(jparams)
    np.testing.assert_allclose(cb.codebook.grad.numpy(),
                               np.asarray(want["codebook"]), atol=1e-5)
    # the neighbourhood schedule, and the reference's never-firing check
    for _ in range(4):
        cb.decrease_neighbourhood()
        jcb.decrease_neighbourhood()
        assert cb.neighbourhood_range == jcb.neighbourhood_range
    with pytest.raises(ValueError):
        cb.decrease_neighbourhood(0)
    type(cb)(num_embeddings=4, init_neighbour_range=100)
    init = type(cb)(num_embeddings=16).init(torch.Generator().manual_seed(0))
    assert float(init.codebook.detach().abs().max()) <= 1.0 / 16


# ---------------------------------------------------------------------------
# model forward and the attention gradient
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["base", "windowed_cascade", "remat"])
def test_transformer_forward_matches_jax_apply(kind):
    cascade = kind != "base"
    jm, params, tm = make_pair(
        seed=4, use_encoder=cascade, use_pos_cond=cascade,
        num_dec_embedding=HR_K + 1 if cascade else 16,
        use_remat=kind == "remat")
    rng = np.random.default_rng(5)
    x_dec = rng.integers(0, 12, (2, 8))
    x_enc = rng.integers(0, 8, (2, 4)) if cascade else None
    pos = rng.integers(0, 17, (2, 8)) if cascade else None
    want = jm.apply(params, _j(x_dec),
                    x_enc=None if x_enc is None else _j(x_enc),
                    pos_cond=None if pos is None else _j(pos))
    tm.requires_grad_(kind == "remat")
    got = tm(_t(x_dec), x_enc=None if x_enc is None else _t(x_enc),
             pos_cond=None if pos is None else _t(pos))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-4)
    if kind == "remat":   # recomputed blocks give the same gradients
        got.sum().backward()
        remat = {n: p.grad.clone() for n, p in tm.named_parameters()}
        tm.zero_grad()
        tm.cfg = dataclasses.replace(tm.cfg, use_remat=False)
        tm(_t(x_dec), x_enc=_t(x_enc), pos_cond=_t(pos)).sum().backward()
        for n, p in tm.named_parameters():
            torch.testing.assert_close(remat[n], p.grad, rtol=0, atol=1e-6)


# (heads, dh, S, causal): S 16 both ways, a ragged causal S (the JAX kernel
# pads it to 16; the causal mask hides the padding) and a non-causal S 64
_GRAD_CASES = [(heads, dh, s, causal)
               for s, causal in ((16, True), (16, False), (13, True),
                                 (64, False))
               for heads, dh in ((4, 8), (2, 32))]
# the head dims of the float32 backward's strip form and its head-dim split
# (dh 64-256), one or two heads, S 16 full and a ragged S 13 causal
_GRAD_CASES += [(heads, dh, s, causal)
                for s, causal in ((16, False), (13, True))
                for heads, dh in ((2, 64), (2, 128), (1, 192), (1, 256))]


@pytest.mark.parametrize(
    "heads,dh,s,causal", _GRAD_CASES,
    ids=[f"{c}-{h}-{d}" + ("" if s == 16 else f"-s{s}")
         for h, d, s, c in _GRAD_CASES])
def test_flash_attention_gradient_matches_jax(heads, dh, s, causal):
    """The port's ``autograd.Function`` (plain forward on the CPU, the
    ``_flash_bwd`` products) against ``jax.grad`` through the JAX kernel in
    interpret mode."""
    from qaig_tpu.ops.flash_attention import flash_attention as jax_flash
    from qaig_tpu_torch.ops.flash_attention import flash_attention

    rng = np.random.default_rng(dh + causal + s)
    q, k, v, w = (rng.standard_normal((2, s, heads * dh)).astype(np.float32)
                  for _ in range(4))
    want = jax.grad(lambda q, k, v: jnp.sum(jax_flash(
        q, k, v, heads, causal=causal, interpret=True) * _j(w)),
        argnums=(0, 1, 2))(_j(q), _j(k), _j(v))
    tq, tk, tv = (_t(x).requires_grad_() for x in (q, k, v))
    calls = flash_attention.backward_calls
    (flash_attention(tq, tk, tv, heads, causal=causal) * _t(w)).sum() \
        .backward()
    assert flash_attention.backward_calls == calls   # counts CUDA only
    for got, ref in zip((tq.grad, tk.grad, tv.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)


# ---------------------------------------------------------------------------
# sequences, windows, one train step, Adam
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("base", [True, False])
def test_assemble_sequences_is_exact(base):
    from qaig_tpu.train.transformer import (
        assemble_sequences as jax_assemble)
    from qaig_tpu_torch.train.transformer import (
        assemble_sequences, input_length)

    rng = np.random.default_rng(6)
    lr_idx = rng.integers(0, LR_K, (3, 1 if base else 4))
    hr_idx = rng.integers(0, HR_K, (3, 16))
    got = assemble_sequences(_t(lr_idx), _t(hr_idx), base, LR_K, HR_K)
    want = jax_assemble(_j(lr_idx), _j(hr_idx), base, LR_K, HR_K)
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if g is not None:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert input_length(lr_idx.shape[1], 16, base) == got[0].shape[1]


def test_slice_windows_matches_jax_sample_windows():
    from qaig_tpu.train.transformer import sample_windows as jax_windows
    from qaig_tpu_torch.train.transformer import (
        draw_window_starts, slice_windows)

    rng = np.random.default_rng(7)
    hr_in, hr_tgt = (rng.integers(0, 12, (5, 17)) for _ in range(2))
    want = jax_windows(jax.random.PRNGKey(3), _j(hr_in), _j(hr_tgt), 8)
    starts = torch.from_numpy(np.asarray(want[2])[:, 0].copy())
    got = slice_windows(_t(hr_in), _t(hr_tgt), starts, 8)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    starts = draw_window_starts(torch.Generator().manual_seed(0), 5, 17, 8)
    _, _, pos = slice_windows(_t(hr_in), _t(hr_tgt), starts, 8)
    assert int(pos.min()) >= 0 and int(pos.max()) <= 16
    assert bool((pos[:, 1:] - pos[:, :-1] == 1).all())


def _train_setup(base):
    """Matching JAX and port models plus codebook pairs for one stage."""
    lr_patch = (8, 8) if base else (4, 4)   # base: one LR token
    lj, lp, lt = _codebook_pair(lr_patch, LR_K, seed=8)
    hj, hp, ht = _codebook_pair((2, 2), HR_K, seed=9)
    jm, params, tm = make_pair(
        seed=10, use_encoder=not base, use_pos_cond=not base,
        num_enc_embedding=LR_K,
        num_dec_embedding=LR_K + HR_K if base else HR_K + 1,
        out_dim=HR_K + 1)
    for cb in (lt, ht):
        cb.requires_grad_(False)
    return (lj, lp, lt), (hj, hp, ht), jm, params, tm.requires_grad_(True)


def _jax_sgd_step(setup, base, bf16=False, **kw):
    """One JAX ``make_train_step`` with ``optax.sgd(1.0)``: (loss, the
    gradients as old minus new parameters, its window starts)."""
    from qaig_tpu.train.transformer import make_train_step as jax_step

    (lj, lp, _), (hj, hp, _), jm, params, _ = setup
    window = None if base else 8
    rng = jax.random.PRNGKey(12)
    old = _flat_jax(params)
    step = jax_step(jm, optax.sgd(1.0), lj, hj, base, LR_K, HR_K, window,
                    bf16=bf16, **kw)
    new_params, _, loss = step(params, optax.sgd(1.0).init(params),
                               (lp, hp), _j(_latents(4, seed=11)), rng)
    starts = None if window is None else torch.from_numpy(np.asarray(
        jax.random.randint(rng, (4,), 0, 17 - window + 1)).copy())
    return (float(loss), {k: old[k] - v for k, v in
                          _flat_jax(new_params).items()}, starts)


def _port_sgd_step(setup, base, starts, monkeypatch, bf16=False, **kw):
    """The port's ``make_train_step`` on the same batch with SGD(lr=1) and
    the given window starts: (loss, gradients as old minus new)."""
    from qaig_tpu_torch.convert import to_jax_state
    from qaig_tpu_torch.train import transformer as port

    (_, _, lt), (_, _, ht), _, _, tm = setup
    if starts is not None:
        monkeypatch.setattr(port, "draw_window_starts",
                            lambda gen, n, seq_in, w: starts)
    before = to_jax_state(tm)
    loss = port.make_train_step(
        tm, torch.optim.SGD(tm.parameters(), lr=1.0), lt, ht, base, LR_K,
        HR_K, None if base else 8, bf16=bf16, debug_nans=bool(kw),
        **kw)(_t(_latents(4, seed=11)), torch.Generator())
    assert all(p.dtype == torch.float32 for p in tm.parameters())
    after = to_jax_state(tm)
    return loss, {k: before[k] - after[k] for k in after}


@pytest.mark.parametrize("case", ["cascade", "cascade_clip_accum", "base"])
def test_train_step_matches_jax(case, monkeypatch):
    """One step with SGD(lr=1) on both sides, so old minus new parameters
    are the gradients; the window starts are JAX's."""
    base = case == "base"
    kw = ({"grad_clip": 0.5, "grad_accum": 2}
          if case == "cascade_clip_accum" else {})
    setup = _train_setup(base)
    jax_loss, want, starts = _jax_sgd_step(setup, base, **kw)
    loss, got = _port_sgd_step(setup, base, starts, monkeypatch, **kw)
    np.testing.assert_allclose(float(loss), jax_loss, rtol=1e-5)
    assert set(got) == set(want)
    for name, grad in want.items():
        np.testing.assert_allclose(got[name], grad, atol=1e-5, err_msg=name)


def _record_stage_dtypes(monkeypatch, targets, trace):
    """Wrap each ``(owner, name)`` so that a call appends ``(name, dtype)``
    to ``trace``: the dtype of what it returns, or for ``cross_entropy``
    of the logits it is given."""
    for owner, name in targets:
        fn = getattr(owner, name)

        def wrapped(*a, _fn=fn, _name=name, **kw):
            out = _fn(*a, **kw)
            x = a[0] if "cross_entropy" in _name else out
            trace.append((_name, str(x.dtype).split(".")[-1]))
            return out
        monkeypatch.setattr(owner, name, wrapped)


@pytest.mark.parametrize("base", [False, True], ids=["cascade", "base"])
def test_bf16_train_step_matches_jax(base, monkeypatch):
    """One ``bf16`` step on both sides (SGD(lr=1), JAX's window starts).

    The frameworks' bf16 CPU kernels round differently (the pos-cond MLP
    alone agrees on about a third of its elements), so the port's float32
    step lies about as close to JAX's bf16 step as its bf16 step does.
    Loss (rtol 1e-3: a bf16 cross-entropy would round it by up to 3e-3)
    and gradients (within 3e-2 of the largest: bf16 rounding through two
    layers and back) are held with bf16 tolerances.  What tells the
    precisions apart is the dtype each stage of the forward returns
    (embeddings, pos-cond, encoder, every block, logits) and the dtype the
    cross-entropy reads: it must be the same on both sides, and the port's
    float32 step must fail that."""
    from qaig_tpu.models import blocks as jax_blocks
    from qaig_tpu.models.transformer import Transformer as JaxTransformer
    from qaig_tpu_torch.models import blocks
    from qaig_tpu_torch.models.transformer import Transformer

    stages = ("encode", "embed_decoder", "pos_cond_embedding", "classify")
    jax_trace, port_trace, f32_trace = [], [], []
    with monkeypatch.context() as m:
        _record_stage_dtypes(
            m, [(JaxTransformer, s) for s in stages]
            + [(jax_blocks, "transformer_block"),
               (optax, "softmax_cross_entropy_with_integer_labels")],
            jax_trace)
        jax_loss, want, starts = _jax_sgd_step(_train_setup(base), base,
                                               bf16=True)
    with monkeypatch.context() as m:
        _record_stage_dtypes(
            m, [(Transformer, s) for s in stages]
            + [(blocks, "transformer_block"),
               (torch.nn.functional, "cross_entropy")], port_trace)
        loss, got = _port_sgd_step(_train_setup(base), base, starts, m,
                                   bf16=True)
        trace, port_trace[:] = list(port_trace), []
        _port_sgd_step(_train_setup(base), base, starts, m)
        f32_trace, port_trace[:] = list(port_trace), trace

    def same_names(trace):
        return [("cross_entropy" if "cross_entropy" in name else name, dtype)
                for name, dtype in trace]

    # base: embedding, 2 decoder blocks, logits, loss; cascade adds 2
    # encoder blocks, the encoder output and the pos-cond embedding
    assert len(jax_trace) == (5 if base else 9)
    assert ("embed_decoder", "bfloat16") in jax_trace
    assert same_names(jax_trace)[-1] == ("cross_entropy", "float32")
    assert same_names(port_trace) == same_names(jax_trace)
    assert same_names(f32_trace) != same_names(jax_trace)

    assert loss.dtype == torch.float32
    np.testing.assert_allclose(float(loss), jax_loss, rtol=1e-3)
    assert set(got) == set(want)
    scale = max(float(np.abs(g).max()) for g in want.values())
    for name, grad in want.items():
        np.testing.assert_allclose(got[name], grad, rtol=0,
                                   atol=3e-2 * scale, err_msg=name)


def test_bf16_train_step_remat_gives_the_same_gradients():
    """bf16 compute on float32 masters: recomputing blocks in the backward
    (``use_remat``) changes no gradient, and the masters stay float32."""
    from qaig_tpu_torch.models.transformer import Transformer
    from qaig_tpu_torch.train.transformer import make_train_step

    (_, _, lt), (_, _, ht), _, _, tm = _train_setup(False)
    grads = []
    for remat in (False, True):
        model = Transformer(dataclasses.replace(tm.cfg, use_remat=remat))
        model.load_state_dict(tm.state_dict())
        sgd = torch.optim.SGD(model.parameters(), lr=1.0)
        before = {n: p.detach().clone() for n, p in model.named_parameters()}
        make_train_step(model, sgd, lt, ht, False, LR_K, HR_K, 8,
                        bf16=True)(_t(_latents(4, 13)),
                                   torch.Generator().manual_seed(1))
        assert all(p.dtype == torch.float32 for p in model.parameters())
        grads.append({n: before[n] - p.detach()
                      for n, p in model.named_parameters()})
    for name in grads[0]:
        torch.testing.assert_close(grads[1][name], grads[0][name], rtol=0,
                                   atol=0, msg=name)


def test_adam_and_halving_schedule_match_optax():
    """Five updates on the same gradients with ``lr_step`` 2: the
    ``LambdaLR`` stepped after each update reads optax's count."""
    from qaig_tpu.train.optim import make_adam as jax_adam
    from qaig_tpu_torch.train import optim

    rng = np.random.default_rng(14)
    p0 = rng.standard_normal((3, 4)).astype(np.float32)
    grads = rng.standard_normal((5, 3, 4)).astype(np.float32)
    tx = jax_adam(1e-2, 2)
    jp, state = _j(p0), tx.init(_j(p0))
    tp = torch.nn.Parameter(_t(p0.copy()))
    opt, sched = optim.make_adam([tp], 1e-2, 2)
    for i, g in enumerate(grads):
        assert opt.param_groups[0]["lr"] == pytest.approx(
            optim.current_lr(1e-2, 2, i))
        updates, state = tx.update(_j(g), state, jp)
        jp = optax.apply_updates(jp, updates)
        tp.grad = _t(g)
        opt.step()
        sched.step()
        np.testing.assert_allclose(tp.detach().numpy(), np.asarray(jp),
                                   atol=1e-6)
    assert [optim.current_lr(1.0, 2, c) for c in range(6)] == \
        [1.0, 1.0, 1.0, 0.5, 0.5, 0.25]


# ---------------------------------------------------------------------------
# data, optimizer state interchange, the trainer
# ---------------------------------------------------------------------------

def _write_fmaps(root, n, seed=15):
    from qaig_tpu_torch.data.manifest import write_manifest
    rows = []
    for i, x in enumerate(_latents(n, seed)):
        path = Path(root) / f"fmap_{i}.npy"
        np.save(path, x)
        rows.append({"fmap_path": str(path), "image_path": ""})
    return write_manifest(Path(root) / "all_dataset.json", rows)


def test_data_loader_batches_match_jax(tmp_path):
    from qaig_tpu.data import DataLoader as JaxLoader
    from qaig_tpu.data import FeatureMapDataset as JaxDataset
    from qaig_tpu_torch.data.fmap_dataset import FeatureMapDataset
    from qaig_tpu_torch.data.loader import DataLoader

    manifest = _write_fmaps(tmp_path, 11)
    port = DataLoader(FeatureMapDataset(manifest), batch_size=3, seed=5)
    ref = JaxLoader(JaxDataset(manifest), batch_size=3, seed=5)
    assert len(port) == len(ref) == 3
    for _ in range(2):   # two epochs: the shuffle advances alike
        got, want = list(port), list(ref)
        assert len(got) == len(want) == 3
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, np.asarray(w))
    with pytest.raises(ValueError, match="No data"):
        FeatureMapDataset(tmp_path / "missing.json")


def test_optimizer_state_crosses_both_ways(tmp_path):
    """The port reads a ``qaig_tpu``-written optax Adam state into
    ``torch.optim.Adam``, and ``qaig_tpu`` restores what the port
    writes."""
    from qaig_tpu.train.common import restore_opt_state
    from qaig_tpu.train.optim import make_adam as jax_adam
    from qaig_tpu.utils.checkpoint import save_model as jax_save
    from qaig_tpu_torch.convert import load_optax_state, to_optax_state
    from qaig_tpu_torch.train import optim
    from qaig_tpu_torch.utils.checkpoint import load_model, save_model

    jm, params, tm = make_pair(seed=16, use_encoder=True, use_pos_cond=True)
    tm.requires_grad_(True)
    tx = jax_adam(1e-3, 50_000)
    state = tx.init(params)
    rng = np.random.default_rng(17)
    for _ in range(2):
        grads = jax.tree_util.tree_map(
            lambda p: _j(rng.standard_normal(p.shape).astype(np.float32)),
            params)
        _, state = tx.update(grads, state, params)
    jax_save({"model_optimizer": state}, tmp_path, "jax.pt")
    ok, ckpt = load_model(tmp_path / "models_checkpoint" / "jax.pt")
    assert ok
    opt, sched = optim.make_adam(tm.parameters(), 1e-3, 50_000)
    count = load_optax_state(tm, opt, ckpt["model_optimizer"],
                             logging=pytest.fail)
    assert count == 2
    written = to_optax_state(tm, opt)
    want = _flat_jax(state)
    from qaig_tpu_torch.utils.checkpoint import flatten_tree
    got = flatten_tree(written)
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_array_equal(np.asarray(got[key]), want[key],
                                      err_msg=key)

    # the port writes after one more update; qaig_tpu restores it
    for p in tm.parameters():
        p.grad = torch.ones_like(p)
    opt.step()
    save_model({"model_optimizer": to_optax_state(tm, opt)}, tmp_path,
               "port.pt")
    from qaig_tpu.utils.checkpoint import load_model as jax_load
    ok, ckpt = jax_load(tmp_path / "models_checkpoint" / "port.pt")
    assert ok
    restored = restore_opt_state(jm, params, tx.init(params),
                                 ckpt["model_optimizer"],
                                 logging=pytest.fail)
    assert int(restored[0].count) == 3 and int(restored[1].count) == 3
    flat = _flat_jax(restored)
    for key, value in flatten_tree(to_optax_state(tm, opt)).items():
        np.testing.assert_array_equal(flat[key], np.asarray(value),
                                      err_msg=key)


def _write_training_fixture(root, base=False):
    """Feature maps, LR (patch 4; base: 8, one token) and HR (patch 2)
    codebooks, an FC decoder and a config (cascade: windowed), with the
    port's writers."""
    from qaig_tpu_torch.convert import to_jax_state
    from qaig_tpu_torch.models.codebook import Codebook
    from qaig_tpu_torch.models.conv_nets import ConvNetConfig, FCDecoder
    from qaig_tpu_torch.models.core import init_parameters
    from qaig_tpu_torch.utils.checkpoint import save_model

    root = Path(root)
    gen = torch.Generator().manual_seed(18)
    dec_cfg = dict(num_layers=1, image_channel=3, min_channel=8,
                   max_channel=16, latent_channel=LATENT[0],
                   hidden_activation_type="silu")
    decoder = init_parameters(FCDecoder(ConvNetConfig(**dec_cfg)), gen)
    save_model(dict(dec_cfg, use_final_enc_activation=True,
                    encoder_activation_type="silu",
                    use_final_dec_activation=True,
                    decoder_activation_type="tanh",
                    model={f"fc_decoder.{k}": v for k, v in
                           to_jax_state(decoder).items()}), root, "dec.pt")
    for name, patch, k in (("lr", (8, 8) if base else (4, 4), LR_K),
                           ("hr", (2, 2), HR_K)):
        cb = Codebook(patch_dim=patch, image_dim=LATENT[1:],
                      image_channel=LATENT[0], num_embeddings=k).init(gen)
        save_model({"patch_dim": patch, "image_dim": LATENT[1:],
                    "image_C": LATENT[0], "num_embeddings": k,
                    "neighbourhood_range": 2,
                    "checkpoint": to_jax_state(cb)}, root, f"{name}.pt")
    config = root / "tf.json"
    config.write_text(json.dumps({
        "model_lr": 1e-3, "use_sliding_window": not base,
        "sliding_window": 8, "num_enc_layers": 1, "num_dec_layers": 2,
        "self_attn_heads": 4, "cross_attn_heads": 4, "in_dim": 32,
        "hidden_dim": 48, "hidden_activation": "silu"}))
    ckpt = root / "models_checkpoint"
    return {"device": "cpu", "dataset_path": _write_fmaps(root, 8),
            "decoder_path": str(ckpt / "dec.pt"),
            "lr_codebook_path": str(ckpt / "lr.pt"),
            "hr_codebook_path": str(ckpt / "hr.pt"),
            "config_path": str(config), "batch_size": 4,
            "test_num_sample": 2, "checkpoint_step": 2, "seed": 0}


def test_cpu_run_ema_retention_and_auto_resume(tmp_path):
    """Three steps with EMA and retention, then an auto-resumed run that
    continues the step numbering; ``qaig_tpu`` reads the checkpoint."""
    from qaig_tpu.train.common import restore_model_state
    from qaig_tpu.utils.checkpoint import load_model as jax_load
    from qaig_tpu_torch.train import transformer

    args = dict(_write_training_fixture(tmp_path), ema_decay=0.9,
                keep_checkpoints=1, auto_resume=True,
                out_dir=str(tmp_path / "out"))
    transformer.run(dict(args, max_steps=3, profile_start=1,
                         profile_steps=1,
                         profile_dir=str(tmp_path / "profile")))
    assert (tmp_path / "profile" / "trace_1.json").exists()
    out = tmp_path / "out"
    ckpts = out / "models_checkpoint"
    assert sorted(p.name for p in ckpts.iterdir()) == ["model_2.pt"]
    for name in ("ground_truth", "low_res_cond", "high_res_example",
                 "high_res_recon"):
        for step in (0, 2):
            assert (out / "images" / f"{name}_{step}.jpg").exists()
    ok, ckpt = jax_load(ckpts / "model_2.pt")
    assert ok and ckpt["global_steps"] == 2
    assert set(ckpt) >= {"model", "model_optimizer", "model_ema"}
    assert int(np.asarray(ckpt["model_optimizer"][0][0])) == 3
    assert not np.allclose(ckpt["model_ema"]["classifier.l1.w"],
                           ckpt["model"]["classifier.l1.w"])
    jm, params, _ = make_pair(use_encoder=True, use_pos_cond=True,
                              num_enc_layers=1, num_enc_embedding=LR_K,
                              num_dec_embedding=HR_K + 1, out_dim=HR_K + 1)
    restored = restore_model_state(jm, params, ckpt["model"],
                                   logging=pytest.fail)
    np.testing.assert_array_equal(
        np.asarray(restored["classifier"]["l1"]["w"]),
        ckpt["model"]["classifier.l1.w"])

    transformer.run(dict(args, max_steps=5, log_every=2))
    log = (out / "Quantized Transformer.log").read_text()
    assert "Auto-resume: continuing from" in log
    assert "Resuming at global step 3." in log
    steps = [json.loads(line)["step"]
             for line in (out / "metrics.jsonl").read_text().splitlines()]
    assert steps == [1, 2, 3, 4, 5]
    assert all(np.isfinite(json.loads(line)["ce_loss"]) for line in
               (out / "metrics.jsonl").read_text().splitlines())
    assert sorted(p.name for p in ckpts.iterdir()) == ["model_4.pt"]


def test_cpu_run_base_model_preview(tmp_path):
    """Base mode: decoder-only over LR + shifted HR tokens, and its
    preview conditioned on the one LR token."""
    from qaig_tpu_torch.train import transformer
    from qaig_tpu_torch.utils.checkpoint import load_model

    out = tmp_path / "out"
    transformer.run(dict(_write_training_fixture(tmp_path, base=True),
                         train_base_model=True, max_steps=1,
                         temperature=0.5, out_dir=str(out)))
    assert (out / "images" / "high_res_recon_0.jpg").exists()
    ok, ckpt = load_model(out / "models_checkpoint" / "model_0.pt")
    assert ok and ckpt["train_base_model"] and ckpt["num_enc_layers"] is None
    assert ckpt["num_dec_embedding"] == LR_K + HR_K
    assert ckpt["model"]["dec_embedding.w"].shape == (LR_K + HR_K, 32)


def test_train_device_cuda_without_a_gpu_raises(tmp_path):
    from qaig_tpu_torch.cli import train_quantized_transformer as cli
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--dataset-path", "d.json", "--decoder-path", "d.pt",
                  "--lr-codebook-path", "l.pt", "--hr-codebook-path",
                  "h.pt", "--config-path", "c.json", "--out-dir",
                  str(tmp_path)])


# flags of the JAX CLI that the port leaves out: XLA's
LEFT_OUT = {"compilation_cache_dir", "compiler_options"}


def test_cli_flags_match_jax_cli(monkeypatch):
    """Every other flag has the JAX CLI's name, type, default and
    required-ness; ``--device`` narrows its choices to what the port
    runs, ``--checkpoint-backend`` trades the orbax ones for
    ``pickle-async``."""
    from qaig_tpu.cli import train_quantized_transformer as jax_cli
    from qaig_tpu_torch.cli import train_quantized_transformer as cli

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
            continue
        if dest == "checkpoint_backend":   # orbax imports JAX
            assert set(action.choices) & set(other.choices) == {"pickle"}
            assert set(action.choices) == {"pickle", "pickle-async"}
        assert action.default == other.default, dest
        assert getattr(action.type, "__name__", action.type) == \
            getattr(other.type, "__name__", other.type), dest
