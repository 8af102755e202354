"""Parity of the PyTorch port's models (``qaig_tpu_torch.models``) with
``qaig_tpu``'s, on the CPU in float32, at a small size (2 layers, in_dim 32,
4 heads).

Parameters are drawn with numpy in the shapes of ``qaig_tpu``'s init tree
(so the zero-initialized AdaLN-Zero and gate weights take part too) and
reach the port through ``qaig_tpu_torch.convert``.  Inputs come from
``np.random.default_rng``.  Tolerance: atol 1e-4 on logits and pixels
(float32 through several layers, reduction order differs); the codebook
lookup is exact.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

ATOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU ops here are tiny: one intra-op thread keeps them
    from competing with the suite's other workers for every core."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _small_cfg(**kw):
    base = dict(use_encoder=False, use_pos_cond=False, num_enc_layers=2,
                num_dec_layers=2, num_enc_embedding=8, num_dec_embedding=16,
                self_attn_heads=4, cross_attn_heads=4, in_dim=32, out_dim=12,
                hidden_dim=48)
    base.update(kw)
    return base


def random_params(init, seed):
    """Numpy-drawn parameters in the shapes of the JAX ``init`` tree:
    U(+-1/sqrt(fan_in)) weights, U(+-0.1) biases, norm gains 1 + N(0, 0.1),
    N(0, 1) embeddings."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(init, jax.random.PRNGKey(0))

    def draw(path, leaf):
        name = jax.tree_util.keystr(path)
        shape = leaf.shape
        if name.endswith("['g']"):
            x = 1.0 + rng.normal(0.0, 0.1, shape)
        elif "embedding" in name:
            x = rng.standard_normal(shape)
        elif len(shape) == 1:
            x = rng.uniform(-0.1, 0.1, shape)
        else:
            fan_in = int(np.prod(shape[:-1]))
            x = rng.uniform(-1.0, 1.0, shape) / np.sqrt(fan_in)
        return jnp.asarray(x.astype(np.float32))
    return jax.tree_util.tree_map_with_path(draw, shapes)


def make_pair(seed=0, **kw):
    """(jax model, jax params, port model) sharing the same parameters."""
    from qaig_tpu.models.transformer import Transformer as JaxTransformer
    from qaig_tpu.models.transformer import (
        TransformerConfig as JaxTransformerConfig)
    from qaig_tpu_torch.convert import load_jax_state
    from qaig_tpu_torch.models.transformer import (Transformer,
                                                   TransformerConfig)

    cfg = _small_cfg(**kw)
    jmodel = JaxTransformer(JaxTransformerConfig(**cfg))
    params = random_params(jmodel.init, seed)
    tmodel = Transformer(TransformerConfig(**cfg)).requires_grad_(False)
    load_jax_state(tmodel, jax.tree_util.tree_map(np.asarray, params),
                   logging=_no_skips)
    return jmodel, params, tmodel


def _no_skips(msg):
    raise AssertionError(f"parameter conversion skipped a leaf: {msg}")


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=atol)


def test_convert_round_trip_is_exact():
    from qaig_tpu.utils.checkpoint import flatten_tree
    from qaig_tpu_torch.convert import to_jax_state

    _, params, tmodel = make_pair(use_encoder=True, use_pos_cond=True)
    flat = flatten_tree(jax.tree_util.tree_map(np.asarray, params))
    back = to_jax_state(tmodel)
    assert set(back) == set(flat)
    for key, value in flat.items():
        np.testing.assert_array_equal(back[key], value, err_msg=key)


def test_encode_and_prefill_match_jax():
    jm, params, tm = make_pair(seed=1, use_encoder=True, use_pos_cond=True)
    rng = np.random.default_rng(1)
    x_enc = rng.integers(0, 8, (2, 5))
    tokens = rng.integers(0, 16, (2, 4))
    pos = rng.integers(0, 30, (2, 4)).astype(np.float32)

    enc = tm.encode(_t(x_enc))
    jenc = jm.encode(params, jnp.asarray(x_enc))
    _close(enc, jenc)

    jckv = jm.make_cross_kv(params, jenc)
    ckv = tm.make_cross_kv(enc)
    logits, caches = tm.prefill(_t(tokens), tm.init_cache(2, 6),
                                cross_kv=ckv, pos_cond=_t(pos))
    jlogits, jcaches = jm.prefill(params, jnp.asarray(tokens),
                                  jm.init_cache(2, 6), cross_kv=jckv,
                                  pos_cond=jnp.asarray(pos))
    _close(logits, jlogits)
    for c, jc in zip(caches, jcaches):
        _close(c["k"], jc["k"])
        _close(c["v"], jc["v"])


@pytest.mark.parametrize("use_encoder", [False, True])
def test_decode_step_matches_jax(use_encoder):
    jm, params, tm = make_pair(seed=2, use_encoder=use_encoder,
                               use_pos_cond=use_encoder)
    rng = np.random.default_rng(2)
    tokens = rng.integers(0, 16, (2, 6))
    x_enc = rng.integers(0, 8, (2, 5))
    ckv = jckv = None
    if use_encoder:
        ckv = tm.make_cross_kv(tm.encode(_t(x_enc)))
        jckv = jm.make_cross_kv(params, jm.encode(params,
                                                  jnp.asarray(x_enc)))
    pos = (np.arange(3, dtype=np.float32)[None].repeat(2, 0)
           if use_encoder else None)
    _, caches = tm.prefill(_t(tokens[:, :3]), tm.init_cache(2, 8),
                           cross_kv=ckv,
                           pos_cond=None if pos is None else _t(pos))
    _, jcaches = jm.prefill(params, jnp.asarray(tokens[:, :3]),
                            jm.init_cache(2, 8), cross_kv=jckv,
                            pos_cond=None if pos is None
                            else jnp.asarray(pos))
    packed, jpacked = tm.pack_decode(), jm.pack_decode(params)
    for i in range(3, 6):
        pv = i + 1 if use_encoder else None
        logits, caches = tm.decode_step(_t(tokens[:, i]), caches, i,
                                        cross_kv=ckv, pos_cond_value=pv,
                                        packed=packed)
        jlogits, jcaches = jm.decode_step(
            params, jnp.asarray(tokens[:, i]), jcaches, jnp.asarray(i),
            cross_kv=jckv, pos_cond_value=pv, packed=jpacked)
        _close(logits, jlogits)


@pytest.mark.parametrize("int8", [False, True])
def test_decode_step_shared_and_merge_match_jax(int8):
    """A rollout segment step by step: shared-prefix decode, then the
    selected blocks merged back into the (int8) prefix."""
    from qaig_tpu.ops.kv_quant import quantize_caches as jax_quantize
    from qaig_tpu_torch.ops.kv_quant import quantize_caches

    jm, params, tm = make_pair(seed=3, use_encoder=True, use_pos_cond=True)
    rng = np.random.default_rng(3)
    n, b, bw, p = 2, 3, 4, 3
    x_enc = rng.integers(0, 8, (n, 5))
    prefix = rng.integers(0, 16, (n, p))
    pos = np.arange(p, dtype=np.float32)[None].repeat(n, 0)
    enc = tm.encode(_t(x_enc))
    jenc = jm.encode(params, jnp.asarray(x_enc))
    ckv, jckv = tm.make_cross_kv(enc), jm.make_cross_kv(params, jenc)
    _, caches = tm.prefill(_t(prefix), tm.init_cache(n, 8), cross_kv=ckv,
                           pos_cond=_t(pos))
    _, jcaches = jm.prefill(params, jnp.asarray(prefix),
                            jm.init_cache(n, 8), cross_kv=jckv,
                            pos_cond=jnp.asarray(pos))
    if int8:
        caches, jcaches = quantize_caches(caches), jax_quantize(jcaches)
    split, jsplit = tm.presplit_cross_kv(ckv), jm.presplit_cross_kv(jckv)
    blocks = tm.init_block_cache(n * b, bw)
    jblocks = jm.init_block_cache(n * b, bw)
    packed, jpacked = tm.pack_decode(), jm.pack_decode(params)
    step_tokens = rng.integers(0, 16, (bw, n * b))
    for j in range(bw):
        logits, blocks = tm.decode_step_shared(
            _t(step_tokens[j]), caches, blocks, p, j, cross_kv_split=split,
            pos_cond_value=p + j + 1, packed=packed)
        jlogits, jblocks = jm.decode_step_shared(
            params, jnp.asarray(step_tokens[j]), jcaches, jblocks,
            jnp.asarray(p), jnp.asarray(j), cross_kv_split=jsplit,
            pos_cond_value=p + j + 1, packed=jpacked)
        _close(logits, jlogits)
    sel = [{k: v[::b] for k, v in blk.items()} for blk in blocks]
    jsel = [{k: v[::b] for k, v in blk.items()} for blk in jblocks]
    merged = tm.merge_block_caches(caches, sel, p)
    jmerged = jm.merge_block_caches(jcaches, jsel, jnp.asarray(p))
    for c, jc in zip(merged, jmerged):
        for key in jc:
            if key in ("k", "v") and int8:
                # int8 codes may differ by one where a value sits on a
                # rounding boundary after float32 reordering
                diff = np.abs(c[key].numpy().astype(np.int32)
                              - np.asarray(jc[key]).astype(np.int32))
                assert diff.max() <= 1, key
            else:
                _close(c[key].float(), np.asarray(jc[key], np.float32),
                       atol=1e-3 if int8 else ATOL)


def test_window_forward_matches_jax():
    jm, params, tm = make_pair(seed=4, use_encoder=True, use_pos_cond=True)
    rng = np.random.default_rng(4)
    x_enc = rng.integers(0, 8, (2, 5))
    tokens = rng.integers(0, 16, (2, 7))
    pos = rng.integers(0, 40, (2, 7)).astype(np.float32)
    ckv = tm.make_cross_kv(tm.encode(_t(x_enc)))
    jckv = jm.make_cross_kv(params, jm.encode(params, jnp.asarray(x_enc)))
    for last_only in (False, True):
        got = tm.window_forward(_t(tokens), pos_cond=_t(pos), cross_kv=ckv,
                                last_only=last_only)
        want = jm.window_forward(params, jnp.asarray(tokens),
                                 pos_cond=jnp.asarray(pos), cross_kv=jckv,
                                 last_only=last_only)
        _close(got, want)


@pytest.mark.parametrize("t", [1, 3, 6])
def test_window_forward_shared_matches_jax(t):
    jm, params, tm = make_pair(seed=5, use_encoder=True, use_pos_cond=True)
    rng = np.random.default_rng(5 + t)
    n, b, window = 2, 3, 8
    s0 = (window - 1) - t
    x_enc = rng.integers(0, 8, (n, 5))
    sh_tok = rng.integers(0, 16, (n, s0))
    blk_tok = rng.integers(0, 16, (n * b, t))
    sh_pos = rng.integers(0, 20, (n, s0)).astype(np.float32)
    blk_pos = rng.integers(0, 20, (n * b, t)).astype(np.float32)
    ckv = tm.make_cross_kv(tm.encode(_t(x_enc)))
    jckv = jm.make_cross_kv(params, jm.encode(params, jnp.asarray(x_enc)))
    got = tm.window_forward_shared(_t(sh_tok), _t(blk_tok),
                                   shared_pos_cond=_t(sh_pos),
                                   block_pos_cond=_t(blk_pos), cross_kv=ckv)
    want = jm.window_forward_shared(
        params, jnp.asarray(sh_tok), jnp.asarray(blk_tok),
        shared_pos_cond=jnp.asarray(sh_pos),
        block_pos_cond=jnp.asarray(blk_pos), cross_kv=jckv)
    _close(got, want)


def test_codebook_lookup_is_exact():
    from qaig_tpu.models.codebook import Codebook as JaxCodebook
    from qaig_tpu_torch.convert import load_jax_state
    from qaig_tpu_torch.models.codebook import Codebook

    kw = dict(patch_dim=(2, 4), image_dim=(8, 8), image_channel=3,
              num_embeddings=10)
    jcb = JaxCodebook(**kw)
    params = jcb.init(jax.random.PRNGKey(0))
    cb = Codebook(**kw).requires_grad_(False)
    load_jax_state(cb, {"codebook": np.asarray(params["codebook"])},
                   logging=_no_skips)
    idx = np.random.default_rng(6).integers(0, 10, (2, cb.seq_len))
    assert cb.seq_len == jcb.seq_len == 8
    np.testing.assert_array_equal(
        cb.get_quantized_image(_t(idx)).numpy(),
        np.asarray(jcb.get_quantized_image(params, jnp.asarray(idx))))


def test_fc_decoder_matches_jax():
    from qaig_tpu.models.conv_nets import ConvNetConfig as JaxConvNetConfig
    from qaig_tpu.models.conv_nets import FCDecoder as JaxFCDecoder
    from qaig_tpu_torch.convert import load_jax_state
    from qaig_tpu_torch.models.conv_nets import ConvNetConfig, FCDecoder

    kw = dict(num_layers=2, image_channel=3, min_channel=8, max_channel=16,
              latent_channel=2)
    jdec = JaxFCDecoder(JaxConvNetConfig(**kw))
    params = random_params(jdec.init, 7)
    dec = FCDecoder(ConvNetConfig(**kw)).requires_grad_(False)
    load_jax_state(dec, jax.tree_util.tree_map(np.asarray, params),
                   logging=_no_skips)
    z = np.random.default_rng(7).standard_normal((2, 2, 4, 4)).astype(
        np.float32)
    got = dec(_t(z))
    assert got.shape == (2, 3, 16, 16)
    _close(got, jdec.apply(params, jnp.asarray(z)))
