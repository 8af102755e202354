"""Parity of the PyTorch port's ops (``qaig_tpu_torch.ops``) with
``qaig_tpu``'s, on the CPU in float32.

Both packages get the same numpy inputs.  Where the JAX function reaches a
Pallas kernel it runs in the Pallas interpreter, as ``qaig_tpu``'s own
tests run it on the CPU; the port's CPU path is its kernels' plain version.
Tolerance: atol 1e-5 (float32, reduction order differs), bit-exact for
the int8 quantizer and the pure index ops.
"""

import math

import numpy as np
import pytest
import jax.numpy as jnp
import torch

ATOL = 1e-5


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


def _decode_inputs(n=2, b=4, h=8, s=256, dh=64, bw=8, seed=0):
    rng = np.random.default_rng(seed)

    def mk(shape):
        return (rng.standard_normal(shape) * 0.5).astype(np.float32)
    return (mk((n * b, 1, h * dh)), mk((n, h, dh, s)), mk((n, h, dh, s)),
            mk((n * b, h, bw, dh)), mk((n * b, h, bw, dh)))


@pytest.mark.parametrize("bw,index0,block_index",
                         [(8, 200, 5), (8, 1, 0), (8, 256, 7), (7, 200, 6),
                          (7, 1, 3)])
def test_shared_prefix_attention_matches_jax(bw, index0, block_index):
    """Plain port vs the JAX Pallas kernel (interpreted) and the JAX einsum
    path; bw=7 is a crossing segment's width."""
    from qaig_tpu.ops.attention import shared_prefix_attention as jax_einsum
    from qaig_tpu.ops.decode_attention import shared_prefix_attention_fused_t
    from qaig_tpu_torch.ops.attention import shared_prefix_attention

    q, kt, vt, kb, vb = _decode_inputs(bw=bw)
    got = shared_prefix_attention(_t(q), _t(kt), _t(vt), _t(kb), _t(vb),
                                  index0, block_index).numpy()
    want_kernel = shared_prefix_attention_fused_t(
        _j(q), _j(kt), _j(vt), _j(kb), _j(vb), jnp.asarray(index0),
        jnp.asarray(block_index), interpret=None)
    want_einsum = jax_einsum(_j(q), _j(kt), _j(vt), _j(kb), _j(vb),
                             jnp.asarray(index0), jnp.asarray(block_index))
    assert got.shape == (8, 1, 512)
    np.testing.assert_allclose(got, np.asarray(want_kernel), atol=ATOL)
    np.testing.assert_allclose(got, np.asarray(want_einsum), atol=ATOL)


def _split_combine(q, kt, vt, kb, vb, index0, block_index, plan, chunk,
                   k_scale=None, v_scale=None):
    """Kernel B's arithmetic in plain PyTorch: each rank's partial softmax
    (base-2 max, sum and B x dh accumulator) over its slot range of
    ``plan`` and its segment chunks (``chunk`` slots each, dealt to the
    ranks in turn), combined in rank order by the kernel's rule (weights
    2^(m_r - M), a rank at -inf weighing 0).  With ``k_scale`` /
    ``v_scale`` (N, H, S), kernel C's: the K scales multiply the prefix
    scores, the V scales the probabilities of the P V product (the sum
    takes the unscaled ones)."""
    n, h, dh, _ = kt.shape
    b = q.shape[0] // n
    splits = len(plan["ranges"])
    c = math.log2(math.e) / math.sqrt(dh)
    qg = q.reshape(n, b, h, dh)
    kseg = kb[:, :, :block_index + 1].reshape(n, b, h, -1, dh)
    vseg = vb[:, :, :block_index + 1].reshape(n, b, h, -1, dh)
    slots = torch.arange(block_index + 1)
    ms, ls, accs = [], [], []
    ones = torch.ones(n, h, kt.shape[-1])
    ks = ones if k_scale is None else k_scale.float()
    vs = ones if v_scale is None else v_scale.float()
    for r, (lo, hi) in enumerate(plan["ranges"]):
        mine = (slots // chunk) % splits == r
        scores = torch.cat([
            torch.einsum("nbhd,nhds->nbhs", qg, kt[..., lo:hi])
            * ks[:, None, :, lo:hi],
            torch.einsum("nbhd,nbhtd->nbht", qg, kseg[:, :, :, mine])],
            dim=-1) * c
        vals = torch.cat([
            vt[..., lo:hi].permute(0, 1, 3, 2)[:, None].expand(
                n, b, h, hi - lo, dh), vseg[:, :, :, mine]], dim=3)
        vscale = torch.cat([vs[:, None, :, lo:hi].expand(n, b, h, hi - lo),
                            torch.ones(n, b, h, int(mine.sum()))], dim=-1)
        m = scores.amax(-1, keepdim=True)
        p = torch.exp2(scores - m)
        ms.append(m)
        ls.append(p.sum(-1, keepdim=True))
        accs.append(torch.einsum("nbhs,nbhsd->nbhd", p * vscale, vals))
    top = torch.stack(ms).amax(0)
    total, out = 0.0, 0.0
    for m, l, acc in zip(ms, ls, accs):
        w = torch.where(m == float("-inf"), torch.zeros_like(m),
                        torch.exp2(m - top))
        total = total + l * w
        out = out + acc * w
    return (out / total).reshape(q.shape)


@pytest.mark.parametrize("bw,index0,block_index,chunk,splits",
                         [(8, 200, 5, 16, None), (8, 256, 7, 16, None),
                          (7, 64, 3, 16, None), (8, 1, 0, 16, None),
                          (8, 200, 7, 2, 2), (7, 64, 6, 1, 1),
                          (8, 256, 7, 1, 2)])
def test_decode_split_combine_matches_jax(bw, index0, block_index, chunk,
                                          splits):
    """Kernel B's split of the prefix into its plan's slot ranges (or a
    forced 1 or 2) and of the segment into chunks
    dealt to the ranks in turn (16 slots: the plan's at 4 rollouts of dh
    64; 2 and 1: every rank gets some), and the rank-order combine, in
    plain PyTorch, against the JAX Pallas kernel (interpreted): the same
    function as one softmax over all slots."""
    from qaig_tpu.ops.decode_attention import shared_prefix_attention_fused_t
    from qaig_tpu_torch.ops.decode_attention import _plan, segment_chunk

    q, kt, vt, kb, vb = _decode_inputs(bw=bw, seed=index0 + chunk)
    plan = _plan(2, 4, 8, 64, index0, 132, 4, block_index, splits or 0)
    assert plan["splits"] == (splits or {1: 1, 64: 2, 200: 2, 256: 2}[index0])
    assert segment_chunk(4, 64, 4) == 16
    got = _split_combine(_t(q), _t(kt), _t(vt), _t(kb), _t(vb), index0,
                         block_index, plan, chunk).numpy()
    want = shared_prefix_attention_fused_t(
        _j(q), _j(kt), _j(vt), _j(kb), _j(vb), jnp.asarray(index0),
        jnp.asarray(block_index), interpret=None)
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("n", [8, 16])
@pytest.mark.parametrize("b", [4, 32])
@pytest.mark.parametrize("index0", [1, 7, 64, 200, 256])
def test_decode_launch_plan(n, b, index0):
    """Kernel B's split on the H100 (132 SMs): contiguous slot ranges in
    rank order covering [0, index0) once, none empty, each starting on a
    16-byte chunk; 1 or 2 CTAs a cluster (at most the measured best,
    ``SPLIT_MAX``), one at index0 1, and at least one CTA an SM
    wherever the prefix gives each 32 slots and the cap allows; every CTA
    in one wave; the ring (at most two slots) and shared memory within a
    block's 227 KB."""
    from qaig_tpu_torch.ops.decode_attention import (SPLIT_MAX,
                                                     SPLIT_MAX_STAGES,
                                                     launch_plan, split_smem)

    heads, dh = 8, 64
    for itemsize in (2, 4):
        plan = launch_plan(n, b, heads, dh, index0, 132, itemsize)
        splits, ranges = plan["splits"], plan["ranges"]
        assert 1 <= splits <= SPLIT_MAX == 2 and len(ranges) == splits
        assert ranges[0][0] == 0 and ranges[-1][1] == index0
        for (lo, hi), (nxt, _) in zip(ranges, ranges[1:] + [(index0, 0)]):
            assert lo < hi == nxt and lo % 8 == 0
            assert lo == ranges.index((lo, hi)) * plan["chunk"]
        if index0 == 1:
            assert splits == 1
        if n * heads * splits < 132:
            assert splits == SPLIT_MAX or index0 < 2 * splits * 32
        assert plan["waves"] == 1
        # the ring: two slots, or one where the busiest rank has one tile
        # (its prefix slots, and on rank 0 the segment's one chunk)
        busiest = max(-(-(hi - lo) // 64) + (r == 0)
                      for r, (lo, hi) in enumerate(ranges))
        assert plan["stages"] == min(SPLIT_MAX_STAGES, busiest) <= 2
        assert plan["smem"] == split_smem(b, dh, itemsize, plan["stages"])
        assert plan["smem"] <= 227 * 1024
        assert plan["ctas"] == n * heads * splits


@pytest.mark.parametrize("n", [8, 16])
@pytest.mark.parametrize("b", [4, 32])
@pytest.mark.parametrize("index0", [1, 7, 64, 200, 256])
def test_decode_launch_plan_int8_prefix(n, b, index0):
    """Kernel C's split (kernel B's kernel over an int8 prefix) on the
    H100: the same properties as kernel B's (ranges of 8-slot multiples:
    the kernel reads a range that starts mid-chunk from the chunk's start
    and masks the slots before it), one wave counted at C's own shared
    memory, and the byte-counted ring equal to a hand count."""
    from qaig_tpu_torch.ops.decode_attention import (SPLIT_MAX, launch_plan,
                                                     segment_chunk,
                                                     split_smem)

    heads, dh = 8, 64
    for itemsize in (2, 4):
        plan = launch_plan(n, b, heads, dh, index0, 132, itemsize, 0, 1)
        splits, ranges = plan["splits"], plan["ranges"]
        assert 1 <= splits <= SPLIT_MAX and len(ranges) == splits
        assert ranges[0][0] == 0 and ranges[-1][1] == index0
        for (lo, hi), (nxt, _) in zip(ranges, ranges[1:] + [(index0, 0)]):
            assert lo < hi == nxt and lo % 8 == 0
        if index0 == 1:
            assert splits == 1
        assert plan["waves"] == 1
        assert plan["smem"] == split_smem(b, dh, itemsize, plan["stages"], 1)
        assert plan["smem"] <= 227 * 1024
        assert segment_chunk(b, dh, itemsize, 1) >= 1
    # the hand count at dh 64, bf16 q, two ring slots: floats (q, acc,
    # score strips of `parts` x B4 x 64, m / l / alpha), then per slot a K
    # and a V part of max(64 rows x (64 + 16) bytes + 64 bf16 scales,
    # B rows x (64 x 2 + 16) bytes)
    parts = {4: 8, 32: 1}[b]
    floats = 64 * b + b * 64 + parts * b * 64 + 3 * b
    part = max(64 * (64 + 16) + 2 * 64, b * (64 * 2 + 16))
    assert split_smem(b, 64, 2, 2, 1) == floats * 4 + 2 * 2 * part
    assert split_smem(b, 64, 2, 2) == floats * 4 + 2 * 2 * max(
        64 * (64 * 2 + 16), b * (64 * 2 + 16))


@pytest.mark.parametrize("bw,index0,block_index,chunk,splits",
                         [(8, 200, 5, None, None), (8, 256, 7, None, None),
                          (8, 1, 0, None, None), (7, 64, 6, 1, 2),
                          (8, 48, 7, 3, 2)])
def test_int8_split_combine_matches_jax(bw, index0, block_index, chunk,
                                        splits):
    """Kernel C as kernel B's kernel over an int8 prefix: its plan's (or a
    forced) split into 8-slot ranges, the segment dealt to the
    ranks in chunks (the plan's, or 1 and 3: every rank gets some), the
    scales folded in, and the rank-order combine, in plain PyTorch,
    against the JAX int8 Pallas kernel (interpreted)."""
    from qaig_tpu.ops.decode_attention import (
        shared_prefix_attention_fused_int8 as jax_int8)
    from qaig_tpu.ops.kv_quant import quantize_kv_t as jax_quantize
    from qaig_tpu_torch.ops.decode_attention import _plan, segment_chunk
    from qaig_tpu_torch.ops.kv_quant import quantize_kv_t

    q, kt, vt, kb, vb = _decode_inputs(bw=bw, seed=index0 + 3)
    plan = _plan(2, 4, 8, 64, index0, 132, 4, block_index, splits or 0, 1)
    assert plan["splits"] == (splits or {1: 1, 200: 2, 256: 2}[index0])
    assert all(lo % 8 == 0 for lo, _ in plan["ranges"])
    k8, ks = quantize_kv_t(_t(kt))
    v8, vs = quantize_kv_t(_t(vt))
    got = _split_combine(_t(q), k8.float(), v8.float(), _t(kb), _t(vb),
                         index0, block_index, plan,
                         chunk or segment_chunk(4, 64, 4, 1), ks, vs).numpy()
    jk8, jks = jax_quantize(_j(kt))
    jv8, jvs = jax_quantize(_j(vt))
    want = jax_int8(_j(q), jk8, jks, jv8, jvs, _j(kb), _j(vb),
                    jnp.asarray(index0), jnp.asarray(block_index),
                    interpret=None)
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL)


def _flat_split_combine(q, k_il, v_il, kb, vb, index0, block_index, heads,
                        plan, chunk, k_scale=None, v_scale=None):
    """The flat kernel's arithmetic in plain PyTorch (float32, where its
    roundings to the working dtype are exact): q pre-scaled by 1/sqrt(dh);
    each rank's partial softmax (natural-base max, sum and (H x B) x dh
    accumulator) over all heads of its slot range of ``plan`` and its
    segment chunks (``chunk`` slots of every (rollout, head), dealt to the
    ranks in turn); the K scales on the prefix scores, the V scales on its
    probabilities; combined in rank order (weights e^(m_r - M), a rank
    with no slot weighing 0)."""
    nb, _, d = q.shape
    n, dh, sh = k_il.shape
    h, b, s = heads, nb // n, sh // heads
    splits = len(plan["ranges"])
    q4 = (q.reshape(n, b, h, dh) / math.sqrt(dh)).transpose(1, 2)
    k = k_il.float().reshape(n, dh, s, h)
    v = v_il.float().reshape(n, dh, s, h)
    ones = torch.ones(n, s, h)
    ks = ones if k_scale is None else k_scale.float().reshape(n, s, h)
    vs = ones if v_scale is None else v_scale.float().reshape(n, s, h)
    kseg = kb.reshape(n, b, h, -1, dh).transpose(1, 2)[:, :, :, :block_index
                                                        + 1]
    vseg = vb.reshape(n, b, h, -1, dh).transpose(1, 2)[:, :, :, :block_index
                                                        + 1]
    slots = torch.arange(block_index + 1)
    ms, ls, accs = [], [], []
    for r, (lo, hi) in enumerate(plan["ranges"]):
        mine = (slots // chunk) % splits == r
        sc_s = torch.einsum("nhbd,ndsh->nhbs", q4, k[:, :, lo:hi]) * \
            ks[:, lo:hi].transpose(1, 2)[:, :, None]
        sc_b = torch.einsum("nhbd,nhbtd->nhbt", q4, kseg[:, :, :, mine])
        scores = torch.cat([sc_s, sc_b], dim=-1)
        if scores.shape[-1] == 0:
            continue
        m = scores.amax(-1, keepdim=True)
        p = torch.exp(scores - m)
        p_s = p[..., :hi - lo] * vs[:, lo:hi].transpose(1, 2)[:, :, None]
        ms.append(m)
        ls.append(p.sum(-1, keepdim=True))
        accs.append(torch.einsum("nhbs,ndsh->nhbd", p_s, v[:, :, lo:hi])
                    + torch.einsum("nhbt,nhbtd->nhbd", p[..., hi - lo:],
                                   vseg[:, :, :, mine]))
    top = torch.stack(ms).amax(0)
    total, out = 0.0, 0.0
    for m, l, acc in zip(ms, ls, accs):
        w = torch.exp(m - top)
        total = total + l * w
        out = out + acc * w
    return (out / total).transpose(1, 2).reshape(nb, 1, d)


@pytest.mark.parametrize("quant", [False, True], ids=["t", "int8"])
@pytest.mark.parametrize("index0,block_index,splits,chunk",
                         [(256, 7, 0, None), (200, 5, 0, None),
                          (1, 0, 0, None), (96, 3, 5, 2), (64, 7, 8, 1)])
def test_flat_split_combine_matches_jax(quant, index0, block_index, splits,
                                        chunk):
    """The flat kernel's split of each image's prefix into the slot ranges
    of its plan (8 CTAs an image at N8) or a forced 5 or 8, the segment's
    chunks (the plan's, or 1 and 2 slots: every rank gets some) dealt to
    the ranks, and the rank-order combine, in plain PyTorch, against the
    JAX flat Pallas kernel (interpreted), with and without int8 scales."""
    from qaig_tpu.ops import decode_attention as jda
    from qaig_tpu.ops.kv_quant import quantize_kv_t as jax_quantize
    from qaig_tpu_torch.ops import decode_attention as da
    from qaig_tpu_torch.ops.kv_quant import quantize_kv_t

    q, kt, vt, kb, vb = _decode_inputs(n=8, seed=index0 + splits)
    itemsize = 1 if quant else 4
    plan = da._flat_plan(8, 4, 8, 64, index0, 132, itemsize, block_index, 4,
                         splits)
    assert plan["splits"] == (splits or (1 if index0 == 1 else 8))
    assert plan["ranges"][-1][1] == index0
    if quant:
        (k8, ks), (v8, vs) = quantize_kv_t(_t(kt)), quantize_kv_t(_t(vt))
        k_il, v_il = da.interleave_t(k8), da.interleave_t(v8)
        scales = (da.interleave_scale(ks), da.interleave_scale(vs))
        (jk8, jks), (jv8, jvs) = jax_quantize(_j(kt)), jax_quantize(_j(vt))
        jax_args = (jda.interleave_t(jk8), jda.interleave_t(jv8))
        jax_kw = {"k_scale": jda.interleave_scale(jks),
                  "v_scale": jda.interleave_scale(jvs)}
    else:
        k_il, v_il = da.interleave_t(_t(kt)), da.interleave_t(_t(vt))
        scales = (None, None)
        jax_args = (_j(k_il), _j(v_il))
        jax_kw = {}
    got = _flat_split_combine(_t(q), k_il, v_il, _t(kb), _t(vb), index0,
                              block_index, 8, plan,
                              chunk or plan["segment_chunk"],
                              *scales).numpy()
    want = jda.shared_prefix_attention_fused_flat(
        _j(q), *jax_args, _j(kb), _j(vb), jnp.asarray(index0),
        jnp.asarray(block_index), heads=8, interpret=True, **jax_kw)
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("n", [8, 16])
@pytest.mark.parametrize("b", [4, 8])
@pytest.mark.parametrize("index0", [1, 7, 64, 200, 256])
@pytest.mark.parametrize("itemsize", [1, 2, 4])
def test_flat_launch_plan(n, b, index0, itemsize):
    """The flat kernel's plan on the H100 (132 SMs), 8 heads of dim 64:
    slot ranges in rank order covering [0, index0) once, none empty, each
    starting on a 16-byte chunk of its interleaved rows; one cluster of at
    most 8 CTAs an image, as many as the prefix has chunks for and the
    card holds in one wave (clusters fill 120 of its SMs); an even tile of
    at most 64 slots, the ring within a block's 227 KB, and the shared
    memory the sum of its parts."""
    from qaig_tpu_torch.ops import decode_attention as da

    heads, dh = 8, 64
    plan = da.flat_launch_plan(n, b, heads, dh, index0, 132, itemsize, 7)
    splits, ranges = plan["splits"], plan["ranges"]
    assert 1 <= splits <= da.FLAT_MAX_SPLITS == 8
    assert plan["rollouts"] == b and plan["groups"] == 1
    assert len(ranges) == splits and plan["ctas"] == n * splits
    assert ranges[0][0] == 0 and ranges[-1][1] == index0
    for (lo, hi), (nxt, _) in zip(ranges, ranges[1:] + [(index0, 0)]):
        assert lo < hi == nxt and lo * heads * itemsize % 16 == 0
    fit = 8
    while n * fit > 120:
        fit //= 2
    chunk_slots = 16 // math.gcd(16, heads * itemsize)
    assert splits <= fit
    assert splits >= min(fit, -(-index0 // chunk_slots)) // 2
    assert plan["waves"] == 1
    tile = plan["tile"]
    assert tile % 2 == 0 and 2 <= tile <= da.FLAT_MAX_TILE
    assert tile * heads * itemsize % 16 == 0
    assert plan["stages"] in (1, 2) and plan["smem"] <= 227 * 1024
    q_itemsize = 2 if itemsize == 1 else itemsize
    assert plan["smem"] == da.flat_smem(b, heads, dh, tile, q_itemsize,
                                        itemsize, plan["stages"])
    assert 1 <= plan["segment_chunk"] == da.flat_segment_chunk(
        b, heads, dh, tile, q_itemsize, itemsize) <= tile


def test_quantize_kv_t_bit_exact():
    from qaig_tpu.ops.kv_quant import quantize_kv_t as jax_quantize
    from qaig_tpu_torch.ops.kv_quant import dequantize_kv_t, quantize_kv_t

    _, kt, _, _, _ = _decode_inputs()
    q8, scale = quantize_kv_t(_t(kt))
    jq8, jscale = jax_quantize(_j(kt))
    assert q8.dtype == torch.int8 and scale.dtype == torch.bfloat16
    np.testing.assert_array_equal(q8.numpy(), np.asarray(jq8))
    np.testing.assert_array_equal(scale.float().numpy(),
                                  np.asarray(jscale, np.float32))
    back = dequantize_kv_t(q8, scale, torch.float32).numpy()
    np.testing.assert_allclose(back, kt, atol=float(np.abs(kt).max()) / 127
                               * 1.01)


@pytest.mark.parametrize("index0,block_index", [(200, 5), (256, 7)])
def test_int8_prefix_attention_matches_jax(index0, block_index):
    from qaig_tpu.ops.decode_attention import (
        shared_prefix_attention_fused_int8 as jax_int8)
    from qaig_tpu.ops.kv_quant import quantize_kv_t as jax_quantize
    from qaig_tpu_torch.ops.decode_attention import (
        shared_prefix_attention_fused_int8)
    from qaig_tpu_torch.ops.kv_quant import quantize_kv_t

    q, kt, vt, kb, vb = _decode_inputs(seed=1)
    k8, ks = quantize_kv_t(_t(kt))
    v8, vs = quantize_kv_t(_t(vt))
    got = shared_prefix_attention_fused_int8(
        _t(q), k8, ks, v8, vs, _t(kb), _t(vb), index0, block_index).numpy()
    jk8, jks = jax_quantize(_j(kt))
    jv8, jvs = jax_quantize(_j(vt))
    want = jax_int8(_j(q), jk8, jks, jv8, jvs, _j(kb), _j(vb),
                    jnp.asarray(index0), jnp.asarray(block_index),
                    interpret=None)
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("index0,block_index", [(200, 5), (1, 0), (256, 7)])
def test_flat_attention_matches_jax(index0, block_index):
    """The flat kernel's plain version against the JAX flat Pallas kernel
    (interpreted) at N8 B4 H8 dh64 S256 bw8, and against the slot-minor
    plain version (the same function)."""
    from qaig_tpu.ops import decode_attention as jda
    from qaig_tpu_torch.ops import attention as ta
    from qaig_tpu_torch.ops import decode_attention as da

    q, kt, vt, kb, vb = _decode_inputs(n=8)
    k_il, v_il = da.interleave_t(_t(kt)), da.interleave_t(_t(vt))
    got = da.shared_prefix_attention_fused_flat(
        _t(q), k_il, v_il, _t(kb), _t(vb), index0, block_index, 8).numpy()
    want = jda.shared_prefix_attention_fused_flat(
        _j(q), _j(k_il), _j(v_il), _j(kb), _j(vb), jnp.asarray(index0),
        jnp.asarray(block_index), heads=8, interpret=True)
    assert got.shape == (32, 1, 512)
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL)
    np.testing.assert_allclose(
        got, da.shared_prefix_attention_reference(
            _t(q), _t(kt), _t(vt), _t(kb), _t(vb), index0,
            block_index).numpy(), atol=ATOL)
    # a 3-D prefix routes to the flat kernel
    np.testing.assert_array_equal(ta.shared_prefix_attention(
        _t(q), k_il, v_il, _t(kb), _t(vb), index0, block_index).numpy(),
        got)


def test_flat_int8_attention_matches_jax():
    from qaig_tpu.ops import decode_attention as jda
    from qaig_tpu.ops.kv_quant import quantize_kv_t as jax_quantize
    from qaig_tpu_torch.ops import decode_attention as da
    from qaig_tpu_torch.ops.kv_quant import quantize_kv_t

    q, kt, vt, kb, vb = _decode_inputs(n=8, seed=1)
    (k8, ks), (v8, vs) = quantize_kv_t(_t(kt)), quantize_kv_t(_t(vt))
    got = da.shared_prefix_attention_fused_flat(
        _t(q), da.interleave_t(k8), da.interleave_t(v8), _t(kb), _t(vb),
        200, 5, 8, k_scale=da.interleave_scale(ks),
        v_scale=da.interleave_scale(vs)).numpy()
    (jk8, jks), (jv8, jvs) = jax_quantize(_j(kt)), jax_quantize(_j(vt))
    want = jda.shared_prefix_attention_fused_flat(
        _j(q), jda.interleave_t(jk8), jda.interleave_t(jv8), _j(kb), _j(vb),
        jnp.asarray(200), jnp.asarray(5), heads=8,
        k_scale=jda.interleave_scale(jks), v_scale=jda.interleave_scale(jvs),
        interpret=True)
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL)


def test_interleave_and_flat_routing_rule_match_jax():
    from qaig_tpu.ops import decode_attention as jda
    from qaig_tpu_torch.ops import decode_attention as da

    _, kt, _, _, _ = _decode_inputs(n=2, s=40)
    scale = np.random.default_rng(2).standard_normal((2, 8, 40)).astype(
        np.float32)
    np.testing.assert_array_equal(da.interleave_t(_t(kt)).numpy(),
                                  np.asarray(jda.interleave_t(_j(kt))))
    np.testing.assert_array_equal(da.interleave_scale(_t(scale)).numpy(),
                                  np.asarray(jda.interleave_scale(
                                      _j(scale))))
    for args in ((8, 4, 8), (8, 8, 16), (8, 32, 16), (8, 4, 7), (8, 4, 4),
                 (8, 4, 0)):
        assert da.flat_segment_supported(*args) == \
            jda.flat_segment_supported(*args), args


@pytest.mark.parametrize("s,causal", [(13, True), (16, True), (16, False)])
def test_flash_attention_reference_matches_jax_kernel(s, causal):
    """The plain version against the JAX Pallas kernel in interpret mode
    (which refuses non-causal S off a multiple of 8)."""
    from qaig_tpu.ops.flash_attention import flash_attention as jax_flash
    from qaig_tpu_torch.ops.flash_attention import (flash_attention,
                                                    flash_attention_reference)

    rng = np.random.default_rng(s)
    q, k, v = (rng.standard_normal((2, s, 128)).astype(np.float32)
               for _ in range(3))
    got = flash_attention_reference(_t(q), _t(k), _t(v), 2, causal).numpy()
    want = jax_flash(_j(q), _j(k), _j(v), 2, causal=causal, interpret=True)
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL)
    # the public wrapper takes the plain version for CPU tensors
    np.testing.assert_array_equal(
        flash_attention(_t(q), _t(k), _t(v), 2, causal=causal).numpy(), got)


@pytest.mark.parametrize("case", ["causal", "cross", "kv_mask", "q_offset"])
def test_dot_product_attention_matches_jax(case):
    from qaig_tpu.ops.attention import dot_product_attention as jax_dpa
    from qaig_tpu_torch.ops.attention import dot_product_attention

    rng = np.random.default_rng(3)
    sq = 1 if case == "q_offset" else 6
    sk = 9 if case == "cross" else (6 if case != "q_offset" else 7)
    q = rng.standard_normal((2, sq, 32)).astype(np.float32)
    k, v = (rng.standard_normal((2, sk, 32)).astype(np.float32)
            for _ in range(2))
    kw_t, kw_j = {}, {}
    if case in ("causal", "q_offset"):
        kw_t["causal"] = kw_j["causal"] = True
    if case == "q_offset":
        kw_t["q_offset"], kw_j["q_offset"] = sk - 1, sk - 1
    if case == "kv_mask":
        mask = rng.random((2, sk)) > 0.3
        mask[:, 0] = True
        kw_t["kv_mask"], kw_j["kv_mask"] = _t(mask), _j(mask)
    got = dot_product_attention(_t(q), _t(k), _t(v), 4, **kw_t).numpy()
    want = jax_dpa(_j(q), _j(k), _j(v), 4, **kw_j)
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("heads,dh,kernel", [
    (16, 24, False), (2, 256, True), (4, 192, True), (1, 320, False)])
def test_dot_product_attention_other_head_dims_match_jax(heads, dh, kernel,
                                                         causal,
                                                         monkeypatch):
    """Head dims past the repo's configs match ``qaig_tpu``: in_dim 384 in 16
    heads (24) and 320 in one go to the plain products, as ``qaig_tpu``
    routes 24 to XLA einsums; 512 in 2 heads (256) and 768 in 4 (192) go to
    the flash wrapper, as they go to the Pallas kernel there."""
    from qaig_tpu.ops.attention import dot_product_attention as jax_dpa
    from qaig_tpu_torch.ops import attention, flash_attention as fa

    calls = []
    wrapper = fa.flash_attention

    def recording(*args, **kwargs):
        calls.append(args[3])
        return wrapper(*args, **kwargs)

    monkeypatch.setattr(fa, "flash_attention", recording)
    rng = np.random.default_rng(dh)
    q, k, v = (rng.standard_normal((2, 9, heads * dh)).astype(np.float32)
               for _ in range(3))
    assert fa.supported(_t(q), _t(k), _t(v), heads, causal, None,
                        None) == kernel
    got = attention.dot_product_attention(_t(q), _t(k), _t(v), heads,
                                          causal=causal).numpy()
    assert calls == ([heads] if kernel else [])
    want = jax_dpa(_j(q), _j(k), _j(v), heads, causal=causal)
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("dh", [4, 8, 16, 24, 32, 40, 64, 96, 128, 192, 256,
                                320, 512])
def test_flash_attention_supported_head_dims(dh):
    """The routing rule is the shape alone: the head dims the kernel
    instantiates (8, 16, 32, 64, 128, 192, 256) go to it, any other to the
    plain products; key masks, query offsets and unequal shapes never do."""
    from qaig_tpu_torch.ops import flash_attention as fa

    x = torch.zeros(2, 5, 3 * dh)
    assert fa.supported(x, x, x, 3, True, None, None) == (
        dh in (8, 16, 32, 64, 128, 192, 256))
    assert fa.supported(x, x, x, 3, False, None, None) == (
        dh in fa.HEAD_DIMS)
    assert not fa.supported(x, x, x, 3, True, torch.ones(2, 5, dtype=bool),
                            None)
    assert not fa.supported(x, x, x, 3, True, None, 4)
    assert not fa.supported(x, x[:, :4], x[:, :4], 3, False, None, None)


def test_shared_cross_and_block_and_presplit_attention_match_jax():
    from qaig_tpu.ops import attention as ja
    from qaig_tpu_torch.ops import attention as ta

    rng = np.random.default_rng(4)

    def mk(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    n, b, h, dh = 2, 3, 4, 8
    q = mk(n * b, 2, h * dh)
    ks, vs = mk(n, h, dh, 5), mk(n, h, dh, 5)
    np.testing.assert_allclose(
        ta.shared_cross_attention(_t(q), _t(ks), _t(vs)).numpy(),
        np.asarray(ja.shared_cross_attention(_j(q), _j(ks), _j(vs))),
        atol=ATOL)

    k_sh, v_sh = mk(n, h, 5, dh), mk(n, h, 5, dh)
    k_bl, v_bl = mk(n * b, h, 3, dh), mk(n * b, h, 3, dh)
    np.testing.assert_allclose(
        ta.shared_prefix_block_attention(
            _t(q), _t(k_sh), _t(v_sh), _t(k_bl), _t(v_bl)).numpy(),
        np.asarray(ja.shared_prefix_block_attention(
            _j(q), _j(k_sh), _j(v_sh), _j(k_bl), _j(v_bl))), atol=ATOL)

    q1 = mk(n, 1, h * dh)
    mask = np.arange(5)[None, :] <= np.array([[2], [4]])
    np.testing.assert_allclose(
        ta.decode_attention_presplit(_t(q1), _t(ks), _t(vs),
                                     _t(mask)).numpy(),
        np.asarray(ja.decode_attention_presplit(_j(q1), _j(ks), _j(vs),
                                                _j(mask))), atol=ATOL)


def test_patch_posemb_activations_match_jax():
    from qaig_tpu.ops.activations import get_activation as jax_act
    from qaig_tpu.ops.patch import patchify as jax_patchify
    from qaig_tpu.ops.posemb import sinusoidal_pos_emb as jax_pos
    from qaig_tpu_torch.ops.activations import get_activation
    from qaig_tpu_torch.ops.patch import patchify, unpatchify
    from qaig_tpu_torch.ops.posemb import sinusoidal_pos_emb

    rng = np.random.default_rng(5)
    img = rng.standard_normal((2, 4, 8, 8)).astype(np.float32)
    patches = patchify(_t(img), (2, 4))
    np.testing.assert_array_equal(patches.numpy(),
                                  np.asarray(jax_patchify(_j(img), (2, 4))))
    np.testing.assert_array_equal(
        unpatchify(patches, (8, 8), (2, 4)).numpy(), img)

    # float32 sin/cos of angles up to 300 rad differ by a few ulp of the
    # angle between the two libraries: atol 5e-5
    pos = np.array([[0.0, 1.0, 7.0, 300.0]], np.float32)
    np.testing.assert_allclose(sinusoidal_pos_emb(64, _t(pos)).numpy(),
                               np.asarray(jax_pos(64, _j(pos))), atol=5e-5)

    x = rng.standard_normal(50).astype(np.float32)
    for name in ("silu", "tanh", "sigmoid"):
        np.testing.assert_allclose(get_activation(name)(_t(x)).numpy(),
                                   np.asarray(jax_act(name)(_j(x))),
                                   atol=1e-6)
    with pytest.raises(KeyError):
        get_activation("relu")


def test_non_cpu_tensors_never_take_the_plain_version():
    """Only a CPU tensor runs the plain version: any other device goes to
    the kernel wrapper, which refuses what it cannot launch."""
    from qaig_tpu_torch.ops.bmu import bmu_argmin, fused_bmu
    from qaig_tpu_torch.ops.decode_attention import (
        shared_prefix_attention_fused_flat, shared_prefix_attention_fused_t)
    from qaig_tpu_torch.ops.flash_attention import flash_attention

    before = (flash_attention.launches,
              shared_prefix_attention_fused_t.launches, fused_bmu.launches)
    p = torch.empty(16, 16, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        bmu_argmin(p, p)
    x = torch.empty(2, 4, 128, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        flash_attention(x, x, x, 2)
    q = torch.empty(8, 1, 512, device="meta")
    kt = torch.empty(2, 8, 64, 32, device="meta")
    kb = torch.empty(8, 8, 8, 64, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        shared_prefix_attention_fused_t(q, kt, kt, kb, kb, 1, 0)
    flat = shared_prefix_attention_fused_flat
    flat_before = (flat.launches, flat.int8_launches)
    k_il = torch.empty(2, 64, 32 * 8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        flat(q, k_il, k_il, kb, kb, 1, 0, 8)
    assert (flash_attention.launches,
            shared_prefix_attention_fused_t.launches,
            fused_bmu.launches) == before
    assert (flat.launches, flat.int8_launches) == flat_before


def test_non_cpu_tensors_take_the_backward_kernel():
    """The gradient of a non-CPU attention goes to the backward kernel's
    wrapper (counted as a CUDA backward pass), which refuses what it cannot
    launch; the plain products run for CPU tensors only."""
    from qaig_tpu_torch.ops import flash_attention as fa

    x = torch.empty(2, 4, 128, device="meta")
    calls = fa.flash_attention.backward_calls
    launches = fa.fused_flash_attention_backward.launches
    with pytest.raises(ValueError, match="unsupported device"):
        fa._FlashAttention.backward(
            type("Ctx", (), {"saved_tensors": (x, x, x, x), "heads": 2,
                             "causal": True})(), x)
    with pytest.raises(ValueError, match="unsupported device"):
        fa.fused_flash_attention_backward(x, x, x, x, x, 2, False)
    assert fa.flash_attention.backward_calls == calls + 1
    assert fa.fused_flash_attention_backward.launches == launches


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("dh", [8, 16, 32, 64, 128, 192, 256])
def test_backward_launch_plan(dtype, dh):
    """The backward kernel's form and geometry by head dim, at in_dim 512
    (768 and 1024 past dh 128) in 8 rows of S 255 on the H100's 132 SMs:
    float32 keeps a row in registers at dh 8 and 16 and takes
    register-blocked FMAs (16 x 16 threads of 4-row micro-tiles over 64
    fixed rows, 32-row streamed tiles at dh 192 and 256) from dh 32, its
    streamed rows split over
    clusters of 2 CTAs where a pass has fewer blocks than SMs; bf16 runs
    on mma.sync (dh 8:
    8 warps of 16 rows).  A split covers dh once, the rows split evenly
    over the threads, the shared memory fits a block."""
    from qaig_tpu_torch.ops.flash_attention import (F32_BACKWARD_GEOMETRY,
                                                    _backward_plan,
                                                    backward_launch_plan)

    n, s = 8, 255
    heads = {192: 4, 256: 4}.get(dh, 512 // dh)
    plan = backward_launch_plan(torch.float32 if dtype == "f32"
                                else torch.bfloat16, dh, s, heads, n)
    want = {("f32", 8): ("f32_rows", 128, 1, 1, 1),
            ("f32", 16): ("f32_rows", 128, 1, 1, 1),
            ("f32", 32): ("f32_fma", 64, 1, 1, 1),
            ("f32", 64): ("f32_fma", 64, 1, 2, 1),
            ("f32", 128): ("f32_fma", 64, 1, 2, 2),
            ("f32", 192): ("f32_fma", 32, 1, 2, 2),
            ("f32", 256): ("f32_fma", 32, 1, 1, 2),
            ("bf16", 8): ("bf16_mma_dh8", 256, 1, 1, 1),
            ("bf16", 16): ("bf16_mma", 64, 1, 4, 1),
            ("bf16", 32): ("bf16_mma", 64, 1, 4, 1),
            ("bf16", 64): ("bf16_mma", 64, 1, 4, 1),
            ("bf16", 128): ("bf16_mma", 64, 2, 2, 1),
            ("bf16", 192): ("bf16_mma", 32, 2, 2, 1),
            ("bf16", 256): ("bf16_mma", 32, 2, 2, 1)}[dtype, dh]
    assert (plan["form"], plan["tile"], plan["split"], plan["stages"],
            plan["cluster"]) == want
    assert dh % plan["split"] == 0
    part = dh // plan["split"]
    tiles = -(-s // plan["rows"])
    if plan["form"] == "f32_fma":
        # 16 threads a row of the block, 4 rows each; 16 lanes share a
        # part's columns in float2 or float4 groups
        assert (plan["threads"], plan["rows"]) == (256, 64)
        assert plan["rows"] == 16 * 4 and (part // 16) % 2 == 0
        assert plan["tile"] % 16 == 0
        assert (plan["cluster"] == 2) == (n * heads * tiles < 132)
        assert (plan["tile"], plan["stages"]) == F32_BACKWARD_GEOMETRY[dh]
        assert _backward_plan(torch.float32, dh, s, heads, n, 132,
                              1)["cluster"] == 1
    elif plan["form"] == "f32_rows":
        # dh / 8 lanes a row, every lane of the block on one row
        assert plan["rows"] * (dh // 8) == plan["threads"] == 128
    else:
        assert plan["rows"] // (plan["threads"] // 32) == 16
    z = plan["split"] if plan["form"] == "bf16_mma" else 1
    assert plan["grid"] == (n * heads * plan["cluster"], tiles, z)
    assert max(plan["smem1"], plan["smem2"]) <= 227 * 1024
    with pytest.raises(ValueError):
        backward_launch_plan(torch.float32, 24, s, heads, n)


@pytest.mark.parametrize("m,d,k,geometry,splits", [
    (8, 4096, 512, "small_m", 8), (31, 4096, 512, "small_m", 16),
    (1, 4096, 512, "small_m", 8), (8, 4096, 4096, "small_m", 4),
    (2048, 16, 512, "row_tiled", 4), (128, 256, 512, "row_tiled", 8),
    (512, 64, 512, "row_tiled", 8), (77, 40, 4096, "row_tiled", 64),
    (1, 8, 1, "row_tiled", 1), (8, 4104, 512, "row_tiled", 8),
    (2048, 2, 512, "row_tiled", 4), (8, 2, 512, "row_tiled", 8),
    (8, 8192, 512, "small_m", 8), (32, 8192, 512, "small_m", 32),
    (8, 4096, 8192, "small_m", 4), (2048, 16, 8192, "row_tiled", 5),
    (1, 8192, 8192, "small_m", 8)])
def test_bmu_launch_plan(m, d, k, geometry, splits):
    """The BMU kernel's geometry by shape: few rows against long codes
    (the LR codebook's M 8, D 4096) take the small-M blocks, at least two
    per SM of the H100's 132 where the codes allow; the training and HR
    shapes keep the row tiles; every code and D column is covered.  D 2
    (``bench.py``'s smoke cascade), D 8192 (``codebook_lr.json`` at
    ``image_C`` 8) and K 8192 are inside the kernels' limits, and the
    small-M scratch (splits, M, K) float32 stays within 8 MB."""
    from qaig_tpu_torch.ops.bmu import launch_plan

    plan = launch_plan(m, d, k)
    assert (plan["geometry"], plan["splits"]) == (geometry, splits)
    if geometry == "small_m":
        assert plan["slice"] * plan["splits"] == d
        assert plan["slice"] % 128 == 0 and plan["slice"] <= 1024
        assert m * plan["slice"] * 4 <= 48 * 1024
        assert plan["blocks"] == -(-k // 8) * splits >= 264
        assert splits * m * k * 4 <= 8 * 2 ** 20
    else:
        assert plan["tiles_per_split"] * 64 * splits >= k
        assert plan["blocks"] == -(-m // 32) * splits
    # a misaligned input keeps the row tiles, which take any alignment
    assert launch_plan(m, d, k, aligned=False)["geometry"] == "row_tiled"
