"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Marked ``cuda``: they skip where no GPU is visible and run on the
machine with the card:

    python -m pytest tests/test_torch_port_kernels.py -q -m cuda

Tolerance: atol 2e-2 in bf16 (both round the same float32 result to bf16,
so they differ by at most one bf16 step at these magnitudes; the flat
kernel also rounds q and the probabilities to bf16 as its plain version
does, in another order across its slot tiles) and 1e-5 in float32
(summation order only).  Attention gradients: atol 5e-2 in bf16
(the kernel's bf16 output enters the backward's delta term and the
gradients are rounded to bf16) and 1e-4 in float32 (products over S keys
in another order); the backward kernel is held to the same against the
plain backward products on the same inputs.  BMU indices: the near-tie rule of
``qaig_tpu_torch.ops.bmu.near_tie_agreement`` (equal wherever the best and
second-best float64 distances are more than 1e-5 * max(1, |best|) apart;
elsewhere the kernel's pick lies within that margin of the minimum);
duplicated codes give the first index exactly.  The fused MLP (kernel 6):
atol 2e-2 in bf16 (the kernel and its plain version round the same
float32 hidden and output to bf16; sums in another order can move one
bf16 step), its only type on the card.
"""

import pytest
import torch

pytestmark = pytest.mark.cuda

TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-5}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _rand(gen, *shape, dtype):
    return (torch.randn(*shape, generator=gen, device="cuda") * 0.5).to(dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,bw,s,index0,block_index",
                         [(32, 16, 17, 1, 0), (4, 8, 96, 50, 3),
                          (4, 7, 256, 249, 6), (4, 1, 40, 40, 0)])
def test_decode_kernels_match_plain(cuda, dtype, b, bw, s, index0,
                                    block_index):
    from qaig_tpu_torch.ops import decode_attention as da
    from qaig_tpu_torch.ops.kv_quant import quantize_kv_t

    gen = torch.Generator(device=cuda).manual_seed(0)
    n, h, dh = 3, 8, 64
    q = _rand(gen, n * b, 1, h * dh, dtype=dtype)
    kt, vt = (_rand(gen, n, h, dh, s, dtype=dtype) for _ in range(2))
    kb, vb = (_rand(gen, n * b, h, bw, dh, dtype=dtype) for _ in range(2))
    got = da.shared_prefix_attention_fused_t(q, kt, vt, kb, vb, index0,
                                             block_index)
    want = da.shared_prefix_attention_reference(q, kt, vt, kb, vb, index0,
                                                block_index)
    torch.testing.assert_close(got.float(), want.float(), rtol=0,
                               atol=TOL[dtype])
    k8, ks = quantize_kv_t(kt)
    v8, vs = quantize_kv_t(vt)
    got = da.shared_prefix_attention_fused_int8(q, k8, ks, v8, vs, kb, vb,
                                                index0, block_index)
    want = da.shared_prefix_attention_reference(
        q, k8, v8, kb, vb, index0, block_index, k_scale=ks, v_scale=vs)
    torch.testing.assert_close(got.float(), want.float(), rtol=0,
                               atol=TOL[dtype])


# (n, b, bw, s, index0, block_index): the generation path's 8 images at
# index0 64 and 256, index0 200 (ranges of 56, not a multiple of a tile),
# index0 1, B 32 at stage 0's S 32, a prefix of S 17 (rows not 16-byte
# aligned: the element loads) and an empty prefix
_SPLIT_CASES = [(8, 4, 8, 256, 64, 3), (8, 4, 8, 256, 256, 7),
                (16, 4, 8, 256, 200, 5), (16, 4, 8, 256, 1, 0),
                (8, 32, 16, 32, 32, 15), (8, 32, 16, 256, 256, 15),
                (3, 4, 7, 17, 17, 6), (3, 4, 8, 64, 0, 2)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("n,b,bw,s,index0,block_index", _SPLIT_CASES)
def test_decode_split_kernel_matches_plain(cuda, dtype, n, b, bw, s, index0,
                                           block_index):
    """Kernel B (the prefix split across a cluster) against its plain
    version at the plan's split, and in 1 and 2 CTAs a cluster where this
    index0 splits in that many non-empty ranges; launched once a call."""
    from qaig_tpu_torch.ops import decode_attention as da

    gen = torch.Generator(device=cuda).manual_seed(index0 + b + s)
    h, dh = 8, 64
    q = _rand(gen, n * b, 1, h * dh, dtype=dtype)
    kt, vt = (_rand(gen, n, h, dh, s, dtype=dtype) for _ in range(2))
    kb, vb = (_rand(gen, n * b, h, bw, dh, dtype=dtype) for _ in range(2))
    want = da.shared_prefix_attention_reference(q, kt, vt, kb, vb, index0,
                                                block_index)
    launches = da.shared_prefix_attention_fused_t.launches
    got = da.shared_prefix_attention_fused_t(q, kt, vt, kb, vb, index0,
                                             block_index)
    assert da.shared_prefix_attention_fused_t.launches == launches + 1
    torch.testing.assert_close(got.float(), want.float(), rtol=0,
                               atol=TOL[dtype])
    for splits in (1, 2):
        try:
            plan = da._plan(n, b, h, dh, index0, 132, q.element_size(),
                            block_index, splits)
        except ValueError:   # no split of index0 in non-empty ranges
            assert splits == 2 and index0 <= 8
            continue
        got = da._launch_split(q, kt, vt, kb, vb, index0, block_index, plan)
        torch.testing.assert_close(got.float(), want.float(), rtol=0,
                                   atol=TOL[dtype])
    # the C side refuses a split it was not built for
    plan = da._plan(n, b, h, dh, index0, 132, q.element_size(), block_index,
                    1)
    with pytest.raises(RuntimeError, match="invalid argument"):
        da._launch_split(q, kt, vt, kb, vb, index0, block_index,
                         dict(plan, splits=4))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("dh,s", [(8, 64), (20, 64), (20, 17), (12, 40)])
def test_decode_split_kernel_takes_any_head_dim(cuda, dtype, dh, s):
    """Kernel B at head dims whose block rows (dh 20 and 12 in bf16, 12 in
    float32) or prefix rows (S 17) are not whole 16-byte chunks: the
    element loads instead of cp.async, in clusters of 1 and 2."""
    from qaig_tpu_torch.ops import decode_attention as da

    gen = torch.Generator(device=cuda).manual_seed(dh + s)
    n, b, h, bw = 3, 4, 4, 8
    q = _rand(gen, n * b, 1, h * dh, dtype=dtype)
    kt, vt = (_rand(gen, n, h, dh, s, dtype=dtype) for _ in range(2))
    kb, vb = (_rand(gen, n * b, h, bw, dh, dtype=dtype) for _ in range(2))
    want = da.shared_prefix_attention_reference(q, kt, vt, kb, vb, s - 1, 5)
    for splits in (1, 2):
        plan = da._plan(n, b, h, dh, s - 1, 132, q.element_size(), 5, splits)
        got = da._launch_split(q, kt, vt, kb, vb, s - 1, 5, plan)
        torch.testing.assert_close(got.float(), want.float(), rtol=0,
                                   atol=TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_decode_split_kernel_is_deterministic(cuda, dtype):
    """Kernel B combines the CTAs' partials in rank order: two calls give
    the same bits (greedy tokens on the card stay equal run to run)."""
    from qaig_tpu_torch.ops import decode_attention as da

    gen = torch.Generator(device=cuda).manual_seed(9)
    n, b, h, dh, s, bw = 8, 4, 8, 64, 256, 8
    q = _rand(gen, n * b, 1, h * dh, dtype=dtype)
    kt, vt = (_rand(gen, n, h, dh, s, dtype=dtype) for _ in range(2))
    kb, vb = (_rand(gen, n * b, h, bw, dh, dtype=dtype) for _ in range(2))
    assert da.launch_plan(n, b, h, dh, 256, 132)["splits"] > 1
    first = da.shared_prefix_attention_fused_t(q, kt, vt, kb, vb, 256, 7)
    for _ in range(3):
        again = da.shared_prefix_attention_fused_t(q, kt, vt, kb, vb, 256, 7)
        assert torch.equal(first, again)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("n,b,bw,s,index0,block_index", _SPLIT_CASES)
def test_int8_split_kernel_matches_plain(cuda, dtype, n, b, bw, s, index0,
                                         block_index):
    """Kernel C (kernel B's kernel over an int8 prefix and its per-slot
    scales) against its plain version at the plan's split, and in 1 and 2
    CTAs a cluster where this index0 splits in that many non-empty ranges
    (a range of int8 slots may start mid-chunk: index0 200 at S 256; S 17:
    rows not 16-byte aligned, the element loads); launched once a call,
    equal bits over two calls."""
    from qaig_tpu_torch.ops import decode_attention as da
    from qaig_tpu_torch.ops.kv_quant import quantize_kv_t

    gen = torch.Generator(device=cuda).manual_seed(index0 + b + s + 1)
    h, dh = 8, 64
    q = _rand(gen, n * b, 1, h * dh, dtype=dtype)
    (k8, ks), (v8, vs) = (quantize_kv_t(_rand(gen, n, h, dh, s, dtype=dtype))
                          for _ in range(2))
    kb, vb = (_rand(gen, n * b, h, bw, dh, dtype=dtype) for _ in range(2))
    want = da.shared_prefix_attention_reference(
        q, k8, v8, kb, vb, index0, block_index, k_scale=ks, v_scale=vs)
    fn = da.shared_prefix_attention_fused_int8
    launches = fn.launches
    got = fn(q, k8, ks, v8, vs, kb, vb, index0, block_index)
    assert fn.launches == launches + 1
    torch.testing.assert_close(got.float(), want.float(), rtol=0,
                               atol=TOL[dtype])
    assert torch.equal(got, fn(q, k8, ks, v8, vs, kb, vb, index0,
                               block_index))
    for splits in (1, 2):
        try:
            plan = da._plan(n, b, h, dh, index0, 132, q.element_size(),
                            block_index, splits, 1)
        except ValueError:   # no split of index0 in non-empty ranges
            assert splits == 2 and index0 <= 8
            continue
        got = da._launch_split(q, k8, v8, kb, vb, index0, block_index, plan,
                               k_scale=ks, v_scale=vs)
        torch.testing.assert_close(got.float(), want.float(), rtol=0,
                                   atol=TOL[dtype])


def test_decode_plan_the_card_cannot_hold_raises(cuda):
    """A kernel-B/C plan whose shared memory is past a block's 227 KB
    (B 256 at dh 256) raises before any launch."""
    from qaig_tpu_torch.ops import decode_attention as da
    from qaig_tpu_torch.ops.kv_quant import quantize_kv_t

    n, b, h, dh, s = 1, 256, 1, 256, 64
    q = torch.zeros(n * b, 1, h * dh, device=cuda)
    k8, ks = quantize_kv_t(torch.zeros(n, h, dh, s, device=cuda))
    kb = torch.zeros(n * b, h, 8, dh, device=cuda)
    fn = da.shared_prefix_attention_fused_int8
    launches = fn.launches
    with pytest.raises(ValueError, match="shared memory"):
        fn(q, k8, ks, k8, ks, kb, kb, s, 7)
    assert fn.launches == launches


# (n, b, bw, s, index0, block_index): the timed shapes (16 images, and the
# flat path's 8 at stage 1's S 64 and stage 2's S 256), index0 1, a range
# that is not a whole tile, B 8, and an empty prefix
_FLAT_CASES = [(16, 4, 8, 256, 256, 7), (8, 4, 8, 64, 57, 7),
               (8, 4, 8, 256, 241, 7), (16, 4, 8, 256, 1, 0),
               (16, 4, 8, 256, 200, 5), (8, 8, 8, 96, 90, 7),
               (3, 4, 8, 64, 0, 2)]


def _flat_inputs(gen, n, b, h, dh, bw, s, dtype, quant):
    from qaig_tpu_torch.ops import decode_attention as da
    from qaig_tpu_torch.ops.kv_quant import quantize_kv_t

    q = _rand(gen, n * b, 1, h * dh, dtype=dtype)
    kt, vt = (_rand(gen, n, h, dh, s, dtype=dtype) for _ in range(2))
    kb, vb = (_rand(gen, n * b, h, bw, dh, dtype=dtype) for _ in range(2))
    if not quant:
        return (q, da.interleave_t(kt), da.interleave_t(vt), kb, vb), {}
    (k8, ks), (v8, vs) = quantize_kv_t(kt), quantize_kv_t(vt)
    return ((q, da.interleave_t(k8), da.interleave_t(v8), kb, vb),
            {"k_scale": da.interleave_scale(ks),
             "v_scale": da.interleave_scale(vs)})


@pytest.mark.parametrize("quant", [False, True], ids=["t", "int8"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("n,b,bw,s,index0,block_index", _FLAT_CASES)
def test_flat_split_kernel_matches_plain(cuda, quant, dtype, n, b, bw, s,
                                         index0, block_index):
    """The flat kernel (one launch, the prefix split over a cluster of
    CTAs by its plan) against its plain version, and in forced clusters of
    1 and 3 CTAs an image; launched once a call, equal bits over two
    calls."""
    from qaig_tpu_torch.ops import decode_attention as da

    gen = torch.Generator(device=cuda).manual_seed(index0 + b + s)
    h, dh = 8, 64
    (q, k_il, v_il, kb, vb), kw = _flat_inputs(gen, n, b, h, dh, bw, s,
                                               dtype, quant)
    args = (q, k_il, v_il, kb, vb, index0, block_index, h)
    want = da.shared_prefix_attention_flat_reference(*args, **kw)
    flat = da.shared_prefix_attention_fused_flat
    counts = (flat.launches, flat.int8_launches)
    got = flat(*args, **kw)
    assert (flat.launches, flat.int8_launches) == (
        counts[0] + (not quant), counts[1] + quant)
    torch.testing.assert_close(got.float(), want.float(), rtol=0,
                               atol=TOL[dtype])
    assert torch.equal(got, flat(*args, **kw))
    for splits in (1, 3):
        try:
            plan = da._flat_plan(n, b, h, dh, index0, 132,
                                 k_il.element_size(), block_index,
                                 q.element_size(), splits)
        except ValueError:   # no split of index0 in non-empty ranges
            assert splits == 3 and index0 <= 2 * 2
            continue
        got = da._launch_flat(q, k_il, v_il, kw.get("k_scale"),
                              kw.get("v_scale"), kb, vb, index0, block_index,
                              h, plan=plan)
        torch.testing.assert_close(got.float(), want.float(), rtol=0,
                                   atol=TOL[dtype])


@pytest.mark.parametrize("quant", [False, True], ids=["t", "int8"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("h,s,index0", [(3, 17, 17), (5, 40, 33),
                                        (8, 17, 15)])
def test_flat_kernel_element_path_matches_plain(cuda, quant, dtype, h, s,
                                                index0):
    """The flat kernel where an interleaved row (S*H elements) is not
    whole 16-byte chunks (3 and 5 heads; 8 heads of int8 at S 17): the
    element loads instead of cp.async."""
    from qaig_tpu_torch.ops import decode_attention as da

    gen = torch.Generator(device=cuda).manual_seed(h + s)
    n, b, dh, bw = 3, 4, 64, 8
    (q, k_il, v_il, kb, vb), kw = _flat_inputs(gen, n, b, h, dh, bw, s,
                                               dtype, quant)
    args = (q, k_il, v_il, kb, vb, index0, 5, h)
    torch.testing.assert_close(
        da.shared_prefix_attention_fused_flat(*args, **kw).float(),
        da.shared_prefix_attention_flat_reference(*args, **kw).float(),
        rtol=0, atol=TOL[dtype])


def test_flat_plan_the_card_cannot_hold_raises(cuda):
    """A flat plan of 64-slot float32 tiles in two ring slots (~540 KB of
    shared memory) is refused once its occupancy is asked, before any
    launch."""
    from qaig_tpu_torch.ops import decode_attention as da

    gen = torch.Generator(device=cuda).manual_seed(2)
    n, b, h, dh = 2, 4, 8, 64
    (q, k_il, v_il, kb, vb), _ = _flat_inputs(gen, n, b, h, dh, 8, 256,
                                              torch.float32, False)
    plan = dict(da.flat_launch_plan(n, b, h, dh, 256, 132, 4, 7), tile=64,
                stages=2)
    plan["smem"] = da.flat_smem(b, h, dh, 64, 4, 4, 2)
    assert plan["smem"] > 227 * 1024
    with pytest.raises(RuntimeError, match="holds no"):
        da._launch_flat(q, k_il, v_il, None, None, kb, vb, 256, 7, h,
                        plan=plan)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,bw,s,index0,block_index",
                         [(4, 8, 256, 256, 7), (4, 8, 256, 96, 3),
                          (4, 8, 256, 1, 0), (32, 16, 40, 33, 15),
                          (4, 7, 96, 90, 6), (2, 1, 17, 0, 0)])
def test_flat_kernel_matches_plain(cuda, dtype, b, bw, s, index0,
                                   block_index):
    """The flat kernel (working-dtype and int8 prefix) against its plain
    version, and against the slot-minor kernel's plain version (the same
    function; the flat one rounds q and the probabilities to the working
    dtype, so bf16 compares within the bf16 tolerance)."""
    from qaig_tpu_torch.ops import decode_attention as da
    from qaig_tpu_torch.ops.kv_quant import quantize_kv_t

    gen = torch.Generator(device=cuda).manual_seed(index0 + b)
    n, h, dh = 3, 8, 64
    q = _rand(gen, n * b, 1, h * dh, dtype=dtype)
    kt, vt = (_rand(gen, n, h, dh, s, dtype=dtype) for _ in range(2))
    kb, vb = (_rand(gen, n * b, h, bw, dh, dtype=dtype) for _ in range(2))
    k_il, v_il = da.interleave_t(kt), da.interleave_t(vt)
    flat = da.shared_prefix_attention_fused_flat
    launches = (flat.launches, flat.int8_launches)
    got = flat(q, k_il, v_il, kb, vb, index0, block_index, h)
    want = da.shared_prefix_attention_flat_reference(
        q, k_il, v_il, kb, vb, index0, block_index, h)
    torch.testing.assert_close(got.float(), want.float(), rtol=0,
                               atol=TOL[dtype])
    torch.testing.assert_close(
        got.float(), da.shared_prefix_attention_reference(
            q, kt, vt, kb, vb, index0, block_index).float(), rtol=0,
        atol=TOL[torch.bfloat16])
    (k8, ks), (v8, vs) = quantize_kv_t(kt), quantize_kv_t(vt)
    args = (q, da.interleave_t(k8), da.interleave_t(v8), kb, vb, index0,
            block_index, h)
    scales = {"k_scale": da.interleave_scale(ks),
              "v_scale": da.interleave_scale(vs)}
    got = flat(*args, **scales)
    want = da.shared_prefix_attention_flat_reference(*args, **scales)
    torch.testing.assert_close(got.float(), want.float(), rtol=0,
                               atol=TOL[dtype])
    assert (flat.launches, flat.int8_launches) == (launches[0] + 1,
                                                   launches[1] + 1)


def test_flat_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    from qaig_tpu_torch.ops import decode_attention as da

    q = torch.zeros(8, 1, 512, device=cuda)
    k_il = torch.zeros(2, 64, 32 * 8, device=cuda)
    kb = torch.zeros(8, 8, 4, 64, device=cuda)
    flat = da.shared_prefix_attention_fused_flat
    launches = (flat.launches, flat.int8_launches)
    for args, kw, match in (
            ((q, k_il, k_il, kb, kb, 33, 0, 8), {}, "outside"),
            ((q, k_il.bfloat16(), k_il, kb, kb, 1, 0, 8), {}, "must be"),
            ((q, k_il, k_il, kb, kb, 1, 0, 3), {}, "interleaved"),
            ((q, k_il.to(torch.int8), k_il.to(torch.int8), kb, kb, 1, 0, 8),
             {"k_scale": torch.zeros(2, 256, device=cuda,
                                     dtype=torch.bfloat16)}, "both"),
            ((torch.zeros(8, 1, 64 * 256, device=cuda),
              torch.zeros(2, 256, 32 * 64, device=cuda),
              torch.zeros(2, 256, 32 * 64, device=cuda),
              torch.zeros(8, 64, 4, 256, device=cuda),
              torch.zeros(8, 64, 4, 256, device=cuda), 1, 0, 64), {},
             "shared memory")):
        with pytest.raises(ValueError, match=match):
            flat(*args, **kw)
    assert (flat.launches, flat.int8_launches) == launches


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("dh", [8, 16, 32, 64, 128, 192, 256])
@pytest.mark.parametrize("s", [1, 13, 64, 65, 100, 129, 255])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_kernel_matches_plain(cuda, dtype, dh, s, causal):
    """Every head dim, both masks, and S around the 64-key tiles: one key,
    a ragged first tile, one full tile, a tile and one key, ragged and full
    later tiles (past dh 128 fewer K/V slots than tiles, so slots are
    refilled)."""
    from qaig_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device=cuda).manual_seed(s)
    heads = 4
    q, k, v = (_rand(gen, 3, s, heads * dh, dtype=dtype) for _ in range(3))
    got = fa.flash_attention(q, k, v, heads, causal=causal)
    want = fa.flash_attention_reference(q, k, v, heads, causal)
    torch.testing.assert_close(got.float(), want.float(), rtol=0,
                               atol=TOL[dtype])


GRAD_TOL = {torch.bfloat16: 5e-2, torch.float32: 1e-4}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("heads,dh", [(64, 8), (4, 32)])
@pytest.mark.parametrize("s,causal", [(256, True), (64, False), (13, True)])
def test_flash_attention_gradient_matches_plain(cuda, dtype, heads, dh, s,
                                                causal):
    from qaig_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device=cuda).manual_seed(s + dh)
    q, k, v = (_rand(gen, 2, s, heads * dh, dtype=dtype).requires_grad_()
               for _ in range(3))
    weight = torch.randn(2, s, heads * dh, generator=gen, device=cuda)
    calls = fa.flash_attention.backward_calls
    got = torch.autograd.grad(
        (fa.flash_attention(q, k, v, heads, causal=causal).float()
         * weight).sum(), (q, k, v))
    assert fa.flash_attention.backward_calls == calls + 1
    want = torch.autograd.grad(
        (fa.flash_attention_reference(q, k, v, heads, causal).float()
         * weight).sum(), (q, k, v))
    for g, w in zip(got, want):
        assert g.dtype == dtype
        torch.testing.assert_close(g.float(), w.float(), rtol=0,
                                   atol=GRAD_TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("dh", [8, 16, 32, 64, 128, 192, 256])
@pytest.mark.parametrize("s", [1, 13, 64, 255, 256])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_backward_kernel_matches_plain(cuda, dtype, dh, s,
                                                       causal):
    """The backward kernel called directly, against the plain ``_flash_bwd``
    products on the same (q, k, v, out, dout); ragged S, one key, both
    masks, every head dim the forward takes."""
    from qaig_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device=cuda).manual_seed(s + dh)
    heads = 3
    q, k, v, dout = (_rand(gen, 2, s, heads * dh, dtype=dtype)
                     for _ in range(4))
    out = fa.flash_attention(q, k, v, heads, causal=causal)
    launches = fa.fused_flash_attention_backward.launches
    got = fa.fused_flash_attention_backward(q, k, v, out, dout, heads,
                                            causal)
    assert fa.fused_flash_attention_backward.launches == launches + 1
    want = fa.flash_attention_backward(q, k, v, out, dout, heads, causal)
    for g, w in zip(got, want):
        assert g.dtype == dtype and g.shape == q.shape
        torch.testing.assert_close(g.float(), w.float(), rtol=0,
                                   atol=GRAD_TOL[dtype])


@pytest.mark.parametrize("dh", [32, 64, 128, 192, 256])
@pytest.mark.parametrize("cluster", [1, 2])
@pytest.mark.parametrize("s,causal", [(13, True), (64, False), (255, True),
                                      (200, False)])
def test_flash_attention_f32_backward_clusters_match_plain(cuda, dh, cluster,
                                                           s, causal):
    """The float32 backward's register-blocked form in clusters of 1 and
    2 CTAs sharing a block's streamed rows; a plan the kernel was not built
    with is refused."""
    from qaig_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device=cuda).manual_seed(s + dh + cluster)
    heads = 3
    q, k, v, dout = (_rand(gen, 2, s, heads * dh, dtype=torch.float32)
                     for _ in range(4))
    out = fa.flash_attention(q, k, v, heads, causal=causal)
    plan = fa._backward_plan(torch.float32, dh, s, heads, 2, 132, cluster)
    got = fa._backward(q, k, v, out, dout, heads, causal, plan=plan)
    want = fa.flash_attention_backward(q, k, v, out, dout, heads, causal)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=GRAD_TOL[torch.float32])
    for bad in (dict(stages=3), dict(tile=16), dict(split=2),
                dict(cluster=4)):
        with pytest.raises(RuntimeError, match="invalid argument"):
            fa._backward(q, k, v, out, dout, heads, causal,
                         plan=dict(plan, **bad))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_runs_past_65535_heads_of_rows(cuda, dtype, causal):
    """N * H = 65536 (1024 rows of 64 heads of 8, S 64): the forward and
    the backward put (n, h) on the grid's x axis, which a y axis (at most
    65535) could not hold."""
    from qaig_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device=cuda).manual_seed(5)
    n, heads, dh, s = 1024, 64, 8, 64
    q, k, v, dout = (_rand(gen, n, s, heads * dh, dtype=dtype)
                     for _ in range(4))
    launches = fa.flash_attention.launches
    out = fa.flash_attention(q, k, v, heads, causal=causal)
    assert fa.flash_attention.launches == launches + 1
    torch.testing.assert_close(
        out.float(), fa.flash_attention_reference(q, k, v, heads,
                                                  causal).float(),
        rtol=0, atol=TOL[dtype])
    got = fa.fused_flash_attention_backward(q, k, v, out, dout, heads,
                                            causal)
    want = fa.flash_attention_backward(q, k, v, out, dout, heads, causal)
    for g, w in zip(got, want):
        torch.testing.assert_close(g.float(), w.float(), rtol=0,
                                   atol=GRAD_TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("heads,dh", [(16, 24)])
def test_attention_routes_other_head_dims_past_the_kernel(cuda, dtype,
                                                          heads, dh):
    """dot_product_attention at a head dim the kernel does not instantiate
    runs its plain products on the card, with their gradient, and launches
    neither kernel."""
    from qaig_tpu_torch.ops import attention
    from qaig_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device=cuda).manual_seed(dh)
    q, k, v = (_rand(gen, 3, 40, heads * dh, dtype=dtype).requires_grad_()
               for _ in range(3))
    launches = (fa.flash_attention.launches,
                fa.fused_flash_attention_backward.launches)
    for causal in (True, False):
        got = attention.dot_product_attention(q, k, v, heads, causal=causal)
        torch.testing.assert_close(
            got.float(), fa.flash_attention_reference(
                q, k, v, heads, causal).float(), rtol=0, atol=TOL[dtype])
        got.float().sum().backward()
    assert q.grad is not None
    assert (fa.flash_attention.launches,
            fa.fused_flash_attention_backward.launches) == launches


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("heads,dh", [(2, 256), (4, 192)])
def test_attention_sends_wide_head_dims_to_the_kernel(cuda, dtype, heads,
                                                      dh):
    """dot_product_attention at the head dims past 128 that ``qaig_tpu``'s
    Pallas kernel takes (in_dim 512 in 2 heads, 768 in 4) launches kernel A
    forward and backward, and matches the plain version and its gradient."""
    from qaig_tpu_torch.ops import attention
    from qaig_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device=cuda).manual_seed(dh)
    q, k, v = (_rand(gen, 3, 100, heads * dh, dtype=dtype).requires_grad_()
               for _ in range(3))
    weight = torch.randn(3, 100, heads * dh, generator=gen, device=cuda)
    for causal in (True, False):
        launches = (fa.flash_attention.launches,
                    fa.fused_flash_attention_backward.launches)
        got = attention.dot_product_attention(q, k, v, heads, causal=causal)
        grads = torch.autograd.grad((got.float() * weight).sum(), (q, k, v))
        assert (fa.flash_attention.launches,
                fa.fused_flash_attention_backward.launches) == (
                    launches[0] + 1, launches[1] + 1)
        want = fa.flash_attention_reference(q, k, v, heads, causal)
        torch.testing.assert_close(got.float(), want.float(), rtol=0,
                                   atol=TOL[dtype])
        for g, w in zip(grads, torch.autograd.grad(
                (want.float() * weight).sum(), (q, k, v))):
            torch.testing.assert_close(g.float(), w.float(), rtol=0,
                                       atol=GRAD_TOL[dtype])


def test_flash_attention_backward_kernel_takes_a_non_contiguous_dout(cuda):
    """Autograd may hand the backward a strided output gradient: the
    wrapper makes it contiguous, and refuses what the kernel cannot take."""
    from qaig_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device=cuda).manual_seed(11)
    q, k, v = (_rand(gen, 2, 40, 4 * 16, dtype=torch.bfloat16)
               for _ in range(3))
    out = fa.flash_attention(q, k, v, 4, causal=True)
    dout = _rand(gen, 40, 2, 4 * 16, dtype=torch.bfloat16).transpose(0, 1)
    assert not dout.is_contiguous()
    got = fa.fused_flash_attention_backward(q, k, v, out, dout, 4, True)
    want = fa.flash_attention_backward(q, k, v, out, dout.contiguous(), 4,
                                       True)
    for g, w in zip(got, want):
        torch.testing.assert_close(g.float(), w.float(), rtol=0,
                                   atol=GRAD_TOL[torch.bfloat16])
    launches = fa.fused_flash_attention_backward.launches
    for args, match in (((q, k, v, out.float(), dout, 4, True), "out must"),
                        ((q, k, v, out, dout[:, :-1], 4, True), "dout must"),
                        ((q, k, v, out, dout, 3, True), "H\\*dh")):
        with pytest.raises(ValueError, match=match):
            fa.fused_flash_attention_backward(*args)
    assert fa.fused_flash_attention_backward.launches == launches


@pytest.mark.parametrize("m,d,k", [(2048, 16, 512), (512, 64, 512),
                                   (128, 256, 512), (8, 4096, 512),
                                   (300, 16, 64), (1, 8, 1),
                                   (77, 40, 4096), (8, 4096, 4096),
                                   (31, 4096, 512), (1, 4096, 512),
                                   (2048, 2, 512), (8, 2, 64), (5, 1, 3),
                                   (8, 8192, 512), (32, 8192, 512),
                                   (300, 8200, 64), (2048, 16, 8192),
                                   (8, 4096, 8192)])
def test_bmu_kernel_matches_plain(cuda, m, d, k):
    """The cascade's codebook shapes in both geometries, and the shapes the
    wrapper once refused: D 1-2 (``bench.py``'s smoke cascade), D 8192
    (``codebook_lr.json`` at ``image_C`` 8; small M and row tiles), K
    8192."""
    from qaig_tpu_torch.ops import bmu

    gen = torch.Generator(device=cuda).manual_seed(m + d + k)
    patches = torch.randn(m, d, generator=gen, device=cuda)
    codes = torch.randn(k, d, generator=gen, device=cuda) * 0.5
    launches = bmu.fused_bmu.launches
    small = bmu.fused_bmu.small_m_launches
    got = bmu.bmu_argmin(patches, codes)
    assert bmu.fused_bmu.launches == launches + 1
    assert bmu.fused_bmu.small_m_launches == small + (
        bmu.launch_plan(m, d, k)["geometry"] == "small_m")
    assert got.dtype == torch.int64 and got.shape == (m,)
    bmu.near_tie_agreement(patches, codes, got,
                           bmu.bmu_argmin_reference(patches, codes))


@pytest.mark.parametrize("m,d", [(500, 16), (8, 4096), (8, 8192),
                                 (500, 8192)])
def test_bmu_kernel_duplicated_codes_give_the_first_index(cuda, m, d):
    """Three copies of 64 codes, in the row tiles (M 500, D 16 and D 8192)
    and in the small-M geometry (M 8, D 4096 and 8192, where D is split
    over blocks)."""
    from qaig_tpu_torch.ops import bmu

    gen = torch.Generator(device=cuda).manual_seed(7)
    codes = torch.randn(64, d, generator=gen, device=cuda)
    codes = torch.cat([codes, codes, codes]).contiguous()   # K 192
    patches = codes[torch.randint(0, 64, (m,), generator=gen,
                                  device=cuda)] + 1e-3 * torch.randn(
        m, d, generator=gen, device=cuda)
    patches = patches.contiguous()
    got = bmu.fused_bmu(patches, codes)
    # the first of three equal distances, and the nearest of the 64 codes
    assert bool((got < 64).all())
    bmu.near_tie_agreement(patches, codes[:64], got,
                           bmu.bmu_argmin_reference(patches, codes[:64]))


def test_bmu_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    from qaig_tpu_torch.ops import bmu

    p = torch.zeros(4, 16, device=cuda)
    c = torch.zeros(8, 16, device=cuda)
    launches = bmu.fused_bmu.launches
    for patches, codes, match in (
            (p.double(), c.double(), "float32"),
            (p[:, ::2], c[:, ::2], "not contiguous"),
            (p, torch.zeros(0, 16, device=cuda), "K = 0"),
            (torch.zeros(4, 0, device=cuda), torch.zeros(8, 0, device=cuda),
             "D = 0"),
            (p, torch.zeros(8, 32, device=cuda), "codes"),
            (torch.zeros(0, 16, device=cuda), c, "M = 0")):
        with pytest.raises(ValueError, match=match):
            bmu.bmu_argmin(patches, codes)
    assert bmu.fused_bmu.launches == launches


def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    from qaig_tpu_torch.ops import decode_attention as da
    from qaig_tpu_torch.ops import flash_attention as fa

    x = torch.zeros(2, 8, 4 * 24, device=cuda)
    with pytest.raises(ValueError, match="head dim 24.*routes"):
        fa.flash_attention(x, x, x, 4)
    z = torch.zeros(2 * 8 * 128 + 1, device=cuda)[1:].view(2, 8, 128)
    with pytest.raises(ValueError, match="16-byte"):
        fa.flash_attention(z, z, z, 2)
    y = torch.zeros(2, 8, 128, device=cuda)
    with pytest.raises(ValueError, match="not contiguous"):
        fa.flash_attention(y.transpose(0, 1).contiguous().transpose(0, 1),
                           y, y, 2)
    q = torch.zeros(8, 1, 512, device=cuda)
    kt = torch.zeros(2, 8, 64, 32, device=cuda)
    kb = torch.zeros(8, 8, 4, 64, device=cuda)
    with pytest.raises(ValueError, match="outside"):
        da.shared_prefix_attention_fused_t(q, kt, kt, kb, kb, 33, 0)
    with pytest.raises(ValueError, match="must be"):
        da.shared_prefix_attention_fused_t(q, kt.bfloat16(), kt, kb, kb, 1,
                                           0)


@pytest.mark.parametrize("n,splits,act_last,dim,hidden,d2", [
    (8192, 3, False, 512, 2048, 512), (8192, 1, True, 512, 2048, 512),
    (1024, 3, False, 512, 2048, 512), (1024, 1, True, 512, 2048, 512),
    (1000, 3, False, 512, 2048, 512), (1, 1, True, 512, 2048, 512),
    (77, 2, True, 128, 192, 64), (130, 1, False, 256, 64, 256),
    (200, 2, False, 512, 2048, 512), (300, 2, True, 256, 128, 128),
    (65, 2, False, 128, 64, 64)])
def test_mlp2_fused_kernel_matches_plain(cuda, n, splits, act_last, dim,
                                         hidden, d2):
    """The probe's shapes (packed QKV and FFN at 8192 and 1024 rows), a
    ragged N, one row, and narrower widths (one hidden chunk; the split
    of hidden chunks over blocks at small N); and the clusters' edges at S
    2: 4 row tiles with a ragged last one (N 200), 5 row tiles padded to 2
    clusters of 4 (N 300), 2 tiles in a pair with one row in the second
    (N 65); N 1000 runs clusters of 4 with a ragged last tile."""
    from qaig_tpu_torch.ops import mlp_fused as mf

    gen = torch.Generator(device=cuda).manual_seed(n + splits + dim)

    def rnd(*shape):
        return (torch.randn(*shape, generator=gen, device=cuda)
                * 0.05).to(torch.bfloat16)

    x = rnd(n, dim)
    w0, b0 = rnd(splits * hidden, dim), rnd(splits * hidden)
    w1, b1 = rnd(splits, d2, hidden), rnd(splits, d2)
    launches = mf.mlp2_fused.launches
    got = mf.mlp2_fused(x, w0, b0, w1, b1, act_last=act_last)
    assert mf.mlp2_fused.launches == launches + 1
    assert got.dtype == torch.bfloat16 and got.shape == (splits, n, d2)
    want = mf.mlp2_fused_reference(x, w0, b0, w1, b1, act_last=act_last)
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=2e-2)


def test_mlp2_fused_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    from qaig_tpu_torch.ops import mlp_fused as mf

    def z(*shape, dtype=torch.bfloat16):
        return torch.zeros(*shape, device=cuda, dtype=dtype)

    ok = (z(8, 64), z(128, 64), z(128), z(1, 64, 128), z(1, 64))
    launches = mf.mlp2_fused.launches
    for args, match in (
            ((z(8, 64, dtype=torch.float32),) + ok[1:], "bf16 only"),
            ((z(8, 128)[:, ::2],) + ok[1:], "contiguous"),
            ((z(8, 40), z(128, 40), z(128), z(1, 64, 128), z(1, 64)),
             "D % 16"),
            ((z(8, 64), z(96, 64), z(96), z(1, 64, 96), z(1, 64)), "H %"),
            ((z(8, 64), z(128, 64), z(128), z(1, 96, 128), z(1, 96)),
             "D2 in"),
            ((z(8, 64), z(128, 32), z(128), z(1, 64, 128), z(1, 64)),
             "do not fit"),
            ((z(8, 1536), z(128, 1536), z(128), z(1, 64, 128), z(1, 64)),
             "shared memory")):
        with pytest.raises(ValueError, match=match):
            mf.mlp2_fused(*args)
    assert mf.mlp2_fused.launches == launches
