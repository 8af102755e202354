"""The three-pass TF32 linear layer (``qaig_tpu_torch/ops/linear_f32.py``)
on the CPU: the kernel's split arithmetic against float64, the shape rule
that picks the kernel, its launch plan, and the autograd Function's
products against ``F.linear``'s.  The kernel itself is held to float64 on
the card in ``tests/test_torch_port_kernels.py``."""

import pytest
import torch
import torch.nn.functional as F

from qaig_tpu_torch.ops import linear_f32 as lf


def _operands(kind, m, k, n, seed=0):
    """(a, b) of ``a . b^T`` for one of F.linear's products, x ~ N(0, 1),
    W ~ U(+-1/sqrt(k)), dY ~ N(0, 1)."""
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(m, k, generator=gen)
    w = (torch.rand(n, k, generator=gen) * 2 - 1) / k ** 0.5
    dy = torch.randn(m, n, generator=gen)
    return {"forward": (x, w), "grad_input": (dy, w.T.contiguous()),
            "grad_weight": (dy.T.contiguous(), x.T.contiguous())}[kind]


@pytest.mark.parametrize("kind", ["forward", "grad_input", "grad_weight"])
def test_emulated_split_error_is_float32s(kind):
    """The kernel's arithmetic (TF32 splits, each K-step's main term
    rounded and added in float32, the small terms apart) against a float64
    product, at small shapes of the three products' layouts: its
    norm-wise error at most 1.25x that of a float32 ``F.linear`` on the
    same inputs."""
    a, b = _operands(kind, 96, 256, 320)
    ref = a.double() @ b.double().T
    got = lf.linear_f32_emulated(a, b)
    f32 = F.linear(a, b)
    err = (got.double() - ref).norm() / ref.norm()
    f32_err = (f32.double() - ref).norm() / ref.norm()
    assert got.dtype == torch.float32 and got.shape == ref.shape
    assert err <= 1.25 * f32_err, (err.item(), f32_err.item())


def test_emulated_adds_the_bias_and_drops_only_lo_lo():
    """With one K-step the emulation is the three products of the splits
    plus the bias, and the dropped ``lo . lo`` is all it lacks of the
    exact product of the splits."""
    a, b = _operands("forward", 8, 8, 12, seed=1)
    bias = torch.linspace(-1, 1, 12)
    a_hi, a_lo = lf.tf32_split(a)
    b_hi, b_lo = lf.tf32_split(b)
    full = (a_hi.double() + a_lo.double()) @ (b_hi.double()
                                              + b_lo.double()).T
    got = lf.linear_f32_emulated(a, b, bias) - bias
    lo_lo = a_lo.double() @ b_lo.double().T
    assert torch.allclose(got.double(), full - lo_lo, rtol=0, atol=1e-6)
    assert lo_lo.abs().max() < 2 ** -20 * full.abs().max()


def test_tf32_split_rounds_to_nearest_ties_away():
    one = 1.0 + 2 ** -11          # halfway between two TF32 numbers
    x = torch.tensor([one, -one, 1.0 + 2 ** -12, 3.0, float("inf"),
                      float("-inf")])
    hi, lo = lf.tf32_split(x)
    assert hi.tolist()[:4] == [1.0 + 2 ** -10, -(1.0 + 2 ** -10), 1.0, 3.0]
    assert hi[4:].tolist() == [float("inf"), float("-inf")]
    assert lo.tolist() == [-2 ** -11, 2 ** -11, 2 ** -12, 0.0, 0.0, 0.0]
    # every hi and lo has at most 10 mantissa bits
    y = torch.randn(1000, generator=torch.Generator().manual_seed(2))
    for part in lf.tf32_split(y):
        assert not (part.view(torch.int32) & 0x1FFF).any()
    assert ((sum(lf.tf32_split(y)) - y).abs() <= 2 ** -21 * y.abs()).all()


def _x(rows, cols, dtype=torch.float32):
    return torch.ones(rows, cols, dtype=dtype)


@pytest.mark.parametrize("case,want", [
    ("casc2_decoder", True), ("casc2_hidden", True), ("three_dim", True),
    ("rows_512", True), ("rows_511", False), ("columns_strided", True),
    ("classifier_513", False),
    ("in_not_four", False), ("bf16", False),
    ("weight_transposed_view", False), ("rows_misaligned", False),
    ("row_stride_not_four", False), ("no_rows", False),
    ("bias_bf16", False)])
def test_shape_rule(case, want):
    """Which float32 products the kernel takes: in and out features
    multiples of 4, 16-byte aligned rows, a contiguous weight and at least
    512 rows; the rest (the classifier's 513 outputs, small decode steps
    among them) falls back."""
    w = torch.ones(2048, 512)
    x, b = _x(4096, 512), torch.ones(2048)
    if case == "casc2_hidden":
        x, w, b = _x(16384, 2048), torch.ones(512, 2048), torch.ones(512)
    elif case == "three_dim":
        x = torch.ones(64, 256, 512)
    elif case == "rows_512":
        x = torch.ones(2, 256, 512)
    elif case == "rows_511":
        x = _x(511, 512)
    elif case == "columns_strided":   # copied to rows by the wrapper
        x = torch.ones(512, 4096).T
    elif case == "classifier_513":
        x, w, b = _x(4096, 2048), torch.ones(513, 2048), torch.ones(513)
    elif case == "in_not_four":
        x, w = _x(4096, 510), torch.ones(2048, 510)
    elif case == "bf16":
        x, w = _x(4096, 512, torch.bfloat16), w.bfloat16()
    elif case == "weight_transposed_view":
        w = torch.ones(512, 2048).T
    elif case == "rows_misaligned":
        x = _x(4096, 513)[:, 1:]
    elif case == "row_stride_not_four":
        x = _x(4096, 514).as_strided((4096, 512), (514, 1))
    elif case == "no_rows":
        x = _x(0, 512)
    elif case == "bias_bf16":
        b = b.bfloat16()
    assert lf.takes(x, w, b) is want


def test_cpu_calls_are_f_linear_and_count_nothing():
    """On the CPU the wrapper is ``F.linear`` bit for bit, in float32 and
    bf16, and neither counter moves."""
    gen = torch.Generator().manual_seed(3)
    before = (lf.linear_f32.launches, lf.linear_f32.fallbacks)
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.randn(5, 7, 64, generator=gen).to(dtype)
        w = torch.randn(48, 64, generator=gen).to(dtype)
        b = torch.randn(48, generator=gen).to(dtype)
        assert torch.equal(lf.linear_f32(x, w, b), F.linear(x, w, b))
        assert torch.equal(lf.linear_f32(x, w), F.linear(x, w))
    assert (lf.linear_f32.launches, lf.linear_f32.fallbacks) == before


@pytest.mark.parametrize("m,n,k,sm,want", [
    (16384, 2048, 512, 132, (1, 132)),   # forward, 2048 tiles
    (16384, 512, 2048, 132, (1, 132)),   # dX of the hidden layer
    (4096, 512, 2048, 132, (1, 128)),    # encoder rows: 128 tiles
    (2048, 512, 16384, 132, (2, 128)),   # dW^T of the 512 -> 2048 layer
    (512, 512, 16384, 132, (8, 128)),    # dW of a 512 -> 512 layer
    (512, 512, 4096, 132, (8, 128)),     # the same over the encoder rows
    (8, 2048, 64, 132, (1, 16)),         # two K-blocks: no split
    (1, 12, 20, 132, (1, 1))])
def test_launch_plan(m, n, k, sm, want):
    """One 128 x 128 tile a block; K split where the tiles leave SMs idle,
    each split at least 4 K-blocks of 32, and never more splits than
    K-blocks."""
    assert lf.launch_plan(m, n, k, sm) == want
    splits, grid = want
    kblocks = -(-k // lf.K_BLOCK)
    per = -(-kblocks // splits)
    assert (splits - 1) * per < kblocks <= splits * per


@pytest.mark.parametrize("bias", [True, False], ids=["bias", "no_bias"])
@pytest.mark.parametrize("needs", ["all", "weight_only", "input_only"])
def test_function_gradients_match_f_linear(bias, needs):
    """``LinearF32`` on CPU tensors (its plain products): the output, dX,
    dW and db equal ``F.linear``'s autograd, and only the gradients asked
    for are computed."""
    gen = torch.Generator().manual_seed(4)
    x0 = torch.randn(24, 40, generator=gen)
    w0 = torch.randn(36, 40, generator=gen) / 6
    b0 = torch.randn(36, generator=gen) if bias else None
    dy = torch.randn(24, 36, generator=gen)
    outs = []
    for fn in (lf.LinearF32.apply, F.linear):
        x = x0.clone().requires_grad_(needs != "weight_only")
        w = w0.clone().requires_grad_(needs != "input_only")
        b = None if b0 is None else b0.clone().requires_grad_(
            needs != "input_only")
        y = fn(x, w, b)
        y.backward(dy)
        outs.append((y, x.grad, w.grad, None if b is None else b.grad))
    for got, want in zip(*outs):
        assert (got is None) == (want is None)
        if got is not None:
            torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


def test_counters_are_kept_across_graph_replays():
    """Both counters are launch counters of the graph runner, so a replay
    adds what its capture counted."""
    from qaig_tpu_torch.infer.graphs import launch_counters
    named = {name: (owner, attr) for name, owner, attr in launch_counters()}
    assert named["linear_f32"] == (lf.linear_f32, "launches")
    assert named["linear_f32_fallbacks"] == (lf.linear_f32, "fallbacks")
