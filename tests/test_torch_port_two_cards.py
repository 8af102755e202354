"""Kernel launches and serving on a second card of one process (the
PyTorch port).  This file imports no JAX; its tests are marked ``cuda``
and need at least two visible cards (they skip with fewer):

    python -m pytest tests/test_torch_port_two_cards.py -q -m cuda \
        --noconftest

CUDA keeps a kernel's attributes (its dynamic shared memory cap) in each
device's context, and a launch goes to the current device: every kernel
of the port is launched first on ``cuda:0``, then on ``cuda:1`` with
``cuda:0`` current, and held against its plain version at
``chip_smoke.py`` phase 3's tolerances (atol 2e-2 bf16 / int8, 1e-5
float32; gradients 5e-2 / 1e-4; BMU indices outside near-ties).  Then a
data 2 pipeline over ``cuda:0`` and ``cuda:1`` (one fused graph a card)
gives the one-card pipeline's tokens.
"""

import json
import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_port_graphs import cascade, cuda  # noqa: E402,F401

pytestmark = pytest.mark.cuda

TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-5}
GRAD_TOL = {torch.bfloat16: 5e-2, torch.float32: 1e-4}


@pytest.fixture
def cards():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    torch.cuda.set_device(0)
    return [torch.device("cuda", 0), torch.device("cuda", 1)]


def _rand(gen, *shape, dtype, scale=0.5):
    return (torch.randn(*shape, generator=gen, device=gen.device)
            * scale).to(dtype)


def _on_each_card(cards, run):
    """``run(device)`` on ``cuda:0``, then on ``cuda:1``, with ``cuda:0``
    current both times; each result must lie on its card."""
    for device in cards:
        assert torch.cuda.current_device() == 0
        for out in run(device):
            assert out.device == device


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_attention_forward_and_backward_on_the_second_card(cards,
                                                                 dtype):
    """Kernel A and its backward (A') at dh 64 and 256 (float32 at dh 256
    takes more than 48 KB of shared memory)."""
    from qaig_tpu_torch.ops import flash_attention as fa

    def run(device):
        outs = []
        for heads, dh in ((8, 64), (2, 256)):
            gen = torch.Generator(device=device).manual_seed(dh)
            q, k, v, dout = (_rand(gen, 2, 200, heads * dh, dtype=dtype)
                             for _ in range(4))
            out = fa.flash_attention(q, k, v, heads, causal=True)
            torch.testing.assert_close(
                out.float(),
                fa.flash_attention_reference(q, k, v, heads, True).float(),
                rtol=0, atol=TOL[dtype])
            got = fa.fused_flash_attention_backward(q, k, v, out, dout,
                                                    heads, True)
            want = fa.flash_attention_backward(q, k, v, out, dout, heads,
                                               True)
            for g, w in zip(got, want):
                torch.testing.assert_close(g.float(), w.float(), rtol=0,
                                           atol=GRAD_TOL[dtype])
            outs += [out, *got]
        return outs

    _on_each_card(cards, run)


@pytest.mark.parametrize("m,d,k", [(2048, 16, 512), (8, 4096, 512)])
def test_bmu_on_the_second_card(cards, m, d, k):
    """BMU in both geometries (row tiles; small M)."""
    from qaig_tpu_torch.ops import bmu

    def run(device):
        gen = torch.Generator(device=device).manual_seed(m + d)
        patches = torch.randn(m, d, generator=gen, device=device)
        codes = torch.randn(k, d, generator=gen, device=device) * 0.5
        got = bmu.fused_bmu(patches, codes)
        bmu.near_tie_agreement(patches, codes, got,
                               bmu.bmu_argmin_reference(patches, codes))
        return [got]

    _on_each_card(cards, run)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_decode_kernels_on_the_second_card(cards, dtype):
    """Kernels B and C (the split kernel over a working or an int8 prefix)
    and kernel 4 in both prefix forms, at the generation path's stage-2
    shape (16 images, 4 rollouts, S 256)."""
    from qaig_tpu_torch.ops import decode_attention as da
    from qaig_tpu_torch.ops.kv_quant import quantize_kv_t

    n, b, bw, s, h, dh, index0, block = 16, 4, 8, 256, 8, 64, 200, 5

    def run(device):
        gen = torch.Generator(device=device).manual_seed(1)
        q = _rand(gen, n * b, 1, h * dh, dtype=dtype)
        kt, vt = (_rand(gen, n, h, dh, s, dtype=dtype) for _ in range(2))
        kb, vb = (_rand(gen, n * b, h, bw, dh, dtype=dtype)
                  for _ in range(2))
        (k8, ks), (v8, vs) = quantize_kv_t(kt), quantize_kv_t(vt)
        scales = {"k_scale": ks, "v_scale": vs}
        flat_scales = {"k_scale": da.interleave_scale(ks),
                       "v_scale": da.interleave_scale(vs)}
        calls = [
            (da.shared_prefix_attention_fused_t(q, kt, vt, kb, vb, index0,
                                                block),
             da.shared_prefix_attention_reference(q, kt, vt, kb, vb, index0,
                                                  block)),
            (da.shared_prefix_attention_fused_int8(q, k8, ks, v8, vs, kb, vb,
                                                   index0, block),
             da.shared_prefix_attention_reference(q, k8, v8, kb, vb, index0,
                                                  block, **scales))]
        for args, kw in (
                ((q, da.interleave_t(kt), da.interleave_t(vt)), {}),
                ((q, da.interleave_t(k8), da.interleave_t(v8)),
                 flat_scales)):
            full = args + (kb, vb, index0, block, h)
            calls.append((da.shared_prefix_attention_fused_flat(*full, **kw),
                          da.shared_prefix_attention_flat_reference(*full,
                                                                    **kw)))
        for got, want in calls:
            torch.testing.assert_close(got.float(), want.float(), rtol=0,
                                       atol=TOL[dtype])
        return [got for got, _ in calls]

    _on_each_card(cards, run)


def test_mlp2_fused_on_the_second_card(cards):
    """Kernel 6 at the probe's packed-QKV shape, 1024 rows."""
    from qaig_tpu_torch.ops import mlp_fused as mf

    def run(device):
        gen = torch.Generator(device=device).manual_seed(6)
        x = _rand(gen, 1024, 512, dtype=torch.bfloat16, scale=0.05)
        w0 = _rand(gen, 3 * 2048, 512, dtype=torch.bfloat16, scale=0.05)
        b0 = _rand(gen, 3 * 2048, dtype=torch.bfloat16, scale=0.05)
        w1 = _rand(gen, 3, 512, 2048, dtype=torch.bfloat16, scale=0.05)
        b1 = _rand(gen, 3, 512, dtype=torch.bfloat16, scale=0.05)
        got = mf.mlp2_fused(x, w0, b0, w1, b1)
        torch.testing.assert_close(
            got.float(), mf.mlp2_fused_reference(x, w0, b0, w1, b1).float(),
            rtol=0, atol=2e-2)
        return [got]

    _on_each_card(cards, run)


@pytest.mark.parametrize("fused", [True, False])
def test_data_2_pipeline_over_two_cards(cards, cascade, fused):
    """``CascadePipeline`` on a data 2 mesh over ``cuda:0`` and ``cuda:1``
    (float32): each replica on its card (fused: its own graph there), the
    tokens of 4 images equal a one-card pipeline's, on ``cuda:0``."""
    from qaig_tpu_torch.infer.pipeline import CascadePipeline
    from qaig_tpu_torch.parallel.local import LocalMesh

    config_path, decoder_path = cascade
    config = json.loads(Path(config_path).read_text())
    pipe = CascadePipeline.from_config(config, decoder_path, logging=print,
                                       mesh=LocalMesh(2, 1, cards))
    assert [r.device for r in pipe.replicas] == cards
    images, tokens = pipe.generate(4, seed=2, fused=fused)
    assert tokens.device == cards[0] and images.device == cards[0]
    one = CascadePipeline.from_config(config, decoder_path, logging=print,
                                      device=cards[0])
    _, want = one.generate(4, seed=2, fused=fused)
    assert torch.equal(tokens, want)
    if fused:
        assert [list(r._graphs.graphs) for r in pipe.replicas] == \
            [[(2, None)], [(2, None)]]


def test_bench_over_every_card(cards, capsys):
    """``python -m qaig_tpu_torch.bench`` over every visible card: one
    replica and one graph a card, every replay launched before the one
    synchronise; the per-card figures divide by the cards."""
    from qaig_tpu_torch import bench
    bench.main(["--scale", "smoke", "--batch", "4", "--iters", "2",
                "--no-breakdown"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    n = torch.cuda.device_count()
    assert line["n_chips"] == n and line["batch_per_chip"] == 4
    assert line["device_kind"] == torch.cuda.get_device_name(0)
    assert line["value"] == pytest.approx(
        4 * 2 / (line["iter_time_mean_s"] * 2), rel=1e-2)
