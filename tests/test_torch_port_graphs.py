"""The graph runner of the PyTorch port (``qaig_tpu_torch/infer/graphs.py``)
and the fused cascade's CUDA graphs.  This file imports no JAX, so its
``cuda``-marked tests run on a machine with the card and without JAX:

    python -m pytest tests/test_torch_port_graphs.py -q -m cuda --noconftest

* On the CPU, over a stub graph (``torch.cuda``'s graph and stream calls as
  no-ops, so a "capture" runs the function eagerly): a capture's launch
  counts are taken back out and added at every replay; inputs are copied
  in and outputs handed back as clones; a failed capture raises and counts
  nothing; the warm-up runs once per thread; the server CLI takes one
  malloc arena on CUDA (its dispatcher thread captures).
* On the card, over a small two-stage cascade written with the port's own
  checkpoint writer: ``generate.run`` replays two seeds from one capture
  with the dispatched loop's tokens; a pipeline's graphs at two batch
  sizes share one pool; a capture that reads a device value raises.
"""

import contextlib
import gc
import json
import threading

import pytest
import torch

from qaig_tpu_torch.infer.graphs import GraphRunner, read_counts
from qaig_tpu_torch.ops import decode_attention as da
from qaig_tpu_torch.ops import flash_attention as fa


class _StubGraph:
    def __init__(self):
        self.replays = 0
        self.generators = []

    def register_generator_state(self, generator):
        self.generators.append(generator)

    def capture_begin(self, pool=None, capture_error_mode=None):
        assert capture_error_mode == "thread_local"

    def capture_end(self):
        pass

    def replay(self):
        self.replays += 1


class _StubStream:
    def wait_stream(self, other):
        pass


@pytest.fixture
def stub_cuda(monkeypatch):
    """``torch.cuda``'s graph and stream calls as no-ops, so that a
    :class:`GraphRunner` "captures" by running the function on the CPU."""
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _StubGraph)
    monkeypatch.setattr(torch.cuda, "Stream", lambda device: _StubStream())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: _StubStream())
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: None)
    monkeypatch.setattr(torch.cuda, "stream", contextlib.nullcontext)
    monkeypatch.setattr(torch.cuda, "device", contextlib.nullcontext)


def _launching(counts):
    """A function that ticks the flash and decode counters as the wrappers
    do when they launch, and returns (its input + 1, [its input * 2])."""
    def fn(x):
        fa.flash_attention.launches += counts[0]
        da.shared_prefix_attention_fused_t.launches += counts[1]
        return (x + 1, [x * 2])
    return fn


def _counts():
    return (fa.flash_attention.launches,
            da.shared_prefix_attention_fused_t.launches)


def test_runners_of_a_card_share_one_capture_stream(stub_cuda,
                                                    monkeypatch):
    """Every runner on a card captures on the card's one capture stream
    (cuBLAS keeps a workspace for each stream it ran on until the process
    ends); another card has its own."""
    from qaig_tpu_torch.infer import graphs
    monkeypatch.setattr(graphs, "_CAPTURE_STREAMS", {})
    first, second = GraphRunner("cpu"), GraphRunner("cpu")
    other = GraphRunner(torch.device("cuda", 1))
    assert first.stream is second.stream
    assert other.stream is not first.stream
    assert graphs.capture_stream(torch.device("cuda", 1)) is other.stream
    assert first.pool is None and len(graphs._CAPTURE_STREAMS) == 2


def test_runner_counts_a_capture_once_per_replay(stub_cuda):
    """A capture's counter deltas are taken back out and added again at
    every replay, the first included: each call counts what one run of
    the function launches."""
    runner = GraphRunner("cpu")
    gen = torch.Generator()
    start = _counts()
    x = torch.arange(3)
    for call in range(1, 4):
        out, (doubled,) = runner("key", _launching((2, 5)), inputs=(x,),
                                 generator=gen)
        assert _counts() == (start[0] + 2 * call, start[1] + 5 * call)
    graph = runner.graphs["key"]
    assert graph.launches[0] == 2 and graph.graph.replays == 3
    assert graph.graph.generators == [gen]
    assert graph.capture_s >= 0 and graph.instantiate_s >= 0
    assert torch.equal(out, x + 1) and torch.equal(doubled, x * 2)


def test_runner_copies_inputs_and_hands_back_clones(stub_cuda):
    """Inputs go into the static buffers before each replay; the caller
    gets clones, so the next replay cannot overwrite what it holds."""
    runner = GraphRunner("cpu")
    first = runner("k", _launching((0, 0)), inputs=(torch.zeros(2),))[0]
    graph = runner.graphs["k"]
    runner("k", _launching((0, 0)), inputs=(torch.full((2,), 7.0),))
    assert torch.equal(graph.inputs[0], torch.full((2,), 7.0))
    assert first.data_ptr() != graph.outputs[0].data_ptr()
    graph.outputs[0].fill_(-1)
    assert torch.equal(first, torch.ones(2))


def test_runner_failed_capture_raises_and_counts_nothing(stub_cuda):
    runner = GraphRunner("cpu")
    start = _counts()

    def failing(x):
        fa.flash_attention.launches += 3
        raise RuntimeError("operation not permitted when stream is "
                           "capturing")
    with pytest.raises(RuntimeError, match="capturing"):
        runner("key", failing, inputs=(torch.zeros(1),))
    assert _counts() == start and runner.graphs == {}
    runner("key", _launching((1, 0)), inputs=(torch.zeros(1),))
    assert _counts() == (start[0] + 1, start[1])


def test_runner_collects_garbage_before_a_capture(stub_cuda):
    """Garbage in a reference cycle is collected before the capture
    begins: a CUDA graph among it would otherwise be destroyed inside the
    capture (at a collection the capture's allocations trigger), which
    invalidates the capture."""
    events = []

    class Cyclic:
        def __init__(self):
            self.me = self

        def __del__(self):
            events.append("collected")

    def fn(x):
        events.append("captured")
        return (x,)

    gc.disable()
    try:
        Cyclic()
        GraphRunner("cpu")("k", fn, inputs=(torch.zeros(1),))
    finally:
        gc.enable()
    assert events == ["collected", "captured"]


def test_runner_warms_up_once_per_thread(stub_cuda):
    """The warm-up runs before the first capture of each thread (cuDNN and
    cuBLAS set up per thread) and not before later captures or replays."""
    threads = []
    runner = GraphRunner("cpu", warmup=lambda: threads.append(
        threading.get_ident()))
    x = torch.zeros(1)
    runner("a", _launching((0, 0)), inputs=(x,))
    runner("a", _launching((0, 0)), inputs=(x,))
    runner("b", _launching((0, 0)), inputs=(x,))
    assert threads == [threading.get_ident()]
    worker = threading.Thread(target=runner, args=(
        "c", _launching((0, 0)), (x,)))
    worker.start()
    worker.join(timeout=60)
    assert not worker.is_alive()
    assert len(threads) == 2 and threads[1] != threads[0]
    assert sorted(runner.graphs) == ["a", "b", "c"]


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.fixture
def cascade(cuda, tmp_path):
    """A two-stage cascade (a base stage, then an encoder stage with a
    sliding window of 8) with seeded random weights, written with the
    port's checkpoint writer.  Returns (config path, decoder path)."""
    from qaig_tpu_torch.convert import to_jax_state
    from qaig_tpu_torch.models.codebook import Codebook
    from qaig_tpu_torch.models.conv_nets import ConvNetConfig, FCDecoder
    from qaig_tpu_torch.models.core import init_parameters
    from qaig_tpu_torch.models.transformer import (Transformer,
                                                   TransformerConfig)
    from qaig_tpu_torch.utils.checkpoint import save_model

    gen = torch.Generator(device=cuda).manual_seed(0)
    k, image_dim, latent_c = 16, (8, 8), 4

    def weights(module):
        return to_jax_state(init_parameters(module, gen))

    dec_cfg = dict(num_layers=1, image_channel=3, min_channel=8,
                   max_channel=16, latent_channel=latent_c,
                   hidden_activation_type="silu")
    decoder = FCDecoder(ConvNetConfig(**dec_cfg), device=cuda)
    save_model(dict(dec_cfg, use_final_enc_activation=True,
                    encoder_activation_type="silu",
                    use_final_dec_activation=True,
                    decoder_activation_type="tanh",
                    model={f"fc_decoder.{name}": v
                           for name, v in weights(decoder).items()}),
               tmp_path, "decoder.pt")
    for i, patch in enumerate([(8, 8), (4, 4), (2, 2)]):
        cb = Codebook(patch_dim=patch, image_dim=image_dim,
                      image_channel=latent_c, num_embeddings=k,
                      init_neighbour_range=1, device=cuda)
        save_model({"patch_dim": patch, "image_dim": image_dim,
                    "image_C": latent_c, "num_embeddings": k,
                    "neighbourhood_range": 1, "checkpoint": weights(cb)},
                   tmp_path, f"codebook_{i}.pt")
    ckpt = tmp_path / "models_checkpoint"
    config = {}
    for i, (window, beams) in enumerate([(None, (4, 2)), (8, (2, 4))]):
        base = i == 0
        cfg = TransformerConfig(
            use_encoder=not base, use_pos_cond=window is not None,
            num_enc_layers=0 if base else 1, num_dec_layers=2,
            num_enc_embedding=1 if base else k,
            num_dec_embedding=2 * k if base else k + 1,
            self_attn_heads=4, cross_attn_heads=0 if base else 4,
            in_dim=64, out_dim=k + 1, hidden_dim=128)
        save_model({
            "train_base_model": base, "use_sliding_window": window
            is not None, "sliding_window": window,
            "num_enc_layers": None if base else 1, "num_dec_layers": 2,
            "num_enc_embedding": None if base else k,
            "num_dec_embedding": cfg.num_dec_embedding,
            "self_attn_heads": 4, "cross_attn_heads": None if base else 4,
            "transformer_in_dim": 64, "transformer_out_dim": k + 1,
            "transformer_hidden_dim": 128, "hidden_activation": "silu",
            "model": weights(Transformer(cfg, device=cuda))},
            tmp_path, f"transformer_{i}.pt")
        config[str(i)] = {
            "model_path": str(ckpt / f"transformer_{i}.pt"),
            "lr_codebook_path": str(ckpt / f"codebook_{i}.pt"),
            "hr_codebook_path": str(ckpt / f"codebook_{i + 1}.pt"),
            "temperature": 1.0, "num_beam": beams[0],
            "beam_width": beams[1]}
    config_path = tmp_path / "generate.json"
    config_path.write_text(json.dumps(config))
    return config_path, ckpt / "decoder.pt"


@pytest.mark.cuda
def test_graph_replay_matches_dispatched_two_seeds(cuda, cascade, tmp_path):
    """``generate.run`` on the card: two seeds replayed from one capture
    give the dispatched loop's tokens at each seed, and count the
    dispatched loop's launches."""
    from qaig_tpu_torch.infer import generate

    config_path, decoder_path = cascade
    cache = {}
    for seed in (3, 4):
        args = dict(device="cuda", config_path=str(config_path),
                    decoder_path=str(decoder_path), num_images=2, seed=seed,
                    out_dir=str(tmp_path / str(seed)))
        before = read_counts()
        fused = generate.run(dict(args, fused=True), cache=cache)
        fused_counts = [a - b for a, b in zip(read_counts(), before)]
        before = read_counts()
        dispatched = generate.run(dict(args, fused=False))
        assert torch.equal(fused.cpu(), dispatched.cpu()), seed
        assert fused_counts == [a - b for a, b in zip(read_counts(), before)]
    assert list(cache["runner"].graphs) == [2]


@pytest.mark.cuda
def test_pipeline_graphs_share_one_pool(cuda, cascade):
    """Graphs at two batch sizes in one pipeline's pool, replayed in turns,
    give the dispatched loop's images and tokens."""
    from qaig_tpu_torch.infer.pipeline import CascadePipeline

    config_path, decoder_path = cascade
    pipe = CascadePipeline.from_config(json.loads(config_path.read_text()),
                                       decoder_path, logging=print,
                                       device=cuda)
    for _ in range(2):
        for rows in (1, 3):
            img, tok = pipe.generate(rows, seed=rows)
            want_img, want_tok = pipe.generate(rows, seed=rows, fused=False)
            assert torch.equal(tok, want_tok)
            torch.testing.assert_close(img, want_img, atol=1e-5, rtol=0)
    assert sorted(pipe._graphs.graphs) == [(1, None), (3, None)]


@pytest.mark.cuda
def test_failed_capture_raises_on_the_card(cuda):
    """A function that reads a device value on the host cannot be
    captured: the runner raises, keeps no graph, counts nothing, and
    captures the next function."""
    runner = GraphRunner(cuda)
    x = torch.ones(4, device=cuda)
    before = read_counts()
    with pytest.raises(RuntimeError):
        runner("bad", lambda t: t * float(t.sum()), inputs=(x,))
    assert runner.graphs == {} and read_counts() == before
    assert torch.equal(runner("good", lambda t: (t * 2,), inputs=(x,))[0],
                       x * 2)


def test_serve_cli_takes_one_malloc_arena_on_cuda(monkeypatch, tmp_path):
    """The server's dispatcher thread captures the graphs, so on CUDA the
    CLI puts every thread in one malloc arena before any thread starts
    (and not on the CPU, where nothing is captured)."""
    from qaig_tpu_torch.cli import serve_generation

    calls = []
    monkeypatch.setattr(serve_generation, "one_malloc_arena",
                        lambda: calls.append(True))

    class Stop(Exception):
        pass

    def stop(*a, **kw):
        raise Stop
    monkeypatch.setattr("qaig_tpu_torch.train.common.load_config", stop)
    config = tmp_path / "gen.json"
    config.write_text("{}")
    for device, want in (("cpu", []), ("cuda", [True])):
        with pytest.raises((Stop, RuntimeError)):
            serve_generation.main(["--config-path", str(config),
                                   "--decoder-path", "d.pt", "--device",
                                   device])
        assert calls == want, device
