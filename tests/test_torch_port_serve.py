"""Serving in the PyTorch port (``qaig_tpu_torch.serve``,
``infer/pipeline.py``, ``infer/row_keys.py``, ``cli/serve_generation.py``)
against ``qaig_tpu``, on the CPU.

* The batcher and server behaviour tests of ``tests/test_serve.py`` that
  drive a fake pipeline run on BOTH packages (parametrised by module).
* Row keys: ``derive_row_keys`` row ``j`` depends only on (seed, start + j);
  the Gumbel-max sampler follows the softmax; the port's
  ``CascadePipeline.generate`` is composition-invariant.
* The pipeline gives ``qaig_tpu``'s greedy tokens (images atol 1e-4:
  float32 convolutions in another order) on checkpoints ``qaig_tpu`` wrote.
* The CLI end to end over HTTP (``--device cpu``), its stdlib PNG against
  PIL's, and its flags against the JAX CLI's.
"""

import base64
import importlib
import io
import json
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_serve import gen_config  # noqa: E402,F401  (fixture)
from test_torch_port_generate import _write_jax_checkpoints  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
PACKAGES = ["qaig_tpu", "qaig_tpu_torch"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(params=PACKAGES)
def pkg(request):
    """(serve module, pipeline module) of one package."""
    return (importlib.import_module(f"{request.param}.serve"),
            importlib.import_module(f"{request.param}.infer.pipeline"))


def _post(url, payload):
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req) as resp:
        return resp.status, json.loads(resp.read())


# ---------------------------------------------------------------------------
# batcher and server behaviour (tests/test_serve.py), on both packages
# ---------------------------------------------------------------------------

def test_request_batcher_coalesces_concurrent_requests(pkg):
    serve, pipeline = pkg
    calls = []
    # The batcher keys every dispatched row with ``derive_row_keys``; in
    # qaig_tpu that is a ``jax.vmap`` which compiles once per row count.
    # Warm the counts this test dispatches, so that the timed window holds
    # the batching and not those compiles.
    for n in range(1, 9):
        pipeline.derive_row_keys(0, n)

    class FakePipe:
        def generate(self, num, row_keys=None):
            calls.append(num)
            time.sleep(0.15)
            return (np.zeros((num, 3, 4, 4), np.float32),
                    np.zeros((num, 2), np.int32))

    batcher = serve.RequestBatcher(FakePipe(), max_batch=16,
                                   batch_multiple=1)
    results = [None] * 8

    def worker(i):
        results[i] = batcher.submit(1, seed=i)

    t0 = time.time()
    threads = [threading.Thread(target=worker, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    elapsed = time.time() - t0
    batcher.stop()
    for images, tokens in results:
        assert images.shape == (1, 3, 4, 4) and tokens.shape == (1, 2)
    assert len(calls) <= 3, calls
    assert elapsed < 0.15 * 8, f"serialized: {elapsed:.2f}s, {calls}"


def test_request_batcher_pads_to_multiple(pkg):
    serve, _ = pkg
    calls = []

    class FakePipe:
        def generate(self, num, row_keys=None):
            calls.append(num)
            return (np.zeros((num, 3, 2, 2), np.float32),
                    np.zeros((num, 2), np.int32))

    batcher = serve.RequestBatcher(FakePipe(), max_batch=16,
                                   batch_multiple=4)
    images, tokens = batcher.submit(3, seed=0)
    batcher.stop()
    assert images.shape[0] == 3 and tokens.shape[0] == 3
    assert calls == [4]


def test_request_batcher_solo_request_matches_pipeline_generate(pkg):
    serve, pipeline = pkg
    calls = []

    class FakePipe:
        def generate(self, num, row_keys=None):
            calls.append((num, np.asarray(row_keys)))
            return (np.zeros((num, 3, 2, 2), np.float32),
                    np.zeros((num, 2), np.int32))

    batcher = serve.RequestBatcher(FakePipe(), max_batch=16,
                                   batch_multiple=1)
    images, _ = batcher.submit(3, seed=7)
    batcher.stop()
    assert images.shape[0] == 3
    assert len(calls) == 1 and calls[0][0] == 3
    np.testing.assert_array_equal(calls[0][1],
                                  np.asarray(pipeline.derive_row_keys(7, 3)))


def test_request_batcher_sampling_is_composition_invariant(pkg):
    serve, _ = pkg

    class KeyedPipe:
        def generate(self, num, row_keys=None):
            time.sleep(0.15)
            keys = np.asarray(row_keys).astype(np.int64)
            tok = keys.sum(axis=1) % 97
            tok = np.stack([tok, tok + 1], axis=1).astype(np.int32)
            return np.zeros((num, 3, 2, 2), np.float32), tok

    batcher = serve.RequestBatcher(KeyedPipe(), max_batch=16,
                                   batch_multiple=4)
    _, solo = batcher.submit(3, seed=7)
    results = {}

    def call(name, num, seed):
        results[name] = batcher.submit(num, seed=seed)

    head = threading.Thread(target=call, args=("head", 1, 0))
    head.start()
    time.sleep(0.05)
    rest = [threading.Thread(target=call, args=("a", 3, 7)),
            threading.Thread(target=call, args=("b", 5, 123))]
    for t in rest:
        t.start()
    for t in rest + [head]:
        t.join()
    m = batcher.metrics()
    batcher.stop()
    assert m["coalesced_dispatches_total"] >= 1
    np.testing.assert_array_equal(results["a"][1], solo)


def test_request_batcher_max_batch_never_exceeded(pkg):
    serve, _ = pkg
    calls = []

    class FakePipe:
        def generate(self, num, row_keys=None):
            calls.append(num)
            return (np.zeros((num, 3, 2, 2), np.float32),
                    np.zeros((num, 2), np.int32))

    batcher = serve.RequestBatcher(FakePipe(), max_batch=20,
                                   batch_multiple=8)
    assert batcher.max_batch == 16
    results = [None] * 4

    def worker(i):
        results[i] = batcher.submit(4 + i, seed=i)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    batcher.stop()
    for i, (images, _) in enumerate(results):
        assert images.shape[0] == 4 + i
    assert max(calls) <= 16, calls


def test_server_backpressure_rejects_with_503(pkg):
    serve, _ = pkg

    class SlowPipe:
        def generate(self, num, row_keys=None):
            time.sleep(0.8)
            return (np.zeros((num, 3, 2, 2), np.float32),
                    np.zeros((num, 2), np.int32))

    server = serve.GenerationServer(SlowPipe(), port=0, max_batch=2,
                                    max_queue_rows=2)
    server.start()
    try:
        base = f"http://127.0.0.1:{server.port}"
        results = {}

        def post(name, num):
            try:
                results[name] = _post(base + "/generate",
                                      {"num_images": num, "seed": 1})
            except urllib.error.HTTPError as e:
                results[name] = (e.code, json.loads(e.read()),
                                 e.headers.get("Retry-After"))

        ta = threading.Thread(target=post, args=("a", 2))
        tb = threading.Thread(target=post, args=("b", 2))
        ta.start()
        time.sleep(0.3)
        tb.start()
        time.sleep(0.2)
        post("c", 1)
        ta.join()
        tb.join()
        code, body, retry_after = results["c"]
        assert code == 503 and "queue full" in body["error"]
        assert retry_after == "1"
        assert results["a"][0] == 200 and results["b"][0] == 200
        with urllib.request.urlopen(base + "/metrics") as resp:
            m = json.loads(resp.read())
        assert m["rejected_total"] == 1
        assert m["requests_total"] == 2
    finally:
        server.stop()


def test_request_batcher_queue_timeout(pkg):
    serve, _ = pkg

    class SlowPipe:
        def generate(self, num, row_keys=None):
            time.sleep(0.5)
            return (np.zeros((num, 3, 2, 2), np.float32),
                    np.zeros((num, 2), np.int32))

    batcher = serve.RequestBatcher(SlowPipe(), max_batch=2,
                                   request_timeout=0.15)
    results = {}

    def submit(name, num):
        try:
            results[name] = batcher.submit(num, seed=0)
        except serve.RequestTimeoutError:
            results[name] = "timeout"

    ta = threading.Thread(target=submit, args=("a", 2))
    ta.start()
    time.sleep(0.1)
    tb = threading.Thread(target=submit, args=("b", 2))
    tb.start()
    ta.join()
    tb.join()
    assert results["b"] == "timeout"
    images, _ = results["a"]
    assert images.shape[0] == 2
    m = batcher.metrics()
    batcher.stop()
    assert m["timeouts_total"] == 1
    assert m["queue_depth"] == 0


def test_request_batcher_groups_by_temperature(pkg):
    serve, _ = pkg
    calls = []

    class FakePipe:
        def generate(self, num, row_keys=None, temperature=None):
            time.sleep(0.3)
            calls.append((num, temperature))
            return (np.zeros((num, 3, 2, 2), np.float32),
                    np.zeros((num, 2), np.int32))

    batcher = serve.RequestBatcher(FakePipe(), max_batch=8)
    results = []

    def submit(num, temp):
        results.append(batcher.submit(num, seed=0, temperature=temp))

    t0 = threading.Thread(target=submit, args=(1, None))
    t0.start()
    time.sleep(0.1)
    threads = [threading.Thread(target=submit, args=(1, 2.0)),
               threading.Thread(target=submit, args=(1, None)),
               threading.Thread(target=submit, args=(1, 2.0))]
    for t in threads:
        t.start()
        time.sleep(0.05)
    t0.join()
    for t in threads:
        t.join()
    batcher.stop()
    assert len(results) == 4 and all(r[0].shape[0] == 1 for r in results)
    assert calls[0] == (1, None)
    assert sorted(calls[1:]) == [(1, None), (2, 2.0)], calls


def test_submit_after_stop_is_retryable(pkg):
    serve, _ = pkg

    class FakePipe:
        def generate(self, num, row_keys=None):
            return (np.zeros((num, 3, 2, 2), np.float32),
                    np.zeros((num, 2), np.int32))

    batcher = serve.RequestBatcher(FakePipe(), max_batch=4)
    batcher.stop()
    with pytest.raises(serve.ServerOverloadedError, match="shutting down"):
        batcher.submit(1, seed=0)


def test_request_batcher_concurrent_stress(pkg):
    import random
    serve, _ = pkg

    class FakePipe:
        def generate(self, num, row_keys=None, temperature=None):
            time.sleep(0.01)
            tok = np.arange(num, dtype=np.int32)[:, None].repeat(2, axis=1)
            return np.full((num, 3, 2, 2), float(num), np.float32), tok

    batcher = serve.RequestBatcher(FakePipe(), max_batch=16,
                                   batch_multiple=2)
    rng = random.Random(0)
    results = [None] * 40

    def worker(i, num, temp):
        results[i] = (num, batcher.submit(num, seed=i, temperature=temp))

    threads = []
    for i in range(40):
        num = rng.randint(1, 5)
        temp = rng.choice([None, 1.0, 2.0])
        t = threading.Thread(target=worker, args=(i, num, temp))
        threads.append(t)
        t.start()
    for t in threads:
        t.join()
    total_rows = 0
    for num, (images, tokens) in results:
        assert images.shape[0] == num and tokens.shape[0] == num
        assert (np.diff(tokens[:, 0]) == 1).all() or num == 1
        total_rows += num
    m = batcher.metrics()
    batcher.stop()
    assert m["requests_total"] == 40
    assert m["images_total"] == total_rows
    assert m["errors_total"] == 0 and m["queue_depth"] == 0
    assert m["dispatches_total"] <= 40


# ---------------------------------------------------------------------------
# row keys and the row-keyed sampler
# ---------------------------------------------------------------------------

def test_derive_row_keys_rows_depend_only_on_seed_and_index():
    from qaig_tpu_torch.infer.pipeline import derive_row_keys

    keys = derive_row_keys(7, 6)
    assert keys.shape == (6, 2) and keys.dtype == torch.int64
    assert int(keys.min()) >= 0 and int(keys.max()) < 2 ** 32
    for j in range(6):
        np.testing.assert_array_equal(derive_row_keys(7, 1, start=j)[0],
                                      keys[j])
    np.testing.assert_array_equal(derive_row_keys(7, 3, start=2),
                                  keys[2:5])
    assert len({tuple(k) for k in keys.tolist()}) == 6
    assert not torch.equal(derive_row_keys(8, 6), keys)
    # the serving batcher's padding rows never collide with request rows
    pad = derive_row_keys(0, 4, start=1 << 20)
    assert not {tuple(k) for k in pad.tolist()} & {
        tuple(k) for k in derive_row_keys(0, 64).tolist()}


def test_row_keyed_sampler_follows_the_softmax():
    """50,000 rows with distinct keys draw from one 8-way softmax through
    the engine's Gumbel-max draw: every category's count lies within 4
    standard deviations of N p (the keys are fixed, so the check is
    deterministic)."""
    from qaig_tpu_torch.infer import decode, row_keys
    from qaig_tpu_torch.infer.pipeline import derive_row_keys

    n = 50_000
    logits = torch.tensor([1.5, 0.2, -1.0, 0.7, 0.0, -2.5, 2.2, 0.9])
    keys = row_keys.fold_in(derive_row_keys(11, n), 3)
    draws = decode._categorical(logits.expand(n, 8),
                                row_keys.gumbel(keys, 8))
    counts = torch.bincount(draws, minlength=8).double()
    p = torch.softmax(logits.double(), 0)
    sigma = torch.sqrt(n * p * (1 - p))
    assert ((counts - n * p).abs() <= 4 * sigma).all(), (counts, n * p)
    # integer hashing only: the same bits for the same key, whatever else
    # is in the batch
    np.testing.assert_array_equal(
        row_keys.random_bits(keys[5:9], 8),
        row_keys.random_bits(keys, 8)[5:9])


def test_segment_noise_equals_the_per_step_fold():
    """The engine draws a segment's Gumbel noise in one pass; each slot's
    row is exactly the noise of ``fold_in(key, slot)``."""
    from qaig_tpu_torch.infer import decode, row_keys
    from qaig_tpu_torch.infer.pipeline import derive_row_keys

    keys = derive_row_keys(3, 5)
    noise = decode._SlotNoise(keys, 40, 6, 17)
    for slot in range(40, 46):
        np.testing.assert_array_equal(
            noise.at(slot), row_keys.gumbel(row_keys.fold_in(keys, slot),
                                            17))


# ---------------------------------------------------------------------------
# the pipeline against qaig_tpu's, and its composition invariance
# ---------------------------------------------------------------------------

@pytest.fixture
def greedy(monkeypatch):
    from qaig_tpu_torch.infer import decode as port_decode
    monkeypatch.setattr(
        jax.random, "categorical",
        lambda key, logits, axis=-1, **kw: jnp.argmax(logits, axis=axis))
    monkeypatch.setattr(port_decode, "_categorical",
                        lambda logits, rng: logits.argmax(dim=-1))


def _configs(case, gen_config, tmp_path):
    if case == "base":
        return gen_config
    args = _write_jax_checkpoints(tmp_path)
    return (json.loads(Path(args["config_path"]).read_text()),
            args["decoder_path"])


@pytest.mark.parametrize("case", ["base", "cascade"])
def test_pipeline_matches_jax_greedy(greedy, gen_config, tmp_path, case):
    """``CascadePipeline.generate`` with given stage-0 tokens: the greedy
    tokens of every row equal ``qaig_tpu``'s, the images within atol 1e-4.
    ``base``: ``tests/test_serve.py``'s one-stage config; ``cascade``: a
    base stage and a windowed encoder stage (window 8)."""
    from qaig_tpu.infer.pipeline import CascadePipeline as JaxPipeline
    from qaig_tpu_torch.infer.pipeline import CascadePipeline

    config, decoder_path = _configs(case, gen_config, tmp_path)
    init = np.array([[3], [1], [5]], dtype=np.int64)
    want_img, want_tok = JaxPipeline.from_config(
        config, decoder_path, logging=lambda m: None).generate(
            3, seed=2, init_tokens=jnp.asarray(init, jnp.int32))
    pipe = CascadePipeline.from_config(config, decoder_path,
                                       logging=_no_log, device="cpu")
    img, tok = pipe.generate(3, seed=2, init_tokens=init)
    assert img.dtype == torch.float32 and tok.shape == want_tok.shape
    np.testing.assert_array_equal(tok.numpy(), np.asarray(want_tok))
    np.testing.assert_allclose(img.numpy(), np.asarray(want_img), atol=1e-4)


def _no_log(msg):
    raise AssertionError(f"unexpected loader message: {msg}")


@pytest.mark.parametrize("case", ["base", "cascade"])
def test_pipeline_row_keys_composition_invariance(gen_config, tmp_path,
                                                  case):
    """At temperature 1, the rows of a request inside a merged batch (with
    another request and padding rows keyed as the server keys them) equal
    its solo run: tokens exactly, images to float32 rounding."""
    from qaig_tpu_torch.infer.pipeline import (CascadePipeline,
                                               derive_row_keys)

    config, decoder_path = _configs(case, gen_config, tmp_path)
    pipe = CascadePipeline.from_config(config, decoder_path,
                                       logging=_no_log, device="cpu")
    solo_img, solo_tok = pipe.generate(2, seed=5)
    other_img, other_tok = pipe.generate(3, seed=9)
    merged = torch.cat([derive_row_keys(5, 2), derive_row_keys(9, 3),
                        derive_row_keys(0, 3, start=1 << 20)])
    img, tok = pipe.generate(8, row_keys=merged)
    np.testing.assert_array_equal(tok[:2].numpy(), solo_tok.numpy())
    np.testing.assert_array_equal(tok[2:5].numpy(), other_tok.numpy())
    np.testing.assert_allclose(img[:2].numpy(), solo_img.numpy(), atol=1e-6)
    np.testing.assert_allclose(img[2:5].numpy(), other_img.numpy(),
                               atol=1e-6)
    # and the keys matter: another seed gives other tokens
    assert not torch.equal(pipe.generate(2, seed=6)[1], solo_tok)


# ---------------------------------------------------------------------------
# PNG, CLI flags and the CLI end to end over HTTP
# ---------------------------------------------------------------------------

def test_png_pixels_equal_pils_render():
    from PIL import Image
    from qaig_tpu.serve import _render_png as pil_render
    from qaig_tpu_torch.serve import _render_png

    rng = np.random.default_rng(0)
    image = rng.uniform(-1.2, 1.2, (3, 9, 13)).astype(np.float32)
    mine = Image.open(io.BytesIO(_render_png(image)))
    theirs = Image.open(io.BytesIO(pil_render(image)))
    assert mine.mode == "RGB" and mine.size == (13, 9)
    np.testing.assert_array_equal(np.asarray(mine), np.asarray(theirs))


REFUSED = ("--compilation-cache-dir", "--compiler-options")


def test_serve_cli_flags_match_jax_cli(monkeypatch, capsys, tmp_path):
    """Every flag has the JAX CLI's name, type, default and required-ness
    (``--device`` narrows its choices); the XLA flags are refused with an
    error naming XLA, and ``--shard-batch`` / ``--num-model-shards`` are
    taken (``tests/test_torch_port_serve_sharded.py`` drives them);
    ``--device cuda`` (the default) raises where no GPU is visible, with
    or without them."""
    import argparse
    from qaig_tpu.cli import serve_generation as jax_cli
    from qaig_tpu_torch.cli import serve_generation as cli

    class Captured(Exception):
        pass

    def capture(self, *a, **kw):
        raise Captured(self)

    with monkeypatch.context() as patch:
        patch.setattr(argparse.ArgumentParser, "parse_args", capture)
        tables = []
        for main in (jax_cli.main, lambda: cli.main([])):
            with pytest.raises(Captured) as info:
                main()
            tables.append({a.dest: a for a in info.value.args[0]._actions
                           if a.dest != "help"})
    theirs, mine = tables
    assert set(mine) == set(theirs)
    for dest, action in mine.items():
        other = theirs[dest]
        assert action.option_strings == other.option_strings, dest
        assert action.required == other.required, dest
        assert type(action) is type(other), dest
        if dest == "device":
            assert set(action.choices) < set(other.choices), dest
            assert action.default == "cuda"
            continue
        assert action.default == other.default, dest
        assert getattr(action.type, "__name__", action.type) == \
            getattr(other.type, "__name__", other.type), dest

    config = tmp_path / "gen.json"
    config.write_text("{}")
    required = ["--config-path", str(config), "--decoder-path", "d.pt"]
    for flag, value in zip(REFUSED, (["cache"], ["a=1"])):
        with pytest.raises(SystemExit):
            cli.main(required + [flag] + value)
        err = capsys.readouterr().err
        assert f"{flag}: " in err and "XLA-only" in err, (flag, err)
    if torch.cuda.is_available():
        return
    for extra in ([], ["--shard-batch"], ["--num-model-shards", "2"]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main(required + extra)


def test_serve_cli_end_to_end_over_http(gen_config, tmp_path):
    """``python -m qaig_tpu_torch.cli.serve_generation --device cpu``:
    /healthz, concurrent /generate requests (one returns images), a
    request's tokens equal to the same request again, /metrics in JSON and
    Prometheus text, 400s, and SIGTERM during a request: the client still
    gets its 200, the process prints ``drained; bye.`` and exits 0."""
    config, decoder_path = gen_config
    cfg_path = tmp_path / "gen.json"
    cfg_path.write_text(json.dumps(config))
    proc = subprocess.Popen(
        [sys.executable, "-m", "qaig_tpu_torch.cli.serve_generation",
         "--device", "cpu", "--config-path", str(cfg_path),
         "--decoder-path", decoder_path, "--port", "0", "--max-batch", "4",
         "--warmup-batch", "1"],
        cwd=REPO, text=True, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT)
    lines = []
    pump = threading.Thread(target=lambda: lines.extend(proc.stdout),
                            daemon=True)
    pump.start()
    try:
        deadline = time.monotonic() + 120
        while not any("serving on http" in ln for ln in lines):
            assert proc.poll() is None, "".join(lines)[-2000:]
            assert time.monotonic() < deadline, "server never came up"
            time.sleep(0.2)
        serving = next(ln for ln in lines if "serving on http" in ln)
        base = f"http://127.0.0.1:{int(serving.rsplit(':', 1)[1])}"
        assert any("warmed up at batch 1" in ln for ln in lines)
        with urllib.request.urlopen(base + "/healthz") as resp:
            assert json.loads(resp.read()) == {"status": "ok"}

        results = {}

        def post(name, payload):
            results[name] = _post(base + "/generate", payload)

        threads = [threading.Thread(target=post, args=(
            i, {"num_images": num, "seed": 10 + i,
                "return_images": i == 0}))
            for i, num in enumerate((1, 2, 3, 2))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        for i, num in enumerate((1, 2, 3, 2)):
            status, out = results[i]
            tokens = np.asarray(out["tokens"])
            assert status == 200 and tokens.shape == (num, 4)
            assert tokens.min() >= 0 and tokens.max() < 8
            assert out["shape"] == [num, 3, 8, 8]
        from PIL import Image
        img = Image.open(io.BytesIO(base64.b64decode(
            results[0][1]["images_png_b64"][0])))
        assert img.size == (8, 8) and img.mode == "RGB"
        _, again = _post(base + "/generate", {"num_images": 3, "seed": 12})
        assert again["tokens"] == results[2][1]["tokens"]

        for payload in ({"num_images": 99}, {"temperature": 0.05},
                        {"temperature": "hot"}):
            with pytest.raises(urllib.error.HTTPError) as info:
                _post(base + "/generate", payload)
            assert info.value.code == 400
        with urllib.request.urlopen(base + "/metrics") as resp:
            m = json.loads(resp.read())
        assert m["requests_total"] == 5 and m["images_total"] == 11
        assert m["errors_total"] == 0 and m["queue_depth"] == 0
        assert sum(e["count"] for e in
                   m["dispatches_by_batch"].values()) == m["dispatches_total"]
        with urllib.request.urlopen(base + "/metrics?format=prometheus") \
                as resp:
            text = resp.read().decode()
        assert "qaig_requests_total 5" in text
        assert "# TYPE qaig_images_total counter" in text

        late = threading.Thread(target=post, args=(
            "late", {"num_images": 4, "seed": 1, "temperature": 2.0}))
        late.start()
        time.sleep(0.05)
        proc.terminate()
        late.join(timeout=60)
        assert results["late"][0] == 200
        assert proc.wait(timeout=60) == 0, "".join(lines)[-2000:]
        pump.join(timeout=10)
        assert "drained; bye." in "".join(lines)
    finally:
        if proc.poll() is None:
            proc.kill()
