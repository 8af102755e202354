"""Serving over several devices in one process in the PyTorch port
(``qaig_tpu_torch/parallel/local.py``, ``CascadePipeline(mesh=...)``, the
serve CLI's ``--shard-batch`` / ``--num-model-shards``) against
``qaig_tpu``, on the CPU.

The port's meshes repeat the ``cpu`` device (``LocalMesh(devices=["cpu"]
* 8)``), as ``qaig_tpu``'s run on the 8 virtual CPU devices of
``tests/conftest.py``:

* greedy tokens of the port's pipeline on a data 8 and a data 4 x model 2
  mesh equal ``qaig_tpu``'s pipeline on the same meshes and checkpoints
  (``tests/test_serve.py``'s sharded-serving cases, through the server);
  exactly;
* the port's sharded pipeline equals its unsharded one: row-keyed at
  temperature 1 (data only, dispatched and fused), greedy under tensor
  parallelism, and batch-keyed ``generate_tokens`` (the draws sliced per
  replica, the generator left where one replica leaves it); exactly;
* the in-process TP ``mlp2`` and ``packed_qkv`` within 1e-6 of the
  unsharded ones in float32, each shard holding its slice;
* the server pads a 3-image request to the mesh multiple and returns 3
  rows; ``fused=True`` with a model axis above 1 raises;
* the CLI: ``--device cpu --shard-batch`` serves over ``data=1 x
  model=1`` (``/metrics`` reports the mesh) and ``--num-model-shards 2``
  exits with ``qaig_tpu``'s "must divide the chip count" message.
"""

import json
import subprocess
import sys
import threading
import time
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
CPU8 = ["cpu"] * 8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
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
                        lambda logits, rng: logits.argmax(dim=-1))


def _post(url, payload):
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req) as resp:
        return resp.status, json.loads(resp.read())


def _configs(case, gen_config, tmp_path):
    if case == "base":
        return gen_config
    args = _write_jax_checkpoints(tmp_path)
    return (json.loads(Path(args["config_path"]).read_text()),
            args["decoder_path"])


def _pipe(config, decoder_path, mesh=None):
    from qaig_tpu_torch.infer.pipeline import CascadePipeline
    return CascadePipeline.from_config(config, decoder_path,
                                       logging=lambda m: None, device="cpu",
                                       mesh=mesh)


def _mesh(n_data, n_model=1):
    from qaig_tpu_torch.parallel.local import LocalMesh
    return LocalMesh(n_data=n_data, n_model=n_model, devices=CPU8)


# ---------------------------------------------------------------------------
# the mesh
# ---------------------------------------------------------------------------

def test_local_mesh_lays_devices_out_row_major():
    """``(data, model)`` as ``np.asarray(devices).reshape(n_data,
    n_model)``; the first ``n_data * n_model`` devices; blocks of ``n /
    n_data`` rows; too few devices, or a batch that is not a multiple of
    the data axis, raise."""
    from qaig_tpu_torch.parallel.local import LocalMesh

    devices = [torch.device("cpu", i) for i in range(8)]
    mesh = LocalMesh(n_data=3, n_model=2, devices=devices)
    want = np.asarray(devices[:6], dtype=object).reshape(3, 2)
    assert mesh.grid == [list(row) for row in want]
    assert mesh.describe() == "data=3 x model=2"
    assert mesh.batch_blocks(6) == [(0, 2), (2, 4), (4, 6)]
    assert LocalMesh(n_model=4, devices=devices).shape == {"data": 2,
                                                            "model": 4}
    with pytest.raises(ValueError, match="not a multiple"):
        mesh.batch_blocks(7)
    with pytest.raises(ValueError, match="needs 9 devices, have 8"):
        LocalMesh(n_data=3, n_model=3, devices=devices)


# ---------------------------------------------------------------------------
# in-process tensor parallelism
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_model", [2, 4])
def test_local_tp_mlp2_and_packed_qkv_match_unsharded(n_model):
    """``shard_mlps_local_`` over ``n_model`` devices: shard ``i`` holds
    ``l0``'s rows ``i`` and ``l1``'s columns ``i`` (``l1.bias`` whole, on
    shard 0); ``mlp2`` (act on the first layer, and on both) and the
    packed QKV projections are within 1e-6 of the unsharded module's in
    float32."""
    import copy
    from qaig_tpu_torch.models import blocks, core
    from qaig_tpu_torch.ops.activations import get_activation
    from qaig_tpu_torch.parallel.local import shard_mlps_local_

    gen = torch.Generator().manual_seed(0)
    d, hidden = 16, 32
    full = core.init_parameters(blocks.QKV(d, hidden, d), gen)
    sharded = shard_mlps_local_(copy.deepcopy(full), ["cpu"] * n_model)
    k = hidden // n_model
    for name in ("q", "k", "v"):
        m, ref = getattr(sharded, name), getattr(full, name)
        shards = [m] + m.tp.parts
        assert len(shards) == n_model
        for i, shard in enumerate(shards):
            torch.testing.assert_close(shard.l0.weight,
                                       ref.l0.weight[i * k:(i + 1) * k],
                                       rtol=0, atol=0)
            torch.testing.assert_close(shard.l0.bias,
                                       ref.l0.bias[i * k:(i + 1) * k],
                                       rtol=0, atol=0)
            torch.testing.assert_close(shard.l1.weight,
                                       ref.l1.weight[:, i * k:(i + 1) * k],
                                       rtol=0, atol=0)
        torch.testing.assert_close(m.l1.bias, ref.l1.bias, rtol=0, atol=0)
    act = get_activation("silu")
    x = torch.randn(3, 5, d, generator=gen)
    for act_last in (False, True):
        torch.testing.assert_close(
            core.mlp2(sharded.q, x, act, act_last=act_last),
            core.mlp2(full.q, x, act, act_last=act_last), rtol=0, atol=1e-6)
    got = blocks.packed_qkv(blocks.pack_qkv(sharded), x, act)
    want = blocks.packed_qkv(blocks.pack_qkv(full), x, act)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# the sharded pipeline against qaig_tpu's and against its unsharded self
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_data,n_model", [(8, 1), (4, 2)])
def test_sharded_pipeline_matches_jax_greedy(greedy, gen_config, n_data,
                                             n_model):
    """``tests/test_serve.py``'s data 8 and data 4 x model 2 serving cases
    on both packages: each pipeline on its mesh behind its server, 8
    images of seed 11 at greedy; the port's tokens equal ``qaig_tpu``'s,
    and equal the port's unsharded pipeline's.  Greedy rows depend only on
    the stage-0 grid, which the two packages draw from different RNGs, so
    both pipelines get the same grid (``init_tokens``) for the token
    check."""
    from qaig_tpu.infer.pipeline import CascadePipeline as JaxPipeline
    from qaig_tpu.parallel.mesh import make_mesh
    from qaig_tpu_torch.serve import GenerationServer

    config, decoder_path = gen_config
    jax_mesh = make_mesh(n_data=n_data, n_model=n_model)
    jax_pipe = JaxPipeline.from_config(config, decoder_path,
                                       logging=lambda m: None, mesh=jax_mesh)
    pipe = _pipe(config, decoder_path, _mesh(n_data, n_model))
    init = np.arange(8, dtype=np.int64)[:, None] % 8
    _, want = jax_pipe.generate(8, seed=11,
                                init_tokens=jnp.asarray(init, jnp.int32))
    _, tokens = pipe.generate(8, seed=11, init_tokens=init)
    np.testing.assert_array_equal(tokens.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        tokens.numpy(),
        _pipe(config, decoder_path).generate(8, seed=11,
                                             init_tokens=init)[1].numpy())

    server = GenerationServer(pipe, port=0, max_batch=32,
                              batch_multiple=n_data)
    server.start()
    try:
        status, out = _post(f"http://127.0.0.1:{server.port}/generate",
                            {"num_images": 8, "seed": 11})
    finally:
        server.stop()
    assert status == 200
    _, plain = _pipe(config, decoder_path).generate(8, seed=11)
    np.testing.assert_array_equal(np.asarray(out["tokens"]), plain.numpy())


@pytest.mark.parametrize("case", ["base", "cascade"])
@pytest.mark.parametrize("fused", [False, True])
def test_data_sharded_pipeline_equals_unsharded(gen_config, tmp_path, case,
                                                fused):
    """Row-keyed at temperature 1, data 8 (``base``) or data 4
    (``cascade``: a base stage and a windowed encoder stage): the tokens
    and images of 8 rows equal the unsharded pipeline's, dispatched and
    fused (on the CPU, eagerly), on the first replica's device."""
    config, decoder_path = _configs(case, gen_config, tmp_path)
    n_data = 8 if case == "base" else 4
    pipe = _pipe(config, decoder_path, _mesh(n_data))
    assert len(pipe.replicas) == n_data and pipe.replicas[0] is pipe
    images, tokens = pipe.generate(8, seed=3, fused=fused)
    want_images, want = _pipe(config, decoder_path).generate(8, seed=3)
    np.testing.assert_array_equal(tokens.numpy(), want.numpy())
    np.testing.assert_allclose(images.numpy(), want_images.numpy(),
                               atol=1e-6)
    with pytest.raises(ValueError, match="multiple of the mesh's data"):
        pipe.generate(n_data + 1, seed=3)


@pytest.mark.parametrize("case", ["base", "cascade"])
def test_tensor_parallel_pipeline_equals_unsharded_greedy(
        greedy, gen_config, tmp_path, case):
    """Data 4 x model 2 (every stage MLP, pos-cond and classifier split,
    l0 of hidden/2 rows on each shard), greedy: tokens equal the unsharded
    pipeline's; generation is dispatched and ``fused=True`` raises with
    ``qaig_tpu``'s message."""
    from qaig_tpu_torch.models import core

    config, decoder_path = _configs(case, gen_config, tmp_path)
    pipe = _pipe(config, decoder_path, _mesh(4, 2))
    for replica in pipe.replicas:
        model = replica.stages[0].engine.model
        mlps = [m for m in model.modules() if isinstance(m, core.MLP2)]
        assert mlps and all(
            m.l0.weight.shape[0] * 2 == model.cfg.hidden_dim
            and len(m.tp.parts) == 1 for m in mlps)
        assert replica._graphs is None
    _, tokens = pipe.generate(8, seed=5)
    _, want = _pipe(config, decoder_path).generate(8, seed=5)
    np.testing.assert_array_equal(tokens.numpy(), want.numpy())
    with pytest.raises(ValueError, match="unsharded, unconditioned"):
        pipe.generate(8, seed=5, fused=True)


@pytest.mark.parametrize("case", ["base", "cascade"])
def test_batch_keyed_generate_tokens_over_data_2_equals_unsharded(
        gen_config, tmp_path, case):
    """``generate_tokens(rng=...)`` over data 2: each replica draws from a
    copy of the generator and keeps its rows of every draw, so the final
    and per-stage tokens equal one pipeline's, and the caller's generator
    ends where one pipeline's does."""
    config, decoder_path = _configs(case, gen_config, tmp_path)
    pipe = _pipe(config, decoder_path, _mesh(2))
    plain = _pipe(config, decoder_path)
    rng = torch.Generator().manual_seed(21)
    ref_rng = torch.Generator().manual_seed(21)
    tokens, stages = pipe.generate_tokens(4, rng=rng)
    want, want_stages = plain.generate_tokens(4, rng=ref_rng)
    np.testing.assert_array_equal(tokens.numpy(), want.numpy())
    assert len(stages) == len(want_stages)
    for a, b in zip(stages, want_stages):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert torch.equal(rng.get_state(), ref_rng.get_state())


@pytest.mark.parametrize("n_data,n_model", [(1, 1), (2, 1), (2, 2)])
def test_pipeline_is_freed_without_the_cycle_collector(gen_config, n_data,
                                                       n_model):
    """Dropping the last reference to a pipeline frees every replica at
    once: no reference cycle leaves its CUDA graphs to a later garbage
    collection, which can fall inside another capture and invalidate
    it."""
    import gc
    import weakref

    config, decoder_path = gen_config
    pipe = _pipe(config, decoder_path,
                 _mesh(n_data, n_model) if n_data * n_model > 1 else None)
    refs = [weakref.ref(r) for r in pipe.replicas]
    assert len(refs) == n_data
    gc.disable()
    try:
        del pipe
        assert [r() for r in refs] == [None] * n_data
    finally:
        gc.enable()


def test_server_pads_to_the_mesh_multiple(gen_config):
    """A 3-image request on a data 8 pipeline: the dispatch is padded to 8
    rows, 3 come back, equal to the unsharded ``generate(3, seed=4)``;
    ``/metrics`` reports the mesh."""
    from qaig_tpu_torch.serve import GenerationServer

    config, decoder_path = gen_config
    pipe = _pipe(config, decoder_path, _mesh(8))
    server = GenerationServer(pipe, port=0, max_batch=16, batch_multiple=8)
    server.start()
    try:
        base = f"http://127.0.0.1:{server.port}"
        status, out = _post(base + "/generate", {"num_images": 3, "seed": 4})
        with urllib.request.urlopen(base + "/metrics") as resp:
            metrics = json.loads(resp.read())
    finally:
        server.stop()
    assert status == 200
    _, want = _pipe(config, decoder_path).generate(3, seed=4)
    np.testing.assert_array_equal(np.asarray(out["tokens"]), want.numpy())
    assert metrics["padded_rows_total"] == 5
    assert metrics["dispatches_by_batch"] == {
        "8": {"count": 1, "seconds_total": pytest.approx(
            metrics["dispatch_seconds_total"])}}
    assert metrics["mesh"] == {"data": 8, "model": 1,
                               "devices": [["cpu"]] * 8}


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

def test_serve_cli_num_model_shards_must_divide_the_chip_count(
        gen_config, tmp_path):
    """``--num-model-shards 2`` on ``--device cpu`` (one chip) exits with
    ``qaig_tpu``'s message before it loads anything."""
    from qaig_tpu_torch.cli import serve_generation as cli

    config, decoder_path = gen_config
    cfg_path = tmp_path / "gen.json"
    cfg_path.write_text(json.dumps(config))
    with pytest.raises(SystemExit) as info:
        cli.main(["--device", "cpu", "--config-path", str(cfg_path),
                  "--decoder-path", decoder_path, "--num-model-shards", "2"])
    assert str(info.value) == ("--num-model-shards 2 must divide the chip "
                               "count (1)")


def test_serve_cli_shard_batch_serves_over_one_cpu(gen_config, tmp_path):
    """``--device cpu --shard-batch --warmup-batch 1``: prints ``serving
    over 1 chips: data=1 x model=1``, answers a 2-image request with the
    tokens of ``generate(2, seed=6)``, reports the mesh in ``/metrics``,
    and drains on SIGTERM."""
    config, decoder_path = gen_config
    cfg_path = tmp_path / "gen.json"
    cfg_path.write_text(json.dumps(config))
    proc = subprocess.Popen(
        [sys.executable, "-m", "qaig_tpu_torch.cli.serve_generation",
         "--device", "cpu", "--shard-batch", "--config-path", str(cfg_path),
         "--decoder-path", decoder_path, "--port", "0",
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
        assert any(ln.strip() == "serving over 1 chips: data=1 x model=1"
                   for ln in lines), "".join(lines)
        serving = next(ln for ln in lines if "serving on http" in ln)
        base = f"http://127.0.0.1:{int(serving.rsplit(':', 1)[1])}"
        status, out = _post(base + "/generate", {"num_images": 2, "seed": 6})
        assert status == 200
        _, want = _pipe(config, decoder_path).generate(2, seed=6)
        np.testing.assert_array_equal(np.asarray(out["tokens"]),
                                      want.numpy())
        with urllib.request.urlopen(base + "/metrics") as resp:
            metrics = json.loads(resp.read())
        assert metrics["mesh"] == {"data": 1, "model": 1,
                                   "devices": [["cpu"]]}
        proc.terminate()
        assert proc.wait(timeout=60) == 0, "".join(lines)[-2000:]
        pump.join(timeout=10)
        assert "drained; bye." in "".join(lines)
    finally:
        if proc.poll() is None:
            proc.kill()
