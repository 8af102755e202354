"""``generate.run`` over an in-process mesh in the PyTorch port
(``qaig_tpu_torch/infer/generate.py``, ``parallel/local.py``), on the CPU.

Without ``--multihost`` the generation mesh is a ``LocalMesh`` over the
process's devices, as ``qaig_tpu``'s is over every local chip; the tests
repeat the ``cpu`` device, as ``tests/test_torch_port_serve_sharded.py``
does.  On ``qaig_tpu``'s checkpoints of a two-stage cascade (a base stage
and a windowed encoder stage, ``tests/test_torch_port_generate.py``):

* the dispatched loop at data 2 and at data 1 x model 2, and the fused
  cascade at data 2 (a replica a device, each drawing its rows), at
  greedy and at temperature 1: the tokens equal one device's exactly
  (every draw is the one-device draw, sliced per replica);
* the fused cascade at data 2 and data 4 gives ``qaig_tpu``'s sharded
  (dispatched) ``generate``'s tokens at greedy;
* the run prints ``Generation mesh: data=D x model=M``;
* ``fused=True`` with a model axis of 2 or under ``--multihost`` raises;
* with ``cache``, a second call loads nothing and, over stub graphs
  (``tests/test_torch_port_graphs.py::stub_cuda``), captures nothing: one
  graph a replica, each holding the replica's own generator;
* the data axis is the largest divisor of ``num_images`` that fits: 6
  images over 4 devices give data 3, with ``qaig_tpu``'s idle warning.

The ``cuda``-marked test runs data 2 on ``cuda:0`` twice (fused by
default: two captures, then a replay) against ``--no-fused`` and one
card.  This file imports JAX only inside the CPU tests' fixtures, so on
a machine with the card and without JAX:

    python -m pytest tests/test_torch_port_generate_mesh.py -q -m cuda \
        --noconftest
"""

import logging
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_port_graphs import cascade, cuda, stub_cuda  # noqa: E402,F401

# the stage-0 conditioning grid of four images (one LR token an image)
INIT_TOKENS = np.array([[3], [1], [5], [0]], dtype=np.int64)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def gen_args(tmp_path_factory):
    from test_torch_port_generate import _write_jax_checkpoints
    root = tmp_path_factory.mktemp("mesh_ckpts")
    return dict(_write_jax_checkpoints(root), device="cpu", seed=4)


def _run(args, tmp_path, name, **kw):
    from qaig_tpu_torch.infer import generate
    return generate.run(dict(args, out_dir=str(tmp_path / name)), **kw)


@pytest.mark.parametrize("greedy", [True, False],
                         ids=["greedy", "temperature_1"])
@pytest.mark.parametrize("n_data,n_model", [(2, 1), (1, 2)],
                         ids=["data2", "model2"])
def test_mesh_tokens_equal_one_device(gen_args, tmp_path, monkeypatch,
                                      capsys, greedy, n_data, n_model):
    from qaig_tpu_torch.infer import decode as port_decode
    if greedy:
        monkeypatch.setattr(port_decode, "_categorical",
                            lambda logits, generator: logits.argmax(dim=-1))
    args = dict(gen_args, num_images=4, num_model_shards=n_model)
    want = _run(dict(args, num_model_shards=1), tmp_path, "one")
    assert "Generation mesh: data=1 x model=1" in capsys.readouterr().out
    got = _run(args, tmp_path, "mesh", devices=["cpu"] * 2)
    out = capsys.readouterr().out
    assert f"Generation mesh: data={n_data} x model={n_model}" in out
    assert "Fused" not in out
    assert got.shape == want.shape == (4, 16)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    assert (tmp_path / "mesh" / "images" / "recon_model_1.jpg").exists()


def _greedy(monkeypatch):
    from qaig_tpu_torch.infer import decode as port_decode
    monkeypatch.setattr(port_decode, "_categorical",
                        lambda logits, generator: logits.argmax(dim=-1))


@pytest.mark.parametrize("greedy", [True, False],
                         ids=["greedy", "temperature_1"])
def test_fused_mesh_tokens_equal_one_device(gen_args, tmp_path, monkeypatch,
                                            capsys, greedy):
    """``fused=True`` over ``["cpu"] * 2``: each replica runs the fused
    cascade for its two images, drawing its rows of the one-device draws,
    so the tokens equal one device's fused and dispatched runs."""
    if greedy:
        _greedy(monkeypatch)
    args = dict(gen_args, num_images=4)
    want = _run(args, tmp_path, "one")
    one_fused = _run(dict(args, fused=True), tmp_path, "one_fused")
    capsys.readouterr()
    got = _run(dict(args, fused=True), tmp_path, "mesh", devices=["cpu"] * 2)
    out = capsys.readouterr().out
    assert "Generation mesh: data=2 x model=1" in out
    assert ("Fused single-dispatch cascade: 2 stages, a graph on each of 2 "
            "replicas") in out
    assert got.shape == want.shape == (4, 16)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    np.testing.assert_array_equal(got.numpy(), one_fused.numpy())
    for grid in ("recon_model_Cond", "recon_model_0", "recon_model_1"):
        assert (tmp_path / "mesh" / "images" / f"{grid}.jpg").exists()


@pytest.fixture(scope="module")
def jax_sharded_greedy(gen_args, tmp_path_factory):
    """``qaig_tpu``'s ``generate`` at greedy over its 8-device CPU mesh
    (4 images: data 4, dispatched), conditioned on ``INIT_TOKENS``."""
    import jax
    import jax.numpy as jnp
    from qaig_tpu.infer import generate as jax_generate

    with pytest.MonkeyPatch.context() as patch:
        patch.setattr(jax.random, "categorical",
                      lambda key, logits, axis=-1, **kw:
                      jnp.argmax(logits, axis=axis))
        patch.setattr(jax.random, "randint",
                      lambda *a, **kw: jnp.asarray(INIT_TOKENS, jnp.int32))
        out = tmp_path_factory.mktemp("jax_sharded")
        tokens = jax_generate.run(dict(gen_args, num_images=4,
                                       out_dir=str(out)))
    return np.asarray(tokens)


@pytest.mark.parametrize("n_data", [2, 4], ids=["data2", "data4"])
def test_fused_mesh_matches_qaig_tpu_sharded_greedy(
        gen_args, jax_sharded_greedy, tmp_path, monkeypatch, n_data):
    """At greedy, on the same stage-0 grid, the port's fused mesh gives
    ``qaig_tpu``'s sharded ``generate``'s tokens."""
    from qaig_tpu_torch.infer import decode, generate

    _greedy(monkeypatch)

    def init_rows(shape, high, draw):
        rows = torch.from_numpy(INIT_TOKENS.copy())
        if isinstance(draw, decode.RowSlice):
            rows = rows[draw.index * shape[0]:(draw.index + 1) * shape[0]]
        assert rows.shape == shape
        return rows
    monkeypatch.setattr(generate, "_random_tokens", init_rows)
    got = _run(dict(gen_args, num_images=4, fused=True), tmp_path, "mesh",
               devices=["cpu"] * n_data)
    np.testing.assert_array_equal(got.numpy(), jax_sharded_greedy)


@pytest.mark.parametrize("how", ["model2", "multihost"])
def test_fused_on_a_larger_mesh_raises(gen_args, tmp_path, monkeypatch,
                                       how):
    """``--fused`` needs one process and a model axis of 1, as in
    ``qaig_tpu``: a model axis of 2, or a run over several processes,
    raises before anything loads."""
    from qaig_tpu_torch.parallel import comm
    args = dict(gen_args, num_images=4, fused=True)
    if how == "model2":
        args["num_model_shards"] = 2
    else:
        monkeypatch.setattr(comm, "world_size", lambda: 2)
    with pytest.raises(ValueError, match="--fused requires unsharded"):
        _run(args, tmp_path, "f", devices=["cpu"] * 2)


def test_fused_mesh_cache_captures_once(gen_args, tmp_path, monkeypatch,
                                        stub_cuda):
    """With ``cache``, a data-2 mesh whose replicas run from graph runners
    (stub graphs: a capture runs the cascade on the CPU) captures one graph
    a replica at the first call, each holding its replica's own
    ``torch.Generator`` (the one its ``RowSlice`` draws from), and at the
    second call replays them: nothing loaded, nothing captured."""
    from qaig_tpu_torch.infer import decode, generate
    from qaig_tpu_torch.infer.graphs import GraphRunner

    monkeypatch.setattr(generate, "_runner",
                        lambda home, decoder, stages, dtype:
                        GraphRunner(home))
    captures = []
    capture = GraphRunner.capture

    def counting(self, *a, **kw):
        captures.append(self)
        return capture(self, *a, **kw)
    monkeypatch.setattr(GraphRunner, "capture", counting)
    args = dict(gen_args, num_images=4)
    want = _run(args, tmp_path, "one")
    cache = {}
    first = _run(dict(args, fused=True), tmp_path, "a", devices=["cpu"] * 2,
                 cache=cache)
    replicas = cache["replicas"]
    assert len(replicas) == 2
    assert replicas[1]["stages"][0]["model"] is not \
        replicas[0]["stages"][0]["model"]
    assert captures == [r["runner"] for r in replicas]
    for d, replica in enumerate(replicas):
        draw = replica["draw"]
        assert isinstance(draw, decode.RowSlice)
        assert (draw.index, draw.count) == (d, 2)
        assert draw.generator is replica["generator"]
        graph = replica["runner"].graphs[2]
        assert graph.graph.generators == [replica["generator"]]
        assert graph.graph.replays == 1
    np.testing.assert_array_equal(first.numpy(), want.numpy())

    def no_load(*a, **kw):
        raise AssertionError("the cached cascade was loaded again")
    monkeypatch.setattr(generate, "_load_stage", no_load)
    again = _run(dict(args, fused=True), tmp_path, "b", devices=["cpu"] * 2,
                 cache=cache)
    assert len(captures) == 2 and cache["replicas"] is replicas
    assert [r["runner"].graphs[2].graph.replays for r in replicas] == [2, 2]
    np.testing.assert_array_equal(again.numpy(), want.numpy())


def test_data_axis_is_the_largest_divisor_with_the_idle_warning(
        gen_args, tmp_path, capsys, caplog):
    from qaig_tpu_torch.infer.generate import make_decode_mesh

    with caplog.at_level(logging.WARNING, logger="qaig_tpu_torch"):
        mesh = make_decode_mesh(6, devices=["cpu"] * 4)
    assert mesh.shape == {"data": 3, "model": 1}
    assert "uses 3 of 4 devices" in caplog.text
    assert "1 chips idle" in caplog.text
    caplog.clear()
    with caplog.at_level(logging.WARNING, logger="qaig_tpu_torch"):
        got = _run(dict(gen_args, num_images=6), tmp_path, "six",
                   devices=["cpu"] * 4)
    assert "Generation mesh: data=3 x model=1" in capsys.readouterr().out
    assert "chips idle" in caplog.text
    want = _run(dict(gen_args, num_images=6), tmp_path, "one")
    np.testing.assert_array_equal(got.numpy(), want.numpy())


@pytest.mark.cuda
def test_data_2_fused_on_one_card_twice(cuda, cascade, tmp_path):
    """``generate.run`` over ``[cuda:0, cuda:0]`` (data 2), fused by
    default: two captures at the first call, a replay of each at the
    second, and the tokens of ``--no-fused`` over the same mesh and of one
    card, at two seeds; each replica's graph launches what one card's
    cascade launches."""
    from qaig_tpu_torch.infer import generate
    from qaig_tpu_torch.infer.graphs import read_counts

    config_path, decoder_path = cascade
    two = [cuda] * 2
    cache, one = {}, {}
    for seed in (3, 4):
        args = dict(device="cuda", config_path=str(config_path),
                    decoder_path=str(decoder_path), num_images=4, seed=seed)
        before = read_counts()
        fused = generate.run(dict(args, out_dir=str(tmp_path / f"f{seed}")),
                             cache=cache, devices=two)
        fused_counts = [a - b for a, b in zip(read_counts(), before)]
        dispatched = generate.run(dict(args, fused=False, out_dir=str(
            tmp_path / f"d{seed}")), devices=two)
        before = read_counts()
        single = generate.run(dict(args, out_dir=str(tmp_path / f"o{seed}")),
                              cache=one, devices=[cuda])
        single_counts = [a - b for a, b in zip(read_counts(), before)]
        assert torch.equal(fused.cpu(), dispatched.cpu()), seed
        assert torch.equal(fused.cpu(), single.cpu()), seed
        assert fused_counts == [2 * c for c in single_counts], seed
    replicas = cache["replicas"]
    assert [list(r["runner"].graphs) for r in replicas] == [[2], [2]]
    (single,) = one["replicas"]
    assert all(r["runner"].graphs[2].launches ==
               single["runner"].graphs[4].launches for r in replicas)
