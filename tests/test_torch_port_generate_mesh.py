"""``generate.run`` over an in-process mesh in the PyTorch port
(``qaig_tpu_torch/infer/generate.py``, ``parallel/local.py``), on the CPU.

Without ``--multihost`` the generation mesh is a ``LocalMesh`` over the
process's devices, as ``qaig_tpu``'s is over every local chip; the tests
repeat the ``cpu`` device, as ``tests/test_torch_port_serve_sharded.py``
does.  On ``qaig_tpu``'s checkpoints of a two-stage cascade (a base stage
and a windowed encoder stage, ``tests/test_torch_port_generate.py``):

* at data 2 and at data 1 x model 2, at greedy and at temperature 1, the
  tokens equal one device's exactly (every draw is the one-device draw,
  sliced per replica);
* the run prints ``Generation mesh: data=D x model=M``;
* ``fused=True`` on a mesh larger than 1x1 raises;
* the data axis is the largest divisor of ``num_images`` that fits: 6
  images over 4 devices give data 3, with ``qaig_tpu``'s idle warning.
"""

import logging
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_port_generate import _write_jax_checkpoints  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def gen_args(tmp_path_factory):
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


def test_fused_on_a_larger_mesh_raises(gen_args, tmp_path):
    with pytest.raises(ValueError, match="--fused requires unsharded"):
        _run(dict(gen_args, num_images=4, fused=True), tmp_path, "f",
             devices=["cpu"] * 2)


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
