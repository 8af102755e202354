"""The port's bench and profile tools (``qaig_tpu_torch/scripts/{bench_train,
bench_stages,probe_latency,bench_serve,profile_rollout,profile_decode,
profile_window_shared}.py``) against the JAX side's ``scripts/``, on the
CPU at smoke scale: one schema test per tool, holding the port's JSON keys
or text lines to the JAX script's (read from its source where the JAX
script runs only at full width, or from a run of its own functions at a
small size), and the FLOPs the tools count from shapes to
``torch.utils.flop_counter.FlopCounterMode`` over the same CPU step.
"""

import ast
import contextlib
import io
import json
import re
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
SCRIPTS = REPO / "scripts"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _lines(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv + ["--device", "cpu", "--scale", "smoke"])
    return buf.getvalue().strip().splitlines()


def _source(name):
    return (SCRIPTS / f"{name}.py").read_text()


def _string_args(source, func):
    """The string literals passed to ``func(...)`` calls in ``source``."""
    out = []
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Call) and getattr(node.func, "id",
                                                  None) == func:
            out += [a.value for a in node.args
                    if isinstance(a, ast.Constant) and isinstance(a.value,
                                                                  str)]
            out += [k.value.value for k in node.keywords
                    if isinstance(k.value, ast.Constant)
                    and isinstance(k.value.value, str)]
    return out


# ---------------------------------------------------------------------------
# bench_train
# ---------------------------------------------------------------------------

def test_bench_train_line_is_the_jax_line():
    """``scripts/bench_train.py``'s line without its ``flash=`` field:
    ``remat=.. batch=.. bf16=..: X ms/step, Y samples/sec`` (plus TFLOP/s
    and the MFU on a card of the peak table), one per configuration: bf16
    and float32, remat off and on."""
    from qaig_tpu_torch.scripts import bench_train
    src = _source("bench_train")
    assert 'tag = f"flash={use_flash} remat={remat} batch={batch} ' \
        'bf16={bf16}"' in src
    assert 'print(f"{tag}: {dt * 1000:.1f} ms/step, "' in src
    assert 'f"{batch / dt:.1f} samples/sec{extra}")' in src
    assert '(mfu {achieved / peak:.3f} vs bf16 peak)' in src
    lines = _lines(bench_train.main, ["--steps", "2", "--batch", "3"])
    pattern = re.compile(r"^remat=(True|False) batch=3 bf16=(True|False): "
                         r"\d+\.\d ms/step, \d+\.\d samples/sec$")
    assert len(lines) == 4 and all(pattern.match(x) for x in lines), lines
    assert [x.split(":")[0] for x in lines] == [
        f"remat={r} batch=3 bf16={b}" for b in (True, False)
        for r in (False, True)]


@pytest.mark.parametrize("remat", [False, True])
def test_bench_train_flops_equal_the_flop_counter(remat):
    """The step's FLOPs (the MFU's numerator: one step at batch 1, times
    the batch) against ``FlopCounterMode`` over one eager CPU step at
    batch 3 (BMU, forward, backward, the recompute under remat; Adam adds
    no product): the count is linear in the batch."""
    from torch.utils.flop_counter import FlopCounterMode
    from qaig_tpu_torch.scripts import bench_train
    step, _ = bench_train.build("smoke", 3, remat, False,
                                torch.device("cpu"))
    counter = FlopCounterMode(display=False)
    with counter:
        loss = step(0)
    assert torch.isfinite(loss)
    assert bench_train.train_step_flops("smoke", remat, 3) == \
        counter.get_total_flops()
    if remat:
        assert bench_train.train_step_flops("smoke", True, 3) > \
            bench_train.train_step_flops("smoke", False, 3)


# ---------------------------------------------------------------------------
# bench_stages
# ---------------------------------------------------------------------------

def _tiny_jax_autoencoder(monkeypatch):
    """``scripts/bench_stages.py``'s autoencoder at 8 -> 16 channels (its
    128x128 images kept), so that its step compiles in seconds."""
    import qaig_tpu.train.autoencoder as jax_ae
    build = jax_ae.build_autoencoder

    def small(cfg_dict, *a, **kw):
        return build(dict(cfg_dict, min_channel=8, max_channel=16), *a,
                     **kw)
    monkeypatch.setattr(jax_ae, "build_autoencoder", small)


def test_bench_stages_keys_equal_jax(monkeypatch):
    monkeypatch.syspath_prepend(str(REPO))
    monkeypatch.syspath_prepend(str(SCRIPTS))
    import bench_stages as jax_stages
    from qaig_tpu_torch.scripts import bench_stages
    _tiny_jax_autoencoder(monkeypatch)
    theirs = {"ae_train_fp32": jax_stages.bench_ae(2, 2, bf16=False),
              "fmap_extract": jax_stages.bench_fmap(2, 2),
              "codebook_train_p8": jax_stages.bench_codebook(2, 2, 8)}
    line = json.loads(_lines(bench_stages.main, [])[-1])
    assert set(line) == {"device_kind", "n_chips", "iters", "stages"}
    assert line["device_kind"] == "cpu" and line["iters"] == 2
    assert list(line["stages"]) == ["ae_train_fp32", "ae_train_bf16",
                                    "fmap_extract", "codebook_train_p8",
                                    "codebook_train_p2"]
    for name, stage in line["stages"].items():
        ref = theirs[{"ae_train_bf16": "ae_train_fp32",
                      "codebook_train_p2": "codebook_train_p8"}.get(
                          name, name)]
        assert list(stage) == list(ref), name
        assert stage["mfu"] is None and stage["flops_per_step"] > 0
        assert stage["step_time_mean_s"] > 0
    assert line["stages"]["ae_train_bf16"]["precision"] == "bf16"
    # the JAX script's own line holds these keys at its top level
    src = _source("bench_stages")
    for key in ("device_kind", "n_chips", "iters", "stages"):
        assert f'"{key}"' in src


def test_bench_stages_flops_equal_the_flop_counter():
    from torch.utils.flop_counter import FlopCounterMode
    from qaig_tpu_torch.models.codebook import Codebook
    from qaig_tpu_torch.models.core import init_parameters
    from qaig_tpu_torch.scripts import bench_stages
    from qaig_tpu_torch.train import autoencoder, codebook, optim

    model, cfg = autoencoder.build_autoencoder(
        bench_stages.ae_config("smoke"))
    init_parameters(model, torch.Generator().manual_seed(0))
    optimizer, _ = optim.make_adam(model.parameters(), 1e-4)
    x = torch.randn(3, 3, 16, 16)
    for bf16 in (False, True):
        step = autoencoder.make_train_step(model, optimizer, bf16=bf16)
        counter = FlopCounterMode(display=False)
        with counter:
            step(x)
        assert bench_stages.conv_flops(cfg, 3, 16, train=True) == \
            counter.get_total_flops()
    counter = FlopCounterMode(display=False)
    with counter, torch.inference_mode():
        model.get_latent(x)
    assert bench_stages.conv_flops(cfg, 3, 16) == counter.get_total_flops()
    for patch in (4, 2):
        cb = Codebook(patch_dim=(patch, patch), image_dim=(8, 8),
                      image_channel=4, num_embeddings=64,
                      init_neighbour_range=32).init(
            torch.Generator().manual_seed(0))
        optimizer, _ = optim.make_adam(cb.parameters(), 1e-4)
        step = codebook.make_train_step(cb, optimizer)
        counter = FlopCounterMode(display=False)
        with counter:
            step(torch.randn(5, 4, 8, 8), 16.0)
        assert bench_stages.codebook_flops(cb, 5) == \
            counter.get_total_flops()


# ---------------------------------------------------------------------------
# probe_latency, bench_serve
# ---------------------------------------------------------------------------

def _jax_out_keys(source):
    """``out["..."]`` keys of a JAX script, ``fused_stage{k}_s`` for the
    bench's three stages."""
    keys = set(re.findall(r'out\["(\w+)"\]', source))
    if 'out[f"fused_stage{k}_s"]' in source:
        keys |= {f"fused_stage{k}_s" for k in range(3)}
    return keys


def test_probe_latency_keys_equal_jax():
    from qaig_tpu_torch.scripts import probe_latency
    theirs = _jax_out_keys(_source("probe_latency"))
    theirs |= {"device", "iters"}   # the dict it starts from
    assert 'out = {"device": jax.devices()[0].device_kind, "iters": ' \
        'args.iters}' in _source("probe_latency")
    line = json.loads(_lines(probe_latency.main, ["--iters", "1"])[-1])
    assert set(line) == theirs
    assert line["device"] == "cpu"
    assert line["fused_b8_per_image_s"] == round(line["fused_b8_s"] / 8, 4)
    skipped = json.loads(_lines(probe_latency.main,
                                ["--iters", "1", "--skip-dispatched"])[-1])
    assert set(skipped) == theirs - {"dispatched_s",
                                     "speedup_fused_vs_dispatched"}


def test_bench_serve_keys_equal_jax():
    from qaig_tpu_torch.scripts import bench_serve
    src = _source("bench_serve")
    block = src[src.index("print(json.dumps({"):]
    block = block[:block.index("}))")]
    theirs = re.findall(r'"(\w+)":', block)
    line = json.loads(_lines(bench_serve.main, ["--n-requests", "3"])[-1])
    assert list(line) == theirs
    assert line["n_requests"] == 3 and line["coalesced_s"] > 0


# ---------------------------------------------------------------------------
# the three profile tools
# ---------------------------------------------------------------------------

def test_profile_rollout_labels_equal_jax():
    from qaig_tpu_torch.scripts import profile_rollout
    theirs = _string_args(_source("profile_rollout"), "stage")
    assert [row[-1] for row in profile_rollout.plan("full")] == theirs
    full = profile_rollout.plan("full")
    assert [row[:7] for row in full] == [
        (256, 16, 32, 16, False, 0, None), (256, 16, 8, 16, False, 0, None),
        (256, 64, 4, 8, True, 16, None), (256, 256, 4, 8, True, 64, 256),
        (256, 224, 4, 8, True, 64, 256), (256, 248, 4, 8, True, 64, 256)]
    lines = _lines(profile_rollout.main, [])
    assert [x.split(": ")[0] for x in lines] == theirs
    assert all(re.match(r"^.+: \d+\.\d{4}s$", x) for x in lines), lines


def test_profile_decode_labels_equal_jax():
    from qaig_tpu_torch.scripts import profile_decode
    theirs = _string_args(_source("profile_decode"), "run")
    assert [kw["label"] for kw in profile_decode.plan("full")] == theirs
    assert profile_decode.plan("full")[0] == dict(
        profile_decode.BASE, label="baseline b128 l7 h2048 w256")
    lines = _lines(profile_decode.main, [])
    assert [x.split(": ")[0] for x in lines] == theirs
    assert all(re.match(r"^.+: \d+\.\d{3}s total, \d+\.\d{3} ms/step$", x)
               for x in lines), lines


def test_profile_window_shared_labels_equal_jax():
    from qaig_tpu_torch.scripts import profile_window_shared as pws
    src = _source("profile_window_shared")
    assert "n, b, s0, t = 256, 4, 248, 8" in src
    n, b, s0, t = 256, 4, 248, 8
    theirs = [f"window_forward_shared n={n} s0={s0} t={t} B={b}",
              f"window_forward (N rows) n={n} seq={s0 + t}",
              "window_forward_shared n=128"]
    assert 'f"window_forward_shared n={n} s0={s0} t={t} B={b}")' in src
    assert 'f"window_forward (N rows) n={n} seq={s0 + t}")' in src
    assert '"window_forward_shared n=128")' in src
    assert list(pws.labels("full")) == theirs
    lines = _lines(pws.main, [])
    assert [x.split(": ")[0] for x in lines] == list(pws.labels("smoke"))
    assert all(re.match(r"^.+: \d+\.\d{2} ms$", x) for x in lines), lines


@pytest.mark.parametrize("tool", ["bench_train", "bench_stages",
                                  "probe_latency", "bench_serve",
                                  "profile_rollout", "profile_decode",
                                  "profile_window_shared"])
def test_tools_need_a_card_without_device_cpu(tool):
    import importlib
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    module = importlib.import_module(f"qaig_tpu_torch.scripts.{tool}")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        module.main(["--scale", "smoke"])
