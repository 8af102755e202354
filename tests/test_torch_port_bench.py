"""The port's bench (``qaig_tpu_torch/bench.py``) against ``bench.py``, on
the CPU at smoke scale.

* ``build_cascade("smoke")`` has ``bench.py``'s stage configs, sequence
  lengths, beam plan, window, sampler settings and codebook shapes;
* with ``bench.py``'s own smoke weights carried through ``convert.py`` and
  sampling patched to argmax on both sides (the
  ``tests/test_torch_port_generate.py`` pattern), and the same stage-0
  init tokens, ``run_cascade`` gives ``bench.py``'s tokens and
  ``decode_pixels`` its pixels within 1e-4 (float32);
* ``token_counts`` and ``ci95_half_width`` equal ``bench.py``'s;
* ``cascade_flops`` (counted from shapes) equals
  ``torch.utils.flop_counter.FlopCounterMode``'s total over one CPU run of
  the same cascade, for every engine form the bench runs (on the CPU
  attention runs through its plain products, so the count is exact);
* the JSON line's keys equal those of ``bench.py`` run at ``--device cpu
  --scale smoke --iters 2 --no-breakdown`` (a subprocess started before the
  first test), and every flag gives ``bench.py``'s ``mode`` (without its
  ``_fusedattn``); an error inside the cascade propagates and prints no
  JSON line; with no card and no ``--device cpu`` the bench exits non-zero.
"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
import bench as jax_bench  # noqa: E402

from qaig_tpu_torch import bench  # noqa: E402

ENV = dict(os.environ, JAX_PLATFORMS="cpu",
           XLA_FLAGS="--xla_force_host_platform_device_count=1")
CPU_SMOKE = ["--device", "cpu", "--scale", "smoke", "--iters", "2",
             "--no-breakdown", "--batch", "1"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module", autouse=True)
def jax_bench_line():
    """``bench.py``'s JSON line at CPU smoke scale (one XLA device), run in
    a new process started before the first test of the file (its compile
    is most of its time); a test that needs it waits.  Its persistent
    compilation cache is off: it writes nothing outside the test."""
    proc = subprocess.Popen(
        [sys.executable, "bench.py", *CPU_SMOKE,
         "--compilation-cache-dir", ""], cwd=REPO, env=ENV,
        text=True, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    state = {}

    def result():
        if "line" not in state:
            out, err = proc.communicate(timeout=600)
            assert proc.returncode == 0, err[-3000:]
            state["line"] = json.loads(out.strip().splitlines()[-1])
        return state["line"]
    yield result
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


def _jax_smoke():
    return jax_bench.build_cascade("smoke", dtype=jnp.float32)


def _params(stages, dec_params):
    tree = jax.tree_util.tree_map(np.asarray, {
        "codebooks": [stages[0]["lr"][1]] + [st["hr"][1] for st in stages],
        "stages": [st["params"] for st in stages],
        "decoder": dec_params})
    return tree


def test_smoke_cascade_has_bench_configs():
    jstages, jdecoder, _ = _jax_smoke()
    stages, decoder = bench.build_cascade("smoke", dtype=torch.float32)
    assert len(stages) == len(jstages) == 3
    for st, js in zip(stages, jstages):
        mine = dataclasses.asdict(st["model"].cfg)
        theirs = dataclasses.asdict(js["model"].cfg)
        assert {k: mine[k] for k in theirs} == theirs
        for key in ("window", "total_seq", "k", "base", "num_beam",
                    "beam_width"):
            assert st[key] == js[key], key
        assert dataclasses.asdict(st["settings"]) == dataclasses.asdict(
            js["settings"])
        for mine_cb, (their_cb, their_p) in ((st["lr"], js["lr"]),
                                             (st["hr"], js["hr"])):
            assert mine_cb.patch_dim == tuple(their_cb.patch_dim)
            assert mine_cb.image_dim == tuple(their_cb.image_dim)
            assert mine_cb.num_embeddings == their_cb.num_embeddings
            assert tuple(mine_cb.codebook.shape) == their_p["codebook"].shape
            assert mine_cb.seq_len == their_cb.seq_len
        assert not st["engine"].quantized_prefix
        assert not st["engine"].flat_decode
    assert dataclasses.asdict(decoder.cfg) == dataclasses.asdict(
        jdecoder.cfg)
    assert [st["total_seq"] for st in stages] == [4, 16, 64]
    assert [(st["num_beam"], st["beam_width"]) for st in stages] == [
        (2, 2), (2, 4), (2, 4)]
    assert [st["window"] for st in stages] == [None, None, 16]
    # the options reach every stage's engine; the weights are seeded
    flagged, _ = bench.build_cascade("smoke", int8_kv=True, flat_decode=True)
    assert all(st["engine"].quantized_prefix and st["engine"].flat_decode
               for st in flagged)
    again, _ = bench.build_cascade("smoke", dtype=torch.float32)
    for a, b in zip(stages, again):
        for pa, pb in zip(a["model"].parameters(), b["model"].parameters()):
            assert torch.equal(pa, pb)


INIT = np.array([[3], [17], [30]])


@pytest.fixture
def greedy(monkeypatch):
    """argmax in place of both packages' categorical draws, and the same
    stage-0 init tokens on both sides."""
    from qaig_tpu_torch.infer import decode as port_decode
    monkeypatch.setattr(
        jax.random, "categorical",
        lambda key, logits, axis=-1, **kw: jnp.argmax(logits, axis=axis))
    monkeypatch.setattr(port_decode, "_categorical",
                        lambda logits, generator: logits.argmax(dim=-1))
    monkeypatch.setattr(jax.random, "randint",
                        lambda *a, **kw: jnp.asarray(INIT, jnp.int32))
    monkeypatch.setattr(bench, "_random_tokens",
                        lambda shape, high, generator: torch.from_numpy(
                            INIT.copy()))


@pytest.mark.parametrize("use_beams", [True, False])
def test_greedy_cascade_matches_bench(greedy, use_beams):
    jstages, jdecoder, dec_params = _jax_smoke()
    want = jax_bench.run_cascade(
        jstages, jdecoder, dec_params, len(INIT),
        [st["params"] for st in jstages], jax.random.PRNGKey(0),
        use_beams=use_beams)
    want_px = jax_bench.decode_pixels(jstages, jdecoder, dec_params, want)
    stages, decoder = bench.build_cascade(
        "smoke", dtype=torch.float32, params=_params(jstages, dec_params))
    got = bench.run_cascade(stages, len(INIT), torch.Generator(),
                            use_beams=use_beams)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    px = bench.decode_pixels(stages, decoder, got)
    assert px.shape == (len(INIT), 3, 16, 16)
    np.testing.assert_allclose(px.numpy(), np.asarray(want_px), atol=1e-4,
                               rtol=0)


def test_token_counts_and_ci95_equal_bench():
    jstages, _, _ = _jax_smoke()
    stages, _ = bench.build_cascade("smoke")
    for use_beams in (True, False):
        assert bench.token_counts(stages, use_beams) == \
            jax_bench.token_counts(jstages, use_beams)
    rng = np.random.default_rng(0)
    for n in (1, 2, 3, 10, 17, 40, 80):
        times = rng.uniform(0.5, 1.5, n)
        assert bench.ci95_half_width(times) == \
            jax_bench.ci95_half_width(times)


@pytest.mark.parametrize("form", ["beams", "single", "int8_flat", "bf16"])
def test_flops_equal_the_flop_counter(form):
    """``cascade_flops`` from shapes against ``FlopCounterMode`` over one
    CPU run of the cascade and pixel decode (3 images; bf16 runs the same
    products)."""
    from torch.utils.flop_counter import FlopCounterMode

    stages, decoder = bench.build_cascade(
        "smoke", dtype=torch.bfloat16 if form == "bf16" else torch.float32,
        int8_kv=form == "int8_flat", flat_decode=form == "int8_flat")
    use_beams = form != "single"
    counter = FlopCounterMode(display=False)
    with counter:
        px, tokens = bench.cascade_program(
            stages, decoder, 3, torch.Generator().manual_seed(0), use_beams)
    assert px.shape == (3, 3, 16, 16) and tokens.shape == (3, 64)
    assert bench.cascade_flops(stages, decoder, 3, use_beams) == \
        counter.get_total_flops()


def test_json_keys_equal_bench(jax_bench_line, capsys):
    """The port's line at ``--device cpu --scale smoke --iters 2
    --no-breakdown`` has exactly ``bench.py``'s keys; XLA's count of the
    same smoke cascade is printed beside the port's for the record."""
    bench.main(list(CPU_SMOKE))
    lines = capsys.readouterr().out.strip().splitlines()
    mine = json.loads(lines[-1])
    theirs = jax_bench_line()
    assert sorted(mine) == sorted(theirs)
    assert mine["metric"] == theirs["metric"]
    assert mine["mode"] == theirs["mode"] == "beams"
    assert mine["device_kind"] == "cpu" and mine["mfu"] is None
    assert mine["n_chips"] == 1 and mine["stages"] is None
    assert mine["decode_tokens_per_sec_per_chip"] > 0
    stages, decoder = bench.build_cascade("smoke")
    assert mine["flops_per_image"] == bench.cascade_flops(stages, decoder, 1)
    print(f"flops_per_image at smoke scale: the port's count "
          f"{mine['flops_per_image']}, XLA's cost analysis "
          f"{theirs['flops_per_image']}")


def test_breakdown_stages_have_bench_keys(capsys):
    bench.main(["--device", "cpu", "--scale", "smoke", "--iters", "1",
                "--batch", "2"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert list(line["stages"]) == ["stage0", "stage1", "stage2",
                                    "pixel_decode"]
    assert [line["stages"][f"stage{i}"]["tokens"] for i in range(3)] == [
        4, 16, 64]
    assert "iter_time_ci95_s" not in line   # one iteration, as bench.py


FLAGS = [[], ["--no-beams"], ["--int8-kv"], ["--flat-decode"], ["--fp32"],
         ["--int8-kv", "--flat-decode"],
         ["--no-beams", "--int8-kv", "--fp32", "--flat-decode"]]


@pytest.mark.parametrize("flags", FLAGS, ids=lambda f: "+".join(f) or "none")
def test_mode_equals_bench(flags, monkeypatch):
    """``bench.py``'s ``main`` with its run replaced by a recorder gives the
    mode string; the port's equals it, and ``--fused-decode``'s
    ``_fusedattn`` is the only difference."""
    import qaig_tpu.train.common as jax_common
    seen = []
    monkeypatch.setattr(jax_common, "select_platform", lambda *a, **k: None)
    monkeypatch.setattr(jax_common, "apply_compilation_cache",
                        lambda *a, **k: None)
    monkeypatch.setattr(jax_bench, "_run",
                        lambda args, mode: seen.append(mode))
    for extra in ([], ["--fused-decode"]):
        monkeypatch.setattr(sys, "argv", ["bench.py", *flags, *extra])
        jax_bench.main()
    mine = bench.bench_mode(bench.parse_args(flags))
    assert seen == [mine, mine + "_fusedattn"]


def test_an_error_in_the_cascade_prints_no_line(monkeypatch, capsys):
    def broken(*a, **kw):
        raise RuntimeError("stage failed")
    monkeypatch.setattr(bench.CascadeStage, "rollout", broken)
    with pytest.raises(RuntimeError, match="stage failed"):
        bench.main(list(CPU_SMOKE))
    assert "{" not in capsys.readouterr().out


def test_no_card_and_no_cpu_flag_exits_nonzero():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    proc = subprocess.run(
        [sys.executable, "-m", "qaig_tpu_torch.bench", "--scale", "smoke",
         "--iters", "1"], cwd=REPO, env=ENV, capture_output=True, text=True,
        timeout=120)
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
    assert "{" not in proc.stdout
    for flag in ("--device auto", "--fused-decode"):
        proc = subprocess.run(
            [sys.executable, "-m", "qaig_tpu_torch.bench", *flag.split()],
            cwd=REPO, env=ENV, capture_output=True, text=True, timeout=120)
        assert proc.returncode == 2, flag
