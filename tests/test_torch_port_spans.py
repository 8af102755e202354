"""The port's spans, counters and timers (``qaig_tpu_torch/utils/spans.py``
and the code that opens them) and the repaired row-keyed sampler.  This
file imports no JAX, so its ``cuda``-marked tests run on a machine with
the card and without JAX:

    python -m pytest tests/test_torch_port_spans.py -q -m cuda --noconftest

* On the CPU: a span does nothing without a profiler; under one, an eager
  training step records ``train.step`` around ``train.window_starts`` and
  ``train.scheduler``, in the span list and among the profiler's events;
  the totals add seconds by name; the list is bounded; the loader reads
  on its worker (``data.read``) and waits on the consumer
  (``data.wait``); a graph replay's three spans nest in the caller's; the
  benchmark's three span readers; the batcher's queue-wait totals and the
  rollout counters in its metrics; the rollout counters of a small
  cascade, counted apart from the kernel launches; the stage clock's
  parts; the top word of ``row_keys.uniform`` and a masked <end> it cannot
  lift.
* On the card: the rollout counters across a capture and two replays, and
  the stage clock's parts of a fused call against its device time.
"""

import collections
import importlib.util
import json
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_port_graphs import stub_cuda, write_cascade  # noqa: E402,F401

from qaig_tpu_torch.infer import row_keys  # noqa: E402
from qaig_tpu_torch.infer.decode import DecodeEngine  # noqa: E402
from qaig_tpu_torch.utils import spans  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _empty_list():
    spans.reset()
    yield
    spans.reset()


def _profiled():
    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])


def _by_name(recs):
    out = {}
    for rec in recs:
        out.setdefault(rec[0], []).append(rec)
    return out


def _within(inner, outer):
    return outer[1] <= inner[1] <= inner[2] <= outer[2]


def _profiler_names(prof):
    return {e.name() for e in prof.profiler.kineto_results.events()}


# ---------------------------------------------------------------------------
# the span list
# ---------------------------------------------------------------------------

def test_span_without_a_profiler_records_nothing(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("record function made without a profiler")
    monkeypatch.setattr(spans, "_RecordFunctionFast", refuse)
    with spans.span("outer"):
        with spans.span("inner"):
            pass
    assert spans.records() == [] and spans.totals() == {}


def test_train_step_spans_under_the_profiler():
    """An eager training step at test size: ``train.step`` encloses the
    window starts' draw and the scheduler's step, in the list and among
    the profiler's own events."""
    from test_torch_port_train_graphs import (_transformer_setup,
                                              _transformer_step)
    model, books = _transformer_setup("cpu")
    step, _ = _transformer_step(model, books, graphed=False)
    batch = torch.randn(2, 4, 8, 8, generator=torch.Generator()
                        .manual_seed(1))
    gen = torch.Generator().manual_seed(2)
    step(batch, gen)
    assert spans.records() == []
    with _profiled() as prof:
        step(batch, gen)
    recs = _by_name(spans.records())
    assert sorted(recs) == ["train.scheduler", "train.step",
                            "train.window_starts"]
    (outer,) = recs["train.step"]
    for name in ("train.window_starts", "train.scheduler"):
        (inner,) = recs[name]
        assert _within(inner, outer)
    assert set(recs) <= _profiler_names(prof)
    totals = spans.totals()
    assert totals["train.step"] > totals["train.window_starts"] + \
        totals["train.scheduler"]


def test_totals_add_seconds_by_name():
    with _profiled():
        with spans.span("a"):
            for _ in range(2):
                with spans.span("b"):
                    time.sleep(0.01)
    recs = _by_name(spans.records())
    totals = spans.totals()
    assert sorted(totals) == ["a", "b"] and len(recs["b"]) == 2
    for name, rs in recs.items():
        assert totals[name] == pytest.approx(
            sum((end - start) / 1e9 for _, start, end in rs))
    assert all(_within(b, recs["a"][0]) for b in recs["b"])
    assert totals["b"] >= 0.02


def test_span_list_is_bounded(monkeypatch):
    assert spans._records.maxlen == spans.CAPACITY
    monkeypatch.setattr(spans, "_records", collections.deque(maxlen=8))
    with _profiled():
        for i in range(10):
            with spans.span(f"r{i}"):
                pass
    assert [r[0] for r in spans.records()] == [f"r{i}" for i in
                                               range(2, 10)]


def test_loader_reads_on_its_worker_and_waits_on_the_consumer():
    from qaig_tpu_torch.data.loader import DataLoader

    class Slow:
        def __len__(self):
            return 8

        def __getitem__(self, i):
            time.sleep(0.005)
            return np.full((2,), i, np.float32)

    with _profiled():
        batches = list(DataLoader(Slow(), batch_size=2, shuffle=False,
                                  num_workers=1))
    assert len(batches) == 4
    recs = _by_name(spans.records())
    assert len(recs["data.read"]) == 4
    assert len(recs["data.wait"]) == 5          # the four and the end
    # the consumer's wait for a batch ends only once the worker read it
    for read, wait in zip(recs["data.read"], recs["data.wait"]):
        assert read[2] <= wait[2]


def test_replay_spans_nest_in_the_callers(stub_cuda):
    """A replay's copies, launch and clones are three spans under the
    caller's; the captured function holds none."""
    from qaig_tpu_torch.infer.graphs import GraphRunner
    runner = GraphRunner("cpu")
    x = torch.arange(3.0)
    with _profiled():
        for _ in range(2):
            with spans.span("caller"):
                runner("key", lambda t: (t + 1,), inputs=(x,))
    recs = _by_name(spans.records())
    assert sorted(recs) == ["caller", "graph.copy_in", "graph.copy_out",
                            "graph.launch"]
    for name in ("graph.copy_in", "graph.launch", "graph.copy_out"):
        assert len(recs[name]) == 2
        assert all(_within(r, outer) for r, outer in
                   zip(recs[name], recs["caller"]))


# ---------------------------------------------------------------------------
# the benchmark's readers of the spans
# ---------------------------------------------------------------------------

def _reader(name):
    path = ROOT / "benchmark" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"span_reader_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


@pytest.mark.parametrize("name, span, want", [
    ("step_host_share.train", "train.step", 3.0 / 4.0),
    ("copy_in_s_per_step.train", "graph.copy_in", 3.0 / 3),
    ("data_wait_share.train", "data.wait", 3.0 / 4.0)])
def test_span_readers(name, span, want):
    read = _reader(name)
    record = {"trace": {"window_s": 4.0}, "trace_steps": 3}
    assert read(record, None) is None
    spans._records.extend([(span, 0, 1_000_000_000),
                           (span, 5_000_000_000, 7_000_000_000),
                           ("other", 0, 4_000_000_000)])
    assert read(record, None) == pytest.approx(want)
    assert read({"trace_steps": 3}, None) is None


# ---------------------------------------------------------------------------
# generation: the batcher, the rollout counters, the stage clock
# ---------------------------------------------------------------------------

@pytest.fixture
def cpu_pipeline(tmp_path):
    from qaig_tpu_torch.infer.pipeline import CascadePipeline
    config_path, decoder_path = write_cascade(torch.device("cpu"), tmp_path)
    return CascadePipeline.from_config(json.loads(config_path.read_text()),
                                       decoder_path, logging=lambda m: None,
                                       device="cpu")


def _plan(pipe):
    """(rollout steps, rollout segments) of one call."""
    return (sum(st.total_seq for st in pipe.stages),
            sum(st.total_seq // st.beam_width for st in pipe.stages))


def _rollouts():
    return DecodeEngine.rollout_steps, DecodeEngine.rollout_segments


def test_batcher_queue_wait_totals(cpu_pipeline):
    """Four requests from four threads: the served requests' queue waits
    add up in the metrics, beside the rollout steps that served them."""
    from qaig_tpu_torch.serve import RequestBatcher
    batcher = RequestBatcher(cpu_pipeline, max_batch=8)
    before = _rollouts()
    try:
        threads = [threading.Thread(
            target=batcher.submit, args=(1 + i % 2, i)) for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
        m = batcher.metrics()
    finally:
        batcher.stop()
    assert m["served_requests_total"] == m["requests_total"] == 4
    assert 0 < m["queue_wait_seconds_max"] <= m["queue_wait_seconds_total"]
    assert m["queue_wait_seconds_total"] <= 4 * m["uptime_seconds"]
    steps, segments = _plan(cpu_pipeline)
    assert m["rollout_steps_total"] - before[0] == \
        steps * m["dispatches_total"]
    assert m["rollout_segments_total"] - before[1] == \
        segments * m["dispatches_total"]


def test_batcher_stamps_its_requests(cpu_pipeline):
    """A request is numbered and stamped as submitted, dispatched and
    returned, in that order, with its dispatch's number."""
    from qaig_tpu_torch.serve import RequestBatcher
    batcher = RequestBatcher(cpu_pipeline, max_batch=8)
    try:
        items = [batcher._request(1, i, None) for i in range(3)]
        with batcher._cv:
            batcher._pending.extend(items)
            batcher._cv.notify_all()
        for item in items:
            assert item["event"].wait(120) and item["error"] is None
    finally:
        batcher.stop()
    assert [item["id"] for item in items] == [0, 1, 2]
    assert len({item["dispatch"] for item in items}) == 1
    for item in items:
        assert item["submitted"] <= item["dispatched"] <= item["returned"]


def test_rollout_counter_equals_the_plan(cpu_pipeline):
    """An eager call counts the plan's steps and segments, and the
    counters that a graph's replay keeps carry them."""
    from qaig_tpu_torch.infer.graphs import read_counts, replay_counters
    names = [name for name, _, _ in replay_counters()]
    before, counts = _rollouts(), read_counts()
    cpu_pipeline.generate(3, seed=1)
    steps, segments = _plan(cpu_pipeline)
    assert steps == 4 + 16 and segments == 2 + 4
    assert _rollouts() == (before[0] + steps, before[1] + segments)
    delta = dict(zip(names, (a - b for a, b in zip(read_counts(), counts))))
    assert (delta["rollout_steps"], delta["rollout_segments"]) == \
        (steps, segments)


def test_rollout_counters_are_not_kernel_launches():
    """The kernel launch counts hold no rollout counter, and the graph
    runner does not import the decode engine: the training step captures
    its graphs without it."""
    from qaig_tpu_torch.infer.graphs import launch_counters, replay_counters
    launches = [name for name, _, _ in launch_counters()]
    assert "rollout_steps" not in launches
    assert [name for name, _, _ in replay_counters()][len(launches):] == \
        ["rollout_steps", "rollout_segments"]
    code = ("import sys; import qaig_tpu_torch.infer.graphs; "
            "print('qaig_tpu_torch.infer.decode' in sys.modules)")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "False"


def test_stage_seconds_of_a_dispatched_call(cpu_pipeline):
    assert cpu_pipeline.stage_seconds() == {}
    t0 = time.perf_counter()
    cpu_pipeline.generate(2, seed=3)
    wall = time.perf_counter() - t0
    parts = cpu_pipeline.stage_seconds()
    assert list(parts) == ["stage_0", "stage_1", "decoder"]
    assert all(v > 0 for v in parts.values())
    assert sum(parts.values()) <= wall


def test_generate_images_logs_its_parts(tmp_path, capsys):
    from qaig_tpu_torch.infer import generate
    config_path, decoder_path = write_cascade(torch.device("cpu"), tmp_path)
    generate.run(dict(device="cpu", config_path=str(config_path),
                      decoder_path=str(decoder_path), num_images=2, seed=1,
                      fused=True, out_dir=str(tmp_path / "out")))
    (line,) = [x for x in capsys.readouterr().out.splitlines()
               if x.startswith("Cascade: ")]
    parts = line.split("by part (s): ")[1].split(", ")
    assert [p.split()[0] for p in parts] == ["stage_0", "decoder",
                                             "stage_1"]
    assert all(float(p.split()[1]) > 0 for p in parts)
    assert "; 20 rollout steps; " in line     # 4 + 16, as the plan's


# ---------------------------------------------------------------------------
# the sampler's top word
# ---------------------------------------------------------------------------

def test_uniform_top_word_stays_below_one(monkeypatch):
    words = torch.arange(2 ** 24, dtype=torch.int64) << 8
    monkeypatch.setattr(row_keys, "random_bits", lambda keys, count: words)
    u = row_keys.uniform(None, None)
    old = (words >> 8).to(torch.float32).add(0.5).mul(2.0 ** -24)
    assert float(old[-1]) == 1.0
    assert float(u[-1]) == 1.0 - 2.0 ** -24
    assert torch.equal(u[:-1], old[:-1])
    assert bool((u > 0).all() and (u < 1).all())
    g = row_keys.gumbel(None, None)
    assert bool(torch.isfinite(g).all())
    assert float(g[-1]) == pytest.approx(16.6355, abs=1e-3)


def test_masked_end_is_not_drawn_at_the_top_word(monkeypatch):
    """A draw whose <end> entry gets the top word and every other entry the
    lowest: the masked <end> still loses to every real token."""
    from qaig_tpu_torch.infer.decode import SamplerSettings, _sample
    k, end = 9, 8
    bits = torch.zeros(4, k, dtype=torch.int64)
    bits[:, end] = 0xFFFFFFFF
    monkeypatch.setattr(row_keys, "random_bits", lambda keys, count: bits)
    noise = row_keys.gumbel(None, k)
    logits = torch.full((4, k), -30.0)
    logits[:, end] = 30.0          # <end> holds nearly all the mass
    logits[1, 3] = 0.0
    settings = SamplerSettings(end_token=end, end_mode="mask")
    token, chosen = _sample(logits, noise, settings)
    assert bool((token != end).all()) and bool((chosen >= 0).all())
    assert int(token[1]) == 3


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.fixture
def cuda_pipeline(cuda, tmp_path):
    from qaig_tpu_torch.infer.pipeline import CascadePipeline
    config_path, decoder_path = write_cascade(cuda, tmp_path)
    return CascadePipeline.from_config(json.loads(config_path.read_text()),
                                       decoder_path, logging=print,
                                       device=cuda)


@pytest.mark.cuda
def test_rollout_counter_across_a_capture_and_replays(cuda_pipeline):
    steps, segments = _plan(cuda_pipeline)
    for call in range(3):
        before = _rollouts()
        cuda_pipeline.generate(4, seed=call)
        torch.cuda.synchronize()
        assert _rollouts() == (before[0] + steps, before[1] + segments)
    graph = cuda_pipeline._graphs.graphs[(4, None)]
    from qaig_tpu_torch.infer.graphs import replay_counters
    names = [name for name, _, _ in replay_counters()]
    counted = dict(zip(names, graph.launches))
    assert (counted["rollout_steps"], counted["rollout_segments"]) == \
        (steps, segments)


@pytest.mark.cuda
@pytest.mark.parametrize("fused", [True, False])
def test_stage_clock_sums_to_the_calls_device_time(cuda_pipeline, fused):
    """A call of 64 images, fused (the clock's events recorded by the
    graph's replay) or dispatched: its parts add up to at least 95% of
    its device time, its kernels' span in a profile (first kernel's start
    to last kernel's end), and to no more than the stream's time between
    events recorded around the whole call."""
    from torch.profiler import ProfilerActivity
    pipe = cuda_pipeline
    pipe.generate(64, seed=1, fused=fused)
    for seed in (2, 3):
        torch.cuda.synchronize()
        begin = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                                ProfilerActivity.CUDA]) as p:
            begin.record()
            pipe.generate(64, seed=seed, fused=fused)
            end.record()
            torch.cuda.synchronize()
        kernels = [(e.start_ns(), e.start_ns() + e.duration_ns())
                   for e in p.profiler.kineto_results.events()
                   if e.device_type() == torch.autograd.DeviceType.CUDA
                   and not e.name().startswith("cuda")]
        device_s = (max(e for _, e in kernels)
                    - min(s for s, _ in kernels)) / 1e9
        whole_s = begin.elapsed_time(end) / 1e3
        parts = pipe.stage_seconds()
        assert list(parts) == ["stage_0", "stage_1", "decoder"]
        assert all(v > 0 for v in parts.values())
        assert 0.95 * device_s <= sum(parts.values()) <= whole_s, \
            (parts, device_s, whole_s)
