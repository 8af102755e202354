"""Sampled rollouts of the port against ``qaig_tpu``'s under shared noise,
on the CPU in float32 at T 1.0.

Both engines take per-row keys: rollout ``b`` of image ``n`` draws the
token of slot ``s`` from ``fold_in(fold_in(key[n], b), s)``.  The port
folds with ``infer/row_keys.py``'s integer hash and draws Gumbel-max
noise from it (``infer/decode.py::_SlotNoise``, ``_categorical``);
``qaig_tpu`` folds with ``jax.random.fold_in`` and draws with
``jax.random.categorical`` (``qaig_tpu/infer/decode.py::_sample``,
``_expand_row_keys``).  Here, in the test only, ``jax.random.fold_in`` and
``jax.random.categorical`` are replaced by a ``jnp`` uint32 transcription
of the port's hash (``_fmix32`` / ``_mix`` / ``gumbel``), so that the same
keys give the same noise on both sides; nothing in either package changes.

Weights are drawn with numpy in ``qaig_tpu``'s shapes for ``bench.py``'s
smoke stages and carried to the port by ``convert.py``; the beam plan and
window are ``bench.py``'s smoke ones.  Every draw of both engines is
recorded in order (its tokens and the chosen tokens' probabilities) and
every segment's winners (the chosen rollout of each image): the tokens and
winners must be equal, the probabilities within rtol 1e-5 (float32 through
two layers), each segment's per-rollout log-probability within 1e-4.  A
token that differs where the port's top two noisy logits lie within 1e-5
(a near-tie) would end the comparison of that run (the trajectories part
there); the committed seeds meet none, so the test asserts that no run
meets one and that every event was compared.  Any other difference fails.
"""

import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(Path(__file__).resolve().parent))
import bench as jax_bench  # noqa: E402
from test_torch_port_models import random_params  # noqa: E402

NEAR_TIE = 1e-5
PROB_RTOL = 1e-5
LOGP_ATOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---------------------------------------------------------------------------
# the port's hash, in jnp uint32 (infer/row_keys.py)
# ---------------------------------------------------------------------------

def _u32(x):
    return jnp.asarray(x, dtype=jnp.uint32)


def _fmix32(h):
    h = h ^ (h >> 16)
    h = h * _u32(0x85EBCA6B)
    h = h ^ (h >> 13)
    h = h * _u32(0xC2B2AE35)
    return h ^ (h >> 16)


def _mix(k0, k1, data):
    d = jnp.asarray(data).astype(jnp.uint32)
    a = _fmix32(k0 ^ (d * _u32(0x9E3779B1)))
    b = _fmix32(k1 ^ a ^ ((d + _u32(0x7F4A7C15)) * _u32(0xCC9E2D51)))
    return _fmix32(a ^ (b * _u32(0x1B873593))), b


def jnp_fold_in(key, data):
    key = jnp.asarray(key).astype(jnp.uint32)
    a, b = _mix(key[..., 0], key[..., 1], data)
    return jnp.stack(jnp.broadcast_arrays(a, b), axis=-1)


def jnp_uniform(key, count):
    key = jnp.asarray(key).astype(jnp.uint32)
    counter = jnp.arange(count, dtype=jnp.uint32)
    bits = _mix(key[..., :1], key[..., 1:] ^ _u32(0x5BD1E995), counter)[0]
    return ((bits >> 8).astype(jnp.float32) + 0.5) * (2.0 ** -24)


def jnp_gumbel(key, count):
    return -jnp.log(-jnp.log(jnp_uniform(key, count)))


def jnp_categorical(key, logits, axis=-1, **kw):
    return jnp.argmax(logits + jnp_gumbel(key, logits.shape[-1]), axis=axis)


def test_jnp_hash_equals_the_port():
    """The transcription gives the port's keys and noise bit for bit."""
    from qaig_tpu_torch.infer import row_keys as rk
    keys = rk.fold_in(rk.key(12345), torch.arange(6))
    got = np.asarray(jnp_fold_in(jnp.asarray(keys.numpy()), 77))
    np.testing.assert_array_equal(got, rk.fold_in(keys, 77).numpy())
    np.testing.assert_array_equal(
        np.asarray(jax.vmap(lambda k: jnp_fold_in(k, 5))(
            jnp.asarray(keys.numpy().astype(np.uint32)))),
        rk.fold_in(keys, 5).numpy())
    # the uniform draws bit for bit; the logs of the two libraries may
    # differ in the last bit (a near-tie's scale)
    np.testing.assert_array_equal(
        np.asarray(jnp_uniform(jnp.asarray(keys.numpy()), 33)),
        rk.uniform(keys, 33).numpy())
    np.testing.assert_allclose(
        np.asarray(jnp_gumbel(jnp.asarray(keys.numpy()), 33)),
        rk.gumbel(keys, 33).numpy(), rtol=1e-6, atol=NEAR_TIE / 10)


# ---------------------------------------------------------------------------
# recording both engines' draws and winners
# ---------------------------------------------------------------------------

@pytest.fixture
def shared_noise(monkeypatch):
    """The hash in place of JAX's folds and draws; both engines' draws and
    winners recorded in program order.  Returns {"jax": [...], "port":
    [...]} of ("draw", tokens, chosen, gap) / ("winner", winner)."""
    from qaig_tpu.infer import decode as jax_decode
    from qaig_tpu_torch.infer import decode as port_decode

    monkeypatch.setattr(jax.random, "fold_in", jnp_fold_in)
    monkeypatch.setattr(jax.random, "categorical", jnp_categorical)
    events = {"jax": [], "port": []}

    def record_jax_draw(token, chosen):
        events["jax"].append(("draw", np.asarray(token), np.asarray(chosen),
                              None))

    def jax_sample(logits, rng, s, slot=None, _orig=jax_decode._sample):
        token, chosen = _orig(logits, rng, s, slot=slot)
        jax.debug.callback(record_jax_draw, token, chosen, ordered=True)
        return token, chosen

    def jax_select(tree, winner, num_beam, _orig=jax_decode._select_beam):
        jax.debug.callback(
            lambda w: events["jax"].append(("winner", np.asarray(w))),
            winner, ordered=True)
        return _orig(tree, winner, num_beam)

    gaps = []

    def port_categorical(logits, draw, _orig=port_decode._categorical):
        noisy = logits + draw
        top2 = torch.topk(noisy, 2, dim=-1).values
        gaps.append((top2[:, 0] - top2[:, 1]).numpy())
        return _orig(logits, draw)

    def port_sample(logits, rng, s, slot=None, _orig=port_decode._sample):
        token, chosen = _orig(logits, rng, s, slot=slot)
        events["port"].append(("draw", token.numpy(), chosen.numpy(),
                               gaps.pop()))
        return token, chosen

    def port_select(tree, winner, num_beam,
                    _orig=port_decode._select_beam):
        events["port"].append(("winner", winner.numpy()))
        return _orig(tree, winner, num_beam)

    monkeypatch.setattr(jax_decode, "_sample", jax_sample)
    monkeypatch.setattr(jax_decode, "_select_beam", jax_select)
    monkeypatch.setattr(port_decode, "_categorical", port_categorical)
    monkeypatch.setattr(port_decode, "_sample", port_sample)
    monkeypatch.setattr(port_decode, "_select_beam", port_select)
    return events


def compare(events, num_beam):
    """Hold the port's events to JAX's; returns (events compared, near
    ties).  Fails on any other difference."""
    theirs, mine = events["jax"], events["port"]
    assert [e[0] for e in mine] == [e[0] for e in theirs]
    logp = {"jax": 0.0, "port": 0.0}
    for i, (t, m) in enumerate(zip(theirs, mine)):
        if t[0] == "winner":
            for side in logp:
                assert np.ndim(logp[side]) == 1
            np.testing.assert_allclose(logp["port"], logp["jax"],
                                       atol=LOGP_ATOL, rtol=0)
            per_image = logp["port"].reshape(-1, num_beam)
            differ = np.nonzero(t[1] != m[1])[0]
            for row in differ:   # only a tie of two rollouts may differ
                assert abs(per_image[row, t[1][row]]
                           - per_image[row, m[1][row]]) < NEAR_TIE, (i, row)
            if len(differ):
                return i, len(differ)
            logp = {"jax": 0.0, "port": 0.0}
            continue
        _, t_tok, t_p, _ = t
        _, m_tok, m_p, gap = m
        differ = np.nonzero(t_tok != m_tok)[0]
        if len(differ):
            far = [int(r) for r in differ if gap[r] >= NEAR_TIE]
            assert not far, (f"draw {i}: rows {far} differ outside a "
                             f"near-tie (gaps {gap[far]}), tokens "
                             f"{m_tok[far]} against {t_tok[far]}")
            return i, len(differ)
        np.testing.assert_allclose(m_p, t_p, rtol=PROB_RTOL, atol=1e-7)
        logp["jax"] = logp["jax"] + np.log(np.maximum(t_p, 1e-38))
        logp["port"] = logp["port"] + np.log(np.maximum(m_p, 1e-38))
    return len(theirs), 0


CASES = {
    # (stage index of bench.py's smoke cascade, int8 prefix, tokens): the
    # windowed stage decodes 28 of its 64 tokens (3 cached segments, the
    # crossing one and 3 steady ones; every later segment is another
    # steady one)
    "base": (0, False, 4),
    "windowed_encoder": (2, False, 28),
    "int8_encoder": (1, True, 16),
    "int8_windowed_encoder": (2, True, 28),
}


def _steady_uncached(self, key, build_fn, _orig=None):
    """qaig_tpu's program cache, bypassed for steady windowed segments
    (traced anew for each, so each draws its own slots)."""
    if key[:2] == ("winroll_seg", "steady"):
        return jax.jit(build_fn())
    return _orig(self, key, build_fn)


def run_both(case, events):
    """One stage's rollout on both engines from the same row keys; returns
    (port tokens, JAX tokens, the port's stage)."""
    from qaig_tpu.infer.decode import DecodeEngine as JaxEngine
    from qaig_tpu_torch import bench
    from qaig_tpu_torch.infer.decode import SamplerSettings
    from qaig_tpu_torch.infer.pipeline import derive_row_keys

    index, int8, steps = CASES[case]
    jstages, _, dec_params = jax_bench.build_cascade("smoke",
                                                     dtype=jnp.float32)
    params = [random_params(st["model"].init, 10 + i)
              for i, st in enumerate(jstages)]
    tree = jax.tree_util.tree_map(np.asarray, {
        "codebooks": [jstages[0]["lr"][1]] + [st["hr"][1] for st in jstages],
        "stages": params, "decoder": dec_params})
    stages, _ = bench.build_cascade("smoke", dtype=torch.float32,
                                    int8_kv=int8, params=tree)
    js, st = jstages[index], stages[index]
    assert st["settings"].temperature == 1.0

    n = 3
    rng = np.random.default_rng(index)
    k = st["k"]
    init = (rng.integers(0, k, (n, 1)) if st["base"]
            else np.full((n, 1), k))
    prev = jstages[index - 1]["total_seq"] if index else 0
    x_enc = None if st["base"] else rng.integers(0, k, (n, prev))
    keys = derive_row_keys(7 + index, n)

    want = JaxEngine(js["model"], quantized_prefix=int8).rollout_generate(
        params[index], jnp.asarray(init), steps,
        jnp.asarray(keys.numpy().astype(np.uint32)), js["settings"],
        num_beam=js["num_beam"], beam_width=js["beam_width"],
        x_enc=None if x_enc is None else jnp.asarray(x_enc),
        sliding_window=js["window"])
    settings = SamplerSettings(**dataclasses.asdict(st["settings"]))
    got = st["engine"].rollout_generate(
        torch.from_numpy(init), steps, keys, settings,
        num_beam=st["num_beam"], beam_width=st["beam_width"],
        x_enc=None if x_enc is None else torch.from_numpy(x_enc),
        sliding_window=st["window"])
    segments = steps // st["beam_width"]
    assert sum(e[0] == "winner" for e in events["port"]) == segments
    assert sum(e[0] == "draw" for e in events["port"]) == steps
    return got, want, st


@pytest.mark.parametrize("case", list(CASES))
def test_sampled_rollouts_match_jax_under_shared_noise(shared_noise,
                                                       monkeypatch, case):
    """qaig_tpu's engine traces each steady windowed segment anew: its
    program cache keys them without their first slot, which their
    row-keyed draws read (the test below)."""
    import functools
    from qaig_tpu.infer.decode import DecodeEngine as JaxEngine
    monkeypatch.setattr(JaxEngine, "_jitted", functools.partialmethod(
        _steady_uncached, _orig=JaxEngine._jitted))
    got, want, st = run_both(case, shared_noise)
    compared, near_ties = compare(shared_noise, st["num_beam"])
    print(f"{case}: {compared} events compared, {near_ties} near-ties")
    # the committed seeds meet no near-tie, so every event is compared
    assert near_ties == 0, (case, compared, near_ties)
    assert compared == len(shared_noise["jax"])
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the draws are not degenerate: rollouts of an image differ
    draws = [e[1] for e in shared_noise["port"] if e[0] == "draw"]
    assert any(len(np.unique(d.reshape(3, -1)[0])) > 1 for d in draws)


def test_jax_steady_segments_reuse_the_first_ones_slots(shared_noise):
    """Found in ``qaig_tpu``, not in the port: with its program cache on,
    ``DecodeEngine._windowed_rollout_segment`` keys a steady segment's
    program on the window buffer's shape only, but the program's row-keyed
    draws fold in ``c0 + s`` (``c0`` = the segment's first slot), a Python
    int traced into it.  Every later steady segment replays the first
    one's program and draws that segment's slots again.  The port draws
    each segment's own slots; the two agree up to the first draw of the
    second steady segment and differ there, in every row."""
    _, _, st = run_both("windowed_encoder", shared_noise)
    bw, window = st["beam_width"], st["window"]
    # segments: cached while bw fits before the window fills, then the
    # crossing one, then steady ones; each is bw draws and a winner
    crossing = (window - 1) // bw
    second_steady = (crossing + 2) * (bw + 1)
    theirs, mine = shared_noise["jax"], shared_noise["port"]
    for t, m in zip(theirs[:second_steady], mine[:second_steady]):
        np.testing.assert_array_equal(m[1], t[1])
    assert theirs[second_steady][0] == mine[second_steady][0] == "draw"
    assert (theirs[second_steady][1] != mine[second_steady][1]).all()
