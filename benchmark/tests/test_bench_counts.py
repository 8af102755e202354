"""The benchmark's operation counts: equal to ``FlopCounterMode`` over the
plain reference's model work at small shapes, and blind to the program's
cache schedule."""

import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import counts
from benchmark import reference as ref
from benchmark import weights as bw
from benchmark import system
from benchmark.tests import smoke


def _flops(fn):
    with FlopCounterMode(display=False) as fc:
        fn()
    return fc.get_total_flops()


def _stage_params(cfg, index):
    modules = system.cascade_modules(cfg, "cpu")
    w = bw.draw(modules, 5, "cpu", torch.float32)
    return w.views(f"stages.{index}."), w


def test_teacher_forced_stage_equals_the_counter():
    cfg = smoke.with_updates(smoke.cascade_config(), dtype="float32")
    p, _ = _stage_params(cfg, 2)
    sh, *_ = counts.cascade_shapes(cfg)[2]
    model = ref.Model(p, 4, 4, True, True, 1, 2)
    n, s, e = 3, 10, 16
    tokens = torch.randint(0, 33, (n, s))
    enc = torch.randint(0, 32, (n, e))
    pos = torch.arange(s, dtype=torch.float32).expand(n, s)
    got = _flops(lambda: model.logits(tokens, enc, pos))
    want = (counts.encoder_flops(sh, n, e) + counts.cond_flops(sh, n * s)
            + sh.dec_layers * counts.dec_layer_flops(sh, n * s, n * s * s, e)
            + counts.classifier_flops(sh, n * s))
    assert got == want


def test_base_stage_equals_the_counter():
    cfg = smoke.with_updates(smoke.cascade_config(), dtype="float32")
    p, _ = _stage_params(cfg, 0)
    sh, *_ = counts.cascade_shapes(cfg)[0]
    model = ref.Model(p, 4, 4, False, False, 0, 2)
    n, s = 2, 5
    got = _flops(lambda: model.logits(torch.randint(0, 64, (n, s))))
    want = (sh.dec_layers * counts.dec_layer_flops(sh, n * s, n * s * s, 0)
            + counts.classifier_flops(sh, n * s))
    assert got == want


def test_pixel_decode_equals_the_counter():
    cfg = smoke.with_updates(smoke.cascade_config(), dtype="float32")
    _, w = _stage_params(cfg, 0)
    ae = cfg["autoencoder"]
    latent = torch.randn(3, ae["latent_channel"], 8, 8)
    got = _flops(lambda: ref.decode_pixels(w.views("decoder."), ae, latent))
    assert got == counts.pixel_flops(ae, (8, 8), 3)


def test_training_step_equals_the_counter():
    cfg = smoke.train_config()
    modules = system.cascade_modules(smoke.with_updates(
        smoke.cascade_config(), dtype="float32"), "cpu")
    p = bw.draw(modules, 6, "cpu", torch.float32).views("stages.2.")
    p = {k: v.clone().requires_grad_(True) for k, v in p.items()}
    model = ref.Model(p, 4, 4, True, True, 1, 2)
    n, lr_len, _ = cfg["batch_size"], 4, 16
    s = cfg["sliding_window"]
    tokens = torch.randint(0, 33, (n, s))
    enc = torch.randint(0, 32, (n, lr_len))
    pos = (torch.arange(s, dtype=torch.float32) + 1).expand(n, s)

    def step():
        logits = model.logits(tokens, enc, pos)
        torch.nn.functional.cross_entropy(
            logits.reshape(-1, logits.shape[-1]), tokens.reshape(-1)
        ).backward()
    got = _flops(step)
    sh = counts.train_shapes(cfg)
    full = smoke.with_updates(cfg)
    bmu = 2 * n * (lr_len * 32 * 2 * 16 + 16 * 32 * 2 * 4)
    fwd_causal_counted = (
        counts.train_step_flops(full, n) - bmu
        + 3 * sh.dec_layers * 4 * sh.d * n * (s * s
                                              - counts.causal_sum(1, s)))
    assert got == fwd_causal_counted


def test_count_ignores_the_engines_cache_schedule(monkeypatch):
    """One generate call counted under two cache capacities: the program's
    own work (its plain attention reads a cache's capacity) moves, the
    benchmark's count does not."""
    from qaig_tpu_torch.infer import decode
    cfg = smoke.with_updates(smoke.cascade_config(), dtype="float32")
    pipeline, _, _ = system.build_cascade(cfg, 7, "cpu")
    program = []
    for first in (64, 8):
        monkeypatch.setattr(decode, "FIRST_BUCKET", first)
        program.append(_flops(lambda: pipeline.generate(2, seed=3)))
    assert program[0] != program[1]
    assert counts.cascade_flops(cfg, 2) == counts.cascade_flops(cfg, 2)
    assert counts.cascade_flops(cfg, 2) < min(program)


def test_decode_attention_counts_positions_present():
    cfg = smoke.cascade_config()
    work = counts.decode_attention_launches(cfg, 1)
    sh = counts.cascade_shapes(cfg)
    launches = sum(
        s[0].dec_layers * sum(c for _, c, _ in counts.stage_schedule(
            s[1], s[2], s[6], s[4])) for s in sh)
    assert len(work) == launches
    d = cfg["in_dim"]
    first = work[0]
    assert first[0] == 4 * 2 * d * (1 + 1)
