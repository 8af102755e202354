"""The PyTorch port's train steps as CUDA graphs (``train/common.py::
graph_train_step`` over ``infer/graphs.py::GraphRunner``) and the
capturable Adam beneath them (``train/optim.py``).  This file imports no
JAX, so its ``cuda``-marked tests run on a machine with the card and
without JAX:

    python -m pytest tests/test_torch_port_train_graphs.py -q -m cuda \
        --noconftest

* On the CPU: the three trainers' steps stay eager; the capturable Adam's
  learning-rate tensor keeps its identity under ``set_update_count`` and
  ``scheduler.step()`` and holds the halving factor; a reference Adam
  dict (``"capturable": False``) or an optax state loads and leaves the
  port's group settings in place; the codebook step reads the
  neighbourhood range from its tensor input; over a stub graph
  (``torch.cuda``'s graph calls as no-ops), a graphed step creates the
  Adam state, warms up, then captures, and counts what one step launches.
* On the card, at a small size: graphed and eager steps give the same
  losses, parameters and Adam state bit for bit, for each trainer (the
  transformer in bf16 and float32 with grad-accum, clip and EMA; the
  autoencoder in both precisions with grad-accum; the codebook over a
  shrinking range); a replay counts the kernels of one step; a step that
  reads a device value on the host raises at its capture.
"""

import copy
import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_port_graphs import stub_cuda  # noqa: E402,F401  (fixture)

from qaig_tpu_torch.infer.graphs import (launch_counters,  # noqa: E402
                                         read_counts)
from qaig_tpu_torch.ops import bmu  # noqa: E402
from qaig_tpu_torch.ops import flash_attention as fa  # noqa: E402

K = 16
LATENT = (4, 8, 8)
AE_CFG = {"image_channel": 3, "min_channel": 8, "max_channel": 16,
          "num_layers": 2, "latent_channel": 4,
          "hidden_activation_type": "silu",
          "use_final_enc_activation": True, "encoder_activation_type": "tanh",
          "use_final_dec_activation": True, "decoder_activation_type": "tanh"}


def _transformer_setup(device, seed=0, remat=False):
    """A small windowed cascade stage (2 + 2 layers, in_dim 64 in 8 heads
    of dim 8, window 12) over K-16 codebooks of 4x8x8 latents."""
    from qaig_tpu_torch.models.codebook import Codebook
    from qaig_tpu_torch.models.core import init_parameters
    from qaig_tpu_torch.models.transformer import (Transformer,
                                                   TransformerConfig)
    gen = torch.Generator(device=device).manual_seed(seed)
    cfg = TransformerConfig(
        use_encoder=True, use_pos_cond=True, num_enc_layers=2,
        num_dec_layers=2, num_enc_embedding=K, num_dec_embedding=K + 1,
        self_attn_heads=8, cross_attn_heads=8, in_dim=64, out_dim=K + 1,
        hidden_dim=128, use_remat=remat)
    model = init_parameters(Transformer(cfg, device=device), gen)
    books = [Codebook(patch_dim=patch, image_dim=LATENT[1:],
                      image_channel=LATENT[0], num_embeddings=K,
                      device=device).init(gen).requires_grad_(False)
             for patch in ((4, 4), (2, 2))]
    return model, books


def _transformer_step(model, books, graphed, **kw):
    from qaig_tpu_torch.train import optim, transformer
    optimizer, scheduler = optim.make_adam(model.parameters(), 1e-3,
                                           lr_step=2)
    return transformer.make_train_step(
        model, optimizer, books[0], books[1], False, K, K, 12,
        scheduler=scheduler, graphed=graphed, **kw), optimizer


# ---------------------------------------------------------------------------
# on the CPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("trainer", ["transformer", "autoencoder",
                                     "codebook"])
def test_trainers_stay_eager_on_the_cpu(trainer):
    """On the CPU a step is eager (no runner), and a graphed step is
    refused."""
    from qaig_tpu_torch.models.codebook import Codebook
    from qaig_tpu_torch.train import autoencoder, codebook, optim

    if trainer == "transformer":
        model, books = _transformer_setup("cpu")

        def make(**kw):
            return _transformer_step(model, books, **kw)[0]
    elif trainer == "autoencoder":
        model, _ = autoencoder.build_autoencoder(AE_CFG)

        def make(**kw):
            return autoencoder.make_train_step(
                model, optim.make_adam(model.parameters(), 1e-3)[0], **kw)
    else:
        model = Codebook(patch_dim=(2, 2), image_dim=LATENT[1:],
                         image_channel=LATENT[0], num_embeddings=K)

        def make(**kw):
            return codebook.make_train_step(
                model, optim.make_adam(model.parameters(), 1e-3)[0], **kw)
    assert make(graphed=None).runner is None
    assert make(graphed=False, debug_nans=True).runner is None
    with pytest.raises(ValueError, match="CUDA"):
        make(graphed=True)


def test_graphs_are_the_default_on_cuda_except_under_debug_nans():
    """``--debug-nans`` is the eager step's documented mode on the card:
    anomaly detection cannot run inside a capture."""
    from qaig_tpu_torch.train.common import use_graphs
    assert use_graphs(None, "cuda") is True
    assert use_graphs(None, "cuda", debug_nans=True) is False
    assert use_graphs(None, "cpu") is False
    assert use_graphs(False, "cuda") is False
    with pytest.raises(ValueError, match="anomaly"):
        use_graphs(True, "cuda", debug_nans=True)


@pytest.mark.parametrize("count", [0, 1, 4, 9])
def test_schedule_fills_the_lr_tensor(count):
    """With a tensor learning rate (a capturable Adam; ``lr_step`` 4, so
    counts 0, 1, ``lr_step`` and ``2 lr_step + 1``), ``set_update_count``
    and ``scheduler.step()`` write the halving factor into the same
    tensor, which a captured step reads at every replay."""
    from qaig_tpu_torch.train import optim
    p = torch.nn.Parameter(torch.zeros(3))
    opt, sched = optim.make_adam([p], 0.5, lr_step=4, capturable=True)
    group = opt.param_groups[0]
    lr = group["lr"]
    assert isinstance(lr, torch.Tensor) and group["capturable"]
    factor = optim.halving_factor(4)
    optim.set_update_count(opt, sched, count)
    assert group["lr"] is lr and float(lr) == 0.5 * factor(count)
    sched.step()
    assert group["lr"] is lr and float(lr) == 0.5 * factor(count + 1)
    assert float(lr) == optim.current_lr(0.5, 4, count + 1)


@pytest.mark.parametrize("form", ["reference", "optax"])
def test_loaded_adam_state_keeps_the_ports_group_settings(form):
    """A reference Adam dict (``"capturable": False``, its own ``lr``) or
    an optax state loads into a capturable Adam: moments and step arrive,
    the group stays capturable with its learning-rate tensor, which the
    schedule puts at the state's update count."""
    from qaig_tpu_torch.convert import to_optax_state
    from qaig_tpu_torch.models.codebook import Codebook
    from qaig_tpu_torch.train import common, optim
    from qaig_tpu_torch.utils.torch_optim import export_adam_state

    def book():
        return Codebook(patch_dim=(2, 2), image_dim=LATENT[1:],
                        image_channel=LATENT[0], num_embeddings=K).init(
            torch.Generator().manual_seed(3))
    source = book()
    opt, _ = optim.make_adam(source.parameters(), 1e-3)
    for _ in range(5):
        source.codebook.grad = torch.randn_like(source.codebook)
        opt.step()
    state = (export_adam_state(source, opt, learning_rate=0.25)
             if form == "reference" else to_optax_state(source, opt))
    if form == "reference":
        assert state["param_groups"][0]["capturable"] is False

    target = book()
    new, sched = optim.make_adam(target.parameters(), 1e-3, lr_step=2,
                                 capturable=True)
    group = new.param_groups[0]
    lr = group["lr"]
    common.restore_optimizer(target, new, sched, state, logging=pytest.fail)
    assert group["capturable"] is True and group["lr"] is lr
    assert float(lr) == pytest.approx(1e-3 * optim.halving_factor(2)(5))
    slot = new.state[target.codebook]
    assert float(slot["step"]) == 5.0
    assert slot["step"].device == target.codebook.device
    assert torch.equal(slot["exp_avg"], opt.state[source.codebook]["exp_avg"])


def test_codebook_step_reads_the_range_from_its_tensor_input(monkeypatch):
    """The neighbourhood range enters the step as a float32 0-d tensor
    (one graph serves every range), whatever the caller passes, and the
    loss follows it."""
    from qaig_tpu_torch.models import codebook as cb_module
    from qaig_tpu_torch.train import codebook, optim

    seen = []
    original = cb_module.gaussian_neighbourhood

    def recording(bmu_idx, num_embeddings, neighbourhood_range):
        seen.append(neighbourhood_range)
        return original(bmu_idx, num_embeddings, neighbourhood_range)
    monkeypatch.setattr(cb_module, "gaussian_neighbourhood", recording)
    model = cb_module.Codebook(patch_dim=(2, 2), image_dim=LATENT[1:],
                               image_channel=LATENT[0], num_embeddings=K)
    model.init(torch.Generator().manual_seed(4))
    batch = torch.randn((2,) + LATENT, generator=torch.Generator()
                        .manual_seed(5))
    losses = []
    for value in (8.0, torch.tensor(8.0), 2):
        trial = copy.deepcopy(model)
        step = codebook.make_train_step(
            trial, optim.make_adam(trial.parameters(), 1e-2)[0])
        losses.append(float(step(batch, value)))
    for value, want in zip(seen, (8.0, 8.0, 2.0)):
        assert isinstance(value, torch.Tensor) and value.dim() == 0
        assert value.dtype == torch.float32 and float(value) == want
    assert losses[0] == losses[1] != losses[2]


def test_graphed_step_warms_up_then_captures(stub_cuda):
    """Over a stub graph (the capture runs the function eagerly): the
    first call creates the Adam state, runs the warm-up and then the
    capture on the static inputs; the warm-up's and the capture's launches
    are taken out of the counts and every replay adds one step's, the
    backward passes that reached the CUDA backward included."""
    from qaig_tpu_torch.train import common, optim

    p = torch.nn.Parameter(torch.ones(2))
    opt, _ = optim.make_adam([p], 1e-3)
    events = []

    def device_step(x):
        events.append(("step", bool(opt.state.get(p))))
        fa.flash_attention.backward_calls += 1
        bmu.fused_bmu.launches += 2
        return (x * p).sum()

    def warmup(x):
        events.append(("warmup", bool(opt.state.get(p))))
        bmu.fused_bmu.launches += 5

    replay = common.graph_train_step(device_step, warmup, opt, "cpu")
    start = read_counts()
    x = torch.full((2,), 3.0)
    for call in (1, 2, 3):
        assert float(replay(x)) == 6.0
        assert fa.flash_attention.backward_calls == \
            _count(start, "flash_attention_backward_calls") + call
        assert bmu.fused_bmu.launches == _count(start, "fused_bmu") + 2 * call
    assert events == [("warmup", True), ("step", True)]
    assert float(opt.state[p]["step"]) == 0.0
    assert list(replay.runner.graphs) == [(((2,), torch.float32),)]


def _count(counts, name):
    """``name``'s entry of :func:`read_counts`' list."""
    return counts[[n for n, _, _ in launch_counters()].index(name)]


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from qaig_tpu_torch.train.common import full_float32
    full_float32()
    return torch.device("cuda", torch.cuda.current_device())


def _run_both(build, inputs, steps=3):
    """``build(graphed) -> (step, model, optimizer)`` twice from the same
    state, ``steps`` steps each on ``inputs(i)``; asserts equal losses,
    parameters and Adam state, bit for bit.  Returns the graphed step."""
    out = {}
    for graphed in (False, True):
        step, model, optimizer = build(graphed)
        losses = [step(*inputs(i)) for i in range(steps)]
        torch.cuda.synchronize()
        out[graphed] = (losses, model, optimizer, step)
    (l0, m0, o0, _), (l1, m1, o1, step) = out[False], out[True]
    assert step.runner is not None and out[False][3].runner is None
    for a, b in zip(l0, l1):
        assert torch.equal(a, b), (l0, l1)
    for (name, a), b in zip(m0.named_parameters(), m1.parameters()):
        assert torch.equal(a, b), name
        for key in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(o0.state[a][key], o1.state[b][key]), (name,
                                                                     key)
    return step


@pytest.mark.cuda
@pytest.mark.parametrize("bf16", [True, False], ids=["bf16", "float32"])
def test_graphed_transformer_steps_equal_eager(cuda, bf16):
    """Three steps (windows drawn on the host from one seed): bf16 plain,
    float32 with grad-accum 2, clip 0.5, EMA 0.9 and the recomputed
    blocks of ``use_remat``; the EMA weights equal too.  The float32
    chunks of 48 rows of 12 tokens (576 decoder rows) run the decoder's
    linears through kernel 7."""
    from qaig_tpu_torch.ops import linear_f32 as lf
    latents = torch.randn((3, 4 if bf16 else 96) + LATENT,
                          generator=torch.Generator().manual_seed(1)).to(cuda)
    launches = lf.linear_f32.launches
    extra = {} if bf16 else {"grad_accum": 2, "grad_clip": 0.5}
    emas = {}

    def build(graphed):
        model, books = _transformer_setup(cuda, remat=not bf16)
        model.requires_grad_(True)
        ema = None if bf16 else copy.deepcopy(model).requires_grad_(False)
        emas[graphed] = ema
        step, optimizer = _transformer_step(
            model, books, graphed, bf16=bf16, ema_model=ema,
            ema_decay=None if ema is None else 0.9, **extra)
        gen = torch.Generator().manual_seed(2)

        def windowed(batch):
            return step(batch, gen)
        windowed.runner = step.runner
        return windowed, model, optimizer

    step = _run_both(build, lambda i: (latents[i],))
    assert len(step.runner.graphs) == 1
    assert (lf.linear_f32.launches > launches) is not bf16
    if not bf16:
        for a, b in zip(emas[False].parameters(), emas[True].parameters()):
            assert torch.equal(a, b)


@pytest.mark.cuda
def test_graphed_trainers_in_turn_leave_no_memory_behind(cuda):
    """Three graphed transformer trainers made, stepped and let go in turn,
    as ``quality_run`` trains its stages: the card's allocated memory after
    each is the first one's (each capture runs on the card's one capture
    stream; a stream per runner left a cuBLAS workspace behind each)."""
    import gc
    latents = torch.randn((4,) + LATENT, generator=torch.Generator()
                          .manual_seed(5)).to(cuda)
    after = []
    for seed in range(3):
        model, books = _transformer_setup(cuda, seed=seed, remat=True)
        step, optimizer = _transformer_step(model, books, True)
        gen = torch.Generator().manual_seed(seed)
        for _ in range(2):
            step(latents, gen)
        assert step.runner is not None
        del model, books, step, optimizer
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        after.append(torch.cuda.memory_allocated(cuda))
    assert after == [after[0]] * 3, after


@pytest.mark.cuda
@pytest.mark.parametrize("bf16", [False, True], ids=["float32", "bf16"])
def test_graphed_autoencoder_steps_equal_eager(cuda, bf16):
    from qaig_tpu_torch.models.core import init_parameters
    from qaig_tpu_torch.train import autoencoder, optim
    images = torch.rand((3, 4, 3, 16, 16), generator=torch.Generator()
                        .manual_seed(3)).to(cuda) * 2 - 1

    def build(graphed):
        model, _ = autoencoder.build_autoencoder(AE_CFG, cuda)
        init_parameters(model, torch.Generator(device=cuda).manual_seed(0))
        optimizer, scheduler = optim.make_adam(model.parameters(), 1e-3, 2)
        return autoencoder.make_train_step(
            model, optimizer, bf16=bf16, grad_accum=2, scheduler=scheduler,
            graphed=graphed), model, optimizer

    _run_both(build, lambda i: (images[i],))


@pytest.mark.cuda
def test_graphed_codebook_steps_equal_eager_over_a_shrinking_range(cuda):
    """One graph serves ranges 8, 7, 6 (a device input, not a capture per
    range)."""
    from qaig_tpu_torch.models.codebook import Codebook
    from qaig_tpu_torch.train import codebook, optim
    latents = torch.randn((3, 8) + LATENT, generator=torch.Generator()
                          .manual_seed(4)).to(cuda)

    def build(graphed):
        model = Codebook(patch_dim=(2, 2), image_dim=LATENT[1:],
                         image_channel=LATENT[0], num_embeddings=K,
                         device=cuda).init(torch.Generator(device=cuda)
                                           .manual_seed(0))
        optimizer, scheduler = optim.make_adam(model.parameters(), 1e-2, 2)
        return codebook.make_train_step(
            model, optimizer, scheduler, graphed=graphed), model, optimizer

    step = _run_both(build, lambda i: (latents[i], 8.0 - i))
    assert len(step.runner.graphs) == 1


def _predicted_linear_launches(model, dec_rows, enc_rows):
    """Kernel 7's products and fallbacks in one float32 step, from the
    model's structure: every ``nn.Linear`` runs once in the forward, over
    the encoder's rows (the encoder's layers and the decoder's cross K / V)
    or the decoder's; one with in and out features multiples of 4 over at
    least ``MIN_ROWS`` rows takes the kernel for its forward, dW and dX
    (its input carries a gradient, except the position-conditioning MLP's
    first layer, which reads the fixed sinusoidal positions); any other
    falls back once (the classifier's K + 1 outputs, the encoder's rows
    here)."""
    from qaig_tpu_torch.ops.linear_f32 import MIN_ROWS
    taken = launches = fallbacks = 0
    for name, m in model.named_modules():
        if not isinstance(m, torch.nn.Linear):
            continue
        enc = name.startswith("encoder_layers.") or ".cross_attn.attn.k." \
            in name or ".cross_attn.attn.v." in name
        rows = enc_rows if enc else dec_rows
        if m.in_features % 4 or m.out_features % 4 or rows < MIN_ROWS:
            fallbacks += 1
            continue
        taken += 1
        launches += 2 if m is model.pos_cond_layer.l0 else 3
    assert taken and fallbacks
    return launches, fallbacks


@pytest.mark.cuda
@pytest.mark.parametrize("bf16", [False, True], ids=["float32", "bf16"])
def test_replay_counts_one_steps_launches(cuda, bf16):
    """Per replay of the transformer step: kernel A once per layer
    forward, its backward once per layer, the BMU kernel once per
    codebook, kernel 7 and its fallbacks as the model's linears predict
    in float32 (48 rows of 12 decoder tokens and 4 encoder tokens) and
    neither in bf16; the same as an eager step."""
    latents = torch.randn((48,) + LATENT, generator=torch.Generator()
                          .manual_seed(6)).to(cuda)
    per_step = {}
    for graphed in (False, True):
        model, books = _transformer_setup(cuda)
        model.requires_grad_(True)
        step, _ = _transformer_step(model, books, graphed, bf16=bf16)
        gen = torch.Generator().manual_seed(2)
        step(latents, gen)
        before = read_counts()
        step(latents, gen)
        torch.cuda.synchronize()
        names = [name for name, _, _ in launch_counters()]
        per_step[graphed] = dict(zip(names, (a - b for a, b in zip(
            read_counts(), before))))
    assert per_step[True] == per_step[False]
    assert per_step[True]["flash_attention"] == 4
    assert per_step[True]["flash_attention_backward"] == 4
    assert per_step[True]["flash_attention_backward_calls"] == 4
    assert per_step[True]["fused_bmu"] == 2
    linear = (0, 0) if bf16 else _predicted_linear_launches(model, 48 * 12,
                                                            48 * 4)
    assert (per_step[True]["linear_f32"],
            per_step[True]["linear_f32_fallbacks"]) == linear


@pytest.mark.cuda
def test_failed_train_capture_raises(cuda):
    """A step that reads a device value on the host cannot be captured:
    the graphed step raises, keeps no graph and falls back to nothing."""
    from qaig_tpu_torch.train import common, optim
    p = torch.nn.Parameter(torch.ones(4, device=cuda))
    opt, _ = optim.make_adam([p], 1e-3)

    def device_step(x):
        opt.zero_grad(set_to_none=True)
        loss = (x * p).sum() * float(x.sum())
        loss.backward()
        opt.step()
        return loss.detach()

    replay = common.graph_train_step(device_step, lambda x: None, opt, cuda)
    with pytest.raises(RuntimeError):
        replay(torch.ones(4, device=cuda))
    assert replay.runner.graphs == {}
