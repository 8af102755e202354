"""The port's parallel forms (``qaig_tpu_torch/parallel``) on the CPU: gloo
worlds of 2 and 4 processes against ``qaig_tpu``'s single-device steps.

Each world is started once per module (``file://`` rendezvous in a
temporary directory, one torch thread a process); its processes import
only the port and run every case of the world in turn, each on a fresh
mesh over all of them, and rank 0 writes the results; the comparison with
``qaig_tpu`` runs here.  Small sizes: the windowed cascade of
``tests/test_torch_port_train.py`` (2 layers, in_dim 32, hidden 48, 4
heads; codebooks of K 8 and 11 over 2x8x8 latents), global batch 8, 2
Adam steps.  Tolerances are those of ``tests/test_parallel.py``: loss
rtol 1e-5, parameters atol 1e-5, gathered Adam moments atol 1e-6; logits
atol 1e-4 and one SGD(lr=1) step's gradients atol 1e-5, as the
single-device parity tests hold them.

Cases: DP 2, TP 2, DP 2 x TP 2, ZeRO-1 over DP 2 (and under TP 2), with
and without a global-norm clip; PP 2 and PP 2 x TP 2 (logits, gradients,
Adam steps); the autoencoder's DP 2 and ZeRO-1 steps and the codebook's DP
2 step.
"""

import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
LR_K, HR_K = 8, 11
LATENT = (2, 8, 8)
BATCH, STEPS, WINDOW = 8, 2, 8
LR, LR_STEP = 1e-3, 1
CFG = dict(use_encoder=True, use_pos_cond=True, num_enc_layers=2,
           num_dec_layers=2, num_enc_embedding=LR_K,
           num_dec_embedding=HR_K + 1, self_attn_heads=4, cross_attn_heads=4,
           in_dim=32, out_dim=HR_K + 1, hidden_dim=48)
AE_CFG = dict(num_layers=2, image_channel=3, min_channel=4, max_channel=8,
              latent_channel=2, hidden_activation_type="silu",
              use_final_enc_activation=False, encoder_activation_type="silu",
              use_final_dec_activation=False, decoder_activation_type="tanh")

# name: (world, data, model, pipe, kind, options)
CASES = {
    "dp2": (2, 2, 1, 1, "adam", {}),
    "dp2_clip": (2, 2, 1, 1, "adam", {"clip": 0.05}),
    "tp2": (2, 1, 2, 1, "adam", {}),
    "tp2_clip": (2, 1, 2, 1, "adam", {"clip": 0.05}),
    "zero2": (2, 2, 1, 1, "adam", {"zero": True}),
    "zero2_clip": (2, 2, 1, 1, "adam", {"zero": True, "clip": 0.05}),
    "pp2": (2, 1, 1, 2, "adam", {}),
    "pp2_grads": (2, 1, 1, 2, "sgd", {}),
    "pp2_logits": (2, 1, 1, 2, "logits", {}),
    "ae_dp2": (2, 2, 1, 1, "autoencoder", {}),
    "ae_zero2": (2, 2, 1, 1, "autoencoder", {"zero": True}),
    "cb_dp2": (2, 2, 1, 1, "codebook", {}),
    "dp2tp2": (4, 2, 2, 1, "adam", {}),
    "zero2tp2_clip": (4, 2, 2, 1, "adam", {"zero": True, "clip": 0.05}),
    "pp2tp2": (4, 1, 2, 2, "adam", {}),
    "pp2tp2_grads": (4, 1, 2, 2, "sgd", {}),
    "pp2tp2_logits": (4, 1, 2, 2, "logits", {}),
}


# ---------------------------------------------------------------------------
# the worker (a process of a world: imports the port only)
# ---------------------------------------------------------------------------

def _codebook(patch, k, codes):
    from qaig_tpu_torch.models.codebook import Codebook
    cb = Codebook(patch_dim=patch, image_dim=LATENT[1:],
                  image_channel=LATENT[0], num_embeddings=k,
                  init_neighbour_range=3)
    with torch.no_grad():
        cb.codebook.copy_(torch.from_numpy(codes))
    return cb.requires_grad_(False)


def _transformer_case(name, mesh, inputs, rank):
    from qaig_tpu_torch.convert import load_jax_state, to_jax_state
    from qaig_tpu_torch.convert import to_optax_state
    from qaig_tpu_torch.models.transformer import (Transformer,
                                                   TransformerConfig)
    from qaig_tpu_torch.parallel.pipeline import GPipe, pipelined_apply
    from qaig_tpu_torch.parallel.sharding import Parallel, shard_mlps_
    from qaig_tpu_torch.train import optim
    from qaig_tpu_torch.train import transformer as port
    from qaig_tpu_torch.utils.checkpoint import flatten_tree

    _, n_data, n_model, n_pipe, kind, opts = CASES[name]
    model = Transformer(TransformerConfig(**CFG))
    load_jax_state(model, inputs["params"], logging=print)
    d = mesh.index("data")
    rows = slice(d * BATCH // n_data, (d + 1) * BATCH // n_data)
    if kind == "logits":
        shard_mlps_(model, mesh)
        with torch.no_grad():
            logits = pipelined_apply(
                model, torch.from_numpy(inputs["x_dec"]),
                x_enc=torch.from_numpy(inputs["x_enc"]),
                pos_cond=torch.from_numpy(inputs["pos"]), mesh=mesh,
                num_microbatches=2)
        return {f"logits_{rank}": logits.numpy()}
    model.requires_grad_(True)
    if kind == "sgd":
        optimizer, scheduler = torch.optim.SGD(model.parameters(),
                                               lr=1.0), None
    else:
        optimizer, scheduler = optim.make_adam(model.parameters(), LR,
                                               LR_STEP)
    pipe = GPipe(model, mesh, 2) if n_pipe > 1 else None
    par = Parallel(model, optimizer, mesh, zero=opts.get("zero", False),
                   pipeline=pipe)
    starts = torch.from_numpy(inputs["starts"])
    calls = iter(range(STEPS))
    port.draw_window_starts = lambda gen, n, seq, w: starts[next(calls)]
    step = port.make_train_step(
        model, optimizer, _codebook((4, 4), LR_K, inputs["lr_codes"]),
        _codebook((2, 2), HR_K, inputs["hr_codes"]), False, LR_K, HR_K,
        WINDOW, grad_clip=opts.get("clip"), scheduler=scheduler,
        parallel=par)
    steps = STEPS if kind == "adam" else 1
    losses = [float(step(torch.from_numpy(inputs["latents"][t][rows]),
                         torch.Generator())) for t in range(steps)]
    out = {f"losses_{rank}": np.asarray(losses),
           f"shapes_{rank}": np.asarray(
               [p.numel() for _, p in par.params])}
    full, states = par.full_params(model), par.full_states()
    if rank == 0:
        out["params"] = to_jax_state(model, params=full)
        if kind == "adam":
            out["opt"] = {k: np.asarray(v) for k, v in flatten_tree(
                to_optax_state(model, optimizer, states=states)).items()}
            if par.master is not None:
                out["master_numel"] = par.master.numel()
    return out


def _front_case(name, mesh, inputs, rank):
    from qaig_tpu_torch.convert import load_jax_state, to_jax_state
    from qaig_tpu_torch.models.conv_nets import (Autoencoder,
                                                 AutoencoderConfig)
    from qaig_tpu_torch.parallel.sharding import Parallel
    from qaig_tpu_torch.train import autoencoder, codebook, optim

    _, n_data, _, _, kind, opts = CASES[name]
    d = mesh.index("data")
    rows = slice(d * BATCH // n_data, (d + 1) * BATCH // n_data)
    if kind == "autoencoder":
        model = Autoencoder(AutoencoderConfig(**AE_CFG))
        load_jax_state(model, inputs["ae_params"], logging=print)
        batch = inputs["images"]
    else:
        model = _codebook((2, 2), HR_K, inputs["hr_codes"])
        batch = inputs["latents"]
    model.requires_grad_(True)
    optimizer, scheduler = optim.make_adam(model.parameters(), LR, LR_STEP)
    par = Parallel(model, optimizer, mesh, zero=opts.get("zero", False),
                   tensor_parallel=False)
    if kind == "autoencoder":
        step = autoencoder.make_train_step(model, optimizer,
                                           scheduler=scheduler,
                                           parallel=par)
        losses = [float(step(torch.from_numpy(batch[t][rows])))
                  for t in range(STEPS)]
    else:
        step = codebook.make_train_step(model, optimizer, scheduler,
                                        parallel=par)
        losses = [float(step(torch.from_numpy(batch[t][rows]), 3.0))
                  for t in range(STEPS)]
    full = par.full_params(model)
    out = {f"losses_{rank}": np.asarray(losses)}
    if rank == 0:
        out["params"] = to_jax_state(model, params=full)
    return out


def _worker(world, rank, workdir):
    torch.set_num_threads(1)
    from qaig_tpu_torch.parallel import comm
    from qaig_tpu_torch.parallel.mesh import make_mesh

    workdir = Path(workdir)
    comm.init({"multihost": True, "num_processes": world,
               "process_id": rank,
               "coordinator_address": f"file://{workdir}/rendezvous_{world}"},
              torch.device("cpu"))
    inputs = dict(np.load(workdir / "inputs.npz"))
    for key in ("params", "ae_params"):
        inputs[key] = {k[len(key) + 1:]: v for k, v in inputs.items()
                       if k.startswith(key + "/")}
    for name, (w, n_data, n_model, n_pipe, kind, _) in CASES.items():
        if w != world:
            continue
        mesh = make_mesh(n_data=n_data, n_model=n_model, n_pipe=n_pipe)
        run = (_front_case if kind in ("autoencoder", "codebook")
               else _transformer_case)
        out = run(name, mesh, inputs, rank)
        # written whole before it appears: the test polls for the file
        path = workdir / f"{name}_{rank}.pt"
        torch.save(out, f"{path}.tmp")
        os.replace(f"{path}.tmp", path)


# ---------------------------------------------------------------------------
# the reference (qaig_tpu, this process)
# ---------------------------------------------------------------------------

def _reference_inputs():
    import jax
    from qaig_tpu.models.conv_nets import Autoencoder as JaxAutoencoder
    from qaig_tpu.models.conv_nets import AutoencoderConfig as JaxAEConfig
    from qaig_tpu.models.transformer import Transformer as JaxTransformer
    from qaig_tpu.models.transformer import TransformerConfig as JaxConfig
    from qaig_tpu.utils.checkpoint import flatten_tree
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from test_torch_port_models import random_params

    jm = JaxTransformer(JaxConfig(**CFG))
    params = random_params(jm.init, 21)
    jae = JaxAutoencoder(JaxAEConfig(**AE_CFG))
    ae_params = random_params(jae.init, 22)
    rng = np.random.default_rng(23)
    seq_in = 17
    keys = [jax.random.PRNGKey(30 + t) for t in range(STEPS)]
    starts = np.stack([np.asarray(jax.random.randint(
        k, (BATCH,), 0, seq_in - WINDOW + 1)) for k in keys])
    arrays = {
        "lr_codes": rng.standard_normal((LR_K, 32)).astype(np.float32),
        "hr_codes": rng.standard_normal((HR_K, 8)).astype(np.float32),
        "latents": rng.standard_normal(
            (STEPS, BATCH) + LATENT).astype(np.float32),
        "images": rng.uniform(-1, 1, (STEPS, BATCH, 3, 16, 16)).astype(
            np.float32),
        "starts": starts.astype(np.int64),
        "x_dec": rng.integers(0, HR_K + 1, (BATCH, WINDOW)),
        "x_enc": rng.integers(0, LR_K, (BATCH, 4)),
        "pos": np.stack([s + np.arange(WINDOW) for s in starts[0]]),
    }
    for prefix, tree in (("params", params), ("ae_params", ae_params)):
        for k, v in flatten_tree(jax.tree_util.tree_map(np.asarray,
                                                         tree)).items():
            arrays[f"{prefix}/{k}"] = v
    return arrays, (jm, params, jae, ae_params, keys)


def _launch(world, workdir):
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(REPO))
    env.pop("JAX_PLATFORMS", None)
    return [subprocess.Popen(
        [sys.executable, __file__, str(world), str(rank), str(workdir)],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for rank in range(world)]


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Both worlds run while the reference is computed; returns (the
    workdir, the reference inputs and models)."""
    workdir = tmp_path_factory.mktemp("parallel")
    arrays, ref = _reference_inputs()
    np.savez(workdir / "inputs.npz", **arrays)
    procs = _launch(2, workdir) + _launch(4, workdir)
    yield workdir, arrays, ref, procs
    for p in procs:
        if p.poll() is None:
            p.kill()


def _results(worlds, name):
    workdir, _, _, procs = worlds
    world = CASES[name][0]
    deadline = time.monotonic() + 300
    while not all((workdir / f"{name}_{r}.pt").exists()
                  for r in range(world)):
        failed = [p for p in procs if p.poll() not in (None, 0)]
        assert not failed, failed[0].stdout.read()[-4000:]
        assert time.monotonic() < deadline, "the worlds did not finish"
        time.sleep(0.1)
    out = {}
    for r in range(world):
        out.update(torch.load(workdir / f"{name}_{r}.pt",
                              weights_only=False))
    return out


_REF = {}


def _jax_steps(ref, arrays, kind, clip=None):
    """qaig_tpu's single-device train steps (cached by kind and clip):
    (losses, parameters, optimizer state) flat, or for "sgd" the
    gradients as old minus new parameters."""
    key = (kind, clip)
    if key in _REF:
        return _REF[key]
    import jax
    import jax.numpy as jnp
    import optax
    from qaig_tpu.models.codebook import Codebook as JaxCodebook
    from qaig_tpu.train.optim import make_adam
    from qaig_tpu.train.transformer import make_train_step
    from qaig_tpu.utils.checkpoint import flatten_tree

    jm, params, _, _, keys = ref

    def codebook(patch, k):
        return JaxCodebook(patch_dim=patch, image_dim=LATENT[1:],
                           image_channel=LATENT[0], num_embeddings=k,
                           init_neighbour_range=3)
    cb = ({"codebook": jnp.asarray(arrays["lr_codes"])},
          {"codebook": jnp.asarray(arrays["hr_codes"])})
    tx = make_adam(LR, LR_STEP) if kind == "adam" else optax.sgd(1.0)
    step = make_train_step(jm, tx, codebook((4, 4), LR_K),
                           codebook((2, 2), HR_K), False, LR_K, HR_K,
                           WINDOW, grad_clip=clip)
    p, state = params, tx.init(params)
    old = _flat(params)
    losses = []
    for t in range(STEPS if kind == "adam" else 1):
        p, state, loss = step(p, state, cb,
                              jnp.asarray(arrays["latents"][t]), keys[t])
        losses.append(float(loss))
    new = _flat(p)
    if kind == "sgd":
        _REF[key] = (losses, {k: old[k] - v for k, v in new.items()}, None)
    else:
        _REF[key] = (losses, new, {k: np.asarray(v) for k, v in
                                   flatten_tree(jax.tree_util.tree_map(
                                       np.asarray, state)).items()})
    return _REF[key]


def _flat(tree):
    import jax
    from qaig_tpu.utils.checkpoint import flatten_tree
    return {k: np.asarray(v) for k, v in flatten_tree(
        jax.tree_util.tree_map(np.asarray, tree)).items()}


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------

ADAM_CASES = [n for n, c in CASES.items() if c[4] == "adam"]


@pytest.mark.parametrize("name", ADAM_CASES)
def test_transformer_steps_match_jax_single_device(name, worlds):
    """Two Adam steps of the windowed cascade on the mesh against
    ``qaig_tpu``'s single-device steps: every rank's loss (the global
    mean), the gathered parameters and the gathered Adam moments."""
    _, arrays, ref, _ = worlds
    world, _, n_model, _, _, opts = CASES[name]
    losses, params, state = _jax_steps(ref, arrays, "adam", opts.get("clip"))
    got = _results(worlds, name)
    for r in range(world):
        np.testing.assert_allclose(got[f"losses_{r}"], losses, rtol=1e-5,
                                   err_msg=f"rank {r}")
    assert set(got["params"]) == set(params)
    for k, v in params.items():
        np.testing.assert_allclose(got["params"][k], v, atol=1e-5,
                                   err_msg=k)
    for k, v in state.items():
        np.testing.assert_allclose(got["opt"][k], v, atol=1e-6, err_msg=k)
    total = sum(v.size for v in params.values())
    if n_model > 1:   # each rank holds its TP shard, not the whole model
        assert got["shapes_0"].sum() < total
    if opts.get("zero"):   # ZeRO slices: half of what the rank holds
        assert got["master_numel"] <= got["shapes_0"].sum() // 2


@pytest.mark.parametrize("name", ["pp2_grads", "pp2tp2_grads"])
def test_pipelined_gradients_match_jax(name, worlds):
    """One SGD(lr=1) step through the GPipe schedule (2 microbatches):
    old minus new parameters are the gradients, the replicated parts'
    counted once (embeddings on stage 0, the classifier on the last)."""
    _, arrays, ref, _ = worlds
    losses, grads, _ = _jax_steps(ref, arrays, "sgd")
    got = _results(worlds, name)
    for r in range(CASES[name][0]):
        np.testing.assert_allclose(got[f"losses_{r}"], losses, rtol=1e-5)
    for k, v in grads.items():
        np.testing.assert_allclose(got["params"][k],
                                   _flat(ref[1])[k] - v, atol=1e-5,
                                   err_msg=k)


@pytest.mark.parametrize("name", ["pp2_logits", "pp2tp2_logits"])
def test_pipelined_logits_match_jax_apply(name, worlds):
    """``pipelined_apply`` gives every rank the unpipelined logits."""
    import jax.numpy as jnp
    _, arrays, ref, _ = worlds
    jm, params = ref[0], ref[1]
    want = np.asarray(jm.apply(params, jnp.asarray(arrays["x_dec"]),
                               x_enc=jnp.asarray(arrays["x_enc"]),
                               pos_cond=jnp.asarray(arrays["pos"])))
    got = _results(worlds, name)
    for r in range(CASES[name][0]):
        np.testing.assert_allclose(got[f"logits_{r}"], want, atol=1e-4,
                                   err_msg=f"rank {r}")


@pytest.mark.parametrize("name", ["ae_dp2", "ae_zero2", "cb_dp2"])
def test_front_steps_match_jax_single_device(name, worlds):
    """The autoencoder's (DP 2, ZeRO-1) and the codebook's (DP 2) steps
    against ``qaig_tpu``'s single-device steps on the same batches."""
    import jax.numpy as jnp
    from qaig_tpu.models.codebook import Codebook as JaxCodebook
    from qaig_tpu.train import autoencoder as jax_ae
    from qaig_tpu.train import codebook as jax_cb
    from qaig_tpu.train.optim import make_adam

    _, arrays, ref, _ = worlds
    tx = make_adam(LR, LR_STEP)
    if name.startswith("ae"):
        model, params = ref[2], ref[3]
        step = jax_ae.make_train_step(model, tx)
        batches = arrays["images"]
        call = (lambda p, s, b: step(p, s, b))
    else:
        model = JaxCodebook(patch_dim=(2, 2), image_dim=LATENT[1:],
                            image_channel=LATENT[0], num_embeddings=HR_K,
                            init_neighbour_range=3)
        params = {"codebook": jnp.asarray(arrays["hr_codes"])}
        step = jax_cb.make_train_step(model, tx)
        batches = arrays["latents"]
        call = (lambda p, s, b: step(p, s, b, 3.0))
    state, losses = tx.init(params), []
    for t in range(STEPS):
        params, state, loss = call(params, state, jnp.asarray(batches[t]))
        losses.append(float(loss))
    got = _results(worlds, name)
    for r in range(CASES[name][0]):
        np.testing.assert_allclose(got[f"losses_{r}"], losses, rtol=1e-5)
    for k, v in _flat(params).items():
        np.testing.assert_allclose(got["params"][k], v, atol=1e-5,
                                   err_msg=k)


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
