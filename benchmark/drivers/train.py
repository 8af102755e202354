"""Training of the windowed cascade stage: the port's graphed
``make_train_step`` fed by the port's feature-map loader
(``FeatureMapDataset`` over ``.npy`` latents, ``DataLoader``, the native
batch loader), as the trainer's CLI feeds it.

Set-up writes the data set from the seed under the run's temporary
directory, builds the step, and drives it through its first steps, the
same object the window then drives: the reference follows the first
three.  Traffic parameters: ``samples`` (latents written), ``warm_steps``
(steps after the three checked ones, before the window), ``trace_steps``
(steps profiled after the window in a traced run, whose record keeps the
program's span seconds by name, ``trace["spans"]``).

The window's steps are queued with no wait of the benchmark's own: each
batch goes through a pinned buffer and is copied without a synchronise,
and the loop waits at most for the step ``AHEAD_S`` seconds back.  How far
ahead of the card the host gets is then the program's to decide (on an
H100 the step itself holds it about two steps ahead: the queue drains in
0.5-0.7 s; the result line's ``window``).  When ``--seconds`` are up the
loop queues nothing more and waits for every step it queued; the window
closes there: ``train_samples_per_s`` is every sample of the window's
steps over its length; the loop's waits on the loader are timed apart.
"""

import collections
import gc
import math
import shutil
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from benchmark import checks, system
from benchmark import reference as ref
from benchmark import trace as tr
from benchmark import weights as bw

CHECKED_STEPS = 3
AHEAD_S = 5.0   # seconds of steps queued ahead of the one waited for


def make_data(config, samples, seed, device):
    """(lr codes (K, C*lp*lp), hr codes (K, C*hp*hp), latents
    (samples, C, H, W)) drawn from the seed: each LR patch of a latent is
    one of K LR codes, each built of HR patches that are HR codes, plus a
    little noise."""
    gen = bw.generator(seed, bw.STREAM_DATA, device)
    k, c = config["num_embeddings"], config["image_C"]
    lp, hp = config["lr_patch"][0], config["hr_patch"][0]
    per = lp // hp
    hr_codes = torch.randn(k, c * hp * hp, generator=gen,
                           device=device) * 0.5
    parts = torch.randint(0, k, (k, per, per), generator=gen, device=device)
    proto = hr_codes[parts].reshape(k, per, per, c, hp, hp)
    proto = proto.permute(0, 3, 1, 4, 2, 5).reshape(k, c, lp, lp)
    lr_codes = proto.reshape(k, c * lp * lp)
    gh, gw = config["image_H"] // lp, config["image_W"] // lp
    choice = torch.randint(0, k, (samples, gh, gw), generator=gen,
                           device=device)
    lat = proto[choice].permute(0, 3, 1, 4, 2, 5).reshape(
        samples, c, gh * lp, gw * lp)
    lat = lat + 0.02 * torch.randn(lat.shape, generator=gen, device=device)
    return lr_codes, hr_codes, lat


def write_dataset(latents, root, threads=8):
    """One ``.npy`` a latent under ``root`` and the manifest over them.
    The files are written from a few threads: creating a file costs a
    round trip to the file system, which the threads overlap."""
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    host = latents.cpu().numpy()
    paths = [root / f"{i:05d}.npy" for i in range(len(host))]
    with ThreadPoolExecutor(threads) as pool:
        list(pool.map(np.save, paths, host))
    rows = [{"fmap_path": str(path), "image_path": ""} for path in paths]
    return system.write_manifest(root / "manifest.json", rows)


def run(ctx):
    cfg, traffic, device = ctx.config, ctx.traffic, ctx.device
    cuda = device.startswith("cuda")
    batch = cfg["batch_size"]
    marks = [("to_driver", time.perf_counter())]
    lr_codes, hr_codes, latents = make_data(cfg, traffic["samples"],
                                            ctx.seed, device)
    # a directory of its own: runs in parallel (the CPU tests) share TMPDIR
    data_dir = Path(tempfile.mkdtemp(prefix="qaig_benchmark_fmaps_"))
    manifest = write_dataset(latents, data_dir)
    marks.append(("data", time.perf_counter()))
    model, optimizer, step, weights = system.build_trainer(
        cfg, ctx.seed, device, lr_codes, hr_codes)
    loader = system.fmap_loader(manifest, batch, ctx.seed)
    marks.append(("build", time.perf_counter()))
    window_gen = torch.Generator().manual_seed(ctx.seed)
    state = {"it": iter(loader), "wait": 0.0}

    def next_batch():
        t = time.perf_counter()
        try:
            b = next(state["it"])
        except StopIteration:
            state["it"] = iter(loader)
            b = next(state["it"])
        state["wait"] += time.perf_counter() - t
        return b

    def one_step():
        b = next_batch()
        return b, step(torch.from_numpy(b).to(device), window_gen)

    params = dict(model.named_parameters())
    beta1 = cfg["adam"]["beta1"]
    fed, losses = [], []
    for i in range(CHECKED_STEPS):
        b, loss = one_step()
        fed.append(b.copy())
        losses.append(loss)
        if i == 0:
            grads = {n: optimizer.state[p]["exp_avg"].detach().clone()
                     / (1.0 - beta1) if "exp_avg" in optimizer.state[p]
                     else torch.zeros_like(p) for n, p in params.items()}
    after = {n: p.detach().clone() for n, p in params.items()}
    marks.append(("checked_steps", time.perf_counter()))
    queue_step, ring = queued_feed(step, next_batch, window_gen, device)
    if cuda:
        torch.cuda.synchronize(device)
    t_warm = time.perf_counter()
    for _ in range(traffic["warm_steps"]):
        queue_step()
    if cuda:
        torch.cuda.synchronize(device)
        ring.set_depth(max(2, math.ceil(
            AHEAD_S * traffic["warm_steps"] / (time.perf_counter() - t_warm))))
        torch.cuda.reset_peak_memory_stats(device)

    t_start = time.perf_counter()
    setup_s = t_start - ctx.t0
    marks.append(("warm_steps", t_start))
    ends = [ctx.t0] + [t for _, t in marks]
    setup_parts = {name: ends[i + 1] - ends[i]
                   for i, (name, _) in enumerate(marks)}
    deadline = t_start + ctx.seconds
    state["wait"] = 0.0
    steps = 0
    while True:
        queue_step()
        steps += 1
        if time.perf_counter() >= deadline:
            break
    if cuda:
        torch.cuda.synchronize(device)
    window_s = time.perf_counter() - t_start
    record = {"setup_s": setup_s, "window_s": window_s, "steps": steps,
              "batch": batch, "samples": steps * batch,
              "attempted": steps * batch, "failed": 0,
              "loader_wait_s": state["wait"], "setup_parts": setup_parts,
              "window": {"seconds": window_s, "steps": steps,
                         "queued_ahead": ring.depth},
              "memory_peak_bytes": (torch.cuda.max_memory_allocated(device)
                                    if cuda else 0),
              "graph_setup_s": system.graph_setup_seconds(step.runner)}
    if ctx.trace:
        from qaig_tpu_torch.utils import spans

        def traced():
            for _ in range(traffic["trace_steps"]):
                queue_step()
        spans.reset()
        _, record["trace"] = tr.profile(traced, device)
        record["trace"]["spans"] = spans.totals()
        record["trace_steps"] = traffic["trace_steps"]

    init = weights.views("model.")
    base = {n: init[n] for n in params}
    prog = {"losses": [float(x) for x in losses], "grads": grads,
            "deltas": {n: after[n] - base[n] for n in params}}
    del model, optimizer, step, params, loader, state, queue_step, ring
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    shutil.rmtree(data_dir, ignore_errors=True)
    t_ref = time.perf_counter()
    starts = starts_of(cfg, ctx.seed)
    refr = reference_steps(cfg, base, lr_codes, hr_codes, fed, starts,
                           device)
    record["readings"], record["leaves"] = checks.train_readings(prog, refr)
    if ctx.control:
        with tf32():
            ctrl = reference_steps(cfg, base, lr_codes, hr_codes, fed,
                                   starts, device)
        c_read, _ = checks.train_readings(ctrl, refr)
        record["readings"].update({f"{k}.control": v
                                   for k, v in c_read.items()})
    record["reference_s"] = time.perf_counter() - t_ref
    return record


class _Ring:
    """Pinned host buffers for the batches, one more than the steps that
    may be queued (``depth``): a buffer is written again only once the
    step that last read it has run."""

    def __init__(self):
        self.depth, self.bufs = 2, []

    def set_depth(self, depth):
        """Call with no step queued."""
        self.depth = depth
        if self.bufs:
            self._grow(self.bufs[0])

    def _grow(self, like):
        self.bufs += [torch.empty_like(like).pin_memory()
                      for _ in range(self.depth + 1 - len(self.bufs))]

    def fill(self, n, batch):
        if not self.bufs:
            self._grow(torch.from_numpy(batch))
        buf = self.bufs[n % len(self.bufs)]
        buf.numpy()[...] = batch
        return buf


def queued_feed(step, next_batch, generator, device):
    """(queue_step, ring): ``queue_step()`` takes the loader's next batch
    and queues one train step on it, waiting only, once ``ring.depth``
    steps are queued, for the oldest of them.  On the CPU it runs the
    step."""
    if torch.device(device).type != "cuda":
        return (lambda: step(torch.from_numpy(next_batch()), generator),
                _Ring())
    queued, ring, count = collections.deque(), _Ring(), [0]

    def queue_step():
        b = next_batch()
        while len(queued) >= ring.depth:
            queued.popleft().synchronize()
        buf = ring.fill(count[0], b)
        count[0] += 1
        loss = step(buf.to(device, non_blocking=True), generator)
        done = torch.cuda.Event()
        done.record()
        queued.append(done)
        return loss

    return queue_step, ring


class tf32:
    """TF32 on for the products inside (the control of a float32
    configuration)."""

    def __enter__(self):
        self.saved = (torch.backends.cuda.matmul.allow_tf32,
                      torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True

    def __exit__(self, *exc):
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = self.saved


def starts_of(config, seed):
    """The window starts of the checked steps, drawn again as the trainer
    draws them: one per sample from ``[0, seq - window]`` off a CPU
    generator seeded with the run's seed."""
    _, hr_len, _ = _lengths(config)
    gen = torch.Generator().manual_seed(seed)
    n = config["batch_size"]
    return [torch.randint(0, hr_len + 1 - config["sliding_window"] + 1,
                          (n,), generator=gen)
            for _ in range(CHECKED_STEPS)]


def _lengths(config):
    ih, iw = config["image_H"], config["image_W"]
    lr = (ih // config["lr_patch"][0]) * (iw // config["lr_patch"][1])
    hr = (ih // config["hr_patch"][0]) * (iw // config["hr_patch"][1])
    return lr, hr, config["sliding_window"]


def reference_steps(config, init, lr_codes, hr_codes, batches, starts,
                    device, block=16):
    """The plain reference's first steps: BMU tokens of both codebooks,
    the windowed sequences, the teacher-forced loss, its gradients and
    Adam, from the initial weights ``init``.  Returns the losses, the
    first step's gradients and the change over the steps."""
    k = config["num_embeddings"]
    adam = config["adam"]
    lr_rate = config["model_lr"]
    p = {n: t.detach().clone().to(device).requires_grad_(True)
         for n, t in init.items()}
    model = ref.Model(p, config["self_attn_heads"],
                      config["cross_attn_heads"], True,
                      config["use_sliding_window"], config["num_enc_layers"],
                      config["num_dec_layers"])
    m = {n: torch.zeros_like(t) for n, t in p.items()}
    v = {n: torch.zeros_like(t) for n, t in p.items()}
    losses, first_grads = [], None
    window = config["sliding_window"]
    for t, (b, st) in enumerate(zip(batches, starts), start=1):
        x = torch.from_numpy(b).to(device)
        lr_idx = ref.bmu(x, lr_codes, tuple(config["lr_patch"]))
        hr_idx = ref.bmu(x, hr_codes, tuple(config["hr_patch"]))
        n = x.shape[0]
        end = torch.full((n, 1), k, dtype=torch.long, device=device)
        hr_in = torch.cat([end, hr_idx], 1)
        hr_tgt = torch.cat([hr_idx, end], 1)
        pos = st.to(device)[:, None] + torch.arange(window, device=device)
        hr_in, hr_tgt = hr_in.gather(1, pos), hr_tgt.gather(1, pos)
        for g in p.values():
            g.grad = None
        total = 0.0
        for lo in range(0, n, block):
            sl = slice(lo, lo + block)
            logits = model.logits(hr_in[sl], lr_idx[sl], pos[sl])
            loss = torch.nn.functional.cross_entropy(
                logits.reshape(-1, logits.shape[-1]), hr_tgt[sl].reshape(-1),
                reduction="sum") / (n * window)
            loss.backward()
            total += float(loss.detach())
        losses.append(total)
        with torch.no_grad():
            if first_grads is None:
                first_grads = {nm: g.grad.clone() for nm, g in p.items()}
            b1, b2, eps = adam["beta1"], adam["beta2"], adam["eps"]
            for nm, w in p.items():
                g = w.grad
                m[nm].mul_(b1).add_(g, alpha=1 - b1)
                v[nm].mul_(b2).addcmul_(g, g, value=1 - b2)
                denom = (v[nm] / (1 - b2 ** t)).sqrt().add_(eps)
                w.sub_(lr_rate * (m[nm] / (1 - b1 ** t)) / denom)
    deltas = {nm: (w.detach() - init[nm].to(device)) for nm, w in p.items()}
    return {"losses": losses, "grads": first_grads, "deltas": deltas}
