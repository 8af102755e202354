"""Converged-run quality ledger: the full 6-stage pipeline on the card (the
port's counterpart of ``scripts/quality_run.py``).

It trains every stage on a structured synthetic dataset at the reference
README's shapes (128x128x3 images, latent 32x32x4, K=512 codebooks, in_dim
512 / hidden 2048 / 7-layer transformers) through the port's trainers,
and records

  - the autoencoder's reconstruction-PSNR trajectory (per checkpoint,
    held-out split),
  - each codebook's quantized-PSNR trajectory (per checkpoint), before and
    after pruning, and a larger-K side experiment,
  - the transformers' cross-entropy curves (each stage's metrics.jsonl)
    and their preview PSNRs,
  - the preview grids and the final 25-image generation grid,

in ``<out>/quality.json`` (+ copied grids), the schema
``render_quality.py`` reads.  The report also holds each stage's wall
seconds (``stage_seconds``) and, on the card, ``torch.cuda.memory_
allocated`` / ``memory_reserved`` after each stage (``memory``), which are
also logged.  Between stages the previous trainer's modules, graphs and
their memory pools are let go (``gc.collect`` + ``empty_cache``).

    python -m qaig_tpu_torch.scripts.quality_run --out-dir q [--resume]
    python -m qaig_tpu_torch.scripts.quality_run --smoke --device cpu \\
        --out-dir q

``--device`` is ``cuda`` (the default; raises without a card) or ``cpu``.
The dataset is the JAX side's, draw for draw (gradient backgrounds with
1-3 anti-aliased shapes from ``np.random.default_rng(seed)``), written as
PNGs by ``utils/png.py::encode``.
"""

import argparse
import gc
import json
import pathlib
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

from qaig_tpu_torch.data.image_dataset import ImageDataset
from qaig_tpu_torch.data.manifest import write_manifest
from qaig_tpu_torch.infer import generate as gen_stage
from qaig_tpu_torch.scripts.eval_quality import psnr_db
from qaig_tpu_torch.train import autoencoder as ae_stage
from qaig_tpu_torch.train import codebook as cb_stage
from qaig_tpu_torch.train import common
from qaig_tpu_torch.train import fmap as fmap_stage
from qaig_tpu_torch.train import prune as prune_stage
from qaig_tpu_torch.train import transformer as tf_stage
from qaig_tpu_torch.utils import png
from qaig_tpu_torch.utils.checkpoint import load_model


# ---------------------------------------------------------------------------
# dataset
# ---------------------------------------------------------------------------

def make_dataset(out_dir, n_images, seed, size=128):
    """Structured synthetic images: 2-color gradient background + 1-3
    anti-aliased solid shapes (circle / square) at random positions."""
    rng = np.random.default_rng(seed)
    img_dir = pathlib.Path(out_dir) / "imgs"
    img_dir.mkdir(parents=True, exist_ok=True)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / (size - 1)
    rows = []
    for i in range(n_images):
        c0, c1 = rng.uniform(0, 255, (2, 3)).astype(np.float32)
        ang = rng.uniform(0, 2 * np.pi)
        t = (np.cos(ang) * xx + np.sin(ang) * yy + 1) / 2
        img = c0[None, None] * (1 - t[..., None]) + c1[None, None] * t[..., None]
        for _ in range(rng.integers(1, 4)):
            color = rng.uniform(0, 255, 3).astype(np.float32)
            cx, cy = rng.uniform(0.15, 0.85, 2)
            r = rng.uniform(0.08, 0.25)
            if rng.random() < 0.5:  # circle (soft 2px edge)
                d = np.sqrt((xx - cx) ** 2 + (yy - cy) ** 2)
                mask = np.clip((r - d) * size / 2, 0, 1)
            else:  # axis-aligned square
                mask = (np.clip((r - np.abs(xx - cx)) * size / 2, 0, 1)
                        * np.clip((r - np.abs(yy - cy)) * size / 2, 0, 1))
            img = img * (1 - mask[..., None]) + color[None, None] * mask[..., None]
        path = str(img_dir / f"{i:04d}.png")
        pathlib.Path(path).write_bytes(
            png.encode(img.clip(0, 255).astype(np.uint8)))
        rows.append({"image_fpath": path, "labels": []})
    manifest = str(pathlib.Path(out_dir) / "dataset.json")
    write_manifest(manifest, rows)
    return manifest, [r["image_fpath"] for r in rows]


# ---------------------------------------------------------------------------
# evaluation helpers (in-process, batches kept on the device)
# ---------------------------------------------------------------------------

class QualityEval:
    """Held-out reconstruction/quantization PSNR against an image set."""

    def __init__(self, manifest_path, device, batch_size=32):
        ds = ImageDataset(manifest_path)
        self.batches = []
        for s in range(0, len(ds), batch_size):
            host = np.stack([ds[i] for i in range(s, min(s + batch_size,
                                                         len(ds)))])
            self.batches.append((host, torch.from_numpy(host).to(device)))

    def _mean(self, fn):
        vals, w = [], []
        with torch.inference_mode():
            for host, x in self.batches:
                vals.append(psnr_db(host, fn(x).float().cpu().numpy()))
                w.append(host.shape[0])
        return round(float(np.average(vals, weights=w)), 3)

    def psnr_recon(self, ae):
        return self._mean(ae)

    def psnr_quantized(self, ae, cb):
        """Encoder -> BMU tokens (the BMU kernel on the card) -> codebook
        lookup -> decoder."""
        def f(x):
            tokens = cb.get_patches_bmu(ae.get_latent(x), reshape=True)
            return ae.recon_image(cb.get_quantized_image(tokens))
        return self._mean(f)


def ce_max_last_half(out_dir, max_steps):
    """Max per-step CE over the second half of training, from the FULL
    metrics stream (the downsampled curve can miss a one-step spike)."""
    path = pathlib.Path(out_dir) / "metrics.jsonl"
    if not path.exists():
        return None
    worst = None
    for line in path.read_text().splitlines():
        try:
            rec = json.loads(line)
        except json.JSONDecodeError:
            continue
        if "ce_loss" in rec and rec.get("step", 0) >= max_steps // 2:
            v = float(rec["ce_loss"])
            worst = v if worst is None else max(worst, v)
    return round(worst, 4) if worst is not None else None


def preview_psnr(stage_dir):
    """Per-checkpoint PSNR between the trainer's AR preview grid and its
    ground-truth grid (the visual-verification pair the train loop
    writes).  Both grids are JPEGs, so the absolute value carries a small
    consistent compression bias; the per-checkpoint trend is the signal."""
    from PIL import Image
    img_dir = pathlib.Path(stage_dir) / "images"
    out = []
    for recon in sorted(img_dir.glob("high_res_recon_*.jpg"),
                        key=lambda p: int(p.stem.split("_")[-1])):
        step = int(recon.stem.split("_")[-1])
        gt = img_dir / f"ground_truth_{step}.jpg"
        if not gt.exists():
            continue
        a = np.asarray(Image.open(recon), np.float32)
        b = np.asarray(Image.open(gt), np.float32)
        if a.shape != b.shape:
            continue
        mse = float(np.mean((a - b) ** 2))
        out.append({"step": step,
                    "psnr_db": round(10 * np.log10(255.0 ** 2 / mse), 3)
                    if mse > 0 else float("inf")})
    return out


def checkpoints(out_dir, prefix="model"):
    d = pathlib.Path(out_dir) / "models_checkpoint"
    return sorted(d.glob(f"{prefix}_*.pt"),
                  key=lambda p: int(p.stem.split("_")[-1]))


class EvalCache:
    """Per-checkpoint eval results (PSNR), persisted as they land, so a
    run continued with ``--resume`` never evaluates a checkpoint twice."""

    def __init__(self, path):
        self.path = pathlib.Path(path)
        try:
            self.data = json.loads(self.path.read_text())
        except (OSError, json.JSONDecodeError):
            self.data = {}

    def get(self, key):
        return self.data.get(key)

    def put(self, key, value):
        self.data[key] = value
        tmp = self.path.with_suffix(".tmp")
        tmp.write_text(json.dumps(self.data))
        tmp.replace(self.path)
        return value

    def drop_prefix(self, prefix):
        stale = [k for k in self.data if k.startswith(prefix)]
        for k in stale:
            del self.data[k]
        if stale:
            self.put("_invalidated", prefix)  # also flushes the deletes


def _metrics_last_step(out_dir):
    path = pathlib.Path(out_dir) / "metrics.jsonl"
    if not path.exists():
        return -1
    lines = path.read_text().splitlines()
    for line in reversed(lines):
        try:
            return int(json.loads(line).get("step", -1))
        except (json.JSONDecodeError, ValueError):
            continue
    return -1


def stage_trained(out_dir, prefix, steps, every):
    """A training stage counts as complete when its last scheduled
    checkpoint exists AND its metrics stream reached the final step.
    Everything downstream consumes only ``checkpoints(...)[-1]`` (the
    trainers do not write an extra checkpoint at max_steps), so this is
    exactly the state the pipeline needs: ``--resume`` is safe after a
    kill at any point."""
    final = ((steps - 1) // every) * every
    ck = pathlib.Path(out_dir) / "models_checkpoint" / f"{prefix}_{final}.pt"
    return ck.exists() and _metrics_last_step(out_dir) >= steps - 1


def loss_curve(out_dir, key, every=50):
    """Downsampled per-step losses from a stage's metrics.jsonl."""
    path = pathlib.Path(out_dir) / "metrics.jsonl"
    if not path.exists():
        return []
    curve = []
    for line in path.read_text().splitlines():
        try:
            rec = json.loads(line)
        except json.JSONDecodeError:
            continue
        if key in rec and "step" in rec:
            curve.append((int(rec["step"]), float(rec[key])))
    out = [pt for pt in curve if pt[0] % every == 0 or pt[0] <= 1]
    if curve and (not out or out[-1][0] != curve[-1][0]):
        out.append(curve[-1])
    return out


def device_name(device):
    """``"cpu"``, or the card's name and power limit as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` prints them."""
    if device.type != "cuda":
        return "cpu"
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    lines = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    return lines[index].strip()


def release(device):
    """Let go of what the last stage left (its modules, graphs and their
    pools) and return the cached blocks to the card: (allocated, reserved)
    bytes after, or None on the CPU."""
    gc.collect()
    if device.type != "cuda":
        return None
    torch.cuda.synchronize(device)
    torch.cuda.empty_cache()
    return (torch.cuda.memory_allocated(device),
            torch.cuda.memory_reserved(device))


# ---------------------------------------------------------------------------
# the run
# ---------------------------------------------------------------------------

def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out-dir", required=True, type=pathlib.Path)
    parser.add_argument("--num-images", type=int, default=256)
    parser.add_argument("--eval-images", type=int, default=32,
                        help="held-out split for the PSNR trajectories")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    parser.add_argument("--ae-steps", type=int, default=3000)
    parser.add_argument("--ae-batch", type=int, default=16)
    # 2x the neighbourhood anneal (fully annealed at (K//2)*nstep = 2560
    # steps); the post-anneal half runs winner-take-all SOM refinement at
    # range 0
    parser.add_argument("--cb-steps", type=int, default=5200)
    parser.add_argument("--cb-batch", type=int, default=64)
    parser.add_argument("--tf-steps", type=int, default=2000)
    parser.add_argument("--tf-batch", type=int, default=32)
    parser.add_argument("--ckpt-every", type=int, default=500)
    parser.add_argument("--gen-images", type=int, default=25)
    parser.add_argument("--no-prune", action="store_true",
                        help="skip the prune_codebook stage (the reference "
                             "workflow trains codebooks, prunes underused "
                             "codes, then trains transformers on the pruned "
                             "codebooks)")
    parser.add_argument("--no-k-exp", action="store_true",
                        help="skip the larger-K side experiment on the "
                             "finest codebook (measures whether the "
                             "quantization-PSNR ceiling is K-bound)")
    parser.add_argument("--final-stage-ema", type=float, default=0.999,
                        help="--ema-decay for the LAST cascade stage; "
                             "0 disables")
    parser.add_argument("--final-stage-grad-clip", type=float, default=1.0,
                        help="--grad-clip for the LAST cascade stage; "
                             "0 disables")
    parser.add_argument("--bf16-transformers", action="store_true",
                        help="train the transformer stages in bf16 "
                             "(mixed precision; AE/codebooks stay fp32)")
    parser.add_argument("--cb-patches", default=None,
                        help="comma-separated subset of codebook names to "
                             "train (e.g. 'p2'); default: all scales.  Only "
                             "with --stop-after codebooks (transformer "
                             "stages need every codebook)")
    parser.add_argument("--stop-after", choices=["codebooks"], default=None,
                        help="stop after the named stage (writes quality.json "
                             "+ the tf_*.json configs so quality_bf16_ab "
                             "can consume the run without training the "
                             "transformer stages)")
    parser.add_argument("--resume", action="store_true",
                        help="skip stages whose training already completed "
                             "in --out-dir (cheap file-based evals are "
                             "recomputed); a partially-trained stage is "
                             "wiped and retrained")
    parser.add_argument("--smoke", action="store_true",
                        help="tiny shapes + step counts: validates the "
                             "whole flow on the CPU in a minute (the "
                             "quality numbers are meaningless at this scale)")
    return parser, parser.parse_args(argv)


def scale_table(args):
    """The run's shapes (and, under ``--smoke``, its step counts)."""
    if args.smoke:
        args.image_size = 16
        args.num_images = min(args.num_images, 24)
        args.eval_images = min(args.eval_images, 8)
        args.ae_steps, args.cb_steps, args.tf_steps = 20, 20, 10
        args.ae_batch = args.cb_batch = args.tf_batch = 4
        args.ckpt_every = 10
        args.gen_images = 4
        return {
            "ae": {"min_channel": 8, "max_channel": 16, "latent_channel": 2},
            "latent_hw": 4, "K": 16, "nstep": 2,
            "cbs": [("p4", 4), ("p2", 2), ("p1", 1)],
            "tf": {"in_dim": 16, "hidden_dim": 32, "dec_layers": 2,
                   "enc_layers": 1, "heads": 2},
            "sliding": 4,
            "beams": [(2, 2, 1.0), (2, 4, 1.0)],  # (num_beam, bw, temp)
        }
    args.image_size = 128
    return {
        "ae": {"min_channel": 256, "max_channel": 512, "latent_channel": 4},
        "latent_hw": 32, "K": 512, "nstep": 10,
        "cbs": [("p32", 32), ("p8", 8), ("p4", 4), ("p2", 2)],
        "tf": {"in_dim": 512, "hidden_dim": 2048, "dec_layers": 7,
               "enc_layers": 5, "heads": 64},
        "sliding": 256,
        # reference examples/configs/generate.json beam plan
        "beams": [(32, 16, 1.5), (4, 8, 1.0), (4, 8, 1.5)],
    }


def codebook_subset(parser, args, cbs):
    """The (name, patch) codebooks this run trains: every one of the
    scale, or the ``--cb-patches`` subset.  Unknown names, and a subset
    without ``--stop-after codebooks``, are parser errors (raised before
    any stage runs)."""
    if not args.cb_patches:
        return cbs
    wanted = args.cb_patches.split(",")
    unknown = [n for n in wanted if n not in dict(cbs)]
    if unknown:
        parser.error(f"--cb-patches: unknown codebook name(s) "
                     f"{', '.join(unknown)} (this scale has "
                     f"{', '.join(n for n, _ in cbs)})")
    if args.stop_after != "codebooks" and not set(wanted).issuperset(
            n for n, _ in cbs):
        parser.error("--cb-patches subsets require --stop-after "
                     "codebooks (transformers consume every codebook)")
    return [(n, p) for n, p in cbs if n in wanted]


def main(argv=None):
    """The whole run; returns the report (also written to
    ``<out>/quality.json``)."""
    parser, args = parse_args(argv)
    scale = scale_table(args)
    cbs = codebook_subset(parser, args, scale["cbs"])
    device = common.select_device(args.device)

    out = args.out_dir
    out.mkdir(parents=True, exist_ok=True)
    t_start = time.time()
    report = {"device": device_name(device),
              "backend": device.type,
              "seed": args.seed,
              "num_images": args.num_images,
              "eval_images": args.eval_images,
              "argv": list(sys.argv[1:] if argv is None else argv),
              "stages": {}, "stage_seconds": {}, "memory": []}

    def stage_args(extra):
        base = {"device": args.device, "seed": args.seed}
        base.update(extra)
        return base

    def note(msg):
        print(f"[quality +{time.time() - t_start:7.1f}s] {msg}",
              flush=True)

    t_stage = [time.time()]

    def stage_done(name):
        """The stage's wall seconds, then what it held let go, and the
        card's memory after it."""
        now = time.time()
        report["stage_seconds"][name] = round(now - t_stage[0], 1)
        mem = release(device)
        if mem is not None:
            report["memory"].append({"after": name, "allocated": mem[0],
                                     "reserved": mem[1]})
            note(f"memory after {name}: allocated {mem[0] / 2**20:.1f} MiB, "
                 f"reserved {mem[1] / 2**20:.1f} MiB")
        t_stage[0] = time.time()

    evcache = EvalCache(out / "eval_cache.json")

    def maybe_train(run_fn, run_args, stage_out, prefix, steps):
        """Run a training stage unless --resume finds it already complete."""
        if args.resume and stage_trained(stage_out, prefix, steps,
                                         args.ckpt_every):
            note(f"resume: {pathlib.Path(stage_out).name} already trained, "
                 f"skipping")
            return
        if args.resume and pathlib.Path(stage_out).exists():
            note(f"resume: {pathlib.Path(stage_out).name} incomplete, "
                 f"retraining from scratch")
            shutil.rmtree(stage_out)
        evcache.drop_prefix(pathlib.Path(stage_out).name + "/")
        run_fn(run_args)

    def load(path):
        status, ckpt = load_model(str(path))
        if not status:
            raise RuntimeError(f"could not load checkpoint {path}")
        return ckpt

    def codebook_trajectory(stage_dir):
        traj = []
        for ck in checkpoints(stage_dir, prefix="codebook"):
            key = f"{pathlib.Path(stage_dir).name}/{ck.stem}"
            val = evcache.get(key)
            if val is None:
                cb = common.codebook_from_checkpoint(load(ck), device)
                val = evcache.put(key, evaluator.psnr_quantized(ae, cb))
                del cb
            traj.append({"step": int(ck.stem.split("_")[-1]),
                         "psnr_quantized_db": val})
        return traj

    # -- dataset -------------------------------------------------------------
    manifest, paths = make_dataset(out, args.num_images + args.eval_images,
                                   args.seed, size=args.image_size)
    train_paths = paths[:args.num_images]
    eval_paths = paths[args.num_images:]
    train_manifest = str(out / "train_dataset.json")
    write_manifest(train_manifest,
                   [{"image_fpath": p, "labels": []} for p in train_paths])
    eval_manifest = str(out / "eval_dataset.json")
    write_manifest(eval_manifest,
                   [{"image_fpath": p, "labels": []} for p in eval_paths])
    evaluator = QualityEval(eval_manifest, device)
    note(f"dataset: {args.num_images} train + {args.eval_images} eval")
    stage_done("dataset")

    # -- stage 1: autoencoder --------------------------------------------------
    ae_cfg = out / "ae.json"
    ae_cfg.write_text(json.dumps({
        # reference README schema/shapes (model_lr raised 1e-5 -> 1e-4 for
        # convergence within the run budget on 256 images)
        "model_lr": 1e-4, "image_channel": 3,
        "min_channel": scale["ae"]["min_channel"],
        "max_channel": scale["ae"]["max_channel"], "num_layers": 2,
        "latent_channel": scale["ae"]["latent_channel"],
        "hidden_activation_type": "silu",
        "use_final_enc_activation": True, "encoder_activation_type": "tanh",
        "use_final_dec_activation": True, "decoder_activation_type": "tanh"}))
    ae_out = out / "ae"
    maybe_train(ae_stage.run, stage_args({
        "dataset_path": train_manifest, "config_path": ae_cfg,
        "out_dir": ae_out, "batch_size": args.ae_batch,
        "checkpoint_step": args.ckpt_every, "lr_step": 10 * args.ae_steps,
        "max_epoch": 10 ** 9, "max_steps": args.ae_steps}),
        ae_out, "model", args.ae_steps)

    traj = []
    for ck in checkpoints(ae_out):
        key = f"ae/{ck.stem}"
        val = evcache.get(key)
        if val is None:
            ae, _ = common.autoencoder_from_checkpoint(load(ck), device)
            val = evcache.put(key, evaluator.psnr_recon(ae))
            del ae
        traj.append({"step": int(ck.stem.split("_")[-1]),
                     "psnr_recon_db": val})
        note(f"AE ckpt {ck.name}: {val} dB")
    ae_ckpt = checkpoints(ae_out)[-1]
    report["stages"]["autoencoder"] = {
        "steps": args.ae_steps, "batch": args.ae_batch,
        "psnr_trajectory": traj,
        "loss_curve": loss_curve(ae_out, "recon_loss",
                                 every=args.ckpt_every // 2),
        "checkpoint": str(ae_ckpt)}
    stage_done("autoencoder")

    # -- stage 2: feature maps -------------------------------------------------
    fmap_done = out / "fmaps" / "all_dataset.json"
    if args.resume and fmap_done.exists():
        fmap_manifest = str(fmap_done)
        note("resume: feature maps already cached, skipping")
    else:
        if args.resume and (out / "fmaps").exists():
            shutil.rmtree(out / "fmaps")
        fmap_manifest = fmap_stage.run(stage_args({
            "dataset_path": train_manifest, "model_path": ae_ckpt,
            "out_dir": out / "fmaps", "batch_size": 64}))
        note("feature maps cached")
    stage_done("feature_maps")

    # -- stage 3: codebooks ------------------------------------------------------
    ae, _ = common.autoencoder_from_checkpoint(load(ae_ckpt), device)

    cb_ckpts, cb_traj = {}, {}
    hw, K = scale["latent_hw"], scale["K"]
    for name, patch in cbs:
        cfg = out / f"cb_{name}.json"
        cfg.write_text(json.dumps({
            "model_lr": 1e-3, "image_H": hw, "image_W": hw,
            "image_C": scale["ae"]["latent_channel"],
            "patch_H": patch, "patch_W": patch, "num_embeddings": K,
            # range starts at K//2 and decrements every neighbourhood_step
            # global steps -> fully annealed by ~(K//2)*nstep steps
            "neighbourhood_step": scale["nstep"]}))
        cb_out = out / f"cb_{name}"
        maybe_train(cb_stage.run, stage_args({
            "dataset_path": fmap_manifest, "decoder_path": ae_ckpt,
            "config_path": cfg, "out_dir": cb_out,
            "batch_size": args.cb_batch, "checkpoint_step": args.ckpt_every,
            "lr_step": 10 * args.cb_steps, "max_epoch": 10 ** 9,
            "max_steps": args.cb_steps}),
            cb_out, "codebook", args.cb_steps)
        cb_ckpts[name] = checkpoints(cb_out, prefix="codebook")[-1]
        cb_traj[name] = codebook_trajectory(cb_out)
        note(f"codebook {name}: " + " -> ".join(
            str(p["psnr_quantized_db"]) for p in cb_traj[name]))
        report["stages"][f"codebook_{name}"] = {
            "patch": patch, "steps": args.cb_steps,
            "psnr_trajectory": cb_traj[name],
            "checkpoint": str(cb_ckpts[name])}
        stage_done(f"codebook_{name}")

        # -- stage 4: prune_codebook (train codebook -> prune underused
        # codes -> transformers consume the pruned codebook).  The
        # reference's example threshold (1000) targets its full dataset;
        # scaled to this run's token count, "underused" means < 1/8 of
        # uniform usage.
        if not args.no_prune:
            tokens_total = args.num_images * (hw // patch) ** 2
            threshold = max(1, tokens_total // (8 * K))
            prune_out = out / f"prune_{name}"
            pruned_ckpt = (prune_out / "models_checkpoint"
                           / "pruned_codebook.pt")
            if args.resume and pruned_ckpt.exists():
                new_cb = common.codebook_from_checkpoint(load(pruned_ckpt),
                                                         device)
                note(f"resume: prune {name} already done, skipping")
            else:
                if args.resume and prune_out.exists():
                    shutil.rmtree(prune_out)
                evcache.drop_prefix(f"prune_{name}/")
                new_cb = prune_stage.run(stage_args({
                    "dataset_path": fmap_manifest,
                    "codebook_path": cb_ckpts[name],
                    "out_dir": prune_out, "batch_size": args.cb_batch,
                    "prune_threshold": threshold}))
            psnr_before = cb_traj[name][-1]["psnr_quantized_db"]
            psnr_after = evcache.get(f"prune_{name}/after")
            if psnr_after is None:
                psnr_after = evcache.put(
                    f"prune_{name}/after",
                    evaluator.psnr_quantized(ae, new_cb))
            kept = new_cb.num_embeddings
            del new_cb
            report["stages"][f"codebook_{name}"]["prune"] = {
                "threshold": threshold, "kept": kept, "of": K,
                "psnr_quantized_db_before": psnr_before,
                "psnr_quantized_db_after": psnr_after,
                "checkpoint": str(pruned_ckpt)}
            note(f"prune {name}: kept {kept}/{K} (threshold {threshold}); "
                 f"quantized PSNR {psnr_before} -> {psnr_after} dB")
            cb_ckpts[name] = pruned_ckpt  # downstream consumes pruned
            stage_done(f"prune_{name}")

    # -- side experiment: is the quantization ceiling K-bound?  The finest
    # patch size again at 2x the embeddings (not consumed downstream),
    # beside the finest codebook trained above: skipped when a
    # --cb-patches subset left that codebook out.
    exp_name, exp_patch = scale["cbs"][-1]
    if not args.no_k_exp and exp_name in cb_traj:
        exp_K = 2 * K
        cfg = out / f"cb_{exp_name}_k{exp_K}.json"
        cfg.write_text(json.dumps({
            "model_lr": 1e-3, "image_H": hw, "image_W": hw,
            "image_C": scale["ae"]["latent_channel"],
            "patch_H": exp_patch, "patch_W": exp_patch,
            "num_embeddings": exp_K,
            "neighbourhood_step": scale["nstep"]}))
        exp_out = out / f"cb_{exp_name}_k{exp_K}"
        maybe_train(cb_stage.run, stage_args({
            "dataset_path": fmap_manifest, "decoder_path": ae_ckpt,
            "config_path": cfg, "out_dir": exp_out,
            "batch_size": args.cb_batch, "checkpoint_step": args.ckpt_every,
            "lr_step": 10 * args.cb_steps, "max_epoch": 10 ** 9,
            "max_steps": args.cb_steps}),
            exp_out, "codebook", args.cb_steps)
        exp_traj = codebook_trajectory(exp_out)
        report.setdefault("experiments", {})[
            f"codebook_{exp_name}_k{exp_K}"] = {
            "patch": exp_patch, "num_embeddings": exp_K,
            "steps": args.cb_steps, "psnr_trajectory": exp_traj,
            "baseline_k": K,
            "baseline_psnr": cb_traj[exp_name][-1]["psnr_quantized_db"]}
        note(f"K-experiment {exp_name} @ K={exp_K}: " + " -> ".join(
            str(p["psnr_quantized_db"]) for p in exp_traj))
        stage_done(f"codebook_{exp_name}_k{exp_K}")
    del ae

    # -- stage 5: transformers ---------------------------------------------------
    tf = scale["tf"]
    cb_names = [name for name, _ in scale["cbs"]]
    tf_specs = []
    for i in range(len(cb_names) - 1):
        is_base = i == 0
        last = i == len(cb_names) - 2
        cfg_dict = {"model_lr": 1e-4,
                    "use_sliding_window": last,
                    "num_dec_layers": tf["dec_layers"],
                    "self_attn_heads": tf["heads"], "in_dim": tf["in_dim"],
                    "hidden_dim": tf["hidden_dim"],
                    "hidden_activation": "silu"}
        if last:
            cfg_dict["sliding_window"] = scale["sliding"]
        if not is_base:
            cfg_dict["num_enc_layers"] = tf["enc_layers"]
            cfg_dict["cross_attn_heads"] = tf["heads"]
        tf_specs.append(("base" if is_base else f"casc{i}", is_base,
                         cb_names[i], cb_names[i + 1], cfg_dict))
    for name, _, _, _, cfg_dict in tf_specs:
        (out / f"tf_{name}.json").write_text(json.dumps(cfg_dict))

    def finish(stopped):
        report["wall_seconds"] = round(time.time() - t_start, 1)
        (out / "quality.json").write_text(json.dumps(report, indent=2))
        note(f"{stopped} ({report['wall_seconds']}s total)")
        print(json.dumps({"quality_json": str(out / "quality.json"),
                          "ae_final_psnr": traj[-1]["psnr_recon_db"],
                          "wall_seconds": report["wall_seconds"]}),
              flush=True)
        return report

    if args.stop_after == "codebooks":
        report["stopped_after"] = "codebooks"
        return finish("stopped after codebooks")
    tf_ckpts = {}
    for name, is_base, lr_cb, hr_cb, cfg_dict in tf_specs:
        cfg = out / f"tf_{name}.json"
        tf_out = out / f"tf_{name}"
        run_args = stage_args({
            "dataset_path": fmap_manifest, "train_base_model": is_base,
            "decoder_path": ae_ckpt, "lr_codebook_path": cb_ckpts[lr_cb],
            "hr_codebook_path": cb_ckpts[hr_cb], "config_path": cfg,
            "out_dir": tf_out, "batch_size": args.tf_batch,
            "test_num_sample": 5, "checkpoint_step": args.ckpt_every,
            "lr_step": 10 * args.tf_steps, "max_epoch": 10 ** 9,
            "max_steps": args.tf_steps, "temperature": 1.0,
            "bf16": args.bf16_transformers,
            "use_activation_checkpoint": True})
        # the final cascade stage is the run's fragile one (the JAX side's
        # earlier run: CE spiked 0.02 -> 13.9 near its end under the
        # reference recipe); it trains under EMA + gradient clipping
        stability = {}
        if name == tf_specs[-1][0]:
            if args.final_stage_ema > 0:
                run_args["ema_decay"] = args.final_stage_ema
                stability["ema_decay"] = args.final_stage_ema
            if args.final_stage_grad_clip > 0:
                run_args["grad_clip"] = args.final_stage_grad_clip
                stability["grad_clip"] = args.final_stage_grad_clip
        maybe_train(tf_stage.run, run_args, tf_out, "model", args.tf_steps)
        tf_ckpts[name] = checkpoints(tf_out)[-1]
        curve = loss_curve(tf_out, "ce_loss", every=args.ckpt_every // 2)
        note(f"transformer {name}: CE " + (
            f"{curve[0][1]:.3f} -> {curve[-1][1]:.3f}" if curve else "n/a"))
        report["stages"][f"transformer_{name}"] = {
            "steps": args.tf_steps, "batch": args.tf_batch,
            "precision": "bf16" if args.bf16_transformers else "fp32",
            "loss_curve": curve, "checkpoint": str(tf_ckpts[name]),
            "stability": stability or None,
            "ce_max_last_half": ce_max_last_half(tf_out, args.tf_steps),
            "preview_psnr": preview_psnr(tf_out)}
        stage_done(f"transformer_{name}")

    # -- stage 6: generation -------------------------------------------------------
    gen_cfg = out / "gen.json"
    gen_dict = {}
    for i, (name, _, lr_cb, hr_cb, _) in enumerate(tf_specs):
        num_beam, bw, temp = scale["beams"][i]
        gen_dict[str(i)] = {
            "model_path": str(tf_ckpts[name]),
            "lr_codebook_path": str(cb_ckpts[lr_cb]),
            "hr_codebook_path": str(cb_ckpts[hr_cb]),
            "beam_width": bw, "num_beam": num_beam, "temperature": temp}
    gen_cfg.write_text(json.dumps(gen_dict))
    gen_out = out / "gen"
    last_stage = len(tf_specs) - 1
    final_grid = gen_out / "images" / f"recon_model_{last_stage}.jpg"
    if args.resume and final_grid.exists():
        note("resume: generation grid already present, skipping")
    else:
        if args.resume and gen_out.exists():
            shutil.rmtree(gen_out)
        gen_stage.run(stage_args({
            "decoder_path": ae_ckpt, "config_path": gen_cfg,
            "out_dir": gen_out, "num_images": args.gen_images, "seed": 69}))
        note("generation done")
    report["stages"]["generation"] = {
        "num_images": args.gen_images,
        "grid": str(gen_out / "images" / f"recon_model_{last_stage}.jpg")}
    stage_done("generation")

    # -- collect artifacts ---------------------------------------------------------
    grids = out / "grids"
    grids.mkdir(exist_ok=True)

    def last_preview(stage_dir, name):
        """Newest preview grid the trainer wrote (previews land on
        checkpoint steps, which may stop short of max_steps)."""
        found = sorted((out / stage_dir / "images").glob(f"{name}_*.jpg"),
                       key=lambda p: int(p.stem.split("_")[-1]))
        return found[-1] if found else None

    last_tf = tf_specs[-1][0]
    copies = {
        # full unconditioned cascade generations (coarsest + final stage)
        "generated_final.jpg":
            gen_out / "images" / f"recon_model_{last_stage}.jpg",
        "generated_stage0.jpg": gen_out / "images" / "recon_model_0.jpg",
        # the random stage-0 conditioning grid (decoded coarse-codebook
        # prototypes: what generation starts from)
        "conditioning.jpg": gen_out / "images" / "recon_model_Cond.jpg",
        # final cascade stage's AR preview vs its ground truth: the
        # train-loop visual-verification pair
        "train_preview_recon.jpg":
            last_preview(f"tf_{last_tf}", "high_res_recon"),
        "train_preview_ground_truth.jpg":
            last_preview(f"tf_{last_tf}", "ground_truth"),
        "dataset_sample.png": pathlib.Path(train_paths[0]),
    }
    for dst, src in copies.items():
        if src is not None and pathlib.Path(src).exists():
            shutil.copyfile(src, grids / dst)
    return finish("quality.json written")


if __name__ == "__main__":
    main()
