"""Render QUALITY_TORCH.md from the port's quality run (the counterpart of
``scripts/render_quality.py``).

    python -m qaig_tpu_torch.scripts.quality_run --out-dir q
    python -m qaig_tpu_torch.scripts.sampling_sweep --qrun-dir q
    python -m qaig_tpu_torch.scripts.quality_bf16_ab --qrun-dir q
    python -m qaig_tpu_torch.scripts.render_quality --report q/quality.json

It copies the run's grids and its three JSON files (``quality.json``,
``bf16_ab.json``, ``sweep.json``; the run's ``--out-dir`` written as
``<out>`` in them and in the reproduce line) into ``--grids-dir`` and
writes a
markdown ledger with the sections ``scripts/render_quality.py`` writes:
the autoencoder's recon-PSNR trajectory, each codebook's quantized-PSNR
trajectory and its pruning, the larger-K experiment, the transformers' CE
curves and preview PSNRs, the bf16 A/B, the sampling sweep and the
generation grids.

Beside each of the port's numbers, on a line or table row of its own
labelled ``qaig_tpu, <its device>``, stands the JAX package's number for
the same quantity, read from ``--reference-dir`` (``docs/quality``: the
report, A/B and sweep that QUALITY.md was rendered from).  Those are
quality numbers only: no time of the reference's device is printed.
"""

import argparse
import json
import pathlib
import shutil

RUN_FILES = ("quality.json", "bf16_ab.json", "sweep.json")


def fmt_curve(curve, every=1):
    pts = curve[::every]
    if curve and pts[-1] != curve[-1]:
        pts.append(curve[-1])
    return " → ".join(f"{v:.3f}" for _, v in pts)


def _load(path):
    return json.loads(path.read_text()) if path.exists() else None


def load_reference(ref_dir):
    """The JAX package's report, A/B and sweep ({} where absent)."""
    ref_dir = pathlib.Path(ref_dir)
    return {name: _load(ref_dir / name) for name in RUN_FILES}


def render(report, run_dir, grids_dir, reference):
    """The ledger's lines; copies the grids and run files into
    ``grids_dir``."""
    stages = report["stages"]
    ref = reference.get("quality.json") or {}
    ref_stages = ref.get("stages", {})
    label = f"qaig_tpu, {ref.get('device', 'TPU')}"
    grids_dir.mkdir(parents=True, exist_ok=True)
    copied = {}
    for f in sorted((run_dir / "grids").glob("*")):
        dst = grids_dir / f.name
        shutil.copyfile(f, dst)
        copied[f.stem] = dst.as_posix()
    argv, out_dir = list(report.get("argv", [])), None
    if "--out-dir" in argv[:-1]:
        i = argv.index("--out-dir") + 1
        out_dir, argv[i] = argv[i], "<out>"
    for name in RUN_FILES:
        if (run_dir / name).exists():
            text = (run_dir / name).read_text()
            if out_dir:
                text = text.replace(out_dir, "<out>")
            (grids_dir / name).write_text(text)

    lines = []
    out = lines.append
    out("# Quality ledger — the PyTorch/CUDA port trains to quality")
    out("")
    out("The port's (`qaig_tpu_torch`) counterpart of QUALITY.md: the full "
        "6-stage pipeline (autoencoder → feature maps → 4 codebooks → base "
        "+ cascade transformers → beam-search generation) trained "
        "end-to-end by the port's trainers on the card, with held-out "
        "quality trajectories per stage.  Beside each of the port's "
        f"numbers, on a row or line of its own labelled *{label}*, stands "
        "QUALITY.md's number for the same quantity (the JAX package on its "
        "own device; quality numbers only).  The dataset is the same, "
        "image for image; the weights start from other random streams.")
    out("")
    out(f"- **Device**: {report['device']} ({report['backend']} backend)")
    out(f"- **Dataset**: {report['num_images']} train / "
        f"{report['eval_images']} held-out structured synthetic images "
        "(gradient backgrounds + random anti-aliased shapes; fully "
        "reproducible from the seed — no external data)")
    out(f"- **Shapes**: reference-README scale — 128×128×3 images, "
        "32×32×4 latents, K=512 codebooks, in_dim 512 / hidden 2048 / "
        "7-layer transformers, sliding window 256, the reference "
        "generate.json beam plan")
    resumed = "--resume" in argv
    out(f"- **Wall clock**: {report['wall_seconds']:.0f} s"
        + (" (final resumed attempt)" if resumed else " total")
        + ", one card, on the device above")
    out(f"- **Reproduce**: `python -m qaig_tpu_torch.scripts.quality_run "
        f"{' '.join(argv)}`, then `python -m "
        "qaig_tpu_torch.scripts.sampling_sweep --qrun-dir <out>`, `python "
        "-m qaig_tpu_torch.scripts.quality_bf16_ab --qrun-dir <out>` and "
        "`python -m qaig_tpu_torch.scripts.render_quality --report "
        "<out>/quality.json`")
    out("")

    ae = stages["autoencoder"]
    ref_ae = ref_stages.get("autoencoder") or {}
    ref_psnr = {p["step"]: p["psnr_recon_db"]
                for p in ref_ae.get("psnr_trajectory", [])}
    out("## Stage 1 — autoencoder (held-out reconstruction PSNR)")
    out("")
    out(f"{ae['steps']} steps @ batch {ae['batch']} "
        "(`train_autoencoder.py` schema/shapes; model_lr 1e-4):")
    out("")
    out("| step | recon PSNR (dB, 32 held-out images) |")
    out("|---|---|")
    for p in ae["psnr_trajectory"]:
        out(f"| {p['step']} | {p['psnr_recon_db']} |")
        if p["step"] in ref_psnr:
            out(f"| {p['step']}, {label} | {ref_psnr[p['step']]} |")
    out("")
    lc = ae["loss_curve"]
    if lc:
        out(f"Train recon-loss curve (step → loss): {fmt_curve(lc)}")
        out("")
        if ref_ae.get("loss_curve"):
            out(f"{label}: {fmt_curve(ref_ae['loss_curve'])}")
            out("")

    out("## Stage 3 — codebooks (held-out quantized-reconstruction PSNR)")
    out("")
    out("Per-checkpoint PSNR of encode → BMU-quantize → decode against "
        "the same held-out split, per codebook, across the SOM "
        "neighbourhood anneal.  The unquantized AE ceiling is the final "
        "stage-1 number above.")
    out("")
    cb_names = [k for k in stages if k.startswith("codebook_")]
    pruned = any(stages[n].get("prune") for n in cb_names)
    if pruned:
        out("| codebook (patch) | PSNR trajectory (dB) "
            "| pruned (kept/K, threshold) | PSNR after prune |")
        out("|---|---|---|---|")
    else:
        out("| codebook (patch) | PSNR trajectory (dB) |")
        out("|---|---|")

    def cb_row(st, name, ref_label=None):
        traj = " → ".join(str(p["psnr_quantized_db"])
                          for p in st["psnr_trajectory"])
        row = (f"| {name} ({st['patch']}×{st['patch']})"
               f"{f', {ref_label}' if ref_label else ''} | {traj} |")
        if pruned:
            pr = st.get("prune")
            if pr:
                row += (f" {pr['kept']}/{pr['of']} (≥{pr['threshold']}) "
                        f"| {pr['psnr_quantized_db_after']} |")
            else:
                row += " — | — |"
        return row

    for name in cb_names:
        out(cb_row(stages[name], name.split("_")[1]))
        if name in ref_stages:
            out(cb_row(ref_stages[name], name.split("_")[1], label))
    out("")
    if pruned:
        out("Stage 4 (`prune_codebook`, the reference README workflow: "
            "train → prune underused codes → transformers consume the "
            "pruned codebook) runs on every codebook; the threshold is "
            "the reference's \"underused\" bar scaled to this run's token "
            "count (< 1/8 of uniform usage).  Downstream transformer and "
            "generation stages consume the PRUNED codebooks.")
        out("")

    ref_exps = ref.get("experiments") or {}
    for name, exp in (report.get("experiments") or {}).items():
        traj = " → ".join(str(p["psnr_quantized_db"])
                          for p in exp["psnr_trajectory"])
        final = exp["psnr_trajectory"][-1]["psnr_quantized_db"]
        delta = round(final - exp["baseline_psnr"], 2)
        out(f"**Side experiment — {name}**: the finest patch size "
            f"retrained at K={exp['num_embeddings']} "
            f"(2× the reference's {exp['baseline_k']}): "
            f"quantized PSNR {traj} dB vs the K={exp['baseline_k']} "
            f"baseline's {exp['baseline_psnr']} dB "
            f"({delta:+.2f} dB).  Not consumed by the pipeline (the main "
            "run keeps reference-README shapes); this measures how "
            "K-bound the quantization ceiling is.")
        out("")
        if name in ref_exps:
            r = ref_exps[name]
            r_final = r["psnr_trajectory"][-1]["psnr_quantized_db"]
            out(f"{label}: " + " → ".join(
                str(p["psnr_quantized_db"]) for p in r["psnr_trajectory"])
                + f" dB vs its baseline's {r['baseline_psnr']} dB "
                f"({round(r_final - r['baseline_psnr'], 2):+.2f} dB).")
            out("")
        if delta < 0:
            out("The larger K loses at the same step budget: the SOM "
                "neighbourhood anneal scales with K (range starts at K/2 "
                "and decrements on a fixed step cadence), so doubling K "
                "doubles the anneal length and leaves the K=1024 run less "
                "of its budget in winner-take-all refinement.")
            out("")

    out("## Stage 5 — transformers (cross-entropy curves)")
    out("")
    tf_names = [k for k in stages if k.startswith("transformer_")]
    out("| stage | precision | stability | CE curve (downsampled) "
        "| max CE, 2nd half |")
    out("|---|---|---|---|---|")

    def tf_row(st, tag):
        stab = st.get("stability") or {}
        stab_s = ", ".join(f"{k.replace('_', '-')}={v}"
                           for k, v in stab.items()) or "reference recipe"
        mx = st.get("ce_max_last_half")
        return (f"| {tag} | {st['precision']} | {stab_s} "
                f"| {fmt_curve(st['loss_curve'], every=2)} "
                f"| {mx if mx is not None else '—'} |")

    for name in tf_names:
        out(tf_row(stages[name], name.split("_", 1)[1]))
        if name in ref_stages:
            out(tf_row(ref_stages[name],
                       f"{name.split('_', 1)[1]}, {label}"))
    out("")
    out("\"Max CE, 2nd half\" is the worst PER-STEP loss over the second "
        "half of training, read from the full metrics stream — the "
        "spike detector.  The final cascade stage trains under EMA + "
        "gradient clipping, the framework's beyond-reference stability "
        "tools.")
    out("")

    if any(stages[n].get("preview_psnr") for n in tf_names):
        out("### Generative fidelity: AR-preview vs ground truth (PSNR)")
        out("")
        out("Per-checkpoint PSNR between each stage's autoregressive "
            "preview grid and its ground-truth grid (the train-loop "
            "visual-verification pair).  Both grids are JPEGs, so absolute "
            "values carry a small consistent compression bias; the trend "
            "is the signal.")
        out("")
        out("| stage | preview PSNR by checkpoint (dB) |")
        out("|---|---|")
        for name in tf_names:
            for st, tag in ((stages[name], name.split("_", 1)[1]),
                            (ref_stages.get(name),
                             f"{name.split('_', 1)[1]}, {label}")):
                if st is None:
                    continue
                pp = st.get("preview_psnr") or []
                traj = " → ".join(f"{p['psnr_db']}@{p['step']}" for p in pp)
                out(f"| {tag} | {traj or '—'} |")
        out("")

    ab = _load(run_dir / "bf16_ab.json")
    if ab is not None:
        ref_ab = reference.get("bf16_ab.json")
        out("### bf16 mixed-precision A/B (the flagship training "
            "precision learns the same)")
        out("")
        out(f"The base transformer retrained twice from the same seed on "
            f"this run's feature maps + pruned codebooks "
            f"({ab['steps']} steps @ batch {ab['batch']}, "
            "`python -m qaig_tpu_torch.scripts.quality_bf16_ab`):")
        out("")
        out("| precision | final CE | CE curve | wall (s) |")
        out("|---|---|---|---|")
        for tag in ("fp32", "bf16"):
            r = ab[tag]
            out(f"| {tag} | {r['final_ce']:.4f} "
                f"| {fmt_curve(r['ce_curve'], every=2)} | {r['wall_s']} |")
            if ref_ab:
                r = ref_ab[tag]
                out(f"| {tag}, {label} | {r['final_ce']:.4f} "
                    f"| {fmt_curve(r['ce_curve'], every=2)} | — |")
        out("")
        out(f"final CE delta (bf16 − fp32): **{ab.get('final_ce_delta')}**.")
        out("")
        if ref_ab:
            out(f"{label}: final CE delta {ref_ab.get('final_ce_delta')}.")
            out("")

    sweep = _load(run_dir / "sweep.json")
    if sweep is not None:
        ref_sweep = (reference.get("sweep.json") or {}).get("settings", {})
        out("### Sampling knobs: diversity/fidelity sweep")
        out("")
        out(f"{sweep['num_images']} images per setting from the SAME "
            "trained checkpoints (`python -m "
            "qaig_tpu_torch.scripts.sampling_sweep`), quantifying each "
            "grid's diversity from its final token sequences: `unique` = "
            "fraction of distinct sequences, `pairwise` = mean fraction of "
            "differing token positions over all pairs (0 = every sample "
            "identical).")
        out("")
        out("| setting | num_beam | temperature | unique | pairwise |")
        out("|---|---|---|---|---|")

        def sweep_row(rec, tag):
            beams = "/".join(str(v) for v in rec["num_beam"].values())
            temps = "/".join(f"{v:g}" for v in rec["temperatures"].values())
            return (f"| {tag} | {beams} | {temps} | {rec['unique_frac']} "
                    f"| {rec['pairwise_hamming']} |")

        sweep_grids = {}
        for name, rec in sweep["settings"].items():
            out(sweep_row(rec, name))
            if name in ref_sweep:
                out(sweep_row(ref_sweep[name], f"{name}, {label}"))
            src = pathlib.Path(rec["grid"])
            if src.exists():
                dst = grids_dir / f"sweep_{name}.jpg"
                shutil.copyfile(src, dst)
                sweep_grids[name] = dst.as_posix()
        out("")
        cfg_rec = sweep["settings"].get("config")
        sp_rec = sweep["settings"].get("single_path")
        if cfg_rec and sp_rec:
            out("Read: with the reference generate.json beam plan "
                "(`config`) the pairwise token distance is "
                f"{cfg_rec['pairwise_hamming']:g}, against "
                f"{sp_rec['pairwise_hamming']:g} for single-path sampling "
                "of the SAME models; the sampling knobs (`num_beam`, "
                "per-stage `temperature`) set where the grids fall "
                "between the beams' high-likelihood decodes and "
                "diversity.")
            out("")
        for name, p in sweep_grids.items():
            out(f"![sweep_{name}]({p})")
            out("")
            out(f"*{name} — per-stage num_beam "
                + "/".join(str(v) for v in
                           sweep['settings'][name]['num_beam'].values())
                + ", temperature "
                + "/".join(f"{v:g}" for v in
                           sweep['settings'][name]['temperatures'].values())
                + "*")
            out("")

    gen = stages["generation"]
    out("## Stage 6 — generation")
    out("")
    out(f"{gen['num_images']} images through the full beam-search cascade "
        "(the reference README generation config).  Grids (in-tree):")
    out("")
    captions = {
        "dataset_sample": "a training image (what the model should learn)",
        "train_preview_ground_truth":
            "held-out ground truth for the final cascade stage's preview",
        "train_preview_recon":
            "final cascade stage's autoregressive preview of the same "
            "images at its last checkpoint (the train-loop "
            "visual-verification hook) — the learned coarse→fine mapping",
        "conditioning": "the random stage-0 conditioning grid (decoded "
                        "coarse-codebook prototypes generation starts from)",
        "generated_stage0": "stage-0 (coarse) unconditioned generations",
        "generated_final":
            "final-stage unconditioned generations through the full "
            "beam-search cascade",
    }
    order = ["dataset_sample", "train_preview_ground_truth",
             "train_preview_recon", "conditioning", "generated_stage0",
             "generated_final"]
    for stem in order + [s for s in copied if s not in order]:
        if stem not in copied:
            continue
        out(f"![{stem}]({copied[stem]})")
        out("")
        out(f"*{captions.get(stem, stem)}*")
        out("")

    if report.get("notes"):
        out("## Run notes (training dynamics, checkpoint selection)")
        out("")
        for note in report["notes"]:
            out(f"- {note}")
        out("")
    return lines, copied


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--report", required=True, type=pathlib.Path)
    parser.add_argument("--doc", default="QUALITY_TORCH.md",
                        type=pathlib.Path)
    parser.add_argument("--grids-dir", default="docs/quality_torch",
                        type=pathlib.Path)
    parser.add_argument("--reference-dir", default="docs/quality",
                        type=pathlib.Path,
                        help="the JAX package's quality.json, bf16_ab.json "
                             "and sweep.json, printed beside the port's")
    args = parser.parse_args(argv)

    report = json.loads(args.report.read_text())
    if report.get("stopped_after"):
        raise SystemExit(
            f"quality.json is a partial run (--stop-after "
            f"{report['stopped_after']}): generation/transformer sections "
            "are absent, nothing to render.  Finish the run (re-run "
            "quality_run without --stop-after) first.")
    lines, copied = render(report, args.report.parent, args.grids_dir,
                           load_reference(args.reference_dir))
    args.doc.write_text("\n".join(lines))
    print(f"wrote {args.doc} + {len(copied)} grids in {args.grids_dir}/")


if __name__ == "__main__":
    main()
