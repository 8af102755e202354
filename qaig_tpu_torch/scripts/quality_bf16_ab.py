"""bf16-vs-fp32 transformer-training quality A/B on a finished quality run
(the port's counterpart of ``scripts/quality_bf16_ab.py``).

The quality ledger trains the pipeline in reference numerics (float32).
This script reuses a finished ``quality_run`` output directory (its
feature maps and pruned codebooks) to train the BASE transformer twice
from the same seed through the port's trainer: once in float32, once
``--bf16`` (bfloat16 compute, float32 master weights and Adam), and
writes both CE curves to ``<qrun-dir>/bf16_ab.json``.

    python -m qaig_tpu_torch.scripts.quality_bf16_ab --qrun-dir q \\
        [--steps 1500] [--device cpu]
"""

import argparse
import json
import pathlib
import time

from qaig_tpu_torch.scripts.quality_run import checkpoints, loss_curve
from qaig_tpu_torch.train import transformer as tf_stage


def main(argv=None):
    """The A/B; returns what it writes to ``<qrun-dir>/bf16_ab.json``."""
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--qrun-dir", required=True, type=pathlib.Path,
                        help="a finished quality_run --out-dir")
    parser.add_argument("--steps", type=int, default=1500)
    parser.add_argument("--batch", type=int, default=32)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = parser.parse_args(argv)

    q = args.qrun_dir
    report = json.loads((q / "quality.json").read_text())
    fmap_manifest = str(q / "fmaps" / "all_dataset.json")
    ae_ckpt = report["stages"]["autoencoder"]["checkpoint"]
    # the base stage maps the two COARSEST codebooks (insertion order in
    # the report is quality_run's training order)
    cb_keys = [k for k in report["stages"] if k.startswith("codebook_")]

    def cb_path(key):
        """The codebook the ledger's transformers consumed: the pruned one
        when the run included the prune stage."""
        st = report["stages"][key]
        return (st.get("prune") or {}).get("checkpoint", st["checkpoint"])

    cfg = q / "tf_base.json"  # the config the ledger's base stage used
    out = {"steps": args.steps, "batch": args.batch, "seed": args.seed}
    for tag, bf16 in (("fp32", False), ("bf16", True)):
        run_dir = q / f"tf_base_ab_{tag}"
        t0 = time.time()
        tf_stage.run({
            "device": args.device, "seed": args.seed,
            "dataset_path": fmap_manifest, "train_base_model": True,
            "decoder_path": ae_ckpt, "lr_codebook_path": cb_path(cb_keys[0]),
            "hr_codebook_path": cb_path(cb_keys[1]), "config_path": cfg,
            "out_dir": run_dir, "batch_size": args.batch,
            "test_num_sample": 5, "checkpoint_step": args.steps,
            "lr_step": 10 * args.steps, "max_epoch": 10 ** 9,
            "max_steps": args.steps, "temperature": 1.0, "bf16": bf16,
            "use_activation_checkpoint": True})
        curve = loss_curve(run_dir, "ce_loss", every=max(1, args.steps // 10))
        out[tag] = {"ce_curve": curve,
                    "final_ce": curve[-1][1] if curve else None,
                    "wall_s": round(time.time() - t0, 1),
                    "checkpoint": str(checkpoints(run_dir)[-1])}
    if out["fp32"]["final_ce"] and out["bf16"]["final_ce"]:
        out["final_ce_delta"] = round(
            out["bf16"]["final_ce"] - out["fp32"]["final_ce"], 4)
    (q / "bf16_ab.json").write_text(json.dumps(out, indent=2))
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
