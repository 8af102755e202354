"""Diversity/fidelity sweep over the sampling knobs on a finished quality
run (the port's counterpart of ``scripts/sampling_sweep.py``).

It generates grids from the SAME trained checkpoints under the knobs the
generation config exposes:

  - ``config``       -- the ledger's beam plan as-is (the baseline grid),
  - ``single_path``  -- ``num_beam=1`` everywhere (pure temperature
                        sampling),
  - ``beams_t<T>``   -- the beam plan with every stage's temperature set
                        to T,

through the port's ``generate.run`` (on the card, the fused cascade: one
CUDA graph a setting), and quantifies each grid's diversity from the final
token sequences: ``unique_frac`` (fraction of distinct sequences) and
``pairwise_hamming`` (mean fraction of differing token positions over all
pairs; 0 means every sample is identical).

    python -m qaig_tpu_torch.scripts.sampling_sweep --qrun-dir q \\
        [--device cpu]
"""

import argparse
import itertools
import json
import pathlib
import shutil

import numpy as np

from qaig_tpu_torch.infer import generate as gen_stage


def token_diversity(tokens):
    """(unique_frac, mean pairwise hamming) over (N, seq) int tokens."""
    t = np.asarray(tokens)
    n = t.shape[0]
    uniq = len(np.unique(t, axis=0))
    dists = [float((t[i] != t[j]).mean())
             for i, j in itertools.combinations(range(n), 2)]
    return round(uniq / n, 3), round(float(np.mean(dists)), 4)


def main(argv=None):
    """The sweep; returns what it writes to ``<qrun-dir>/sweep.json``."""
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--qrun-dir", required=True, type=pathlib.Path,
                        help="a finished quality_run --out-dir")
    parser.add_argument("--num-images", type=int, default=25)
    parser.add_argument("--seed", type=int, default=69,
                        help="same default as the ledger's generation stage "
                             "so the baseline grid is comparable")
    parser.add_argument("--temperatures", type=float, nargs="+",
                        default=[0.7, 1.0, 2.0])
    parser.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = parser.parse_args(argv)

    q = args.qrun_dir
    report = json.loads((q / "quality.json").read_text())
    ae_ckpt = report["stages"]["autoencoder"]["checkpoint"]
    base_cfg = json.loads((q / "gen.json").read_text())
    last_stage = max(base_cfg, key=int)

    settings = [("config", base_cfg)]
    single = {k: dict(v, num_beam=1) for k, v in base_cfg.items()}
    settings.append(("single_path", single))
    for t in args.temperatures:
        settings.append((f"beams_t{t:g}",
                         {k: dict(v, temperature=t)
                          for k, v in base_cfg.items()}))

    # one cache for every setting: generate.run keeps the loaded cascade
    # and its graphs there, replays a setting seen before and lets the
    # last setting's go when the config changes
    cache = {}
    sweep_dir = q / "sweep"
    sweep_dir.mkdir(exist_ok=True)
    out = {"num_images": args.num_images, "seed": args.seed, "settings": {}}
    for name, cfg in settings:
        run_dir = sweep_dir / name
        cfg_path = sweep_dir / f"{name}.json"
        cfg_path.write_text(json.dumps(cfg))
        tokens = gen_stage.run({
            "device": args.device, "decoder_path": ae_ckpt,
            "config_path": cfg_path, "out_dir": run_dir,
            "num_images": args.num_images, "seed": args.seed}, cache=cache)
        uniq, ham = token_diversity(tokens.cpu().numpy())
        grid = run_dir / "images" / f"recon_model_{last_stage}.jpg"
        kept = sweep_dir / f"grid_{name}.jpg"
        if grid.exists():
            shutil.copyfile(grid, kept)
        rec = {"unique_frac": uniq, "pairwise_hamming": ham,
               "grid": str(kept),
               "temperatures": {k: cfg[k]["temperature"] for k in cfg},
               "num_beam": {k: cfg[k]["num_beam"] for k in cfg}}
        out["settings"][name] = rec
        print(json.dumps({name: rec}), flush=True)
    (q / "sweep.json").write_text(json.dumps(out, indent=2))
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
