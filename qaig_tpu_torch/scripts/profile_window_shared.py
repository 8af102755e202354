"""``window_forward_shared`` alone at the crossing segment's shapes, on the
card (counterpart of ``scripts/profile_window_shared.py``).

    python -m qaig_tpu_torch.scripts.profile_window_shared
        [--scale full|smoke] [--device cuda|cpu]

The windowed stage's model (5 encoder and 7 decoder layers, in_dim 512,
hidden 2048, bf16, seeded weights) at the last crossing step: 256 images,
4 rollouts, 248 shared window slots and a tail of 8.  Times
``Transformer.window_forward_shared`` (shared slots at N rows, the tail at
N*B), against ``window_forward`` over the full 256-slot window at N rows
(what the tile-everything path pays per rollout at N*B rows), and the
shared form at half the images.  Each call is one CUDA graph on the card
(eager on the CPU); a label's figure is the mean of 5 calls after a warm
one, host clock to a synchronise.  Prints ``profile_window_shared.py``'s
lines, ``<label>: <ms> ms``.  ``--scale smoke`` runs bench.py's smoke
widths with every length divided by 8 (the labels carry the sizes run).
"""

import argparse

import torch

from qaig_tpu_torch import bench
from qaig_tpu_torch.scripts import profile_rollout as pr
from qaig_tpu_torch.train import common


def sizes(scale="full"):
    """(n, b, s0, t, enc_len, half)."""
    if scale == "full":
        return 256, 4, 248, 8, 64, 128
    return 32, 4, 31, 1, 8, 16


def labels(scale="full"):
    """The three lines' labels, ``profile_window_shared.py``'s."""
    n, b, s0, t, _, half = sizes(scale)
    return (f"window_forward_shared n={n} s0={s0} t={t} B={b}",
            f"window_forward (N rows) n={n} seq={s0 + t}",
            f"window_forward_shared n={half}")


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--scale", choices=["full", "smoke"], default="full")
    parser.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = parser.parse_args(argv)
    device = common.select_device(args.device)
    if device.type == "cuda":
        print(f"card: {bench.card_line()}", flush=True)
    model = pr.stage_model(args.scale, True, 1, device)
    n, b, s0, t, enc_len, half = sizes(args.scale)
    shared_label, full_label, half_label = labels(args.scale)
    nb = n * b

    def longs(*shape):
        return torch.zeros(shape, dtype=torch.long, device=device)

    def floats(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=device)
    sh_tok, blk_tok = longs(n, s0), longs(nb, t)
    sh_pos, blk_pos = floats(n, s0), floats(nb, t)
    with torch.inference_mode():
        cross_kv = model.make_cross_kv(model.encode(longs(n, enc_len)))
    call = pr.graphed(device)
    out = {}

    def shared(rows):
        ckv = [{key: v[:rows] for key, v in c.items()} for c in cross_kv]

        def fn():
            return model.window_forward_shared(
                sh_tok[:rows], blk_tok[:rows * b],
                shared_pos_cond=sh_pos[:rows],
                block_pos_cond=blk_pos[:rows * b], cross_kv=ckv)
        return lambda i: call(("shared", rows), fn)

    out["shared"] = pr.timed(
        shared(n), shared_label, device, reps=5, unit="ms")

    full_tok, full_pos = longs(n, s0 + t), floats(n, s0 + t)

    def full_fn():
        return model.window_forward(full_tok, pos_cond=full_pos,
                                    cross_kv=cross_kv, last_only=True)
    out["full"] = pr.timed(
        lambda i: call("full", full_fn), full_label, device, reps=5,
        unit="ms")
    out["half"] = pr.timed(shared(half), half_label, device, reps=5,
                           unit="ms")
    return out


if __name__ == "__main__":
    main()
