"""Small configurations for the CPU tests: the published structure (every
stage kind, a window that slides, heads of dim 8) at toy widths."""

import copy
import json
from pathlib import Path

CONFIGS = Path(__file__).resolve().parents[1] / "configs"


def cascade_config():
    cfg = json.loads((CONFIGS / "qaig_cascade_bf16.json").read_text())
    cfg.update(image_H=8, image_W=8, image_C=2, num_embeddings=32,
               codebook_patches=[[8, 8], [4, 4], [2, 2], [1, 1]],
               in_dim=32, hidden_dim=64, num_enc_layers=1, num_dec_layers=2,
               self_attn_heads=4, cross_attn_heads=4, sliding_window=16)
    for st, (beams, width) in zip(cfg["stages"], [(2, 2), (2, 4), (2, 4)]):
        st.update(num_beam=beams, beam_width=width)
    cfg["autoencoder"].update(min_channel=8, max_channel=16, num_layers=1,
                              latent_channel=2)
    return cfg


def train_config():
    cfg = json.loads((CONFIGS / "qaig_casc2_train_fp32.json").read_text())
    cfg.update(image_H=8, image_W=8, image_C=2, num_embeddings=32,
               in_dim=32, hidden_dim=64, num_enc_layers=1, num_dec_layers=2,
               self_attn_heads=4, cross_attn_heads=4, sliding_window=8,
               batch_size=4)
    return cfg


def with_updates(d, **kw):
    d = copy.deepcopy(d)
    d.update(kw)
    return d

