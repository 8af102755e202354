"""The system under test, built from a configuration file through the
port's own classes (``qaig_tpu_torch``): the only module of the benchmark,
with the traffic drivers, that imports the program.

* :func:`build_cascade`: three ``Transformer`` stages with their
  ``DecodeEngine`` and ``CascadeStage``, four ``Codebook`` and the
  ``FCDecoder``, in one ``CascadePipeline``, at the configuration's widths,
  beam plan and temperatures.
* :func:`build_trainer`: the windowed cascade stage's ``Transformer``, the
  port's Adam and its ``make_train_step``, as the trainer's CLI makes them.

Each stage's ``rollout`` is wrapped by a tap that keeps the tensor it
returns (:class:`StageTaps`): under a CUDA graph capture that tensor is the
graph's own, which every replay rewrites, so after a call the tap holds the
call's tokens of that stage.  The reference needs them as the conditioning
of the next stage; the tap adds no work to the graph.
"""

import torch

from benchmark import weights as bw


def dtype_of(config):
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[
        config["dtype"]]


class StageTaps:
    """The tokens each stage last returned, by (stage, batch)."""

    def __init__(self, stages):
        self.last = {}
        self.count = len(stages)
        for index, stage in enumerate(stages):
            rollout = stage.rollout

            def tapped(tokens, rng, settings=None, use_beams=True,
                       _index=index, _rollout=rollout):
                out = _rollout(tokens, rng, settings, use_beams)
                self.last[(_index, out.shape[0])] = out
                return out
            stage.rollout = tapped

    def tokens(self, batch, rows):
        """Rows ``rows`` (a device index tensor) of each stage's last
        tokens at ``batch``, copied out; None where a stage gave no tokens
        of that batch."""
        if any((i, batch) not in self.last for i in range(self.count)):
            return None
        return [self.last[(i, batch)].index_select(0, rows)
                for i in range(self.count)]


def cascade_modules(config, device):
    """{prefix: module} of the cascade, parameters uninitialised, in the
    served dtype on ``device``."""
    from qaig_tpu_torch.models.codebook import Codebook
    from qaig_tpu_torch.models.conv_nets import ConvNetConfig, FCDecoder
    from qaig_tpu_torch.models.transformer import (Transformer,
                                                   TransformerConfig)
    dtype = dtype_of(config)
    k = config["num_embeddings"]
    image_dim = (config["image_H"], config["image_W"])
    modules = {}
    for i, patch in enumerate(config["codebook_patches"]):
        modules[f"codebooks.{i}."] = Codebook(
            patch_dim=tuple(patch), image_dim=image_dim,
            image_channel=config["image_C"], num_embeddings=k,
            init_neighbour_range=1, device=device, dtype=dtype)
    for i, st in enumerate(config["stages"]):
        base = not st["use_encoder"]
        cfg = TransformerConfig(
            use_encoder=not base, use_pos_cond=st["use_sliding_window"],
            num_enc_layers=0 if base else config["num_enc_layers"],
            num_dec_layers=config["num_dec_layers"],
            num_enc_embedding=1 if base else k,
            num_dec_embedding=2 * k if base else k + 1,
            self_attn_heads=config["self_attn_heads"],
            cross_attn_heads=0 if base else config["cross_attn_heads"],
            in_dim=config["in_dim"], out_dim=k + 1,
            hidden_dim=config["hidden_dim"],
            hidden_activation=config["hidden_activation"])
        modules[f"stages.{i}."] = Transformer(cfg, device=device,
                                              dtype=dtype)
    ae = config["autoencoder"]
    modules["decoder."] = FCDecoder(ConvNetConfig(
        num_layers=ae["num_layers"], image_channel=ae["image_channel"],
        min_channel=ae["min_channel"], max_channel=ae["max_channel"],
        latent_channel=ae["latent_channel"],
        hidden_activation_type=ae["hidden_activation_type"],
        use_final_activation=ae["use_final_dec_activation"],
        final_activation_type=ae["decoder_activation_type"]),
        device=device, dtype=dtype)
    return modules


def build_cascade(config, seed, device):
    """(pipeline, weights, taps): the ``CascadePipeline`` over the
    configuration's stages with weights drawn from ``seed``."""
    from qaig_tpu_torch.infer.decode import DecodeEngine, SamplerSettings
    from qaig_tpu_torch.infer.pipeline import CascadePipeline, CascadeStage
    from qaig_tpu_torch.train import common
    common.full_float32()
    modules = cascade_modules(config, device)
    for m in modules.values():
        m.requires_grad_(False)
    weights = bw.draw(modules, seed, device, dtype_of(config),
                      scales=config.get("weight_scales"))
    k = config["num_embeddings"]
    codebooks = [modules[f"codebooks.{i}."]
                 for i in range(len(config["codebook_patches"]))]
    stages = []
    for i, st in enumerate(config["stages"]):
        base = not st["use_encoder"]
        settings = SamplerSettings(
            temperature=st["temperature"], end_token=k,
            end_mode=config["sampler"]["end_mode"],
            index_shift=k if base else 0,
            pos_offset=config["sampler"]["pos_offset"])
        stages.append(CascadeStage(
            engine=DecodeEngine(modules[f"stages.{i}."]),
            lr_codebook=codebooks[i], hr_codebook=codebooks[i + 1],
            settings=settings, num_beam=st["num_beam"],
            beam_width=st["beam_width"],
            sliding_window=(config["sliding_window"]
                            if st["use_sliding_window"] else None),
            total_seq=codebooks[i + 1].seq_len, is_base=base))
    taps = StageTaps(stages)
    pipeline = CascadePipeline(stages, modules["decoder."], device)
    return pipeline, weights, taps


def graph_setup_seconds(runner):
    """Capture plus instantiation seconds of every graph of a
    ``GraphRunner``, or None without one (the CPU)."""
    if runner is None:
        return None
    return sum(g.capture_s + g.instantiate_s for g in runner.graphs.values())


def build_trainer(config, seed, device, codes_lr, codes_hr):
    """(model, optimizer, train_step, weights): the windowed cascade stage
    as ``train/transformer.py::run`` builds it (float32, Adam with the LR
    halving schedule, no EMA, clip or recompute), with weights drawn from
    ``seed`` and the given codebooks' codes."""
    from qaig_tpu_torch.models.codebook import Codebook
    from qaig_tpu_torch.models.transformer import Transformer
    from qaig_tpu_torch.train import common, optim
    from qaig_tpu_torch.train.transformer import (build_transformer_config,
                                                  make_train_step)
    common.full_float32()
    k = config["num_embeddings"]
    image_dim = (config["image_H"], config["image_W"])
    cfg = build_transformer_config(config, False, k, k,
                                   use_remat=config["use_remat"])
    model = Transformer(cfg, device=device)
    lr_cb = Codebook(tuple(config["lr_patch"]), image_dim, config["image_C"],
                     k, init_neighbour_range=1, device=device)
    hr_cb = Codebook(tuple(config["hr_patch"]), image_dim, config["image_C"],
                     k, init_neighbour_range=1, device=device)
    lr_cb.requires_grad_(False)
    hr_cb.requires_grad_(False)
    weights = bw.draw({"model.": model, "lr.": lr_cb, "hr.": hr_cb}, seed,
                      device, torch.float32,
                      overrides={"lr.codebook": codes_lr,
                                 "hr.codebook": codes_hr},
                      scales=config.get("weight_scales"))
    optimizer, scheduler = optim.make_adam(
        model.parameters(), config["model_lr"], config["adam"]["lr_step"])
    step = make_train_step(
        model, optimizer, lr_cb, hr_cb, False, k, k,
        config["sliding_window"] if config["use_sliding_window"] else None,
        bf16=False, grad_clip=config["grad_clip"], scheduler=scheduler)
    return model, optimizer, step, weights


def fmap_loader(manifest_path, batch_size, seed):
    """The port's feature-map loader over a manifest (the trainer's CLI's
    ``DataLoader(FeatureMapDataset(...))``)."""
    from qaig_tpu_torch.data.fmap_dataset import FeatureMapDataset
    from qaig_tpu_torch.data.loader import DataLoader
    return DataLoader(FeatureMapDataset(manifest_path), batch_size=batch_size,
                      seed=seed)


def write_manifest(path, rows):
    from qaig_tpu_torch.data.manifest import write_manifest as write
    return write(path, rows)
