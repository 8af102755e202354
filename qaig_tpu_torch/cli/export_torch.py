"""Export a checkpoint as a reference-loadable torch ``.pt`` archive (the
port's counterpart of ``qaig_tpu/cli/export_torch.py``, same flags):

    python -m qaig_tpu_torch.cli.export_torch \
        --model-path out/models_checkpoint/model_100.pt \
        --out-path reference_model.pt [--no-optim] [--lr LR]

The archive keeps the checkpoint's hyperparameter schema, with the model
as a reference-named, reference-layout torch ``state_dict`` and
``model_optimizer`` as a torch Adam state dict when the checkpoint has
one (``utils/torch_export.py``, ``utils/torch_optim.py``): the same file
``qaig_tpu``'s exporter writes.  Either package's pickle checkpoints (and
reference archives) are read; the conversion runs on the host, with no
device work.  Not applicable: ``.orbax`` checkpoint directories and
their optimizer layout (orbax imports JAX).
"""

import argparse
import pathlib

import torch


def model_from_checkpoint(ckpt, logging=print):
    """The port module of any of the three checkpoint schemas
    (transformer / codebook / autoencoder, told apart by their keys), on
    the CPU with the checkpoint's weights."""
    from qaig_tpu_torch.train import common
    cpu = torch.device("cpu")
    if "train_base_model" in ckpt:
        from qaig_tpu_torch.infer.generate import transformer_from_checkpoint
        return transformer_from_checkpoint(ckpt, cpu, logging=logging)[0]
    if "checkpoint" in ckpt:
        return common.codebook_from_checkpoint(ckpt, cpu, logging=logging)
    return common.autoencoder_from_checkpoint(ckpt, cpu, logging=logging)[0]


def run(args):
    from qaig_tpu_torch.train import common, optim
    from qaig_tpu_torch.utils.checkpoint import load_model
    from qaig_tpu_torch.utils.torch_export import export_checkpoint
    from qaig_tpu_torch.utils.torch_optim import is_torch_adam_state

    status, ckpt = load_model(str(args["model_path"]))
    if not status:
        raise RuntimeError("An error occured while loading model checkpoint!")
    model = model_from_checkpoint(ckpt)

    # an optax state goes through the port's Adam; a reference Adam state
    # is kept as it is by export_checkpoint
    optimizer = None
    state = ckpt.get("model_optimizer")
    if not args.get("no_optim") and state is not None \
            and not is_torch_adam_state(state):
        model.requires_grad_(True)
        optimizer, _ = optim.make_adam(model.parameters(), 1e-4)
        common.restore_optimizer(model, optimizer, None, state)
    export_checkpoint(model, ckpt, args["out_path"], optimizer=optimizer,
                      learning_rate=args.get("lr"))


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Export checkpoint to reference torch format.")
    parser.add_argument("--model-path", required=True, type=pathlib.Path,
                        help="Pickle (or reference .pt) checkpoint to "
                             "export.")
    parser.add_argument("--out-path", required=True, type=pathlib.Path,
                        help="Destination .pt file (torch.save format).")
    parser.add_argument("--no-optim", action="store_true",
                        help="Skip optimizer-state conversion.")
    parser.add_argument("--lr", type=float, default=None,
                        help="LR recorded in the exported param group "
                             "(the reference force-resets it from config).")
    run(vars(parser.parse_args(argv)))


if __name__ == "__main__":
    main()
