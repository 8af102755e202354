"""Library-level cascade pipeline: load once, generate many (counterpart of
``qaig_tpu/infer/pipeline.py``).

Every stage's transformer and codebooks and the FC decoder are loaded once
onto one device; :meth:`CascadePipeline.generate` then runs the whole
cascade per call and returns float32 images and the final tokens.  Its
sampling is row-keyed (``infer/row_keys.py``): row ``j`` draws from
``derive_row_keys(seed, N)[j]``, or from the keys given, so a row's tokens
do not depend on the rows it is batched with.  The serving batcher
(``qaig_tpu_torch/serve.py``) relies on that.

``generate`` runs the whole cascade as one function per (batch,
temperature) (``fused``, row-keyed only, as in ``qaig_tpu``): on CUDA, the
default, from a CUDA graph captured at the key's first call
(``infer/graphs.py``); on the CPU, where the dispatched loop stays the
default, eagerly.

``mesh`` (a ``parallel/local.py::LocalMesh``: one process over several
cards, as ``qaig_tpu``'s ``mesh``): one replica of the stages, codebooks
and decoder on each data row's home card, with every stage MLP
tensor-parallel over the row's model devices when the model axis is
above 1; each call's rows split into the mesh's batch blocks, each
replica runs its block and the results are concatenated on the first
replica's card.  Multi-process sharded generation is ``generate.run``'s.
"""

import contextlib
import dataclasses
from dataclasses import dataclass

import torch

from qaig_tpu_torch.infer import row_keys as rk
from qaig_tpu_torch.infer.decode import (DecodeEngine, RowSlice,
                                         SamplerSettings)
from qaig_tpu_torch.infer.generate import (_load_stage, _random_tokens,
                                           library_warmup)
from qaig_tpu_torch.infer.graphs import GraphRunner
from qaig_tpu_torch.parallel.local import LocalMesh, shard_mlps_local_
from qaig_tpu_torch.train import common
from qaig_tpu_torch.utils.checkpoint import load_model

# Fold tag separating the stage-0 random conditioning grid's draw from the
# per-stage / per-beam / per-slot sampling folds (all small ints).
_INIT_TAG = 424242


def derive_row_keys(seed, num_rows, start=0):
    """Per-row sampling keys (num_rows, 2) int64 on the CPU: row ``j`` gets
    ``fold_in(key(seed), start + j)``.  The serving batcher builds a merged
    batch's keys per REQUEST with this (each request's own seed, rows
    numbered from 0), so a request's tokens do not depend on its
    co-batch."""
    rows = torch.arange(start, start + num_rows, dtype=torch.int64)
    return rk.fold_in(rk.key(seed), rows)


@dataclass
class CascadeStage:
    engine: DecodeEngine
    lr_codebook: object
    hr_codebook: object
    settings: SamplerSettings
    num_beam: int
    beam_width: int
    sliding_window: int
    total_seq: int
    is_base: bool

    @property
    def lr_num_embeddings(self):
        return self.lr_codebook.num_embeddings if self.lr_codebook else 0


class CascadePipeline:
    """The full coarse-to-fine generation stack on one device, or over a
    :class:`~qaig_tpu_torch.parallel.local.LocalMesh` (``mesh``): this
    object is then data row 0's replica, and ``replicas`` holds every
    row's (row 0 is this one; each other is a pipeline on its home card
    whose mesh is its own row, 1 x model)."""

    def __init__(self, stages, decoder, device, mesh=None, replicas=()):
        self.stages = stages
        self.decoder = decoder
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            # an explicit index: a serving thread makes it its current
            # device (torch.cuda.set_device refuses a bare "cuda")
            device = torch.device("cuda", torch.cuda.current_device())
        self.device = device
        self.mesh = mesh
        self._others = list(replicas)
        # the fused path's CUDA graphs, by (batch, temperature); a
        # tensor-parallel replica spans several cards and has none
        self._graphs = None
        if device.type == "cuda" and not self.tensor_parallel:
            self._graphs = GraphRunner(device, library_warmup(
                decoder, stages[-1].hr_codebook,
                stages[-1].engine.model.dtype, device))

    @property
    def replicas(self):
        """Every data row's replica, this one first (built on each call:
        a list holding ``self`` would make a reference cycle, and its CUDA
        graphs would then die at a later garbage collection, which can
        fall inside another capture and invalidate it)."""
        return [self, *self._others]

    @property
    def tensor_parallel(self):
        return self.mesh is not None and self.mesh.size("model") > 1

    @classmethod
    def from_config(cls, config_dict, decoder_path, logging=print,
                    device="cuda", dtype=None, use_ema=False, mesh=None):
        """``config_dict`` is the ``generate_images`` staged config (keys
        "0", "1", ... with model / codebook paths and sampling settings).
        ``device`` defaults to ``cuda`` and raises when no GPU is visible.
        ``dtype`` (``torch.bfloat16`` for serving) casts every float
        parameter; ``use_ema`` serves the EMA weights (``model_ema``).
        ``mesh`` (a ``LocalMesh``; its devices replace ``device``): one
        replica on each data row's home card, its stage MLPs split over
        the row's model devices (``parallel/local.py::
        shard_mlps_local_``)."""
        if mesh is None:
            return cls(*cls._load(config_dict, decoder_path, logging,
                                  common.select_device(device), dtype,
                                  use_ema))
        common.select_device(mesh.grid[0][0])
        rows = []
        for row in mesh.grid:
            stages, decoder, home = cls._load(config_dict, decoder_path,
                                              logging, row[0], dtype,
                                              use_ema)
            for stage in stages:
                shard_mlps_local_(stage.engine.model, row)
            rows.append((stages, decoder, home, LocalMesh(1, len(row), row)))
        replicas = [cls(*row[:3], mesh=row[3]) for row in rows[1:]]
        return cls(*rows[0][:3], mesh=mesh, replicas=replicas)

    @staticmethod
    def _load(config_dict, decoder_path, logging, device, dtype, use_ema):
        """(stages, decoder, device) of one replica on ``device``."""
        status, dec_ckpt = load_model(decoder_path, logging=logging)
        if not status:
            raise RuntimeError(
                "An error occured while loading decoder model checkpoint!")
        decoder, _ = common.decoder_from_checkpoint(dec_ckpt, device,
                                                    logging=logging)

        def cast(module):
            return module if dtype is None else common.cast_floats(module,
                                                                   dtype)

        stages = []
        for index in sorted(config_dict, key=int):
            stage_cfg = config_dict[index]
            st = _load_stage(index, stage_cfg, cast, device, use_ema=use_ema,
                             logging=logging)
            settings = SamplerSettings(
                temperature=stage_cfg["temperature"],
                end_token=st["hr_num_embeddings"], end_mode="mask",
                index_shift=st["lr_num_embeddings"] if st["is_base"] else 0,
                pos_offset=1)  # the reference's generation position quirk
            stages.append(CascadeStage(
                engine=DecodeEngine(st["model"]),
                lr_codebook=st["lr_codebook"], hr_codebook=st["hr_codebook"],
                settings=settings, num_beam=stage_cfg["num_beam"],
                beam_width=stage_cfg["beam_width"],
                sliding_window=st["sliding_window"],
                total_seq=st["total_seq"], is_base=st["is_base"]))
        return stages, cast(decoder), device

    def _blocks(self, num_images):
        """Each replica's row range of a call of ``num_images`` rows."""
        if self.mesh is None:
            return [(0, num_images)]
        return self.mesh.batch_blocks(num_images)

    def _on(self, replica):
        """Over a mesh, ``replica``'s card as the current CUDA device
        around its work (one card: the caller's, as the server's
        dispatcher sets it)."""
        if len(self.replicas) > 1 and replica.device.type == "cuda":
            return torch.cuda.device(replica.device)
        return contextlib.nullcontext()

    def _gather(self, parts):
        """Per-replica results (tuples of tensors or lists of them) joined
        along the rows on the first replica's card."""
        if len(parts) == 1:
            return parts[0]
        first = parts[0]
        if isinstance(first, torch.Tensor):
            return torch.cat([p.to(self.device) for p in parts])
        return type(first)(self._gather(list(group))
                           for group in zip(*parts))

    @torch.inference_mode()
    def generate_tokens(self, num_images, rng=None, init_tokens=None,
                        temperature=None, row_keys=None):
        """Run every stage; returns (final HR tokens, per-stage tokens).

        ``init_tokens`` optionally conditions stage 0 (by default random
        coarse indices, one per image).  ``temperature`` overrides every
        stage's configured temperature for this call.  Pass EITHER ``rng``
        (a ``torch.Generator`` on the pipeline's device, consumed stage by
        stage: batch-keyed sampling) OR ``row_keys`` (N, 2), one key per
        image row: stage ``i`` of row ``n`` then samples from
        ``fold_in(row_keys[n], i)`` (and the stage-0 random grid from a
        further ``_INIT_TAG`` fold), so a row's whole trajectory is a
        function of its own key.

        Over a mesh each replica runs its block of rows.  Batch-keyed,
        each replica draws from a copy of ``rng`` on its card and keeps
        its block of every draw made for all the rows
        (``infer/decode.py::RowSlice``), so the tokens equal one
        replica's; ``rng`` then stands where one replica leaves it."""
        if (rng is None) == (row_keys is None):
            raise ValueError("pass exactly one of rng / row_keys")
        blocks = self._blocks(num_images)
        if len(blocks) == 1:
            return self._block_tokens(num_images, rng, init_tokens,
                                      temperature, row_keys)
        parts, draws = [], []
        for d, (replica, (a, b)) in enumerate(zip(self.replicas, blocks)):
            draw = None
            if rng is not None:
                copy = torch.Generator(device=replica.device)
                copy.set_state(rng.get_state())
                draw = RowSlice(copy, d, len(blocks))
                draws.append(copy)
            with self._on(replica):
                parts.append(replica._block_tokens(
                    b - a, draw, None if init_tokens is None
                    else init_tokens[a:b], temperature,
                    None if row_keys is None else row_keys[a:b]))
        if draws:
            rng.set_state(draws[0].get_state())
        return self._gather(parts)

    def _block_tokens(self, num_images, rng, init_tokens, temperature,
                      row_keys):
        """:meth:`generate_tokens` on this replica alone (``rng`` a
        generator or a :class:`RowSlice` of one)."""
        if row_keys is not None:
            # a no-op for the fused path's static key buffer, which is
            # filled before the replay, outside the captured region
            row_keys = torch.as_tensor(row_keys, dtype=torch.int64).to(
                self.device)
        tokens = (None if init_tokens is None else
                  torch.as_tensor(init_tokens).long().to(self.device))
        per_stage = []
        for stage_idx, stage in enumerate(self.stages):
            settings = stage.settings
            if temperature is not None:
                settings = dataclasses.replace(
                    settings, temperature=float(temperature))
            gen_rng = (rng if row_keys is None
                       else rk.fold_in(row_keys, stage_idx))
            if stage.is_base:
                if tokens is None:
                    if row_keys is not None:
                        tokens = rk.randint(rk.fold_in(gen_rng, _INIT_TAG),
                                            stage.lr_num_embeddings)[:, None]
                    else:
                        tokens = _random_tokens((num_images, 1),
                                                stage.lr_num_embeddings, rng)
                init, x_enc = tokens, None
            else:
                init = torch.full((num_images, 1),
                                  stage.hr_codebook.num_embeddings,
                                  dtype=torch.long, device=self.device)
                x_enc = tokens
            out = stage.engine.rollout_generate(
                init, stage.total_seq, gen_rng, settings,
                num_beam=stage.num_beam, beam_width=stage.beam_width,
                x_enc=x_enc, sliding_window=stage.sliding_window)
            tokens = out - settings.index_shift
            per_stage.append(tokens)
        return tokens, per_stage

    def _images(self, num_images, row_keys, temperature, init_tokens=None):
        """Every stage, the codebook lookup and the pixel decode on this
        replica: (images float32, final tokens)."""
        tokens, _ = self._block_tokens(num_images, None, init_tokens,
                                       temperature, row_keys)
        quant = self.stages[-1].hr_codebook.get_quantized_image(tokens)
        return self.decoder(quant).float(), tokens

    def _fused_program(self, num_images, temperature):
        """The whole cascade (:meth:`_images`) at a fixed (batch,
        temperature), as a function of the row keys (N, 2): on CUDA,
        replayed from the key's CUDA graph (captured at its first call),
        else run eagerly."""
        def cascade(row_keys):
            return self._images(num_images, row_keys, temperature)

        if self._graphs is None:
            return cascade
        return lambda row_keys: self._graphs((num_images, temperature),
                                             cascade, inputs=(row_keys,))

    @torch.inference_mode()
    def generate(self, num_images, seed=0, init_tokens=None,
                 temperature=None, row_keys=None, fused=None):
        """Returns (images (N, C, H, W) float32 in [-1, 1] BGR, final
        tokens), both on the pipeline's device.

        Sampling is ROW-KEYED: row ``j`` draws from
        ``derive_row_keys(seed, N)[j]``, or from ``row_keys[j]`` when given
        (the serving batcher passes per-request keys), so a row's result
        does not depend on the batch it runs in.

        ``fused``: run the whole cascade as one function
        (:meth:`_fused_program`; on CUDA one CUDA graph replay per call).
        The default is fused on CUDA when no ``init_tokens`` are given,
        and the dispatched loop otherwise; ``fused=True`` with
        ``init_tokens`` raises.

        Over a mesh, ``N`` is a multiple of its data axis and each replica
        generates its block.  On a data-only mesh each replica replays its
        own fused graph on its card (the default on CUDA), every replica's
        replay started before any output is read, so that cards overlap:
        each replica is exactly an unsharded pipeline.  This differs from
        ``qaig_tpu``, whose sharded ``generate`` is dispatched and raises
        on ``fused=True``; the tokens are the same.  With a model axis
        above 1 generation is dispatched (``fused`` None) and
        ``fused=True`` raises, as in ``qaig_tpu``."""
        if row_keys is None:
            row_keys = derive_row_keys(seed, num_images)
        if fused is None:
            fused = (self.device.type == "cuda" and init_tokens is None
                     and not self.tensor_parallel)
        if fused and (init_tokens is not None or self.tensor_parallel):
            raise ValueError("fused generation supports only the "
                             "unsharded, unconditioned path")
        row_keys = torch.as_tensor(row_keys, dtype=torch.int64)
        parts = []
        for replica, (a, b) in zip(self.replicas, self._blocks(num_images)):
            keys = row_keys[a:b]
            with self._on(replica):
                if fused:
                    parts.append(replica._fused_program(b - a, temperature)(
                        keys))
                else:
                    parts.append(replica._images(
                        b - a, keys, temperature,
                        None if init_tokens is None else init_tokens[a:b]))
        return self._gather(parts)
