"""Model registry of the port: one API over every architecture family of the
reference (``dense`` with GQA, MLA and the visual prefix, ``moe``, ``rglru``
(Griffin), ``rwkv6`` and ``encdec`` (Whisper)).

``build_model(cfg)`` returns a :class:`Model` whose members are plain
functions on tensors:

  loss_fn(params, batch)              → (scalar loss, metrics)   [train;
                                        encdec reads batch["frames"] too]
  prefill_fn(params, batch)           → (last logits, cache)     [prefill;
                                        dense reads batch["patches"] too,
                                        encdec batch["frames"]]
  decode_fn(params, cache, tok, pos)  → (logits, cache)          [decode]
  cache_defs_fn(batch, max_seq)       → cache layout on ``meta``
  cache_logical_fn()                  → the cache's logical axes
  forward_fn(params, tokens)          → logits of every position
                                        [dense takes patches= too; encdec
                                        needs frames=]

plus the inputs of each step as ``meta`` tensors of the reference's shapes
and dtypes (``train_inputs``, ``prefill_inputs``, ``decode_inputs``: what
``repro_torch.launch.dryrun`` counts a step on), and the logical axes of the
parameters and inputs (``param_logical``,
``train_input_logical``, ``prefill_input_logical``), which
:mod:`repro_torch.parallel.sharding` resolves to placements on a mesh.

``repro_torch.training.make_prefill_step`` / ``make_serve_step`` run the
prefill and decode functions under sharding rules on a mesh, as the
reference's do; without rules they are these functions themselves. Every family trains through ``loss_fn`` (MoE's metrics add the
``aux_loss``), an MoE model with MLA attention too; its prefill, decode and
cache functions raise ``NotImplementedError``, as the reference's fail
(:func:`repro_torch.models.moe.refuse_mla_serving`). ``build_model`` raises
``NotImplementedError`` for a visual prefix in an MoE model, which the
reference does not build either.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from . import moe
from . import rglru as rg
from . import rwkv6 as rw
from . import transformer as tx
from . import whisper as wh
from .common import init_params, map_defs, resolve_device, torch_dtype
from .config import ArchConfig

VOCAB_PAD = 512  # embeddings padded as in the reference (the padded logits are served too)


def padded_vocab(cfg: ArchConfig) -> int:
    v = cfg.vocab_size
    return ((v + VOCAB_PAD - 1) // VOCAB_PAD) * VOCAB_PAD


@dataclasses.dataclass
class Model:
    cfg: ArchConfig
    param_defs: Any
    loss_fn: Callable  # (params, batch) -> (loss, metrics)
    prefill_fn: Callable
    decode_fn: Callable
    cache_defs_fn: Callable  # (batch, max_seq) -> dict of meta tensors
    cache_logical_fn: Callable  # () -> the cache's logical tree
    forward_fn: Callable  # (params, tokens[, patches | frames]) -> logits of every position

    def init(self, generator: torch.Generator, device="cuda") -> dict:
        """Seeded weights on ``device`` (``cuda`` unless the caller asks for the CPU)."""
        return init_params(self.param_defs, generator, resolve_device(device))

    def abstract_params(self) -> dict:
        """The parameters as tensors on the ``meta`` device (shape and dtype, no storage)."""
        return map_defs(lambda d: torch.empty(d.shape, dtype=d.dtype, device="meta"), self.param_defs)

    def param_logical(self) -> dict:
        """The logical axes of every parameter (tuples as leaves)."""
        return map_defs(lambda d: d.logical, self.param_defs)

    def train_inputs(self, batch: int, seq: int) -> dict:
        """A train batch on ``meta``: int32 tokens and labels (batch, seq);
        Whisper's frames (batch, enc_len, d_model); with a visual prefix,
        patches (batch, n_patches, d_model), tokens for the seq - n_patches
        text positions and labels for all seq (the reference's shapes)."""
        cfg = self.cfg

        def meta(shape, dtype=torch.int32):
            return torch.empty(shape, dtype=dtype, device="meta")

        if cfg.family == "encdec":
            return {"frames": meta((batch, cfg.enc_len, cfg.d_model), torch_dtype(cfg.dtype)),
                    "tokens": meta((batch, seq)), "labels": meta((batch, seq))}
        if cfg.n_patches:
            return {"patches": meta((batch, cfg.n_patches, cfg.d_model), torch_dtype(cfg.dtype)),
                    "tokens": meta((batch, seq - cfg.n_patches)), "labels": meta((batch, seq))}
        return {"tokens": meta((batch, seq)), "labels": meta((batch, seq))}

    def prefill_inputs(self, batch: int, seq: int) -> dict:
        out = self.train_inputs(batch, seq)
        out.pop("labels")
        return out

    def decode_inputs(self, batch: int) -> dict:
        """One decode step's tokens (batch, 1) int32 and position, on ``meta``:
        ``pos`` a 0-dim int32 tensor, the scalar position the decode
        function takes (as the reference's traced scalar)."""
        return {"tokens": torch.empty((batch, 1), dtype=torch.int32, device="meta"),
                "pos": torch.empty((), dtype=torch.int32, device="meta")}

    def train_input_logical(self) -> dict:
        cfg = self.cfg
        out = {"tokens": ("batch", None), "labels": ("batch", None)}
        if cfg.family == "encdec":
            out["frames"] = ("batch", None, None)
        if cfg.n_patches:
            out["patches"] = ("batch", None, None)
        return out

    def prefill_input_logical(self) -> dict:
        out = self.train_input_logical()
        out.pop("labels")
        return out


# family: (param_defs, prefill, decode_step, forward, cache_defs, cache_logical),
# each taking the (padded) config as an argument
_FAMILIES = {
    "dense": (tx.dense_param_defs, tx.dense_prefill, tx.dense_decode_step, tx.dense_forward,
              tx.dense_cache_defs, tx.cache_logical),
    "moe": (moe.moe_param_defs, moe.moe_prefill, moe.moe_decode_step, moe.moe_forward, moe.moe_cache_defs,
            moe.moe_cache_logical),
    "rglru": (rg.griffin_param_defs, rg.griffin_prefill, rg.griffin_decode_step, rg.griffin_forward,
              rg.griffin_cache_defs, rg.griffin_cache_logical),
    "rwkv6": (rw.rwkv_param_defs, rw.rwkv_prefill, rw.rwkv_decode_step, rw.rwkv_forward,
              rw.rwkv_cache_defs, rw.rwkv_cache_logical),
    "encdec": (wh.whisper_param_defs, wh.whisper_prefill, wh.whisper_decode_step, wh.whisper_forward,
               wh.whisper_cache_defs, wh.whisper_cache_logical),
}


# family: loss(params, cfg, batch) → (loss, metrics)
_LOSSES = {"dense": tx.dense_loss, "moe": moe.moe_loss, "rglru": rg.griffin_loss, "rwkv6": rw.rwkv_loss,
           "encdec": wh.whisper_loss}


def build_model(cfg: ArchConfig) -> Model:
    if cfg.family not in _FAMILIES:
        raise NotImplementedError(f"unknown family {cfg.family!r} (the port has {sorted(_FAMILIES)})")
    if cfg.family == "moe" and cfg.n_patches:
        raise NotImplementedError(f"{cfg.name}: a visual prefix in an MoE model (the reference's moe_forward "
                                  "takes none)")
    param_defs, prefill, decode_step, forward, cache_defs, cache_logical = _FAMILIES[cfg.family]
    pcfg = cfg.replace(vocab_size=padded_vocab(cfg))

    def prefill_fn(params, batch):
        if cfg.family == "dense":  # the visual prefix, as the reference's registry
            return prefill(params, pcfg, batch["tokens"], patches=batch.get("patches"))
        if cfg.family == "encdec":  # the audio memory, as the reference's registry
            return prefill(params, pcfg, batch["frames"], batch["tokens"])
        return prefill(params, pcfg, batch["tokens"])

    def forward_fn(params, tokens, patches=None, frames=None):
        if (frames is not None) != (cfg.family == "encdec"):
            raise ValueError(f"family {cfg.family!r} " + ("needs the audio frames (frames=)" if frames is None
                                                            else "takes no audio frames"))
        if cfg.family == "dense":
            return forward(params, pcfg, tokens, patches=patches)
        if patches is not None:
            raise ValueError(f"family {cfg.family!r} takes no visual prefix")
        if cfg.family == "encdec":
            return forward(params, pcfg, tokens, frames)
        out = forward(params, pcfg, tokens)
        return out[0] if cfg.family == "moe" else out  # MoE's forward adds its aux loss

    return Model(
        cfg=pcfg,
        param_defs=param_defs(pcfg),
        loss_fn=lambda p, b: _LOSSES[cfg.family](p, pcfg, b),
        prefill_fn=prefill_fn,
        decode_fn=lambda p, c, t, pos: decode_step(p, pcfg, c, t, pos),
        cache_defs_fn=lambda batch, seq: cache_defs(pcfg, batch, seq),
        cache_logical_fn=lambda: cache_logical(pcfg),
        forward_fn=forward_fn,
    )
