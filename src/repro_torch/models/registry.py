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
  forward_fn(params, tokens)          → logits of every position
                                        [dense takes patches= too; encdec
                                        needs frames=]

The reference's ``make_prefill_step`` / ``make_serve_step``
(``repro/training/steps.py``) only wrap the prefill and decode functions with
sharding rules; on one card there are none, so they are these functions
themselves. Every family trains through ``loss_fn`` (MoE's metrics add the
``aux_loss``); ``build_model`` raises ``NotImplementedError`` for MLA or a
visual prefix in an MoE model, which the reference does not build either.
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
from .common import init_params, resolve_device
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
    forward_fn: Callable  # (params, tokens[, patches | frames]) -> logits of every position

    def init(self, generator: torch.Generator, device="cuda") -> dict:
        """Seeded weights on ``device`` (``cuda`` unless the caller asks for the CPU)."""
        return init_params(self.param_defs, generator, resolve_device(device))


# family: (param_defs, prefill, decode_step, forward, cache_defs), each taking
# the (padded) config as an argument
_FAMILIES = {
    "dense": (tx.dense_param_defs, tx.dense_prefill, tx.dense_decode_step, tx.dense_forward,
              tx.dense_cache_defs),
    "moe": (moe.moe_param_defs, moe.moe_prefill, moe.moe_decode_step, moe.moe_forward, moe.moe_cache_defs),
    "rglru": (rg.griffin_param_defs, rg.griffin_prefill, rg.griffin_decode_step, rg.griffin_forward,
              rg.griffin_cache_defs),
    "rwkv6": (rw.rwkv_param_defs, rw.rwkv_prefill, rw.rwkv_decode_step, rw.rwkv_forward,
              rw.rwkv_cache_defs),
    "encdec": (wh.whisper_param_defs, wh.whisper_prefill, wh.whisper_decode_step, wh.whisper_forward,
               wh.whisper_cache_defs),
}


# family: loss(params, cfg, batch) → (loss, metrics)
_LOSSES = {"dense": tx.dense_loss, "moe": moe.moe_loss, "rglru": rg.griffin_loss, "rwkv6": rw.rwkv_loss,
           "encdec": wh.whisper_loss}


def build_model(cfg: ArchConfig) -> Model:
    if cfg.family not in _FAMILIES:
        raise NotImplementedError(f"unknown family {cfg.family!r} (the port has {sorted(_FAMILIES)})")
    if cfg.family == "moe" and (cfg.attention not in ("gqa", "local") or cfg.n_patches):
        raise NotImplementedError(
            f"{cfg.name}: attention {cfg.attention!r} / visual prefix in an MoE model is not ported yet"
        )
    param_defs, prefill, decode_step, forward, cache_defs = _FAMILIES[cfg.family]
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
        forward_fn=forward_fn,
    )
