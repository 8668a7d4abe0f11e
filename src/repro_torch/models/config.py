"""``ArchConfig`` — one declarative record per architecture.

The port's own copy of ``repro.models.config.ArchConfig``, with every field
kept, so that a config of the port compares field by field with the
reference's. ``use_pallas`` is kept as a field and switches nothing here: on
the card attention and norms always go through the Hopper kernels, on the CPU
always through their plain versions.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | rwkv6 | rglru | encdec
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 → d_model // n_heads

    # attention
    attention: str = "gqa"  # gqa | mla | local | none
    rope_theta: float = 1e4
    window: int = 0  # sliding-window size for local attention

    # MLA (MiniCPM3 / DeepSeek-style latent attention)
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0

    # MoE
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    n_dense_layers: int = 0  # leading dense layers (DeepSeek/Kimi style)
    capacity_factor: float = 1.25
    moe_group_tokens: int = 1024  # GShard dispatch group size (perf lever)
    router_aux_weight: float = 0.01

    # hybrid (Griffin / RecurrentGemma)
    block_pattern: tuple = ()  # e.g. ("rec", "rec", "attn")
    lru_width: int = 0
    conv_width: int = 4
    logit_cap: float = 0.0

    # RWKV6
    rwkv_head_size: int = 64
    rwkv_lora_rank: int = 32
    rwkv_decay_lora: int = 64

    # encoder-decoder (whisper)
    n_enc_layers: int = 0
    enc_len: int = 1500  # encoder memory length (stub frontend output)

    # multimodal stub (llava)
    n_patches: int = 0  # visual tokens prepended by the stub frontend

    # numerics
    param_dtype: str = "bfloat16"
    dtype: str = "bfloat16"  # activation/compute dtype

    # perf levers
    remat: str = "full"  # none | full | selective
    use_scan: bool = True
    use_pallas: bool = False  # the reference's kernel switch; switches nothing in the port
    seq_shard: bool = False  # sequence parallelism: residual stream S over `model`
    fsdp: bool = False  # ZeRO-3: weight/optimizer "embed" dim over the data axes
    #   (training only; serving keeps TP-only weights for per-token latency)
    optimizer: str = "adamw"  # adamw | adamw8bit | lion
    microbatch: int = 1  # gradient-accumulation microbatches
    attn_chunk: int = 1024  # KV chunk for flash-style attention
    tie_embeddings: bool = False
    z_loss: float = 1e-4

    # capability flags
    sub_quadratic: bool = False  # eligible for long_500k
    has_decoder: bool = True  # encoder-only archs skip decode shapes

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    # -- bookkeeping used by launchers, rooflines and EXPERIMENTS.md ---------

    def param_count(self) -> int:
        """Total parameters (all experts), analytic."""
        D, F, V, L = self.d_model, self.d_ff, self.vocab_size, self.n_layers
        hd = self.resolved_head_dim
        emb = V * D * (1 if self.tie_embeddings else 2)
        if self.family == "rwkv6":
            per = self._rwkv_layer_params()
            return emb + L * per + D
        if self.family == "rglru":
            return emb + self._griffin_params() + D
        attn = D * self.n_heads * hd + 2 * D * self.n_kv_heads * hd + self.n_heads * hd * D
        if self.attention == "mla":
            attn = self._mla_layer_params()
        dense_mlp = 3 * D * F
        if self.family == "moe":
            n_moe = L - self.n_dense_layers
            moe_mlp = (
                self.n_experts * 3 * D * self.moe_d_ff
                + self.n_shared_experts * 3 * D * self.moe_d_ff
                + D * self.n_experts  # router
            )
            body = self.n_dense_layers * (attn + dense_mlp) + n_moe * (attn + moe_mlp)
        elif self.family == "encdec":
            enc = self.n_enc_layers * (attn + dense_mlp)
            dec = L * (attn * 2 + dense_mlp)  # self + cross attention
            body = enc + dec
        else:
            body = L * (attn + dense_mlp)
        return emb + body + D

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: routed top-k + shared only)."""
        if self.family != "moe":
            return self.param_count()
        D, F, L = self.d_model, self.d_ff, self.n_layers
        hd = self.resolved_head_dim
        attn = D * self.n_heads * hd + 2 * D * self.n_kv_heads * hd + self.n_heads * hd * D
        n_moe = L - self.n_dense_layers
        active_mlp = (self.top_k + self.n_shared_experts) * 3 * D * self.moe_d_ff
        emb = self.vocab_size * D * (1 if self.tie_embeddings else 2)
        return (
            emb
            + self.n_dense_layers * (attn + 3 * D * F)
            + n_moe * (attn + active_mlp + D * self.n_experts)
            + D
        )

    def _mla_layer_params(self) -> int:
        D = self.d_model
        H = self.n_heads
        qk = self.qk_nope_dim + self.qk_rope_dim
        return (
            D * self.q_lora_rank
            + self.q_lora_rank * H * qk
            + D * (self.kv_lora_rank + self.qk_rope_dim)
            + self.kv_lora_rank * H * (self.qk_nope_dim + self.v_head_dim)
            + H * self.v_head_dim * D
        )

    def _rwkv_layer_params(self) -> int:
        D, F = self.d_model, self.d_ff
        r = self.rwkv_lora_rank
        # time-mix: r/k/v/g/o square proj + 5 ddlerp loras + decay lora
        tm = 5 * D * D + 5 * (D * r + r * D) + (D * self.rwkv_decay_lora + self.rwkv_decay_lora * D)
        cm = 2 * D * F  # channel-mix key/value (+ receptance D*D)
        return tm + cm + D * D

    def _griffin_params(self) -> int:
        D, F = self.d_model, self.d_ff
        W = self.lru_width or D
        hd = self.resolved_head_dim
        n_attn = sum(1 for i in range(self.n_layers) if self._block_kind(i) == "attn")
        n_rec = self.n_layers - n_attn
        attn = D * self.n_heads * hd + 2 * D * self.n_kv_heads * hd + self.n_heads * hd * D
        rec = 2 * D * W + W * self.conv_width + 2 * W + W * D  # in/gate, conv, lru gates, out
        mlp = 3 * D * F
        return n_attn * (attn + mlp) + n_rec * (rec + mlp)

    def _block_kind(self, i: int) -> str:
        if not self.block_pattern:
            return "attn"
        return self.block_pattern[i % len(self.block_pattern)]
