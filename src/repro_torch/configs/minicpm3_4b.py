"""minicpm3-4b — dense with MLA (multi-head latent attention).

62L d_model=2560 40H d_ff=6400 vocab=73448 [hf:openbmb/MiniCPM3-4B; hf].
MLA ranks from the published config: q_lora=768, kv_lora=256, qk_nope=64,
qk_rope=32, v_head=64. Decode uses the compressed-latent cache with absorbed
matmuls (see repro_torch/models/transformer.py); prefill attention has q and
k at 64 + 32 = 96 and v at 64.

The port's copy of ``repro.configs.minicpm3_4b``, with the same values.
"""

from repro_torch.models.config import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="minicpm3-4b",
        family="dense",
        n_layers=62,
        d_model=2560,
        n_heads=40,
        n_kv_heads=40,
        d_ff=6400,
        vocab_size=73448,
        attention="mla",
        q_lora_rank=768,
        kv_lora_rank=256,
        qk_nope_dim=64,
        qk_rope_dim=32,
        v_head_dim=64,
        rope_theta=1e4,
        remat="full",
    )


def smoke_config() -> ArchConfig:
    return config().replace(
        name="minicpm3-smoke",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_ff=128,
        vocab_size=512,
        q_lora_rank=24,
        kv_lora_rank=16,
        qk_nope_dim=8,
        qk_rope_dim=8,
        v_head_dim=8,
        attn_chunk=16,
        param_dtype="float32",
        dtype="float32",
        remat="none",
    )
