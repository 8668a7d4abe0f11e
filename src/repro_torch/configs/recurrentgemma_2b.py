"""recurrentgemma-2b — Griffin: RG-LRU + local attention, 1:2 ratio.

26L d_model=2560 10H (MQA kv=1, head_dim 256) d_ff=7680 vocab=256000
[arXiv:2402.19427; hf]. Window-2048 local attention + O(1) recurrent state
→ runs the long_500k cell. Embeddings tied (Gemma lineage).

The port's copy of ``repro.configs.recurrentgemma_2b``, with the same values.
"""

from repro_torch.models.config import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="recurrentgemma-2b",
        family="rglru",
        n_layers=26,
        d_model=2560,
        n_heads=10,
        n_kv_heads=1,
        d_ff=7680,
        vocab_size=256000,
        head_dim=256,
        attention="local",
        window=2048,
        block_pattern=("rec", "rec", "attn"),
        lru_width=2560,
        conv_width=4,
        rope_theta=1e4,
        tie_embeddings=True,
        sub_quadratic=True,
        remat="full",
    )


def smoke_config() -> ArchConfig:
    return config().replace(
        name="recurrentgemma-smoke",
        n_layers=5,  # 1 super-layer + 2 tail rec pairs
        d_model=64,
        n_heads=4,
        n_kv_heads=1,
        head_dim=16,
        d_ff=128,
        vocab_size=512,
        window=8,
        lru_width=64,
        attn_chunk=8,
        param_dtype="float32",
        dtype="float32",
        remat="none",
    )
