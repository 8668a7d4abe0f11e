"""kimi-k2-1t-a32b — trillion-parameter MoE, 384 routed experts top-8.

61L d_model=7168 64H (GQA kv=8 per assignment) d_ff=2048(expert)
vocab=163840 [arXiv:2501.kimi2; unverified]. 1 shared expert, 1 leading
dense layer (DeepSeek-V3 lineage). Attention is GQA at head dim 128, not MLA.

The port's copy of ``repro.configs.kimi_k2_1t_a32b``, with the same values.
``fsdp`` stays a field so that the configs compare field by field; on one
card it switches nothing. About 1.03 T parameters do not fit one card:
``chip_smoke.py`` serves it at full width and 2 of its 61 layers.
"""

from repro_torch.models.config import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="kimi-k2-1t-a32b",
        family="moe",
        n_layers=61,
        d_model=7168,
        n_heads=64,
        n_kv_heads=8,
        d_ff=18432,  # dense (layer-0) MLP width
        vocab_size=163840,
        head_dim=128,
        n_experts=384,
        n_shared_experts=1,
        top_k=8,
        moe_d_ff=2048,
        n_dense_layers=1,
        rope_theta=5e4,
        moe_group_tokens=256,
        optimizer="adamw8bit",
        microbatch=8,
        remat="selective",
        fsdp=True,
    )


def smoke_config() -> ArchConfig:
    return config().replace(
        name="kimi-k2-smoke",
        n_layers=3,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        head_dim=16,
        d_ff=128,
        moe_d_ff=32,
        n_experts=8,
        n_shared_experts=1,
        top_k=2,
        n_dense_layers=1,
        vocab_size=512,
        moe_group_tokens=32,
        attn_chunk=16,
        param_dtype="float32",
        dtype="float32",
        optimizer="adamw8bit",
        microbatch=1,
        remat="none",
    )
