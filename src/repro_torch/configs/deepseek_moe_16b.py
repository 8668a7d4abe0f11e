"""deepseek-moe-16b — fine-grained MoE: 2 shared + 64 routed top-6.

28L d_model=2048 16H (GQA kv=16) vocab=102400 [arXiv:2401.06066; hf].
The assigned d_ff=1408 is the per-expert (fine-grained) width; the leading
dense layer uses the published 10944 dense intermediate size.

The port's copy of ``repro.configs.deepseek_moe_16b``, with the same values.
"""

from repro_torch.models.config import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="deepseek-moe-16b",
        family="moe",
        n_layers=28,
        d_model=2048,
        n_heads=16,
        n_kv_heads=16,
        d_ff=10944,  # dense (layer-0) MLP width
        vocab_size=102400,
        head_dim=128,
        n_experts=64,
        n_shared_experts=2,
        top_k=6,
        moe_d_ff=1408,
        n_dense_layers=1,
        rope_theta=1e4,
        moe_group_tokens=1024,
        remat="full",
        microbatch=1,
    )


def smoke_config() -> ArchConfig:
    return config().replace(
        name="deepseek-moe-16b-smoke",
        n_layers=3,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        head_dim=16,
        d_ff=128,
        moe_d_ff=32,
        n_experts=8,
        n_shared_experts=2,
        top_k=2,
        n_dense_layers=1,
        vocab_size=512,
        moe_group_tokens=32,
        attn_chunk=16,
        param_dtype="float32",
        dtype="float32",
        remat="none",
    )
