"""codeqwen1.5-7b — dense, qwen1.5 arch (full MHA-as-GQA kv=32).

32L d_model=4096 32H (kv=32) d_ff=13440 vocab=92416
[hf:Qwen/CodeQwen1.5-7B; hf].

The port's copy of ``repro.configs.codeqwen15_7b``, with the same values.
"""

from repro_torch.models.config import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="codeqwen1.5-7b",
        family="dense",
        n_layers=32,
        d_model=4096,
        n_heads=32,
        n_kv_heads=32,
        d_ff=13440,
        vocab_size=92416,
        head_dim=128,
        rope_theta=1e6,
        remat="full",
    )


def smoke_config() -> ArchConfig:
    return config().replace(
        name="codeqwen-smoke",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        head_dim=16,
        d_ff=128,
        vocab_size=512,
        attn_chunk=16,
        param_dtype="float32",
        dtype="float32",
        remat="none",
    )
