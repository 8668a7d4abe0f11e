"""starcoder2-7b — dense GQA, RoPE.

32L d_model=4608 36H (GQA kv=4) d_ff=18432 vocab=49152 [arXiv:2402.19173; hf].

The port's copy of ``repro.configs.starcoder2_7b``, with the same values.
"""

from repro_torch.models.config import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="starcoder2-7b",
        family="dense",
        n_layers=32,
        d_model=4608,
        n_heads=36,
        n_kv_heads=4,
        d_ff=18432,
        vocab_size=49152,
        head_dim=128,
        rope_theta=1e5,
        remat="full",
    )


def smoke_config() -> ArchConfig:
    return config().replace(
        name="starcoder2-smoke",
        n_layers=2,
        d_model=64,
        n_heads=6,
        n_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab_size=512,
        attn_chunk=16,
        param_dtype="float32",
        dtype="float32",
        remat="none",
    )
