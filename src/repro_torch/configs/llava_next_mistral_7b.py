"""llava-next-mistral-7b — VLM: mistral-7b backbone, anyres tiling stub.

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=32000
[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]. The vision tower and the
anyres tiling are a stub: 1152 precomputed patch embeddings (2 anyres tiles ×
576) are prepended to the text sequence.

The port's copy of ``repro.configs.llava_next_mistral_7b``, with the same
values.
"""

from repro_torch.models.config import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="llava-next-mistral-7b",
        family="dense",
        n_layers=32,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        d_ff=14336,
        vocab_size=32000,
        head_dim=128,
        rope_theta=1e6,
        n_patches=1152,
        remat="full",
    )


def smoke_config() -> ArchConfig:
    return config().replace(
        name="llava-smoke",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab_size=512,
        n_patches=8,
        attn_chunk=8,
        param_dtype="float32",
        dtype="float32",
        remat="none",
    )
