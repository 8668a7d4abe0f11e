"""mistral-large-123b — dense GQA flagship.

88L d_model=12288 96H (GQA kv=8) d_ff=28672 vocab=32768
[hf:mistralai/Mistral-Large-Instruct-2407; unverified]. Training defaults to
8 gradient-accumulation microbatches, selective remat and ZeRO-3 (``fsdp``).

The port's copy of ``repro.configs.mistral_large_123b``, with the same values.
Its bf16 weights (about 245 GB) do not fit one card: the port serves it at
full width and reduced depth.
"""

from repro_torch.models.config import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="mistral-large-123b",
        family="dense",
        n_layers=88,
        d_model=12288,
        n_heads=96,
        n_kv_heads=8,
        d_ff=28672,
        vocab_size=32768,
        head_dim=128,
        rope_theta=1e6,
        microbatch=8,
        remat="selective",
        fsdp=True,
    )


def smoke_config() -> ArchConfig:
    return config().replace(
        name="mistral-large-smoke",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab_size=512,
        attn_chunk=16,
        microbatch=2,
        param_dtype="float32",
        dtype="float32",
        remat="none",
    )
