"""rwkv6-7b — Finch: attention-free RNN with data-dependent decay.

32L d_model=4096 d_ff=14336 vocab=65536 [arXiv:2404.05892; hf].
O(1) decode state → runs the long_500k cell.

The port's copy of ``repro.configs.rwkv6_7b``, with the same values.
"""

from repro_torch.models.config import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="rwkv6-7b",
        family="rwkv6",
        n_layers=32,
        d_model=4096,
        n_heads=64,  # d_model / rwkv_head_size
        n_kv_heads=64,
        d_ff=14336,
        vocab_size=65536,
        attention="none",
        rwkv_head_size=64,
        rwkv_lora_rank=32,
        rwkv_decay_lora=64,
        sub_quadratic=True,
        remat="full",
    )


def smoke_config() -> ArchConfig:
    return config().replace(
        name="rwkv6-smoke",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_ff=128,
        vocab_size=512,
        rwkv_head_size=16,
        rwkv_lora_rank=8,
        rwkv_decay_lora=8,
        param_dtype="float32",
        dtype="float32",
        remat="none",
    )
