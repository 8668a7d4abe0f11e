"""nbi-100m — the framework's own ~110M-parameter reference model.

The port's copy of ``repro.configs.nbi100m``, with the same values. It is
the port's main path: ``repro_torch.launch.serve`` serves it at full width on
one card, and ``chip_smoke.py`` drives that.
"""

from repro_torch.models.config import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="nbi-100m",
        family="dense",
        n_layers=12,
        d_model=768,
        n_heads=12,
        n_kv_heads=12,
        d_ff=2048,
        vocab_size=32768,
        head_dim=64,
        tie_embeddings=True,
        param_dtype="float32",
        dtype="float32",
        remat="none",
    )


def smoke_config() -> ArchConfig:
    return config().replace(
        name="nbi100m-smoke",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        head_dim=16,
        d_ff=128,
        vocab_size=512,
        attn_chunk=16,
    )
