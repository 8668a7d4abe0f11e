"""whisper-small — encoder-decoder; the conv audio front end is a stub.

12L(+12 enc) d_model=768 12H d_ff=3072 vocab=51865 [arXiv:2212.04356;
unverified]. The model takes precomputed frame embeddings (B, 1500, 768) in
place of the log-mel + 2×conv stem; shapes apply to the decoder side.

The port's copy of ``repro.configs.whisper_small``, with the same values.
"""

from repro_torch.models.config import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="whisper-small",
        family="encdec",
        n_layers=12,
        d_model=768,
        n_heads=12,
        n_kv_heads=12,
        d_ff=3072,
        vocab_size=51865,
        n_enc_layers=12,
        enc_len=1500,
        tie_embeddings=True,
        attn_chunk=512,
        remat="full",
    )


def smoke_config() -> ArchConfig:
    return config().replace(
        name="whisper-smoke",
        n_layers=2,
        n_enc_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_ff=128,
        vocab_size=512,
        enc_len=24,
        attn_chunk=8,
        param_dtype="float32",
        dtype="float32",
        remat="none",
    )
