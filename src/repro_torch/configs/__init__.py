"""Architecture configs of the port: six dense (one of them MLA and one with a
visual prefix), two MoE, one Griffin, one RWKV-6 and one encoder-decoder
(Whisper), copied from ``repro.configs`` with the same values.

``get_config(name)`` returns the full published config; ``get_smoke_config``
returns the reduced same-family config the CPU tests use.
"""

from __future__ import annotations

import importlib

ARCHS = ["codeqwen15_7b", "deepseek_moe_16b", "kimi_k2_1t_a32b", "llava_next_mistral_7b", "minicpm3_4b",
         "mistral_large_123b", "nbi100m", "recurrentgemma_2b", "rwkv6_7b", "starcoder2_7b", "whisper_small"]

_ALIASES = {
    "codeqwen1.5-7b": "codeqwen15_7b",
    "deepseek-moe-16b": "deepseek_moe_16b",
    "kimi-k2-1t-a32b": "kimi_k2_1t_a32b",
    "llava-next-mistral-7b": "llava_next_mistral_7b",
    "minicpm3-4b": "minicpm3_4b",
    "mistral-large-123b": "mistral_large_123b",
    "nbi-100m": "nbi100m",
    "recurrentgemma-2b": "recurrentgemma_2b",
    "rwkv6-7b": "rwkv6_7b",
    "starcoder2-7b": "starcoder2_7b",
    "whisper-small": "whisper_small",
}


def _module(name: str):
    mod_name = _ALIASES.get(name, name.replace("-", "_").replace(".", ""))
    if mod_name not in ARCHS:
        raise ValueError(f"unknown architecture {name!r}; the port has {ARCHS}")
    return importlib.import_module(f"repro_torch.configs.{mod_name}")


def get_config(name: str):
    return _module(name).config()


def get_smoke_config(name: str):
    return _module(name).smoke_config()
