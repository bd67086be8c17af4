"""Architecture registry: ``get_arch(name)`` -> ``Arch`` with ``init``,
``loss``, ``prefill`` and ``decode`` entry points, over every config of
the JAX registry."""
from __future__ import annotations

import importlib
from dataclasses import dataclass

from ..configs.base import ModelConfig
from . import model as M

ARCH_NAMES = [
    "whisper_large_v3", "deepseek_v2_lite_16b", "starcoder2_7b",
    "llama_3_2_vision_90b", "stablelm_1_6b", "olmoe_1b_7b", "qwen3_32b",
    "zamba2_2_7b", "command_r_35b", "xlstm_350m",
    # the paper's own Chinchilla-style models
    "diloco_60m", "diloco_150m", "diloco_400m",
]


@dataclass
class Arch:
    cfg: ModelConfig

    def init(self, *, generator, device, cfg=None):
        """Random params (a plain dict tree) on ``device``."""
        return M.init_params(cfg or self.cfg, generator=generator,
                             device=device)

    def loss(self, params, batch, *, cfg=None, groups: int = 1):
        return M.loss_fn(params, cfg or self.cfg, batch, groups=groups)

    def prefill(self, params, batch, *, cfg=None, cache_len: int = 0):
        """(logits, cache) of the prompt ``batch["tokens"]``; the batch's
        other entries (``patches``, ``frames``) are the modality input."""
        cfg = cfg or self.cfg
        extra = {k: v for k, v in batch.items() if k != "tokens"}
        return M.prefill(params, cfg, batch["tokens"], extra=extra or None,
                         window=cfg.window, cache_len=cache_len)

    def decode(self, params, cache, tokens, pos, *, cfg=None,
               page_table=None):
        """(logits, cache) of one decode step at absolute position
        ``pos``; the cache is written in place."""
        cfg = cfg or self.cfg
        return M.decode_step(params, cfg, cache, tokens, pos,
                             window=cfg.window, page_table=page_table)


def _module(name: str):
    name = name.replace("-", "_").replace(".", "_")
    if name not in ARCH_NAMES:
        raise ValueError(f"unknown architecture {name!r}; the registry has "
                         f"{ARCH_NAMES}")
    return importlib.import_module(f"repro_torch.configs.{name}")


def get_arch(name: str) -> Arch:
    return Arch(cfg=_module(name).config())


def get_smoke_arch(name: str) -> Arch:
    return Arch(cfg=_module(name).smoke_config())
