"""Architecture registry: ``get_arch(name)`` -> ``Arch`` with ``init``,
``loss``, ``prefill`` and ``decode`` entry points, over every config of
the JAX registry, plus ``shape_cfg``, ``input_specs``, ``cache_specs`` and
``abstract_params``: meta-tensor stand-ins for the dry run
(``launch/dryrun.py``), which allocate nothing."""
from __future__ import annotations

import importlib
from dataclasses import dataclass

import torch

from ..configs.base import LONG_CONTEXT_WINDOW, ModelConfig, ShapeConfig
from . import model as M

ARCH_NAMES = [
    "whisper_large_v3", "deepseek_v2_lite_16b", "starcoder2_7b",
    "llama_3_2_vision_90b", "stablelm_1_6b", "olmoe_1b_7b", "qwen3_32b",
    "zamba2_2_7b", "command_r_35b", "xlstm_350m",
    # the paper's own Chinchilla-style models
    "diloco_60m", "diloco_150m", "diloco_400m",
]

# families with full self-attention that need a sliding window at 500k ctx
_ATTN_FAMILIES = ("dense", "moe", "vlm", "encdec", "hybrid")
META = torch.device("meta")


@dataclass
class Arch:
    cfg: ModelConfig

    def shape_cfg(self, shape: ShapeConfig) -> ModelConfig:
        """Per-shape config: long-context decode on attention archs flips
        on sliding-window attention (sub-quadratic carve-out)."""
        cfg = self.cfg
        if (shape.kind == "decode" and shape.seq_len > 65_536
                and cfg.family in _ATTN_FAMILIES and not cfg.window):
            cfg = cfg.replace(window=LONG_CONTEXT_WINDOW)
        return cfg

    def init(self, *, generator, device, cfg=None):
        """Random params (a plain dict tree) on ``device``."""
        return M.init_params(cfg or self.cfg, generator=generator,
                             device=device)

    def loss(self, params, batch, *, cfg=None, groups: int = 1):
        return M.loss_fn(params, cfg or self.cfg, batch, groups=groups)

    def prefill(self, params, batch, *, cfg=None, cache_len: int = 0,
                groups: int = 1):
        """(logits, cache) of the prompt ``batch["tokens"]``; the batch's
        other entries (``patches``, ``frames``) are the modality input."""
        cfg = cfg or self.cfg
        extra = {k: v for k, v in batch.items() if k != "tokens"}
        return M.prefill(params, cfg, batch["tokens"], extra=extra or None,
                         window=cfg.window, cache_len=cache_len,
                         groups=groups)

    def decode(self, params, cache, tokens, pos, *, cfg=None,
               page_table=None, groups: int = 1):
        """(logits, cache) of one decode step at absolute position
        ``pos``; the cache is written in place."""
        cfg = cfg or self.cfg
        return M.decode_step(params, cfg, cache, tokens, pos,
                             window=cfg.window, page_table=page_table,
                             groups=groups)

    # ---- meta stand-ins for the dry run ----
    def input_specs(self, shape: ShapeConfig, *, batch_override: int = 0,
                    dtype=torch.float32) -> dict:
        """The batch of ``shape`` as meta tensors: int32 ``tokens`` (B, S),
        (B, 1) at decode, plus the VLM's ``patches`` or the
        encoder-decoder's ``frames`` outside decode."""
        cfg = self.shape_cfg(shape)
        B = batch_override or shape.global_batch
        S = 1 if shape.kind == "decode" else shape.seq_len
        out = {"tokens": torch.empty((B, S), dtype=torch.int32, device=META)}
        if cfg.family == "vlm" and shape.kind != "decode":
            out["patches"] = torch.empty((B, cfg.n_patches, cfg.d_model),
                                         dtype=dtype, device=META)
        if cfg.family == "encdec" and shape.kind != "decode":
            out["frames"] = torch.empty((B, cfg.n_frames, cfg.d_model),
                                        dtype=dtype, device=META)
        return out

    def cache_specs(self, shape: ShapeConfig, *, batch_override: int = 0,
                    dtype=torch.float32):
        """The decode cache of ``shape`` (``init_cache``) on meta."""
        cfg = self.shape_cfg(shape)
        B = batch_override or shape.global_batch
        return M.init_cache(cfg, B, shape.seq_len, dtype, device=META,
                            window=cfg.window)

    def abstract_params(self, cfg=None):
        """(meta parameter tree, logical-axes tree with the same keys),
        allocating nothing."""
        cfg = cfg or self.cfg
        return (M.init_params(cfg, generator=None, device=META),
                M.param_axes(cfg))


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
