"""Architecture registry for the ported configs: ``get_arch(name)`` ->
``Arch`` with ``init``, ``loss``, ``prefill`` and ``decode`` entry
points."""
from __future__ import annotations

import importlib
from dataclasses import dataclass

from ..configs.base import ModelConfig
from . import model as M

ARCH_NAMES = ["diloco_60m", "diloco_150m", "diloco_400m"]


@dataclass
class Arch:
    cfg: ModelConfig

    def init(self, *, generator, device, cfg=None):
        """Random params (a plain dict tree) on ``device``."""
        return M.init_params(cfg or self.cfg, generator=generator,
                             device=device)

    def loss(self, params, batch, *, cfg=None):
        return M.loss_fn(params, cfg or self.cfg, batch)

    def prefill(self, params, batch, *, cfg=None, cache_len: int = 0):
        """(logits, cache) of the prompt ``batch["tokens"]``; the other
        families' extra inputs are not ported."""
        cfg = cfg or self.cfg
        extra = sorted(k for k in batch if k != "tokens")
        if extra:
            raise NotImplementedError(
                f"serving inputs {extra} belong to other model families "
                "(ROADMAP.md, port queue: other families)")
        return M.prefill(params, cfg, batch["tokens"], window=cfg.window,
                         cache_len=cache_len)

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
        raise NotImplementedError(
            f"architecture {name!r} is not ported; the port has "
            f"{ARCH_NAMES} (ROADMAP.md, port queue: other families)")
    return importlib.import_module(f"repro_torch.configs.{name}")


def get_arch(name: str) -> Arch:
    return Arch(cfg=_module(name).config())


def get_smoke_arch(name: str) -> Arch:
    return Arch(cfg=_module(name).smoke_config())
