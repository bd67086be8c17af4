"""Batched serving driver: prefill a batch of prompts, then decode (the
JAX ``launch/serve.py``).

The inference-time half of the paper's claim: a DiLoCo-trained model
serves exactly like any other, through the model's own prefill and
decode entry points. ``--continuous`` serves through the
continuous-batching engine (``launch/batching.py``: paged KV cache by
default, ``--contiguous-cache`` for per-slot rings);
``--packed-checkpoint`` serves int4 weights written by
``checkpoint.save_packed`` (either package's), which the engine keeps
packed on the device and decodes at every forward.

The weights are random, drawn from a ``torch.Generator`` seeded with
``--seed`` (or restored from ``--checkpoint``), and so are the prompts
(seeded with ``--seed`` + 1) and the stubbed modality input of the VLM
(``patches``) and encoder-decoder (``frames``) families (seeded from
(``--seed``, 2)): none reproduces the JAX server's ``jax.random`` draws.
Those two families serve on the static path only: the engine's requests
are prompts, with no modality input. The server runs on the card unless
``--device cpu`` asks for the CPU; it raises without a GPU otherwise.

Example:
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
      --batch 4 --prompt-len 64 --gen 32
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
      --arch whisper_large_v3 --batch 2 --prompt-len 16 --gen 8
  PYTHONPATH=src python -m repro_torch.launch.serve --full \\
      --arch diloco_400m --continuous --batch 16 --prompt-len 256 --gen 128
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from .. import tree
from ..checkpoint import checkpoint as ckpt
from ..models.registry import get_arch, get_smoke_arch
from .train import resolve_device


def modality_inputs(cfg, batch: int, seed: int, device) -> dict:
    """The stubbed frontend's output of the VLM (``patches``, (B,
    n_patches, D)) and encoder-decoder (``frames``, (B, n_frames, D))
    families, N(0, 0.1²) from a ``torch.Generator`` seeded from (``seed``,
    2); {} for the other families."""
    n = {"vlm": ("patches", cfg.n_patches),
         "encdec": ("frames", cfg.n_frames)}.get(cfg.family)
    if n is None:
        return {}
    ss = np.random.SeedSequence([int(seed) % 2 ** 63, 2])
    gen = torch.Generator(device=device).manual_seed(
        int(ss.generate_state(1, np.uint64)[0]) % 2 ** 63)
    return {n[0]: 0.1 * torch.randn((batch, n[1], cfg.d_model),
                                    generator=gen, device=device)}


@torch.no_grad()
def greedy_decode(arch, params, prompts, *, gen: int, extra=None,
                  temperature: float = 0.0, seed: int = 0):
    """prompts: (B, S) integer (a tensor or numpy); ``extra``: the
    modality input of a cross-attention family (``modality_inputs``).
    Returns the (B, gen) generated tokens, on the params' device. The
    first token comes from the prefill logits under the same policy as
    the rest: argmax at temperature 0, else a draw from a
    ``torch.Generator`` seeded with ``seed``. No step waits for the
    card."""
    dev = tree.leaves(params)[0].device
    prompts = torch.as_tensor(np.asarray(prompts), dtype=torch.int64) \
        .to(dev) if not torch.is_tensor(prompts) else prompts.to(dev)
    B, S = prompts.shape
    logits, cache = arch.prefill(params,
                                 {"tokens": prompts, **(extra or {})},
                                 cache_len=S + gen)
    g = torch.Generator(device=dev)
    g.manual_seed(seed)

    def pick(lg):
        if temperature > 0:
            probs = torch.softmax(lg.float() / temperature, -1)
            return torch.multinomial(probs, 1, generator=g)
        return torch.argmax(lg, -1, keepdim=True)

    tok = pick(logits[:, -1])
    out = [tok]
    for i in range(gen - 1):
        logits, cache = arch.decode(params, cache, tok, S + i)
        tok = pick(logits[:, -1])
        out.append(tok)
    return torch.cat(out, dim=1)


@torch.no_grad()
def forced_logits(arch, params, prompt, tokens):
    """The (n, V) logits from which each of ``tokens`` (n,) was drawn,
    had the request been decoded alone: the prompt prefilled, then the
    given tokens fed back one by one (teacher forcing) — a served
    request's reference (``check.serve_mismatches(..., forced=True)``)."""
    dev = tree.leaves(params)[0].device
    prompt = torch.as_tensor(np.asarray(prompt), dtype=torch.int64,
                             device=dev)[None]
    toks = torch.as_tensor(np.asarray(tokens), dtype=torch.int64,
                           device=dev)
    S, n = prompt.shape[1], toks.shape[0]
    logits, cache = arch.prefill(params, {"tokens": prompt},
                                 cache_len=S + n)
    out = [logits[0, -1]]
    for i in range(n - 1):
        logits, cache = arch.decode(params, cache, toks[i].view(1, 1),
                                    S + i)
        out.append(logits[0, -1])
    return torch.stack(out)


def run(args):
    device = resolve_device(args.device)
    arch = (get_smoke_arch if args.smoke else get_arch)(args.arch)
    cfg = arch.cfg
    gen = torch.Generator(device=device)
    gen.manual_seed(args.seed)
    params = arch.init(generator=gen, device=device)
    packed = None
    if args.packed_checkpoint:
        packed = ckpt.load_packed(args.packed_checkpoint)
        print("loaded packed weights", args.packed_checkpoint,
              f"({packed['manifest']['packed_bytes']} bytes, "
              f"{packed['manifest']['dtype']})")
    elif args.checkpoint:
        params = ckpt.restore(args.checkpoint, {"params": params})["params"]
        print("restored", args.checkpoint)

    B, S = args.batch, args.prompt_len
    gen.manual_seed(args.seed + 1)
    prompts = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                            device=device)
    extra = modality_inputs(cfg, B, args.seed, device)

    t0 = time.time()
    if args.continuous:
        from .batching import ContinuousBatcher
        ps = args.page_size
        clen = S + args.gen
        if not args.contiguous_cache:   # the paged ring must tile exactly
            clen = -(-clen // ps) * ps
        eng = ContinuousBatcher(
            arch, params, slots=B, cache_len=clen,
            temperature=args.temperature, seed=args.seed,
            paged=not args.contiguous_cache, page_size=ps,
            packed_weights=packed, device=device)
        host = prompts.cpu().numpy()
        rids = [eng.submit(host[i], args.gen) for i in range(B)]
        done = eng.run_until_drained()
        toks = np.stack([done[r] for r in rids])
    else:
        if packed is not None:
            params = ckpt.unpack_params(
                {k: torch.from_numpy(v).to(device)
                 for k, v in packed["buffers"].items()},
                packed["manifest"], params)
        toks = greedy_decode(arch, params, prompts, gen=args.gen,
                             extra=extra, temperature=args.temperature,
                             seed=args.seed).cpu().numpy()
    dt = time.time() - t0
    total = B * args.gen
    print(f"arch={args.arch} batch={B} prompt={S} gen={args.gen} "
          f"-> {total} tokens in {dt:.2f}s ({total / dt:.1f} tok/s on "
          f"{device})")
    print("sample tokens[0,:16]:", toks[0, :16])
    return toks


def make_parser():
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.
                                 RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the plain PyTorch "
                         "versions of the kernels")
    ap.add_argument("--arch", default="diloco_150m")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--checkpoint", default="",
                    help="restore params from a --checkpoint npz of the "
                         "trainer (its 'params' subtree)")
    ap.add_argument("--packed-checkpoint", default="",
                    help="int4 packed-weights checkpoint "
                         "(checkpoint.save_packed)")
    ap.add_argument("--continuous", action="store_true",
                    help="serve through the continuous-batching engine "
                         "instead of one static batch")
    ap.add_argument("--contiguous-cache", action="store_true",
                    help="with --continuous: per-slot ring rows instead of "
                         "the paged pool")
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    return ap


if __name__ == "__main__":
    run(make_parser().parse_args())
