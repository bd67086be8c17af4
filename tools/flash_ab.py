#!/usr/bin/env python3
"""The flash-attention kernels against variants of themselves on one NVIDIA
GPU, in turns.

    python3 tools/flash_ab.py [variant ...]      (default: all of VARIANTS)
    python3 tools/flash_ab.py --bf16 [--parent FILE] [variant ...]
                                                 (BF16_VARIANTS)

Imports nothing of JAX. Needs the CUDA toolkit's nvcc (as the port's
kernel build does). Builds ``kernels/csrc/flash_attention.cu`` as it is
("base") and with each named text patch of ``VARIANTS`` applied, all at
once, under ``build/flash_ab/``; prints each build's registers and spills
of the two backward kernels (ptxas); holds each build's dq, dk and dv to
the plain versions (5e-4·(1 + |want|)) on three cases; then times dq and
dk/dv at diloco_400m's layer (B 8, H = G = 12, S 1024, d 128, causal),
every build in each of ``REPS`` rounds, the order reversed every other
round, and prints the medians beside SDPA's backward. With ``--bf16`` the
same for the three bf16 kernels, the forward (with lse), dq and dk/dv:
their ptxas lines at d 64 and 128 (and any wgmma serialization ptxas
reports), o, lse, dq, dk and dv held to the plain versions on bf16
operands (rtol 2^-7 with atol 2e-5, 2e-5 on lse, 5e-4 on dq, dk and dv),
and each timed by one call (``time_ms``) and by a burst of calls back to
back (``burst_ms``, the device's time) beside SDPA's bf16 forward and
backward, with dq + dk/dv by burst beside SDPA's backward. ``--parent
FILE`` adds a build of another ``flash_attention.cu`` (an earlier
commit's, unpacked with ``git archive``) as "parent", timed in the same
turns, and compares each kernel's SASS (``cuobjdump -sass``) in the two
builds, instruction for instruction. Prints the card's name and power
limit first and last.
"""
from __future__ import annotations

import ctypes
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
OUT = ROOT / "build" / "flash_ab"
REPS = 5
# name: (what the variant undoes, [(text in the source, its replacement)])
VARIANTS = {
    "rna_small": ("the backward's small part rounded to the nearest tf32 "
                  "(the forward's Split) instead of truncated by the MMA",
                  [("small[i] = __float_as_uint(x[i] - __uint_as_float("
                    "big[i]));",
                    "small[i] = tf32_rna(x[i] - __uint_as_float(big[i]));")]),
    "unrolled_score": ("the score products' loop over pairs of 16-wide "
                       "slices of d unrolled",
                       [("#pragma unroll 1\n  for (int k2",
                         "#pragma unroll\n  for (int k2")]),
    "expf": ("p = expf(s - lse) instead of __expf",
             [("__expf(", "expf(")]),
}
CASES = [(8, 12, 12, 1024, 128, True, 0), (2, 8, 2, 700, 128, True, 200),
         (1, 4, 2, (461, 777), 64, False, 0)]
BF16_VARIANTS = {
    "divergent_warp": ("the warp index read from threadIdx.x as it is, "
                       "without the broadcast that shows the compiler it "
                       "is warp-uniform",
                       [("const int warp = __shfl_sync(0xffffffffu, "
                         "threadIdx.x / 32, 0);",
                         "const int warp = threadIdx.x / 32;")]),
    "expf": ("the forward's p = expf(s - m) instead of 2^((s - m) log2 e) "
             "on ex2.approx",
             [("ex2((m[i] - mx) * LOG2E)", "expf(m[i] - mx)"),
              ("ex2((s[4 * j + e] - mx) * LOG2E)",
               "expf(s[4 * j + e] - mx)")]),
}
BF16_KERNELS = ("flash_fwd_bf16_kernel", "flash_dq_bf16_kernel",
                "flash_dkv_bf16_kernel")


def source(name: str, base: str, variants=VARIANTS) -> str:
    text = base
    for old, new in ([] if name in ("base", "parent")
                     else variants[name][1]):
        if old not in text:
            raise SystemExit(f"variant {name}: {old!r} is not in the source")
        text = text.replace(old, new)
    return text


def build_all(names, build, variants=VARIANTS,
              kernels=("flash_dq_kernel", "flash_dkv_kernel"), parent=None):
    """{name: ctypes library}, one nvcc per build, all started together
    ("parent" builds the file ``parent``); prints each one's ptxas lines
    for ``kernels`` (every instantiation: d 64 and 128) and the
    serializations of wgmma that ptxas reports."""
    OUT.mkdir(parents=True, exist_ok=True)
    base = (build.CSRC / "flash_attention.cu").read_text()
    procs = {}
    for n in names:
        cu, so = OUT / f"{n}.cu", OUT / f"{n}.so"
        cu.write_text(Path(parent).read_text() if n == "parent"
                      else source(n, base, variants))
        procs[n] = (so, subprocess.Popen(
            [build.nvcc(), *build.flags("flash_attention"), "-o", str(so),
             str(cu)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    libs = {}
    for n, (so, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"build {n} failed:\n{out}")
        lines = out.splitlines()
        for i, line in enumerate(lines):
            if "serialized" in line:
                print(json.dumps({"build": n, "ptxas": line.strip()}),
                      flush=True)
            for kernel in kernels:
                m = re.search(rf"\d{kernel}I(?:[a-z]*)Li(\d+)E(\S*)'",
                              line) if "Compiling entry" in line else None
                if m:
                    print(json.dumps({"build": n, "kernel": kernel,
                                      "d": int(m.group(1)),
                                      "lse": "Lb1" in m.group(2) or None,
                                      "ptxas": " | ".join(
                                          l.strip() for l in
                                          lines[i + 2:i + 4])}), flush=True)
        libs[n] = ctypes.CDLL(str(so))
    return libs


def sass(so: Path) -> dict:
    """{kernel: [instructions]} of a built library (``cuobjdump -sass``):
    each kernel keyed by its name, head dim and lse flag, and "bf16," for
    a kernel templated on a bf16 element type (so that a float kernel
    that lost its type parameter keeps its key); each instruction without
    its address and encoding."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    out = subprocess.run([tool, "-sass", str(so)], capture_output=True,
                         text=True, check=True).stdout
    funcs, cur = {}, None
    for line in out.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            k = re.search(r"(flash_\w+?_kernel)I(f|13__nv_bfloat16)?"
                          r"Li(\d+)E(Lb1)?", m.group(1))
            cur = m.group(1) if k is None else "{}<{}{}{}>".format(
                k.group(1), "bf16," if k.group(2) == "13__nv_bfloat16"
                else "", k.group(3), ",lse" if k.group(4) else "")
            funcs[cur] = []
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s*(.*?)\s*;?\s*(/\*.*)?$",
                     line)
        if cur and m and m.group(1):
            funcs[cur].append(m.group(1))
    return funcs


def compare_sass(base: Path, parent: Path) -> None:
    """Print, for each kernel of either build, whether its SASS is the
    same instruction for instruction."""
    a, b = sass(base), sass(parent)
    for f in sorted(set(a) | set(b)):
        same = a.get(f) == b.get(f)
        print(json.dumps({"sass": f, "base": len(a.get(f, [])),
                          "parent": len(b.get(f, [])), "same": same}),
              flush=True)


def entry_points(lib, dtype, names=("bwd_dq", "bwd_dkv")):
    """The library's entry points for ``dtype`` operands, keyed as the
    wrapper's cache (``flash_attention._fns``) keys them."""
    from repro_torch.kernels import flash_attention as FK
    fns = {}
    for name in names:
        fn = getattr(lib, f"repro_flash_{name}_{FK.DTYPES[dtype]}")
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 6
                       + [ctypes.c_float] + [ctypes.c_int] * 4
                       + [ctypes.c_void_p])
        fns[(name, dtype)] = fn
    return fns


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("flash_ab: no CUDA device is visible", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as CS
    from repro_torch.kernels import build, ref
    from repro_torch.kernels import flash_attention as FK

    if sys.argv[1:2] == ["--bf16"]:
        args, parent = sys.argv[2:], None
        if args[:1] == ["--parent"]:
            parent, args = args[1], args[2:]
        return main_bf16(torch, CS, args, parent)
    names = ["base"] + (sys.argv[1:] or list(VARIANTS))
    torch.backends.cuda.matmul.allow_tf32 = False
    print(CS.card_line(), flush=True)
    fns = {n: entry_points(lib, torch.float32)
           for n, lib in build_all(names, build).items()}
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2)
    for case in CASES:
        B, H, G, S, d, causal, window = case
        Sq, Sk = S if isinstance(S, tuple) else (S, S)
        q, k, v, do = (torch.randn(shape, generator=gen, device=dev)
                       for shape in ((B, H, Sq, d), (B, G, Sk, d),
                                     (B, G, Sk, d), (B, H, Sq, d)))
        opts = dict(causal=causal, window=window)
        o, lse = FK.flash_fwd_lse(q, k, v, **opts)
        delta = (do * o).sum(-1).contiguous()
        want = (ref.flash_bwd_dq(q, k, v, lse, do, delta, **opts),
                *ref.flash_bwd_dkv(q, k, v, lse, do, delta, **opts))
        dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
        launch = dict(do=do, lse=lse, delta=delta, scale=d ** -0.5,
                      q_offset=0, **opts)
        run = {"bwd_dq": lambda: FK._launch("bwd_dq", q, k, v, out=dq,
                                            **launch),
               "bwd_dkv": lambda: FK._launch("bwd_dkv", q, k, v, out=None,
                                             dk=dk, dv=dv, **launch)}
        for n in names:
            FK._fns.update(fns[n])
            run["bwd_dq"]()
            run["bwd_dkv"]()
            torch.cuda.synchronize()
            err = max(float(((g - w).abs() / (1 + w.abs())).max())
                      for g, w in zip((dq, dk, dv), want))
            if err > 5e-4:
                raise SystemExit(f"{n} differs from the plain version on "
                                 f"{case}: {err}")
            print(json.dumps({"build": n, "case": case,
                              "max_rel_err": err}), flush=True)
        if case != CASES[0]:
            continue
        times = {n: {k_: [] for k_ in run} for n in names}
        for r in range(REPS):
            for n in (names if r % 2 == 0 else names[::-1]):
                FK._fns.update(fns[n])
                for k_, fn in run.items():
                    times[n][k_].append(CS.time_ms(torch, fn))
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        out = torch.nn.functional.scaled_dot_product_attention(
            *leaves, is_causal=causal)
        sdpa_bwd = CS.time_ms(torch, lambda: torch.autograd.grad(
            out, leaves, do, retain_graph=True))
        for n in names:
            med = {k_: sorted(ts)[REPS // 2] for k_, ts in times[n].items()}
            print(json.dumps({"build": n, "undoes": VARIANTS[n][0]
                              if n in VARIANTS else None,
                              "ms": times[n], "median_ms": med,
                              "pair_ms": sum(med.values()),
                              "sdpa_bwd_ms": sdpa_bwd}), flush=True)
        FK._fns.clear()
    print(CS.card_line(), flush=True)
    return 0


def main_bf16(torch, CS, args, parent=None) -> int:
    """``--bf16``: the bf16 forward (with lse), dq and dk/dv kernels
    against ``BF16_VARIANTS`` and, given ``parent``, another source's
    build."""
    from repro_torch.kernels import build, ref
    from repro_torch.kernels import flash_attention as FK

    names = (["base"] + (["parent"] if parent else [])
             + (args or list(BF16_VARIANTS)))
    bf16 = torch.bfloat16
    print(CS.card_line(), flush=True)
    fns = {n: entry_points(lib, bf16, ("fwd_lse", "bwd_dq", "bwd_dkv"))
           for n, lib in build_all(names, build, BF16_VARIANTS,
                                   BF16_KERNELS, parent).items()}
    if parent:
        compare_sass(OUT / "base.so", OUT / "parent.so")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2)

    def outside(got, want, atol, rtol=CS.BF16_RTOL):
        got, want = got.float(), want.float()
        return float(((got - want).abs() - atol - rtol * want.abs()).max())
    for case in CASES:
        B, H, G, S, d, causal, window = case
        Sq, Sk = S if isinstance(S, tuple) else (S, S)
        q, k, v, do = (torch.randn(shape, generator=gen, device=dev).to(bf16)
                       for shape in ((B, H, Sq, d), (B, G, Sk, d),
                                     (B, G, Sk, d), (B, H, Sq, d)))
        opts = dict(causal=causal, window=window)
        want_o, want_lse = ref.flash_fwd_lse(q, k, v, **opts)
        delta = (do.float() * want_o.float()).sum(-1).contiguous()
        want_dq = ref.flash_bwd_dq(q, k, v, want_lse, do, delta, **opts)
        want = ref.flash_bwd_dkv(q, k, v, want_lse, do, delta, **opts)
        o, dq, dk, dv = (torch.empty_like(t) for t in (q, q, k, v))
        lse = torch.empty_like(want_lse)
        launch = dict(scale=d ** -0.5, q_offset=0, **opts)
        bwd = dict(do=do, lse=want_lse, delta=delta, **launch)
        run = {"fwd_lse": lambda: FK._launch("fwd_lse", q, k, v, out=o,
                                             lse_out=lse, **launch),
               "bwd_dq": lambda: FK._launch("bwd_dq", q, k, v, out=dq,
                                            **bwd),
               "bwd_dkv": lambda: FK._launch(
                   "bwd_dkv", q, k, v, out=None, dk=dk, dv=dv, **bwd)}
        for n in names:
            FK._fns.update(fns[n])
            for fn in run.values():
                fn()
            torch.cuda.synchronize()
            err = {"o": outside(o, want_o, CS.FWD_TOL),
                   "lse": outside(lse, want_lse, CS.FWD_TOL, CS.FWD_TOL),
                   "dq": outside(dq, want_dq, CS.BWD_TOL),
                   "dk": outside(dk, want[0], CS.BWD_TOL),
                   "dv": outside(dv, want[1], CS.BWD_TOL)}
            if max(err.values()) > 0:
                raise SystemExit(f"{n} differs from the plain version on "
                                 f"{case}: {err}")
            print(json.dumps({"build": n, "case": case,
                              "outside_bound": err}), flush=True)
        if case != CASES[0]:
            continue
        times = {n: {f"{k_}_{how}": [] for k_ in run
                     for how in ("ms", "burst_ms")} for n in names}
        for r in range(REPS):
            for n in (names if r % 2 == 0 else names[::-1]):
                FK._fns.update(fns[n])
                for k_, fn in run.items():
                    times[n][f"{k_}_ms"].append(CS.time_ms(torch, fn))
                    times[n][f"{k_}_burst_ms"].append(CS.burst_ms(torch, fn))
        sdpa = torch.nn.functional.scaled_dot_product_attention
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        out = sdpa(*leaves, is_causal=causal)
        lib = {"sdpa_fwd_ms": CS.time_ms(torch, lambda: sdpa(
                   q, k, v, is_causal=causal)),
               "sdpa_fwd_burst_ms": CS.burst_ms(torch, lambda: sdpa(
                   q, k, v, is_causal=causal)),
               "sdpa_bwd_ms": CS.time_ms(torch, lambda: torch.autograd.grad(
                   out, leaves, do, retain_graph=True)),
               "sdpa_bwd_burst_ms": CS.burst_ms(
                   torch, lambda: torch.autograd.grad(
                       out, leaves, do, retain_graph=True))}
        for n in names:
            med = {k_: sorted(ts)[REPS // 2] for k_, ts in times[n].items()}
            print(json.dumps({"build": n, "undoes": BF16_VARIANTS[n][0]
                              if n in BF16_VARIANTS else None,
                              "ms": times[n], "median_ms": med,
                              "bwd_burst_ms": med["bwd_dq_burst_ms"]
                              + med["bwd_dkv_burst_ms"], **lib}),
                  flush=True)
        FK._fns.clear()
    print(CS.card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
