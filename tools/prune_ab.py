#!/usr/bin/env python3
"""The sign-prune kernels against variants of themselves on one NVIDIA
GPU, in turns.

    python3 tools/prune_ab.py [variant ...]      (default: all of VARIANTS)

Imports nothing of JAX. Needs the CUDA toolkit's nvcc (as the port's
kernel build does). Builds ``kernels/csrc/sign_prune.cu`` as it is
("base") and with each named variant's text patches applied, all at
once, under ``build/prune_ab/``, and prints each build's registers and
spills (ptxas). Drives every build through its own C entry points, with
the arguments, workspace and chunk that ``kernels/sign_prune.py`` gives
the shipped library (a variant may take another chunk). Holds each
build's output, elected signs and thresholds to the plain version bit
for bit at diloco_150m's leaf shapes (stacked k=2) and on rows holding
NaN, ±inf, one value and zeros; then times one call over the whole
stacked tree, and over its resident-row and long-row leaves apart, every
build in each of ``REPS`` rounds, the order reversed every other round,
and prints the medians, then each build's device time by kernel in one
profiled call. "warp_rows_off" is also timed on resident matrices of 256
to 1024 columns (the warp-row boundary). With "l2_groups" everything
runs on a side stream (the variant sets an access-policy window on it,
and clears it and the L2 set-aside after). Prints the card's name and
power limit first and last.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
OUT = ROOT / "build" / "prune_ab"
REPS = 5
FRAC = 0.5
# The long rows' passes over groups of rows of at most ~30 MB, each group
# held in L2 across its five launches by a persisting access-policy window
# on the stream: replaces the long entry point's last line.
RUN_LONG = "  return (int)run_long(a, (cudaStream_t)stream);\n}"
L2_GROUPS = """  cudaStream_t st = (cudaStream_t)stream;
  int max_persist = 0;
  err = cudaDeviceGetAttribute(&max_persist,
                               cudaDevAttrMaxPersistingL2CacheSize, device);
  if (err != cudaSuccess) return (int)err;
  size_t limit = 31457280;
  if (limit > (size_t)max_persist) limit = (size_t)max_persist;
  if (limit == 0) return (int)cudaErrorNotSupported;
  err = cudaDeviceSetLimit(cudaLimitPersistingL2CacheSize, limit);
  if (err != cudaSuccess) return (int)err;
  auto window = [&](const void* p, size_t bytes) {
    cudaStreamAttrValue v = {};
    v.accessPolicyWindow.base_ptr = const_cast<void*>(p);
    v.accessPolicyWindow.num_bytes = bytes;
    v.accessPolicyWindow.hitRatio =
        bytes ? (bytes <= limit ? 1.0f : (float)limit / (float)bytes) : 0.0f;
    v.accessPolicyWindow.hitProp = cudaAccessPropertyPersisting;
    v.accessPolicyWindow.missProp = cudaAccessPropertyStreaming;
    return cudaStreamSetAttribute(st, cudaStreamAttributeAccessPolicyWindow,
                                  &v);
  };
  const size_t row_bytes = (size_t)cols * sizeof(float);
  long long group = (long long)(limit / row_bytes);
  if (group < 1) group = 1;
  for (long long r0 = 0; r0 < rows && err == cudaSuccess; r0 += group) {
    Long g = a;
    g.rows = rows - r0 < group ? rows - r0 : group;
    g.x = x + r0 * cols;
    g.out = out + r0 * cols;
    g.row_sign = row_sign ? row_sign + r0 : nullptr;
    g.row_hi = row_hi ? row_hi + r0 : nullptr;
    err = window(g.x, (size_t)g.rows * row_bytes);
    if (err == cudaSuccess) err = run_long(g, st);
  }
  const cudaError_t reset = window(x, 0);
  if (err == cudaSuccess) err = reset;
  if (err == cudaSuccess) err = cudaCtxResetPersistingL2Cache();
  if (err == cudaSuccess)
    err = cudaDeviceSetLimit(cudaLimitPersistingL2CacheSize, 0);
  return (int)err;
}"""
# 8,192 bins make 64 KB of resolve state a block, past the 48 KB of dynamic
# shared memory a kernel gets without asking
ALLOW_64K = """  const auto limit = cudaFuncAttributeMaxDynamicSharedMemorySize;
  err = cudaFuncSetAttribute(long_count, limit, (int)RESOLVE_SMEM);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(long_mask, limit, (int)RESOLVE_SMEM);
  if (err != cudaSuccess) return (int)err;
"""
# name: (what the variant changes, [(text in the source, its replacement)],
# entries a long-row block or None for the wrapper's CHUNK)
VARIANTS = {
    "l2_groups": ("the long rows' five passes over groups of rows of ~30 "
                  "MB, each held in L2 by a persisting access-policy "
                  "window", [(RUN_LONG, L2_GROUPS)], None),
    "levels_13_13": ("two count passes of 13 levels (8,192 bins) instead "
                     "of 9, 9, 8, also in the block rows",
                     [("constexpr int PASSES = 3;",
                       "constexpr int PASSES = 2;"),
                      ("constexpr int NB = 512;", "constexpr int NB = 8192;"),
                      ("return pass + 1 < PASSES ? 9 : 8;", "return 13;"),
                      (RUN_LONG, ALLOW_64K + RUN_LONG)], None),
    "search": ("bins by a b-step search of the table, never by the index "
               "estimate",
               [("if (isfinite(w) && w > hi * 0x1p-10f && w > 0x1p-100f) {",
                 "if (false) {")], None),
    "warp_rows_off": ("no warp rows: every resident row a block",
                      [("if (cols <= WARP_MAX_COLS) {", "if (false) {")],
                      None),
    "chunk_16k": ("16,384 entries a long-row block instead of 32,768", [],
                  16384),
    "chunk_64k": ("65,536 entries a long-row block instead of 32,768", [],
                  65536),
}
BOUNDARY_COLS = (256, 512, 896, 1024)
BOUNDARY_ENTRIES = 57_344_000          # the stacked embedding's entries


def source(name: str, base: str) -> str:
    text = base
    for old, new in ([] if name == "base" else VARIANTS[name][1]):
        if text.count(old) != 1:
            raise SystemExit(f"variant {name}: {old!r} is not once in the "
                             f"source")
        text = text.replace(old, new)
    return text


def build_all(names, build):
    """{name: ctypes library}, one nvcc per source, all started together
    (a variant without patches loads the base build); prints each one's
    ptxas lines."""
    OUT.mkdir(parents=True, exist_ok=True)
    base = (build.CSRC / "sign_prune.cu").read_text()
    procs = {}
    for n in names:
        if n != "base" and not VARIANTS[n][1]:
            continue
        cu, so = OUT / f"{n}.cu", OUT / f"{n}.so"
        cu.write_text(source(n, base))
        procs[n] = (so, subprocess.Popen(
            [build.nvcc(), *build.flags("sign_prune"), "-o", str(so),
             str(cu)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    libs = {}
    for n, (so, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"build {n} failed:\n{out}")
        lines = out.splitlines()
        for i, line in enumerate(lines):
            if "Compiling entry" in line:
                kernel = line.split("'")[1] if "'" in line else line
                print(json.dumps({"build": n, "kernel": kernel,
                                  "ptxas": " | ".join(
                                      l.strip() for l in lines[i + 2:i + 4])}),
                      flush=True)
        libs[n] = ctypes.CDLL(str(so))
    return {n: libs.get(n, libs["base"]) for n in names}


class Build:
    """One build's C entry points, called as ``kernels/sign_prune.py``
    calls the shipped library's, with ``chunk`` entries a long-row
    block."""

    def __init__(self, lib, chunk):
        head = [ctypes.c_void_p] * 2 + [ctypes.c_longlong] * 3 \
            + [ctypes.c_float] * 2
        tail = [ctypes.c_void_p] * 2 + [ctypes.c_int, ctypes.c_void_p]
        self.resident = lib.repro_sign_prune_resident_f32
        self.resident.argtypes = head + tail
        self.long = lib.repro_sign_prune_long_f32
        self.long.argtypes = head + [ctypes.c_longlong,
                                     ctypes.c_void_p] + tail
        self.workspace = lib.repro_sign_prune_long_workspace
        self.workspace.restype = ctypes.c_longlong
        self.workspace.argtypes = [ctypes.c_longlong] * 3
        self.chunk = chunk

    def prune(self, x, frac, out=None, sign=None, hi=None):
        """Prune (R, C) float32 ``x`` into ``out`` (default: in place);
        ``sign``/``hi`` (R,) receive each row's elected sign and
        threshold."""
        import torch
        from repro_torch.kernels import ref
        from repro_torch.kernels import sign_prune as SP
        out = x if out is None else out
        R, C = x.shape
        dev = x.device
        common = (x.data_ptr(), out.data_ptr(), R, C, ref.keep_count(frac, C),
                  ref.HI_SCALE, ref.HI_FLOOR)
        rows = (None, None) if sign is None else (sign.data_ptr(),
                                                  hi.data_ptr())
        tail = (dev.index or 0, torch.cuda.current_stream(dev).cuda_stream)
        if C <= SP.RESIDENT_MAX_COLS:
            err = self.resident(*common, *rows, *tail)
        else:
            work = torch.empty(self.workspace(R, C, self.chunk),
                               dtype=torch.uint8, device=dev)
            err = self.long(*common, self.chunk, work.data_ptr(), *rows,
                            *tail)
        if err:
            raise RuntimeError(f"sign_prune variant: CUDA error {err}")

    def parts(self, x, frac):
        import torch
        R = x.shape[0]
        out = torch.empty_like(x)
        sign = torch.empty(R, dtype=torch.float32, device=x.device)
        hi = torch.empty(R, dtype=torch.float32, device=x.device)
        self.prune(x, frac, out, sign, hi)
        return sign[:, None], hi[:, None], out

    def tree(self, part, frac):
        """Prune every leaf of ``part`` (stacked) in place, as
        ``ops.sign_prune_tree(part, frac, stacked=True)`` does."""
        from repro_torch.kernels import ops
        for d in part.values():
            self.prune(ops.as_rows(d, 1), frac)


def same_bits(torch, a, b):
    return bool(((a.view(torch.int32) == b.view(torch.int32))
                 | (a.isnan() & b.isnan())).all())


def check(torch, name, build, cases):
    """Raise unless this build gives the plain version's bits on every
    (matrix, frac, plain parts) of ``cases``."""
    for x, frac, (wsign, whi, wout) in cases:
        sign, hi, out = build.parts(x, frac)
        torch.cuda.synchronize()
        if not (torch.equal(sign, wsign) and same_bits(torch, hi, whi)
                and same_bits(torch, out, wout)):
            raise SystemExit(f"{name} differs from the plain version on "
                             f"{tuple(x.shape)} at frac {frac}")
        del sign, hi, out


def profile(torch, name, run, setup):
    """Device ms of one ``run()`` (after ``setup()``) by kernel: each
    kernel's total, and the long rows' count passes apart (they launch in
    pass order per leaf)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as prof_
    setup()
    run()
    setup()
    torch.cuda.synchronize()
    with prof_(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA
               and ("prune" in e.name or "long_" in e.name)]
    total, passes = {}, {}
    counts = 0
    for e in sorted(kernels, key=lambda e: e.time_range.start):
        key = e.name.replace("(anonymous namespace)::", "").split("(")[0]
        ms = e.time_range.elapsed_us() / 1e3
        total[key] = total.get(key, 0.0) + ms
        if "long_count" in key:
            passes[counts] = passes.get(counts, 0.0) + ms
            counts += 1
        elif "long_mask" in key:
            counts = 0
    print(json.dumps({"build": name, "profile_ms": total,
                      "long_count_ms_by_pass": passes,
                      "device_ms": sum(total.values())}), flush=True)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("prune_ab: no CUDA device is visible", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as CS
    from repro_torch import tree
    from repro_torch.kernels import build, ops, ref
    from repro_torch.kernels import sign_prune as SP
    from repro_torch.models.registry import get_arch

    names = ["base"] + (sys.argv[1:] or list(VARIANTS))
    print(CS.card_line(), flush=True)
    builds = {n: Build(lib, (VARIANTS[n][2] if n in VARIANTS else None)
                       or SP.CHUNK)
              for n, lib in build_all(names, build).items()}
    dev = torch.device("cuda")
    # the L2 variant sets its window on a stream of its own: then every
    # build runs there
    side = torch.cuda.Stream(dev) if "l2_groups" in names else \
        torch.cuda.current_stream(dev)
    gen = torch.Generator(device=dev).manual_seed(19)
    shapes = [tuple(t.shape) for t in tree.leaves(
        get_arch("diloco_150m").init(generator=None, device="meta"))]
    with torch.cuda.stream(side):
        D0 = {f"{i:02d}": torch.randn((CS.K,) + sh, generator=gen,
                                      device=dev)
              for i, sh in enumerate(shapes)}
        D = {k: t.clone() for k, t in D0.items()}
        adv = torch.randn(8, 60001, generator=gen, device=dev)
        adv[0, 7], adv[1, 3], adv[1, 9] = (float("nan"), float("inf"),
                                           float("-inf"))
        adv[2], adv[3] = 0.37, 0.0
        mats = [ops.as_rows(d, 1) for d in D0.values()] + [
            adv, adv[:, :4000].contiguous(), adv[:, :896].contiguous()]
        cases = [(x, frac, ref.sign_prune_parts(x, frac)) for x in mats
                 for frac in (FRAC, 0.9999)]
        for n, b in builds.items():
            check(torch, n, b, cases)
            print(json.dumps({"build": n, "bitwise": True,
                              "cases": len(cases)}), flush=True)
        del cases
        fresh = lambda: [d.copy_(d0) for d, d0 in zip(D.values(),
                                                      D0.values())]
        parts = {"tree": D}
        for regime in ("resident", "long"):
            parts[regime] = {k: d for k, d in D.items()
                             if (ops.as_rows(d, 1).shape[1]
                                 <= SP.RESIDENT_MAX_COLS)
                             == (regime == "resident")}
        bound = {p: sum(d.numel() for d in part.values()) * CS.PRUNE_BYTES
                 for p, part in parts.items()}
        times = {n: {p: [] for p in parts} for n in names}
        for r in range(REPS):
            for n in (names if r % 2 == 0 else names[::-1]):
                for p, part in parts.items():
                    times[n][p].append(CS.time_ms(
                        torch, lambda: builds[n].tree(part, FRAC),
                        setup=fresh))
        bw = CS.bandwidth(torch.cuda.get_device_name(0))
        for n in names:
            med = {p: sorted(ts)[REPS // 2] for p, ts in times[n].items()}
            print(json.dumps({
                "build": n, "changes": VARIANTS[n][0] if n in VARIANTS
                else None, "ms": times[n], "median_ms": med,
                "GBps": {p: bound[p] / med[p] / 1e6 for p in med},
                "bound_ms": {p: bound[p] / bw * 1e3 for p in med}}),
                flush=True)
        for n in names:
            profile(torch, n, lambda: builds[n].tree(D, FRAC), fresh)
        if "warp_rows_off" in names:
            # the warp-row boundary: resident matrices of the embedding's
            # size at narrower and wider rows, warp rows against block rows
            for cols in BOUNDARY_COLS:
                x0 = torch.randn(BOUNDARY_ENTRIES // cols, cols,
                                 generator=gen, device=dev)
                x = x0.clone()
                ms = {n: [] for n in ("base", "warp_rows_off")}
                for r in range(REPS):
                    for n in (list(ms) if r % 2 == 0 else list(ms)[::-1]):
                        ms[n].append(CS.time_ms(
                            torch, lambda: builds[n].prune(x, FRAC),
                            setup=lambda: x.copy_(x0)))
                print(json.dumps({
                    "boundary_cols": cols, "rows": x.shape[0],
                    "median_ms": {n: sorted(t)[REPS // 2]
                                  for n, t in ms.items()}}), flush=True)
                del x, x0
    print(CS.card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
