#!/usr/bin/env python3
"""Time the LSTM forwards of a checkout (the resident one of
mpgcn_tpu_torch/csrc/lstm_fwd.cuh, the wide one of lstm_wide.cuh) in
variants built from copies of their sources, to show what bounds them.

    python3 lstm_fwd_probe.py [--root CHECKOUT] [--group narrow|wide|all]

Variants, each a copy of CHECKOUT's package under smoke_out/probe/ of this
script's directory (gitignored), its kernel source rewritten and built by
its own nvcc:
  base         the checkout's kernels;
  rows8        8 rows a thread in the resident forward, 2 blocks an SM
               (each w_hh fragment serves twice the rows: 0.1875 shared
               wavefronts a warp FMA at H = 32);
  nogate       the resident forward's gate math (expf, tanhf, the
               divisions) replaced by products;
  nofma        the resident forward's recurrent products cut to their
               first 4 k;
  wide-nogate  the same cut of the wide forward's gate math;
  wide-nofma   the wide forward's recurrent product cut to one 16-deep
               slab of each chunk;
  wide-noc     the wide forward's c_{t-1} loads and c_t stores cut (what
               carrying c in device memory costs);
  wide-nowin   the wide forward's h window filled with zeros in place of
               its loads of h_{t-1} from device memory;
  wide-m32     the wide forward on row tiles of 32 rows at every R;
  wide-m48     the same on 48 rows.
The wide variants rewrite the tensor-core kernel of lstm_wide.cuh (PR 14
on). The cut variants give wrong outputs: only their times count. The
narrow group times lstm_infer_last on x_proj and fused from x (F = 1) and
lstm_train_fwd at the N=500 step's shape (R = 500,000, T = 7, H = 32) and
at the N=47 serve shape (R = 17,672); the wide group the same entries and
lstm_infer_collect at the wide model's serve shape (R = 17,672, H = 128),
lstm_train_fwd at its training shape (R = 8,836), and the fused form at
its bucket-1 and bucket-2 serve shapes (R = 2,209 and 4,418). CUDA-event
means over 20 calls after 3, in two rounds in opposite orders, one
process a variant and round. The last line is one JSON object,
{"device": ..., "times": {variant: [round 1, round 2]}}. Needs a CUDA
card; imports nothing of JAX.
"""

import argparse
import json
import os
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join("mpgcn_tpu_torch", "csrc")
#: variant -> (group, source under csrc/, (text, replacement) pairs)
VARIANTS = {
    "base": ("all", "lstm_fwd.cuh", []),
    "rows8": ("narrow", "lstm_fwd.cuh", [
        ("constexpr int kFwdRows = 4;", "constexpr int kFwdRows = 8;"),
        ("constexpr int kFwdMinBlocks = 3;",
         "constexpr int kFwdMinBlocks = 2;")]),
    "nogate": ("narrow", "lstm_fwd.cuh", [
        ("sigmoidf(acc[q][0])", "(acc[q][0] * 0.25f)"),
        ("sigmoidf(acc[q][1])", "(acc[q][1] * 0.25f)"),
        ("tanhf(acc[q][2])", "(acc[q][2] * 0.25f)"),
        ("sigmoidf(acc[q][3])", "(acc[q][3] * 0.25f)"),
        ("__fmul_rn(og, tanhf(c[q]))", "__fmul_rn(og, c[q])")]),
    "nofma": ("narrow", "lstm_fwd.cuh", [
        ("for (; k + 4 <= H; k += 4) {", "for (; k + 4 <= 4; k += 4) {"),
        ("for (; k < H; ++k) {", "for (; k < 0; ++k) {")]),
    "wide-nogate": ("wide", "lstm_wide.cuh", [
        ("sigmoidf(acc[i][0][v])", "(acc[i][0][v] * 0.25f)"),
        ("sigmoidf(acc[i][1][v])", "(acc[i][1][v] * 0.25f)"),
        ("tanhf(acc[i][2][v])", "(acc[i][2][v] * 0.25f)"),
        ("sigmoidf(acc[i][3][v])", "(acc[i][3][v] * 0.25f)"),
        ("__fmul_rn(og, tanhf(cn))", "__fmul_rn(og, cn)")]),
    "wide-nofma": ("wide", "lstm_wide.cuh", [
        ("const int n_ks = (H + kWideSlab - 1) / kWideSlab;",
         "const int n_ks = 1;")]),
    "wide-noc": ("wide", "lstm_wide.cuh", [
        ("r < R && u < H && t > 0 ? c_in[(size_t)r * H + u] : 0.0f;",
         "0.0f;"),
        ("          c_out[o] = cn;\n",
         "          (void)c_in, (void)c_out;\n")]),
    "wide-nowin": ("wide", "lstm_wide.cuh", [
        ("const float4 f = *reinterpret_cast<const float4*>(src);",
         "const float4 f = make_float4(0.0f, 0.0f, 0.0f, 0.0f);")]),
    "wide-m32": ("wide", "lstm_wide.cuh", [
        ("if (R <= 32LL * sms)", "if (true)")]),
    "wide-m48": ("wide", "lstm_wide.cuh", [
        ("if (R <= 32LL * sms)", "if (false)")]),
}
#: (group, T, R, H, entries timed)
SHAPES = [("narrow", 7, 500000, 32, ("last", "fused", "train")),
          ("narrow", 7, 17672, 32, ("last", "fused", "train")),
          ("wide", 7, 17672, 128, ("last", "fused", "collect")),
          ("wide", 7, 8836, 128, ("train",)),
          ("wide", 7, 2209, 128, ("fused",)),
          ("wide", 7, 4418, 128, ("fused",))]


def make_variant(root: str, name: str, dest: str) -> str:
    """Copy root's package to dest/name with the variant's rewrites."""
    out = os.path.join(dest, name)
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(os.path.join(root, "mpgcn_tpu_torch"),
                    os.path.join(out, "mpgcn_tpu_torch"),
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    _, source, rewrites = VARIANTS[name]
    path = os.path.join(out, CSRC, source)
    with open(path) as f:
        src = f.read()
    for old, new in rewrites:
        if old not in src:
            raise RuntimeError(f"variant {name}: {old!r} not in {source}")
        src = src.replace(old, new)
    with open(path, "w") as f:
        f.write(src)
    return out


def run_variant(root: str, build_only: bool, group: str) -> dict:
    """In this process: build root's LSTM kernels, or time them at the
    group's shapes."""
    sys.path.insert(0, root)
    import torch

    from mpgcn_tpu_torch.native import build
    from mpgcn_tpu_torch.nn import cuda_lstm

    if not os.path.abspath(cuda_lstm.__file__).startswith(root + os.sep):
        raise RuntimeError(f"mpgcn_tpu_torch does not come from {root}")
    if build_only:
        for source in ("lstm_infer", "lstm_train"):
            build.load(source)
        return {}
    dev = torch.device("cuda", 0)

    def time_ms(fn, iters=20, warmup=3):
        for _ in range(warmup):
            fn()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters

    times = {}
    for g, T, R, H, entries in SHAPES:
        if group not in ("all", g):
            continue
        gen = torch.Generator(device=dev).manual_seed(R + H)
        xp = torch.randn((T, R, 4 * H), generator=gen, device=dev)
        w = torch.randn((H, 4 * H), generator=gen, device=dev) / H ** 0.5
        x = torch.randn((R, T, 1), generator=gen, device=dev)
        w_ih = torch.randn((4 * H, 1), generator=gen, device=dev) / H ** 0.5
        b = torch.randn((4 * H,), generator=gen, device=dev) / H ** 0.5
        calls = {
            "last": lambda: cuda_lstm.lstm_layer_infer(xp, w, False),
            "fused": lambda: cuda_lstm.lstm_layer_infer_fused(
                x, w_ih, b, w, False),
            "collect": lambda: cuda_lstm.lstm_layer_infer(xp, w, True),
            "train": lambda: cuda_lstm.lstm_layer_train(xp, w)}
        names = {"last": "last x_proj", "fused": "last fused",
                 "collect": "collect x_proj", "train": "train_fwd"}
        for e in entries:
            times[f"R={R} H={H} {names[e]}"] = time_ms(calls[e])
        del xp
        torch.cuda.empty_cache()
    return times


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--group", choices=("narrow", "wide", "all"),
                    default="all")
    ap.add_argument("--variant-root", help=argparse.SUPPRESS)
    ap.add_argument("--build-only", action="store_true",
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.variant_root:
        print(json.dumps(run_variant(args.variant_root, args.build_only,
                                     args.group)))
        return 0
    import torch

    if not torch.cuda.is_available():
        print("lstm_fwd_probe: needs a CUDA card", file=sys.stderr)
        return 2
    dest = os.path.join(HERE, "smoke_out", "probe")
    roots = {n: make_variant(os.path.abspath(args.root), n, dest)
             for n, (g, _, _) in VARIANTS.items()
             if args.group in ("all", g) or g == "all"}

    def child(root, group, *extra):
        return [sys.executable, os.path.abspath(__file__), "--variant-root",
                root, "--group", group, *extra]

    builds = [subprocess.Popen(child(r, args.group, "--build-only"),
                               stdout=subprocess.DEVNULL)
              for r in roots.values()]
    if any([p.wait() != 0 for p in builds]):
        raise RuntimeError("a variant failed to build")
    times = {n: [] for n in roots}
    for order in (list(roots), list(roots)[::-1]):
        for name in order:
            # base times the asked group, a cut variant its own
            group = VARIANTS[name][0]
            out = subprocess.run(
                child(roots[name], args.group if group == "all" else group),
                check=True, capture_output=True, text=True).stdout
            times[name].append(json.loads(out.strip().splitlines()[-1]))
            print(f"[probe] {name}: {json.dumps(times[name][-1])}",
                  flush=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(json.dumps({"device": card, "times": times}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
