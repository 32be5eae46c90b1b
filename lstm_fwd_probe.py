#!/usr/bin/env python3
"""Time the resident LSTM forward (mpgcn_tpu_torch/csrc/lstm_fwd.cuh) of a
checkout in variants built from copies of its sources, to show what bounds
it.

    python3 lstm_fwd_probe.py [--root CHECKOUT]

Variants, each a copy of CHECKOUT's package under smoke_out/probe/ of this
script's directory (gitignored), its kernel source rewritten and built by
its own nvcc:
  base    the checkout's kernel;
  rows8   8 rows a thread, 2 blocks an SM (each w_hh fragment serves twice
          the rows: 0.1875 shared wavefronts a warp FMA at H = 32);
  nogate  the gate math (expf, tanhf, the divisions) replaced by products;
  nofma   the recurrent products cut to their first 4 k.
nogate and nofma give wrong outputs: only their times count. Each variant
times lstm_infer_last on x_proj and fused from x (F = 1) and
lstm_train_fwd at the N=500 step's shape (R = 500,000, T = 7, H = 32) and
at the N=47 serve shape (R = 17,672), CUDA-event means over 20 calls after
3, in two rounds in opposite orders, one process a variant and round. The
last line is one JSON object, {"device": ..., "times": {variant: [round 1,
round 2]}}. Needs a CUDA card; imports nothing of JAX.
"""

import argparse
import json
import os
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join("mpgcn_tpu_torch", "csrc", "lstm_fwd.cuh")
#: variant -> (text, replacement) pairs applied to lstm_fwd.cuh
VARIANTS = {
    "base": [],
    "rows8": [("constexpr int kFwdRows = 4;", "constexpr int kFwdRows = 8;"),
              ("constexpr int kFwdMinBlocks = 3;",
               "constexpr int kFwdMinBlocks = 2;")],
    "nogate": [("sigmoidf(acc[q][0])", "(acc[q][0] * 0.25f)"),
               ("sigmoidf(acc[q][1])", "(acc[q][1] * 0.25f)"),
               ("tanhf(acc[q][2])", "(acc[q][2] * 0.25f)"),
               ("sigmoidf(acc[q][3])", "(acc[q][3] * 0.25f)"),
               ("__fmul_rn(og, tanhf(c[q]))", "__fmul_rn(og, c[q])")],
    "nofma": [("for (; k + 4 <= H; k += 4) {",
               "for (; k + 4 <= 4; k += 4) {"),
              ("for (; k < H; ++k) {", "for (; k < 0; ++k) {")],
}
SHAPES = [(7, 500000, 32), (7, 17672, 32)]


def make_variant(root: str, name: str, dest: str) -> str:
    """Copy root's package to dest/name with the variant's rewrites."""
    out = os.path.join(dest, name)
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(os.path.join(root, "mpgcn_tpu_torch"),
                    os.path.join(out, "mpgcn_tpu_torch"),
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    path = os.path.join(out, SOURCE)
    with open(path) as f:
        src = f.read()
    for old, new in VARIANTS[name]:
        if old not in src:
            raise RuntimeError(f"variant {name}: {old!r} not in {SOURCE}")
        src = src.replace(old, new)
    with open(path, "w") as f:
        f.write(src)
    return out


def run_variant(root: str, build_only: bool) -> dict:
    """In this process: build root's LSTM kernels, or time them."""
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
    for T, R, H in SHAPES:
        gen = torch.Generator(device=dev).manual_seed(R + H)
        xp = torch.randn((T, R, 4 * H), generator=gen, device=dev)
        w = torch.randn((H, 4 * H), generator=gen, device=dev) / H ** 0.5
        x = torch.randn((R, T, 1), generator=gen, device=dev)
        w_ih = torch.randn((4 * H, 1), generator=gen, device=dev) / H ** 0.5
        b = torch.randn((4 * H,), generator=gen, device=dev) / H ** 0.5
        times[f"R={R} last x_proj"] = time_ms(
            lambda: cuda_lstm.lstm_layer_infer(xp, w, False))
        times[f"R={R} last fused"] = time_ms(
            lambda: cuda_lstm.lstm_layer_infer_fused(x, w_ih, b, w, False))
        times[f"R={R} train_fwd"] = time_ms(
            lambda: cuda_lstm.lstm_layer_train(xp, w))
        del xp
        torch.cuda.empty_cache()
    return times


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--variant-root", help=argparse.SUPPRESS)
    ap.add_argument("--build-only", action="store_true",
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.variant_root:
        print(json.dumps(run_variant(args.variant_root, args.build_only)))
        return 0
    import torch

    if not torch.cuda.is_available():
        print("lstm_fwd_probe: needs a CUDA card", file=sys.stderr)
        return 2
    dest = os.path.join(HERE, "smoke_out", "probe")
    roots = {n: make_variant(os.path.abspath(args.root), n, dest)
             for n in VARIANTS}

    def child(root, *extra):
        return [sys.executable, os.path.abspath(__file__), "--variant-root",
                root, *extra]

    builds = [subprocess.Popen(child(r, "--build-only"),
                               stdout=subprocess.DEVNULL)
              for r in roots.values()]
    if any([p.wait() != 0 for p in builds]):
        raise RuntimeError("a variant failed to build")
    times = {n: [] for n in roots}
    for order in (list(roots), list(roots)[::-1]):
        for name in order:
            out = subprocess.run(child(roots[name]), check=True,
                                 capture_output=True, text=True).stdout
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
