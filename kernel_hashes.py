#!/usr/bin/env python3
"""Hash what every CUDA kernel entry of the PyTorch port computes, at fixed
seeded inputs, so that two checkouts' kernels can be compared bit for bit.

    python3 kernel_hashes.py [--root CHECKOUT]

Imports ``mpgcn_tpu_torch`` from CHECKOUT (default: the directory of this
script), builds its kernels, runs each entry once on the card and prints
one JSON object, ``{"hashes": {case: sha256 of the output bytes}}``, on its
last line. The cases cover the eleven entries that chip_smoke.py lists, at
the reference and wide widths and at the N=500 blocked-ELL shapes, the
resident BPTT at the N=500 step's shape, one case with Inf and NaN
inputs per split-TF32 entry, the forwards at the widths around the
resident forward's shared-memory limit, and the model's LSTM stack
through the public ``cuda_lstm.lstm_last_step_fused`` (input width 1, 1
and 2 layers), which both a checkout that projects x in torch and one
that fuses the projection into the kernel take. Last come the bf16 forms
of the LSTM and K-BDGCN entries (cases named "... bf16"), on their own
seeded inputs after every f32 case, so a checkout without them prints
the same f32 hashes. Needs a CUDA card; imports nothing of JAX.
"""

import argparse
import hashlib
import json
import os
import sys
from types import SimpleNamespace

import numpy as np


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.abspath(
        __file__)))
    root = os.path.abspath(ap.parse_args().root)
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        print("kernel_hashes: needs a CUDA card", file=sys.stderr)
        return 2
    import mpgcn_tpu_torch
    from mpgcn_tpu_torch.nn import cuda_bdgcn, cuda_lstm
    from mpgcn_tpu_torch.sparse import cuda_ell
    from mpgcn_tpu_torch.sparse.formats import ell_from_dense, pack_payload
    from mpgcn_tpu_torch.sparse.kernels import flat_stack

    if os.path.dirname(os.path.dirname(os.path.abspath(
            mpgcn_tpu_torch.__file__))) != root:
        print(f"kernel_hashes: mpgcn_tpu_torch does not come from {root}",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(2024)
    hashes = {}

    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev)

    def put(case, *outs):
        torch.cuda.synchronize()
        h = hashlib.sha256()
        for o in outs:
            o = o.detach().contiguous()
            if o.dtype == torch.bfloat16:  # numpy has no bf16: its bits
                o = o.view(torch.int16)
            h.update(o.cpu().numpy().tobytes())
        hashes[case] = h.hexdigest()

    for T, R, H in ((7, 17672, 32), (7, 8836, 32), (7, 1001, 128)):
        xp = t(rng.normal(size=(T, R, 4 * H)))
        w = t(rng.normal(size=(H, 4 * H)) / np.sqrt(H))
        tag = f"T={T} R={R} H={H}"
        for collect, name in ((False, "lstm_infer_last"),
                              (True, "lstm_infer_collect")):
            put(f"{name} {tag}", cuda_lstm.lstm_layer_infer(xp, w, collect))
        hs, cs = cuda_lstm.lstm_layer_train(xp, w)
        put(f"lstm_train_fwd {tag}", hs, cs)
        dhs = t(rng.normal(size=(T, R, H)))
        put(f"lstm_train_bwd {tag}",
            *cuda_lstm.lstm_layer_bwd(xp, w, hs, cs, dhs, None))

    for K, B, N, C, H in ((3, 8, 47, 32, 32), (3, 4, 47, 32, 32),
                          (7, 4, 47, 128, 128)):
        for dynamic in (False, True):
            h1 = t(rng.normal(size=(K, B, N, N, C)))
            g = t(rng.random((B if dynamic else 1, K, N, N)) / N * 2)
            wr = t(rng.normal(size=(K, K, C, H)) / np.sqrt(K * K * C))
            dout = t(rng.normal(size=(B, N, N, H)))
            tag = (f"K={K} B={B} N={N} C={C} H={H} "
                   f"{'dynamic' if dynamic else 'static'}")
            put(f"bdgcn_pair_fwd {tag}",
                cuda_bdgcn.folded_pair_project(h1, g, wr))
            put(f"bdgcn_pair_bwd {tag}",
                *cuda_bdgcn.folded_pair_project_bwd(h1, g, wr, dout))

    # blocked-ELL: the N=500 band of density 0.05 at the (8, 128) tile
    # (static: one X for S = 3; per-sample: X per (B = 2) x K = 3), and a
    # ragged random stack
    def band(shape):
        n = shape[-1]
        d = np.abs(np.arange(n)[:, None] - np.arange(n)[None, :])
        return (rng.normal(size=shape)
                * (np.minimum(d, n - d) <= 12)).astype(np.float32)

    def ragged(shape):
        a = rng.normal(size=shape).astype(np.float32)
        return a * (rng.random(shape) < 0.3)

    for label, A, bc, F, G in (
            ("N=500 static", band((3, 500, 500)), 128, 32000, 1),
            ("N=500 per-sample", band((2, 3, 500, 500)), 128, 16000, 2),
            ("N=90 ragged", ragged((2, 3, 90, 90)), 20, 70, 2)):
        S = int(np.prod(A.shape[:-2]))
        n = A.shape[-1]
        X = t(rng.normal(size=(G, n, F)))
        dout = t(rng.normal(size=(S, n, F)))
        base = ell_from_dense(A, br=8, bc=bc)
        for payload in ("f32", "bf16", "int8"):
            cols, tiles, scale, tp, ts = flat_stack(
                pack_payload(base, payload).to(dev))
            q = "_q" if scale is not None else ""
            put(f"ell_fwd{q} {label} {payload}", cuda_ell.ell_fwd(
                cols, tiles, tp, ts, X, n, S // G, scale))
            put(f"ell_bwd_dx{q} {label} {payload}", cuda_ell.ell_bwd_dx(
                cols, tiles, tp, ts, dout, n, S // G, scale))
        cols = flat_stack(base.to(dev))[0]
        put(f"ell_bwd_dblk {label}",
            cuda_ell.ell_bwd_dblk(cols, X, dout, bc, S // G))
        del X, dout

    # the resident BPTT at the N=500 step's shape (R = B N^2 = 500,000)
    rng = np.random.default_rng(500)
    T, R, H = 7, 500000, 32
    xp = t(rng.normal(size=(T, R, 4 * H)))
    w = t(rng.normal(size=(H, 4 * H)) / np.sqrt(H))
    hs, cs = cuda_lstm.lstm_layer_train(xp, w)
    dhs = t(rng.normal(size=(T, R, H)))
    put(f"lstm_train_bwd T={T} R={R} H={H}",
        *cuda_lstm.lstm_layer_bwd(xp, w, hs, cs, dhs, None))
    del xp, hs, cs, dhs

    # non-finite inputs, one case per split-TF32 entry: +Inf, -Inf and a
    # NaN made on the card (Inf - Inf) in one operand
    rng = np.random.default_rng(7)
    inf = torch.full((), float("inf"), device=dev)

    def non_finite(a, at):
        a = a.clone()
        for i, v in zip(at, (inf, -inf, inf - inf)):
            a.view(-1)[i] = v
        return a

    n, F = 200, 160
    base = ell_from_dense(band((3, n, n)), br=8, bc=128)
    X = non_finite(t(rng.normal(size=(1, n, F))),
                   [150 * F + 7, 60 * F + 40, 5 * F + 130])
    dout = non_finite(t(rng.normal(size=(3, n, F))),
                      [70 * F + 3, 350 * F + 33, 599 * F + 100])
    for payload in ("f32", "int8"):
        cols, tiles, scale, tp, ts = flat_stack(
            pack_payload(base, payload).to(dev))
        q = "_q" if scale is not None else ""
        put(f"ell_fwd{q} non-finite X {payload}",
            cuda_ell.ell_fwd(cols, tiles, tp, ts, X, n, 3, scale))
        put(f"ell_bwd_dx{q} non-finite dout {payload}",
            cuda_ell.ell_bwd_dx(cols, tiles, tp, ts, dout, n, 3, scale))
    cols = flat_stack(base.to(dev))[0]
    put("ell_bwd_dblk non-finite X and dout",
        cuda_ell.ell_bwd_dblk(cols, X, dout, 128, 3))
    K, B, N, C, H = 3, 2, 20, 32, 32
    h1 = t(rng.normal(size=(K, B, N, N, C)))
    g = t(rng.random((B, K, N, N)) / N * 2)
    wr = t(rng.normal(size=(K, K, C, H)) / np.sqrt(K * K * C))
    d = t(rng.normal(size=(B, N, N, H)))
    h1 = non_finite(h1, [h1.numel() // 7, h1.numel() // 3, h1.numel() - 5])
    put("bdgcn_pair_fwd non-finite h1",
        cuda_bdgcn.folded_pair_project(h1, g, wr))
    put("bdgcn_pair_bwd non-finite h1",
        *cuda_bdgcn.folded_pair_project_bwd(h1, g, wr, d))
    T, R, H = 3, 333, 97
    xp = t(rng.normal(size=(T, R, 4 * H)))
    w = t(rng.normal(size=(H, 4 * H)) / np.sqrt(H))
    hs, cs = cuda_lstm.lstm_layer_train(xp, w)
    dhs = non_finite(t(rng.normal(size=(T, R, H))),
                     [(2 * R + 10) * H + 3, (2 * R + 200) * H + 1,
                      (R + 300) * H + 7])
    put(f"lstm_train_bwd non-finite dhs T={T} R={R} H={H}",
        *cuda_lstm.lstm_layer_bwd(xp, w, hs, cs, dhs, None))

    # the forwards at the widths around the resident forward's limit
    # (H = 116 resident; 117 and 118, resident before the rows per thread
    # went from 4 to 8, now the wide kernel)
    rng = np.random.default_rng(118)
    for H in (116, 117, 118):
        T, R = 7, 1001
        xp = t(rng.normal(size=(T, R, 4 * H)))
        w = t(rng.normal(size=(H, 4 * H)) / np.sqrt(H))
        tag = f"T={T} R={R} H={H}"
        for collect, name in ((False, "lstm_infer_last"),
                              (True, "lstm_infer_collect")):
            put(f"{name} {tag}", cuda_lstm.lstm_layer_infer(xp, w, collect))
        put(f"lstm_train_fwd {tag}", *cuda_lstm.lstm_layer_train(xp, w))

    # the model's LSTM stack at input width F = 1, weights as its init
    # draws them (uniform in +-1/sqrt(H))
    rng = np.random.default_rng(1300)

    def stack(n_layers, F, H):
        s = 1 / np.sqrt(H)
        return [SimpleNamespace(**{
            k: t(rng.uniform(-s, s, shape)) for k, shape in (
                ("w_ih", (4 * H, F if i == 0 else H)), ("w_hh", (4 * H, H)),
                ("b_ih", (4 * H,)), ("b_hh", (4 * H,)))})
            for i in range(n_layers)]

    for R, H in ((17672, 32), (500000, 32), (17672, 128)):
        x = t(rng.normal(size=(R, 7, 1)))
        for n_layers in (1, 2):
            with torch.no_grad():
                put(f"lstm_last_step_fused layers={n_layers} T=7 R={R} "
                    f"H={H} F=1",
                    cuda_lstm.lstm_last_step_fused(stack(n_layers, 1, H), x))
        del x

    # the bf16 entries: the three LSTM forwards (on x_proj and fused from
    # x) and the BPTT at the reference, engine and wide widths, K-BDGCN
    # forward and backward at the reference and wide widths
    if hasattr(cuda_lstm, "LSTM_TRAIN_FWD_BF16"):
        rng = np.random.default_rng(1600)

        def b(a):
            return t(a).to(torch.bfloat16)

        for T, R, H in ((7, 17672, 32), (7, 8836, 32), (3, 333, 97),
                        (7, 1001, 128)):
            xp = b(rng.normal(size=(T, R, 4 * H)))
            w = b(rng.normal(size=(H, 4 * H)) / np.sqrt(H))
            tag = f"T={T} R={R} H={H} bf16"
            for collect, name in ((False, "lstm_infer_last"),
                                  (True, "lstm_infer_collect")):
                put(f"{name} {tag}",
                    cuda_lstm.lstm_layer_infer(xp, w, collect))
            s = 1 / np.sqrt(H)
            x, w_ih, bias = (b(rng.normal(size=(R, T, 1))),
                             b(rng.uniform(-s, s, (4 * H, 1))),
                             b(rng.uniform(-s, s, 4 * H)))
            put(f"lstm_infer_last fused F=1 {tag}",
                cuda_lstm.lstm_layer_infer_fused(x, w_ih, bias, w, False))
            hs, cs = cuda_lstm.lstm_layer_train(xp, w)
            put(f"lstm_train_fwd {tag}", hs, cs)
            dhs = b(rng.normal(size=(T, R, H)))
            put(f"lstm_train_bwd {tag}",
                *cuda_lstm.lstm_layer_bwd(xp, w, hs, cs, dhs, None))
        for K, B, N, C, H in ((3, 8, 47, 32, 32), (7, 4, 47, 128, 128)):
            h1 = b(rng.normal(size=(K, B, N, N, C)))
            g = b(rng.random((1, K, N, N)) / N * 2)
            wr = b(rng.normal(size=(K, K, C, H)) / np.sqrt(K * K * C))
            dout = b(rng.normal(size=(B, N, N, H)))
            tag = f"K={K} B={B} N={N} C={C} H={H} static bf16"
            put(f"bdgcn_pair_fwd {tag}",
                cuda_bdgcn.folded_pair_project(h1, g, wr))
            put(f"bdgcn_pair_bwd {tag}",
                *cuda_bdgcn.folded_pair_project_bwd(h1, g, wr, dout))

    print(json.dumps({"root": root, "device": torch.cuda.get_device_name(0),
                      "hashes": hashes}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
