#!/usr/bin/env python3
"""Hash what every CUDA kernel entry of the PyTorch port computes, at fixed
seeded inputs, so that two checkouts' kernels can be compared bit for bit.

    python3 kernel_hashes.py [--root CHECKOUT]

Imports ``mpgcn_tpu_torch`` from CHECKOUT (default: the directory of this
script), builds its kernels, runs each entry once on the card and prints
one JSON object, ``{"hashes": {case: sha256 of the output bytes}}``, on its
last line. The cases cover the eleven entries that chip_smoke.py lists, at
the reference and wide widths and at the N=500 blocked-ELL shapes. Needs a
CUDA card; imports nothing of JAX.
"""

import argparse
import hashlib
import json
import os
import sys

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
            h.update(o.detach().contiguous().cpu().numpy().tobytes())
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

    print(json.dumps({"root": root, "device": torch.cuda.get_device_name(0),
                      "hashes": hashes}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
