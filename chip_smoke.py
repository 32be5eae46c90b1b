#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. build every kernel of mpgcn_tpu_torch/csrc/ with nvcc for sm_90a and
     print the ptxas register / shared-memory / spill report;
  2. hold each kernel against its plain PyTorch version on the card, at
     the shapes the serve and training paths give it and at odd sizes
     (the backward kernels with and without a dcs cotangent, and twice,
     to show that dW is bit-equal from run to run);
  3. serve: a ServeEngine on the card (synthetic data, seed 0; fresh
     weights at the reference widths from the first init seed that leaves
     no branch's ReLU head dead) answers test-split windows in every
     bucket (1, 2, 4, 8); the predictions must be finite, match the same
     weights' plain rollout on the card, and the kernels' launch counts
     must rise by exactly the expected numbers (none of the training
     kernels). Then once more with a 2-layer LSTM, which puts the collect
     kernel on the path;
  4. train: at the reference configuration, every branch is live and
     every parameter gradient of the kernel arms is non-zero and matches
     the plain arms' on a full and a repeat-padded batch, and the first 20
     step losses track theirs; a ModelTrainer takes 3 epochs on the card
     with exactly M*L = 2 launches of each LSTM training entry, M*3 = 6 of
     each BDGCN entry and 2 + 6 of the shared dW reduction per step, moves
     every parameter, its loss falls, its checkpoint is written, and a
     fresh trainer in test mode reloads it, rolls out 7 steps and appends
     finite scores;
  5. time each kernel beside its bound, its plain version and one PyTorch
     library call, the rollout per bucket, the train step, and the
     device's busy share.

The second-to-last line is a JSON object listing each kernel; the last
line is {"ok": true, "device": {...}}. Exits non-zero without a card, and
when run from a directory that holds no mpgcn_tpu_torch package.
"""

import copy
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published peaks (NVIDIA data sheet): device memory rate and the
# f32 rate of the CUDA cores (no tensor cores: the kernels are f32 FMA)
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOP_PER_S = 67e12

LSTM_TOL = dict(rtol=1e-5, atol=1e-5)    # 7 steps of f32, other sum order
BDGCN_TOL = dict(rtol=1e-5, atol=1e-5)   # f32 sums of K^2 N C products
ROLLOUT_TOL = dict(rtol=1e-4, atol=1e-4)  # 7 autoregressive f32 steps
# dW sums R*T (LSTM) or B*M*N (BDGCN) products in another order than the
# plain version: rtol 1e-5 with an atol of 2e-6 x the largest |dW| entry
DW_RTOL, DW_ATOL_SCALE = 1e-5, 2e-6
# the dW reductions add the same partials in the same order as their plain
# version: equal up to the last bit, held at f32 rounding
REDUCE_TOL = dict(rtol=1e-6, atol=1e-6)
# whole-model gradients, each f32 arm against the plain arms in float64
# and the kernel arms against the plain arms in f32: rtol 1e-4 with an atol
# of 1e-4 x the tensor's largest entry. The gradient is not continuous in
# the forward values: a pre-activation within f32 rounding of zero can land
# on the other side of a ReLU in one arm, which moves every gradient below
# that layer by one element's upstream gradient, up to about 1e-4 of the
# largest entry at these sizes (6.4e-5 measured, from one flipped entry)
GRAD_RTOL, GRAD_ATOL_SCALE = 1e-4, 1e-4
# 20 Adam steps: an entry whose gradient is near zero moves by up to lr on
# f32 noise alone, so the arms' losses drift apart slowly
LOSS_CURVE_RTOL = 1e-4

#: the launch-counted kernel entries, by name: (module, attribute, source,
#: the TPU kernel's pl.pallas_call it replaces)
KERNEL_META = {
    "lstm_infer_last": ("cuda_lstm", "LSTM_INFER_LAST", "lstm_infer.cu",
                        "mpgcn_tpu/nn/pallas_lstm.py:380"),
    "lstm_infer_collect": ("cuda_lstm", "LSTM_INFER_COLLECT",
                           "lstm_infer.cu",
                           "mpgcn_tpu/nn/pallas_lstm.py:367"),
    "bdgcn_pair_fwd": ("cuda_bdgcn", "BDGCN_PAIR_FWD", "bdgcn_pair_fwd.cu",
                       "mpgcn_tpu/nn/pallas_bdgcn.py:205"),
    "lstm_train_fwd": ("cuda_lstm", "LSTM_TRAIN_FWD", "lstm_train.cu",
                       "mpgcn_tpu/nn/pallas_lstm.py:414"),
    "lstm_train_bwd": ("cuda_lstm", "LSTM_TRAIN_BWD", "lstm_train.cu",
                       "mpgcn_tpu/nn/pallas_lstm.py:519"),
    # the fixed-order dW sum of both backward kernels (the LSTM BPTT's and
    # K-BDGCN-bwd's, mpgcn_tpu/nn/pallas_bdgcn.py:233 too): one entry
    "dw_reduce": ("cuda_lstm", "DW_REDUCE", "lstm_train.cu",
                  "mpgcn_tpu/nn/pallas_lstm.py:519"),
    "bdgcn_pair_bwd": ("cuda_bdgcn", "BDGCN_PAIR_BWD", "bdgcn_pair_bwd.cu",
                       "mpgcn_tpu/nn/pallas_bdgcn.py:233"),
}
TRAIN_KERNELS = ("lstm_train_fwd", "lstm_train_bwd", "dw_reduce",
                 "bdgcn_pair_bwd")
#: a branch whose FC+ReLU head outputs fewer non-zeros than this on the
#: first training batch counts as dead: its gradients are all 0, so the
#: gradient checks and the training run would not reach its kernels
LIVE_SHARE = 0.1


def kernels():
    """name -> the CudaKernel entry (its launch count lives there)."""
    from mpgcn_tpu_torch.nn import cuda_bdgcn, cuda_lstm

    mods = {"cuda_lstm": cuda_lstm, "cuda_bdgcn": cuda_bdgcn}
    return {n: getattr(mods[m], a) for n, (m, a, _, _) in
            KERNEL_META.items()}


def reset_counts():
    for k in kernels().values():
        k.launches = 0


def read_counts():
    import torch

    torch.cuda.synchronize()
    return {n: k.launches for n, k in kernels().items()}


def require(cond, msg):
    if not cond:
        raise RuntimeError(f"chip smoke check failed: {msg}")


def bound(bytes_moved, flops):
    t_bytes = bytes_moved / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_F32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_ms(fn, iters=50, warmup=5):
    import torch

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


def compare(name, out, ref, tol):
    import torch

    if tol is None:  # a dW sum: atol scaled to its largest entry
        tol = dict(rtol=DW_RTOL,
                   atol=DW_ATOL_SCALE * float(ref.abs().max()))
    err = float((out - ref).abs().max())
    rel = float(((out - ref).abs() / ref.abs().clamp(min=1e-6)).max())
    ok = torch.allclose(out, ref, **tol)
    print(f"[check] {name}: max_abs_err={err:.3e} max_rel_err={rel:.3e} "
          f"tolerance rtol={tol['rtol']} atol={tol['atol']:.3g} "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    require(ok, f"{name} disagrees with its plain version")
    return err


def phase_build():
    from mpgcn_tpu_torch.native import build

    t0 = time.perf_counter()
    build.build_all()
    for name in build.kernel_sources():
        build.load(name)
        report = build.ptxas_reports.get(name, "(library already built)")
        for line in report.splitlines():
            if "ptxas info" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}")
    print(f"[build] {len(build.kernel_sources())} kernel sources built and "
          f"loaded in {time.perf_counter() - t0:.1f}s", flush=True)


def phase_kernels(dev, rng):
    """Each kernel against its plain version at the serve shapes; returns
    the per-kernel worst error and timing inputs."""
    import torch

    from mpgcn_tpu_torch.nn import cuda_bdgcn, cuda_lstm

    B, N, H, T, K = 8, 47, 32, 7, 3
    R = B * N * N
    xp = torch.from_numpy(rng.normal(size=(T, R, 4 * H)).astype(
        np.float32)).to(dev)
    w = torch.from_numpy((rng.normal(size=(H, 4 * H)) / np.sqrt(H)).astype(
        np.float32)).to(dev)
    err = {}
    for collect, name in ((False, "lstm_infer_last"),
                          (True, "lstm_infer_collect")):
        out = cuda_lstm.lstm_layer_infer(xp, w, collect)
        torch.cuda.synchronize()
        ref = cuda_lstm.lstm_layer_infer_plain(xp, w, collect)
        err[name] = compare(f"K-LSTM {name.split('_')[-1]} R={R}", out, ref,
                            LSTM_TOL)

    def bdgcn_inputs(b, n, dynamic):
        h1 = rng.normal(size=(K, b, n, n, H)).astype(np.float32)
        g = (rng.random((b if dynamic else 1, K, n, n)) / n * 2).astype(
            np.float32)
        wr = (rng.normal(size=(K, K, H, H)) / np.sqrt(K * K * H)).astype(
            np.float32)
        return [torch.from_numpy(a).to(dev) for a in (h1, g, wr)]

    err["bdgcn_pair_fwd"] = 0.0
    inputs = {}
    for b, n, dynamic in ((B, N, False), (B, N, True), (2, 200, False),
                          (2, 200, True)):
        args = bdgcn_inputs(b, n, dynamic)
        out = cuda_bdgcn.folded_pair_project(*args)
        torch.cuda.synchronize()
        ref = cuda_bdgcn.folded_pair_project_plain(*args)
        kind = "dynamic" if dynamic else "static"
        e = compare(f"K-BDGCN {kind} B={b} N={n}", out, ref, BDGCN_TOL)
        err["bdgcn_pair_fwd"] = max(err["bdgcn_pair_fwd"], e)
        if n == N:
            inputs[kind] = args
    return err, {"lstm": (xp, w), "bdgcn": inputs["static"],
                 "bdgcn_dynamic": inputs["dynamic"]}


def phase_train_kernels(dev, rng):
    """The training kernels against their plain versions at the shapes a
    training step gives them (R = 4 * 47^2 = 8,836 sequences, T = 7,
    H = 32; B = 4, N = 47, K = 3, C = H = 32, static and dynamic) and at
    odd sizes; dW twice, which must be bit-equal. Returns the per-entry
    worst error and the timing inputs."""
    import torch

    from mpgcn_tpu_torch.nn import cuda_bdgcn, cuda_lstm

    def dev_t(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev)

    err = {n: 0.0 for n in TRAIN_KERNELS}
    inputs = {}
    for T, R, H in ((7, 8836, 32), (7, 1001, 8), (5, 333, 64),
                    (3, 17, 40)):
        xp = dev_t(rng.normal(size=(T, R, 4 * H)))
        w = dev_t(rng.normal(size=(H, 4 * H)) / np.sqrt(H))
        tag = f"T={T} R={R} H={H}"
        hs, cs = cuda_lstm.lstm_layer_train(xp, w)
        torch.cuda.synchronize()
        hp, cp = cuda_lstm.lstm_layer_train_plain(xp, w)
        err["lstm_train_fwd"] = max(
            err["lstm_train_fwd"],
            compare(f"K-LSTM-train fwd hs {tag}", hs, hp, LSTM_TOL),
            compare(f"K-LSTM-train fwd cs {tag}", cs, cp, LSTM_TOL))
        dhs = dev_t(rng.normal(size=(T, R, H)))
        for dcs in (None, dev_t(rng.normal(size=(T, R, H)))):
            label = f"{tag} dcs={'none' if dcs is None else 'random'}"
            dxp, dw = cuda_lstm.lstm_layer_bwd(xp, w, hs, cs, dhs, dcs)
            torch.cuda.synchronize()
            dxr, dwr = cuda_lstm.lstm_layer_bwd_plain(xp, w, hs, cs, dhs,
                                                      dcs)
            err["lstm_train_bwd"] = max(
                err["lstm_train_bwd"],
                compare(f"K-LSTM-train bwd dx_proj {label}", dxp, dxr,
                        LSTM_TOL),
                compare(f"K-LSTM-train bwd dW_hh^T {label}", dw, dwr, None))
            dxp2, dw2 = cuda_lstm.lstm_layer_bwd(xp, w, hs, cs, dhs, dcs)
            require(torch.equal(dw, dw2) and torch.equal(dxp, dxp2),
                    f"K-LSTM-train bwd {label}: two runs differ")
            print(f"[check] K-LSTM-train bwd {label}: dW bit-equal over "
                  f"two runs", flush=True)
        if R == 8836:
            inputs["lstm"] = (xp, w, hs, cs, dhs)

    K = 3
    for b, n, c, h, dynamic in ((4, 47, 32, 32, False),
                                (4, 47, 32, 32, True),
                                (2, 200, 32, 32, False),
                                (2, 200, 32, 32, True),
                                (3, 9, 8, 64, True)):
        h1 = dev_t(rng.normal(size=(K, b, n, n, c)))
        g = dev_t(rng.random((b if dynamic else 1, K, n, n)) / n * 2)
        wr = dev_t(rng.normal(size=(K, K, c, h)) / np.sqrt(K * K * c))
        dout = dev_t(rng.normal(size=(b, n, n, h)))
        tag = (f"{'dynamic' if dynamic else 'static'} B={b} N={n} C={c} "
               f"H={h}")
        dh1, dW = cuda_bdgcn.folded_pair_project_bwd(h1, g, wr, dout)
        torch.cuda.synchronize()
        r1, rW = cuda_bdgcn.folded_pair_project_bwd_plain(h1, g, wr, dout)
        err["bdgcn_pair_bwd"] = max(
            err["bdgcn_pair_bwd"],
            compare(f"K-BDGCN-bwd dh1 {tag}", dh1, r1, BDGCN_TOL),
            compare(f"K-BDGCN-bwd dW {tag}", dW, rW, None))
        _, dW2 = cuda_bdgcn.folded_pair_project_bwd(h1, g, wr, dout)
        require(torch.equal(dW, dW2), f"K-BDGCN-bwd {tag}: two runs differ")
        print(f"[check] K-BDGCN-bwd {tag}: dW bit-equal over two runs",
              flush=True)
        if n == 47:
            inputs["bdgcn_dynamic" if dynamic else "bdgcn"] = (h1, g, wr,
                                                               dout)

    # the shared reduction at the partial counts the training step gives it
    xp, w = inputs["lstm"][:2]
    T, R, G = xp.shape
    for key, P, n in (
            ("dw_reduce", cuda_lstm.bwd_blocks(R, G // 4, dev), G * G // 4),
            ("dw_reduce_bdgcn", cuda_bdgcn.bwd_blocks(4 * 47 * 47, K, dev),
             K * K * 32 * 32)):
        part = dev_t(rng.normal(size=(P, n)))
        out = cuda_lstm.dw_reduce(part)
        torch.cuda.synchronize()
        err["dw_reduce"] = max(err["dw_reduce"], compare(
            f"dw_reduce P={P} n={n}", out, cuda_lstm.dw_reduce_plain(part),
            REDUCE_TOL))
        inputs[key] = part
    return err, inputs


def serve_phase(label, cfg, data, dev, groups, expect_per_batch,
                expect_buckets):
    """Drive a ServeEngine through `groups` of concurrent requests; check
    the buckets dispatched, finiteness, agreement with the plain rollout
    and the launch counts. Returns (engine, launches)."""
    import torch

    from mpgcn_tpu_torch.config import ServeConfig
    from mpgcn_tpu_torch.nn.mpgcn import MPGCN
    from mpgcn_tpu_torch.service.serve import ServeEngine
    from mpgcn_tpu_torch.train.predict import graphs_for, rollout

    # fresh seeded weights; the 100 ms window coalesces each group of
    # concurrent submits into one batch, so every bucket dispatches
    scfg = ServeConfig(max_wait_ms=100.0, deadline_ms=0.0)
    t0 = time.perf_counter()
    eng = ServeEngine(cfg, data, scfg, device=dev, allow_fresh=True)
    print(f"[serve:{label}] engine up in {time.perf_counter() - t0:.1f}s "
          f"(params: {eng.params_source})", flush=True)
    require(eng.params_source.startswith("fresh init"),
            f"expected a fresh seeded init, got {eng.params_source}")
    md = eng.pipeline.modes["test"]
    n_req = sum(groups)
    require(len(md) >= n_req, f"only {len(md)} test windows")
    x = np.array(md.x[:n_req])
    keys = md.keys[:n_req]

    reset_counts()  # count only the main path's launches
    tickets, i = [], 0
    for size in groups:
        batch = [eng.submit(x[j, ..., 0], int(keys[j]))
                 for j in range(i, i + size)]
        for t in batch:
            require(t.wait(120), "request not answered in 120 s")
        tickets += batch
        i += size
    launches = read_counts()
    require(all(launches[n] == 0 for n in TRAIN_KERNELS),
            f"the serve path launched a training kernel: {launches}")
    st = eng.stats()
    print(f"[serve:{label}] {json.dumps(st)}", flush=True)

    require(all(t.ok for t in tickets),
            f"outcomes {[t.outcome for t in tickets]}")
    by_bucket = st["pad_waste"]["by_bucket"]
    batches = sum(v["dispatches"] for v in by_bucket.values())
    require(sorted(int(b) for b in by_bucket) == sorted(expect_buckets),
            f"buckets dispatched {sorted(by_bucket)}, expected "
            f"{sorted(expect_buckets)}")
    for name, per_batch in expect_per_batch.items():
        require(launches[name] == per_batch * batches,
                f"{name} launched {launches[name]} times for {batches} "
                f"batches, expected {per_batch} per batch")
    preds = torch.from_numpy(np.stack([t.pred for t in tickets])).to(dev)
    require(tuple(preds.shape) == (n_req, cfg.pred_len, eng.cfg.num_nodes,
                                   eng.cfg.num_nodes, 1),
            f"prediction shape {tuple(preds.shape)}")
    require(bool(torch.isfinite(preds).all()), "non-finite predictions")
    nonzero = float((preds != 0).float().mean())
    print(f"[serve:{label}] {n_req} requests in {batches} batches, "
          f"buckets {sorted(int(b) for b in by_bucket)}, non-zero share "
          f"{nonzero:.3f}, launches per batch "
          f"{ {k: v / batches for k, v in launches.items() if v} }",
          flush=True)
    require(nonzero > 0.1, "dead ReLU head: comparisons would be vacuous")

    plain = MPGCN.from_config(eng.cfg, device=dev, lstm_impl="plain",
                              bdgcn_impl="einsum").eval()
    plain.load_state_dict(eng.model.state_dict())
    xt = torch.from_numpy(x).to(dev)
    kt = torch.from_numpy(keys.astype(np.int64)).to(dev)
    compare(f"serve:{label} rollout vs plain rollout", preds,
            rollout(plain, eng.banks, xt, kt, cfg.pred_len), ROLLOUT_TOL)
    graphs = graphs_for(eng.banks, kt, eng.model.sources)
    _, hk = eng.model(xt, graphs, return_hidden=True, inference=True)
    _, hp = plain(xt, graphs, return_hidden=True, inference=True)
    for m, (a, b) in enumerate(zip(hk, hp)):
        compare(f"serve:{label} branch {m} pre-head BDGCN output", a, b,
                ROLLOUT_TOL)
    return eng, launches


def busy_share(label, run, n):
    """Device busy share over ``n`` calls of ``run`` (torch.profiler):
    device-side activity time over host wall time, with the device time
    by kernel name. Prints "not measured" when the profiler records no
    device activity."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(n):
                run()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
    except RuntimeError as e:
        print(f"[time] {label} device busy share: not measured ({e})")
        return
    # device-side activities only (kernels, copies, sets): the CPU ops
    # that launched them also carry device time in key_averages(), so
    # summing those would count each kernel twice
    per_name = {}
    for e in prof.events():
        # a user annotation (Optimizer.step, say) also shows on the device
        # timeline, over the kernels it launched: leave it out
        if (e.device_type == torch.autograd.DeviceType.CUDA
                and not getattr(e, "is_user_annotation", False)):
            acc = per_name.setdefault(e.name, [0.0, 0])
            acc[0] += e.time_range.elapsed_us()
            acc[1] += 1
    dev_us = sum(v[0] for v in per_name.values())
    if dev_us <= 0:
        print(f"[time] {label} device busy share: not measured (the "
              f"profiler recorded no device activity)")
        return
    n_dev = sum(v[1] for v in per_name.values())
    print(f"[time] {label} device busy share over {n} calls "
          f"(torch.profiler): {dev_us / wall_us:.4f} ({dev_us:.0f} us of "
          f"device activity in {wall_us:.0f} us; {n_dev / n:.0f} device "
          f"activities per call)")
    top = sorted(per_name.items(), key=lambda kv: -kv[1][0])
    for name, (us, count) in top[:10]:
        print(f"[time]   {name[:60]:60s} {us / n:10.1f} us/call "
              f"x{count / n:g}")


def phase_times(dev, eng, kin):
    """Kernel, plain and library times at the serve shapes (CUDA events),
    the rollout per bucket (host clock around a synchronised call) and
    the device's busy share at the smallest and largest bucket."""
    import torch

    from mpgcn_tpu_torch.nn import cuda_bdgcn, cuda_lstm
    from mpgcn_tpu_torch.train.predict import rollout

    times = {}
    xp, w = kin["lstm"]
    T, R, G = xp.shape
    H = G // 4
    lib = torch.nn.LSTM(1, H, batch_first=True).to(dev)
    seq = torch.randn((R, T, 1), device=dev)
    with torch.no_grad():
        lib_ms = time_ms(lambda: lib(seq))
    for collect, name in ((False, "lstm_infer_last"),
                          (True, "lstm_infer_collect")):
        out_bytes = (T if collect else 1) * R * H * 4
        b_ms, b_by = bound(xp.numel() * 4 + w.numel() * 4 + out_bytes,
                           2 * T * R * H * G)
        times[name] = dict(
            ms=time_ms(lambda: cuda_lstm.lstm_layer_infer(xp, w, collect)),
            plain_ms=time_ms(lambda: cuda_lstm.lstm_layer_infer_plain(
                xp, w, collect), iters=10),
            library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by)
    for key, eq in (("bdgcn", "obmcl,dce,odlh->bmeh"),
                    ("bdgcn_dynamic", "obmcl,bdce,odlh->bmeh")):
        h1, g, wr = kin[key]
        K, B, M, N, C = h1.shape
        Hh = wr.shape[-1]
        # least work: project first, Y_d = sum_o h1[o] Wr[o,d] (K^2 C H per
        # (b,m,c)), then contract, out = sum_d G_d^T Y_d (K N H per (b,m,e))
        b_ms, b_by = bound(
            4 * (h1.numel() + g.numel() + wr.numel() + B * M * N * Hh),
            2 * B * M * N * (K * K * C * Hh + K * N * Hh))
        gl = g[0] if key == "bdgcn" else g
        entry = dict(
            ms=time_ms(lambda: cuda_bdgcn.folded_pair_project(h1, g, wr)),
            plain_ms=time_ms(lambda: cuda_bdgcn.folded_pair_project_plain(
                h1, g, wr), iters=10),
            library_ms=time_ms(lambda: torch.einsum(eq, h1, gl, wr),
                               iters=10),
            bound_ms=b_ms, bound_by=b_by)
        if key == "bdgcn":
            times["bdgcn_pair_fwd"] = entry
        label = "static" if key == "bdgcn" else "dynamic"
        print(f"[time] K-BDGCN {label} B={B} N={N}: {json.dumps(entry)}")
    for name in ("lstm_infer_last", "lstm_infer_collect"):
        print(f"[time] K-LSTM {name}: {json.dumps(times[name])}")

    md = eng.pipeline.modes["test"]
    per_bucket = {}
    for b in eng.scfg.buckets:
        x = torch.from_numpy(np.array(md.x[:b])).to(dev)
        k = torch.from_numpy(md.keys[:b].astype(np.int64)).to(dev)
        samples = []
        for i in range(12):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rollout(eng.model, eng.banks, x, k, eng.cfg.pred_len)
            torch.cuda.synchronize()
            if i >= 2:
                samples.append((time.perf_counter() - t0) * 1e3)
        per_bucket[b] = float(np.median(samples))
    print(f"[time] rollout ms per bucket (horizon {eng.cfg.pred_len}, "
          f"median of 10, host clock): {json.dumps(per_bucket)}")

    for b in (eng.scfg.buckets[0], eng.scfg.buckets[-1]):
        x = torch.from_numpy(np.array(md.x[:b])).to(dev)
        k = torch.from_numpy(md.keys[:b].astype(np.int64)).to(dev)
        busy_share(f"bucket-{b} rollout",
                   lambda: rollout(eng.model, eng.banks, x, k,
                                   eng.cfg.pred_len), 3)
    return times


def _batch(md, sel, size):
    from mpgcn_tpu_torch.data.pipeline import Batch

    return Batch(x=md.x[sel], y=md.y[sel], keys=md.keys[sel], size=size)


def _per_step(cfg, train: bool) -> dict:
    """Launches of one training step (train) or one validation step."""
    M, L, G = cfg.num_branches, cfg.lstm_num_layers, cfg.gcn_num_layers
    counts = dict.fromkeys(KERNEL_META, 0)
    if train:
        counts.update(lstm_train_fwd=M * L, lstm_train_bwd=M * L,
                      dw_reduce=M * L + M * G, bdgcn_pair_fwd=M * G,
                      bdgcn_pair_bwd=M * G)
    else:
        counts.update(lstm_infer_last=M, lstm_infer_collect=M * (L - 1),
                      bdgcn_pair_fwd=M * G)
    return counts


def _scaled(counts: dict, k: int) -> dict:
    return {n: v * k for n, v in counts.items()}


def _add(a: dict, b: dict) -> dict:
    return {n: a.get(n, 0) + b.get(n, 0) for n in set(a) | set(b)}


def branch_shares(model, x, graphs):
    """Per branch, the non-zero shares of its pre-head BDGCN output and of
    its FC+ReLU head (the model's output is the mean of the heads)."""
    import torch
    import torch.nn.functional as F

    _, hidden = model(x, graphs, return_hidden=True, inference=True)
    with torch.no_grad():
        return [(float((h != 0).float().mean()),
                 float((F.relu(b.fc(h)) != 0).float().mean()))
                for b, h in zip(model.branches, hidden)]


def live_init_seed(cfg, data, dev, tries=16):
    """The first init seed from cfg.seed up whose fresh weights give every
    branch a live pre-head output and head on the first training batch of
    ``data`` (which stays as it was drawn). At the reference widths some
    seeds leave one branch's ReLU head dead; its gradients are then all 0
    and neither the gradient checks nor the training run would reach its
    kernels with a non-zero cotangent. The port's trainer has no dead-init
    probe yet, and the JAX trainer's looks at the whole model only."""
    import torch

    from mpgcn_tpu_torch.data.pipeline import DataPipeline
    from mpgcn_tpu_torch.nn.mpgcn import MPGCN
    from mpgcn_tpu_torch.train.predict import graphs_for

    tcfg = cfg.replace(pred_len=1)
    pipe = DataPipeline(tcfg, data, dev)
    batch = next(pipe.batches("train", pad_to_full=True))
    x = torch.from_numpy(np.ascontiguousarray(batch.x)).to(dev)
    keys = torch.from_numpy(batch.keys.astype(np.int64)).to(dev)
    for seed in range(cfg.seed, cfg.seed + tries):
        model = MPGCN.from_config(tcfg.replace(seed=seed), device=dev)
        shares = branch_shares(model, x,
                               graphs_for(pipe.banks, keys, model.sources))
        live = min(min(sh) for sh in shares) > LIVE_SHARE
        print(f"[init] seed {seed}: non-zero shares per branch (pre-head, "
              f"head) {[(round(a, 4), round(b, 4)) for a, b in shares]}: "
              f"{'every branch live' if live else 'a branch is dead'}",
              flush=True)
        if live:
            return seed
    raise RuntimeError(f"chip smoke check failed: no init seed in "
                       f"{cfg.seed}..{cfg.seed + tries - 1} gives every "
                       f"branch a live head")


def phase_train(dev, cfg, data, out_dir):
    """The training path at the reference configuration (train mode trains
    the single-step model: pred_len 1), fresh seeded weights. Returns the
    launches of the training run and of the test-mode run, and trainers
    for the timing phase."""
    import torch

    from mpgcn_tpu_torch.train.objectives import elementwise_loss
    from mpgcn_tpu_torch.train.predict import graphs_for
    from mpgcn_tpu_torch.train.trainer import ModelTrainer
    from mpgcn_tpu_torch.utils.convert import read_checkpoint

    tcfg = cfg.replace(pred_len=1, num_epochs=3, output_dir=out_dir)
    kern = ModelTrainer(tcfg, data, device=dev)
    plain = ModelTrainer(tcfg, data, device=dev, lstm_impl="plain",
                         bdgcn_impl="einsum")
    plain.model.load_state_dict(kern.model.state_dict())
    md = kern.pipeline.modes["train"]
    bs = tcfg.batch_size
    full = _batch(md, np.arange(bs), bs)
    # size 3 of 4, repeat-padded the way DataPipeline.batches pads
    partial = _batch(md, np.array([0, 1, 2, 2]), 3)

    x, _, keys = kern._tensors(full)
    shares = branch_shares(kern.model, x, graphs_for(kern.banks, keys,
                                                     kern.model.sources))
    require(min(min(sh) for sh in shares) > LIVE_SHARE,
            f"a dead branch at init (non-zero shares per branch, pre-head "
            f"and head: {shares}): the gradient checks would be vacuous")
    require(tcfg.loss == "MSE", "the float64 reference computes MSE")
    ref64 = copy.deepcopy(plain.model).double()

    def grads(model, tr, batch, f64):
        """(loss, {name: grad}, the last ReLU's mask per branch) of the
        masked batch loss."""
        model.zero_grad(set_to_none=True)
        xb, yb, kb = tr._tensors(batch)
        if f64:
            g = [tuple(t.double() for t in G) if isinstance(G, tuple)
                 else G.double()
                 for G in graphs_for(tr.banks, kb, model.sources)]
            xb, yb = xb.double(), yb.double()
        else:
            g = graphs_for(tr.banks, kb, model.sources)
        pred, hidden = model(xb, g, return_hidden=True, inference=False)
        per = tr_loss(pred, yb).reshape(len(pred), -1).mean(1)
        mask = (torch.arange(len(pred), device=dev) < batch.size).to(
            per.dtype)
        loss = (per * mask).sum() / batch.size
        loss.backward()
        out = {n: p.grad.detach().clone() for n, p in
               model.named_parameters()}
        model.zero_grad(set_to_none=True)
        return (float(loss.detach()), out,
                [h.detach()[:batch.size] > 0 for h in hidden])

    def tr_loss(pred, y):
        """The trainer's MSE, with the residual kept in float64 for the
        reference (elementwise_loss upcasts to f32 only)."""
        if pred.dtype == torch.float64:
            return (pred - y) ** 2
        return elementwise_loss("MSE", pred, y)

    for label, batch in (("full batch", full),
                         ("padded batch (size 3 of 4)", partial)):
        lk, gk, mk = grads(kern.model, kern, batch, False)
        lp, gp, mp = grads(plain.model, plain, batch, False)
        l64, g64, m64 = grads(ref64, plain, batch, True)
        zero = [n for n, g in g64.items() if not bool(g.any())]
        require(not zero, f"{label}: all-zero float64 gradients {zero}: "
                          f"their comparison would be vacuous")
        flips = {arm: sum(int((a != b).sum()) for a, b in zip(m, m64))
                 for arm, m in (("kernel", mk), ("plain", mp))}
        worst = {}
        for arm, loss, got, ref in (("kernel vs f64", lk, gk, g64),
                                    ("plain vs f64", lp, gp, g64),
                                    ("kernel vs plain", lk, gk, gp)):
            require(abs(loss - float(l64)) <= GRAD_RTOL * abs(l64),
                    f"{label}: loss {loss} vs {l64} ({arm})")
            worst[arm] = (0.0, "")
            for name, r in ref.items():
                r = r.to(got[name].dtype)
                scale = float(r.abs().max())
                err = float((got[name] - r).abs().max())
                worst[arm] = max(worst[arm],
                                 (err / scale if scale else err, name))
                require(torch.allclose(got[name], r, rtol=GRAD_RTOL,
                                       atol=GRAD_ATOL_SCALE * scale),
                        f"{label}: the gradient of {name} differs "
                        f"({arm}: max abs err {err:.3e}, max |g| "
                        f"{scale:.3e})")
        print(f"[train] {label}: loss {lk:.7f} (plain arms {lp:.7f}, "
              f"float64 {l64:.7f}); all {len(gp)} parameter gradients "
              f"agree (rtol {GRAD_RTOL}, atol {GRAD_ATOL_SCALE} x max|g|); "
              f"worst max_abs_err / max|g|: "
              + ", ".join(f"{k} {v:.3e} ({n})" for k, (v, n) in
                          worst.items())
              + f"; last-ReLU entries on the other side of zero than in "
                f"float64: kernel {flips['kernel']}, plain "
                f"{flips['plain']} of {sum(m.numel() for m in m64)}; "
                f"no gradient all zero",
              flush=True)

    batches = list(kern.pipeline.batches("train", pad_to_full=True))
    curve = {"kernel": [], "plain": []}
    for i, batch in enumerate(batches[:20]):
        if i == 0:
            reset_counts()
        curve["kernel"].append(kern.train_step(batch))
        if i == 0:
            step = read_counts()
            require(step == _per_step(tcfg, True),
                    f"one training step launched {step}, expected "
                    f"{_per_step(tcfg, True)}")
            print(f"[train] one step's launches: "
                  f"{ {n: v for n, v in step.items() if v} }", flush=True)
        curve["plain"].append(plain.train_step(batch))
    reset_counts()
    kern.eval_step(full)
    step = read_counts()
    require(step == _per_step(tcfg, False),
            f"one validation step launched {step}, expected "
            f"{_per_step(tcfg, False)}")
    ck, cp = np.array(curve["kernel"]), np.array(curve["plain"])
    rel = float(np.max(np.abs(ck - cp) / np.abs(cp)))
    print(f"[train] first 20 step losses, kernel arms: "
          f"{[round(v, 6) for v in curve['kernel']]}; max relative "
          f"difference from the plain arms {rel:.3e} (rtol "
          f"{LOSS_CURVE_RTOL})", flush=True)
    require(np.all(np.isfinite(ck)) and rel <= LOSS_CURVE_RTOL,
            "the kernel arms' loss curve leaves the plain arms'")

    # the main path: a trainer with fresh seeded weights takes 3 epochs
    tr = ModelTrainer(tcfg, data, device=dev)
    init = {n: p.detach().clone() for n, p in tr.model.named_parameters()}
    reset_counts()
    t0 = time.perf_counter()
    hist = tr.train()
    train_counts = read_counts()
    train_s = time.perf_counter() - t0
    frozen = [n for n, p in tr.model.named_parameters()
              if torch.equal(p.detach(), init[n])]
    require(not frozen, f"parameters the training run never moved: "
                        f"{frozen}")
    steps = tr.global_step
    evals = len(hist["validate"]) * tr.pipeline.num_batches("validate")
    require(steps == tcfg.num_epochs * tr.pipeline.num_batches("train"),
            f"{steps} training steps in {tcfg.num_epochs} epochs")
    expect = _add(_scaled(_per_step(tcfg, True), steps),
                  _scaled(_per_step(tcfg, False), evals))
    require(train_counts == expect,
            f"the training run launched {train_counts}, expected {expect}")
    print(f"[train] {tcfg.num_epochs} epochs ({steps} steps, {evals} "
          f"validation steps) in {train_s:.1f}s; train losses "
          f"{hist['train']}, validation losses {hist['validate']}; "
          f"launches {train_counts}", flush=True)
    require(all(np.isfinite(hist["train"] + hist["validate"])),
            "non-finite epoch loss")
    require(hist["train"][-1] < hist["train"][0],
            "the epoch-3 train loss is not below epoch 1's")
    ckpt_path = os.path.join(out_dir, "MPGCN_od.pkl")
    ckpt = read_checkpoint(ckpt_path)
    require(ckpt["epoch"] == tr.best_epoch >= 1,
            f"checkpoint epoch {ckpt['epoch']}, best epoch {tr.best_epoch}")

    # test mode: a fresh trainer reloads the checkpoint, rolls out 7 steps
    test_cfg = cfg.replace(pred_len=7, mode="test", output_dir=out_dir)
    tt = ModelTrainer(test_cfg, data, device=dev)
    reset_counts()
    res = tt.test()
    test_counts = read_counts()
    n_batches = sum(tt.pipeline.num_batches(m) for m in ("train", "test"))
    expect = _scaled(_per_step(test_cfg, False), 7 * n_batches)
    require(test_counts == expect,
            f"test mode launched {test_counts}, expected {expect}")
    with open(os.path.join(out_dir, "MPGCN_prediction_scores.txt")) as f:
        lines = [line.strip() for line in f]
    print(f"[train] test mode reloaded epoch {ckpt['epoch']}: " + " | ".join(
        lines), flush=True)
    require([line.split(", ")[0] for line in lines] == ["train", "test"],
            f"score file lines {lines}")
    require(all(np.isfinite([float(v) for v in line.split(", ")[5:]]).all()
                for line in lines), "non-finite scores")
    require(len(res["test"]["RMSE_by_horizon"]) == 7, "no 7-step scores")
    mt = tt.pipeline.modes["test"]
    preds = tt.predict(mt.x[:8], mt.keys[:8])
    nonzero = float((preds != 0).mean())
    n = tt.cfg.num_nodes
    require(preds.shape == (8, 7, n, n, 1) and np.isfinite(preds).all(),
            f"test-mode predictions {preds.shape}")
    require(nonzero > 0.1, f"only {nonzero:.3f} of the outputs non-zero")
    print(f"[train] test-mode predictions: finite, {nonzero:.3f} non-zero",
          flush=True)
    return dict(train_counts=train_counts, test_counts=test_counts,
                trainer=tr, plain=plain, batches=batches)


def phase_train_times(dev, kin, train):
    """The training kernels' times at the training shapes (CUDA events),
    beside their bounds, plain versions and one PyTorch library call; the
    train step on the host clock; the device's busy share over 5 steps."""
    import statistics

    import torch

    from mpgcn_tpu_torch.nn import cuda_bdgcn, cuda_lstm

    times = {}
    xp, w, hs, cs, dhs = kin["lstm"]
    T, R, G = xp.shape
    H = G // 4
    lib = torch.nn.LSTM(1, H, batch_first=True).to(dev)
    seq = torch.randn((R, T, 1), device=dev, requires_grad=True)
    lib_fwd = time_ms(lambda: lib(seq), iters=20)
    out, _ = lib(seq)
    gout = torch.randn_like(out)
    lib_params = [seq, *lib.parameters()]
    lib_bwd = time_ms(lambda: torch.autograd.grad(out, lib_params, gout,
                                                  retain_graph=True),
                      iters=20)
    P = cuda_lstm.bwd_blocks(R, H, dev)
    dxp = torch.empty_like(xp)
    part = torch.empty((P, H, G), dtype=torch.float32, device=dev)
    b_ms, b_by = bound(4 * (T * R * G + H * G + 2 * T * R * H),
                       2 * T * R * H * G)
    times["lstm_train_fwd"] = dict(
        ms=time_ms(lambda: cuda_lstm.lstm_layer_train(xp, w)),
        plain_ms=time_ms(lambda: cuda_lstm.lstm_layer_train_plain(xp, w),
                         iters=10),
        library_ms=lib_fwd, bound_ms=b_ms, bound_by=b_by)
    # x_proj, hs, cs, dhs and w read once; dx_proj and dW written once (the
    # model path hands no dcs); 3x the forward's recurrent products
    b_ms, b_by = bound(4 * (2 * T * R * G + 3 * T * R * H + 2 * H * G),
                       3 * 2 * T * R * H * G)
    times["lstm_train_bwd"] = dict(
        ms=time_ms(lambda: cuda_lstm.LSTM_TRAIN_BWD.launch(
            (xp, w, hs, cs, dhs, None, dxp, part), (T, R, H, P))),
        plain_ms=time_ms(lambda: cuda_lstm.lstm_layer_bwd_plain(
            xp, w, hs, cs, dhs, None), iters=10),
        library_ms=lib_bwd, bound_ms=b_ms, bound_by=b_by)
    print(f"[time] K-LSTM-train backward wrapper (BPTT + dW reduction + "
          f"allocations): "
          f"{time_ms(lambda: cuda_lstm.lstm_layer_bwd(xp, w, hs, cs, dhs, None)):.4f}"
          f" ms; library calls: torch.nn.LSTM (cuDNN, input projection "
          f"included) forward and backward at R={R}, T={T}, H={H}")

    # the shared reduction at both of its shapes; the kernels line keeps
    # the LSTM's (the larger: 264 x 4,096 partials against 30 x 9,216)
    for key in ("dw_reduce_bdgcn", "dw_reduce"):
        prt = kin[key]
        Pn, n = prt.shape
        red = torch.empty((n,), dtype=torch.float32, device=dev)
        b_ms, b_by = bound(4 * (Pn * n + n), Pn * n)
        times["dw_reduce"] = dict(
            ms=time_ms(lambda: cuda_lstm.DW_REDUCE.launch((prt, red),
                                                          (Pn, n))),
            plain_ms=time_ms(lambda: cuda_lstm.dw_reduce_plain(prt),
                             iters=10),
            library_ms=time_ms(lambda: torch.sum(prt, 0)),
            bound_ms=b_ms, bound_by=b_by)
        print(f"[time] dw_reduce P={Pn} n={n}: "
              f"{json.dumps(times['dw_reduce'])}")

    for key, eq in (("bdgcn", "obmcl,dce,odlh->bmeh"),
                    ("bdgcn_dynamic", "obmcl,bdce,odlh->bmeh")):
        h1, g, wr, dout = kin[key]
        K, B, M, N, C = h1.shape
        Hh = wr.shape[-1]
        P = cuda_bdgcn.bwd_blocks(B * M * N, K, dev)
        dh1 = torch.empty_like(h1)
        z = torch.empty((K, B, M, N, Hh), dtype=torch.float32, device=dev)
        prt = torch.empty((P, K, K, C, Hh), dtype=torch.float32, device=dev)
        # least work: Z_d = G_d dout (K N H per (b,m,c)), dh1 = sum_d Z_d
        # Wr^T and dW = sum h1^T Z_d (K^2 C H each per (b,m,c))
        b_ms, b_by = bound(
            4 * (2 * h1.numel() + dout.numel() + g.numel()
                 + 2 * wr.numel()),
            2 * B * M * N * (K * N * Hh + 2 * K * K * C * Hh))
        h1r = h1.clone().requires_grad_()
        wrr = wr.clone().requires_grad_()
        ref = torch.einsum(eq, h1r, g[0] if key == "bdgcn" else g, wrr)
        entry = dict(
            ms=time_ms(lambda: cuda_bdgcn.BDGCN_PAIR_BWD.launch(
                (h1, g, wr, dout, dh1, z, prt),
                (K, B, M, N, C, Hh, g.shape[0], P))),
            plain_ms=time_ms(lambda: cuda_bdgcn.folded_pair_project_bwd_plain(
                h1, g, wr, dout), iters=10),
            library_ms=time_ms(lambda: torch.autograd.grad(
                ref, (h1r, wrr), dout, retain_graph=True), iters=10),
            bound_ms=b_ms, bound_by=b_by)
        label = "static" if key == "bdgcn" else "dynamic"
        print(f"[time] K-BDGCN-bwd {label} B={B} N={N}: {json.dumps(entry)}")
        if key == "bdgcn":
            times["bdgcn_pair_bwd"] = entry
    for name in ("lstm_train_fwd", "lstm_train_bwd"):
        print(f"[time] {name}: {json.dumps(times[name])}")

    batches = train["batches"]

    def step_ms(trainer, warmup=5, n=20):
        samples = []
        for i in range(warmup + n):
            batch = batches[i % len(batches)]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            trainer.train_step(batch)
            torch.cuda.synchronize()
            if i >= warmup:
                samples.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(samples), samples

    k_ms, k_samples = step_ms(train["trainer"])
    p_ms, _ = step_ms(train["plain"])
    print(f"[time] train step (batch 4, N=47, M=2, host clock around a "
          f"synchronised step, median of 20 after 5 warm-ups): kernel arms "
          f"{k_ms:.3f} ms ({1e3 / k_ms:.1f} steps/s; min "
          f"{min(k_samples):.3f}, max {max(k_samples):.3f}); plain arms "
          f"{p_ms:.3f} ms")
    busy_share("train step", lambda: train["trainer"].train_step(
        batches[0]), 5)
    return times


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False -- this "
              "smoke run needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import mpgcn_tpu_torch

    require(os.path.dirname(os.path.dirname(os.path.abspath(
        mpgcn_tpu_torch.__file__))) == HERE,
        "mpgcn_tpu_torch must come from this checkout")
    from mpgcn_tpu_torch.config import MPGCNConfig
    from mpgcn_tpu_torch.data.loader import synthetic_dataset

    # full f32 on the plain paths: no TF32 in matmuls or cuDNN
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()
    print(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}",
          flush=True)

    phase_build()
    rng = np.random.default_rng(0)
    errors, kernel_inputs = phase_kernels(dev, rng)
    train_errors, train_inputs = phase_train_kernels(dev, rng)
    errors.update(train_errors)

    cfg = MPGCNConfig()  # reference widths: N=47, hidden 32, M=2, K=3
    data = synthetic_dataset(cfg)
    # every phase draws its fresh weights from a seed that leaves no branch
    # dead; the data stays the seed-0 series
    cfg = cfg.replace(seed=live_init_seed(cfg, data, dev))
    eng, launches = serve_phase(
        "1-layer", cfg, data, dev, groups=(1, 2, 3, 4, 5, 8, 8),
        expect_per_batch={"lstm_infer_last": 14, "lstm_infer_collect": 0,
                          "bdgcn_pair_fwd": 42},
        expect_buckets=(1, 2, 4, 8))
    eng2, launches2 = serve_phase(
        "2-layer", cfg.replace(lstm_num_layers=2), data, dev,
        groups=(8, 1), expect_per_batch={"lstm_infer_last": 14,
                                         "lstm_infer_collect": 14,
                                         "bdgcn_pair_fwd": 42},
        expect_buckets=(1, 8))
    eng2.drain()
    eng2.close()
    out_dir = os.path.join(HERE, "smoke_out", "train")
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    train = phase_train(dev, cfg, data, out_dir)
    total = launches
    for counts in (launches2, train["train_counts"], train["test_counts"]):
        total = _add(total, counts)

    times = phase_times(dev, eng, kernel_inputs)
    times.update(phase_train_times(dev, train_inputs, train))
    eng.drain()
    eng.close()

    smi = shutil.which("nvidia-smi")
    require(smi is not None, "nvidia-smi not found")
    card = subprocess.run(
        [smi, "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True
    ).stdout.strip().splitlines()[0]
    print(card)  # the card's name and power limit, as nvidia-smi gives them
    print(f"[done] smoke run took {time.perf_counter() - t_start:.1f}s")

    entries = []
    for name, (_, _, source, replaces) in KERNEL_META.items():
        require(total[name] > 0, f"{name} never launched on a main path")
        entries.append({"name": name, "route": "cuda",
                        "source": f"mpgcn_tpu_torch/csrc/{source}",
                        "replaces": replaces, "launches": total[name],
                        "max_abs_err": errors[name], **times[name]})
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
