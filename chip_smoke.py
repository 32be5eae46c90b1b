#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. build every kernel of mpgcn_tpu_torch/csrc/ with nvcc for sm_90a and
     print the ptxas register / shared-memory / spill report;
  2. hold each kernel against its plain PyTorch version on the card, at
     the shapes the serve path gives it;
  3. serve: a ServeEngine on the card (synthetic data, seed 0, fresh seeded
     weights at the reference widths) answers test-split windows in every
     bucket (1, 2, 4, 8); the predictions must be finite, match the same
     weights' plain rollout on the card, and the kernels' launch counts
     must rise by exactly the expected numbers. Then once more with a
     2-layer LSTM, which puts the collect kernel on the path;
  4. time each kernel beside its bound, its plain version and one PyTorch
     library call, the rollout per bucket, and the device's busy share.

The second-to-last line is a JSON object listing each kernel; the last
line is {"ok": true, "device": {...}}. Exits non-zero without a card, and
when run from a directory that holds no mpgcn_tpu_torch package.
"""

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

    err = float((out - ref).abs().max())
    rel = float(((out - ref).abs() / ref.abs().clamp(min=1e-6)).max())
    ok = torch.allclose(out, ref, **tol)
    print(f"[check] {name}: max_abs_err={err:.3e} max_rel_err={rel:.3e} "
          f"tolerance rtol={tol['rtol']} atol={tol['atol']} "
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


def serve_phase(label, cfg, data, dev, groups, expect_per_batch,
                expect_buckets):
    """Drive a ServeEngine through `groups` of concurrent requests; check
    the buckets dispatched, finiteness, agreement with the plain rollout
    and the launch counts. Returns (engine, launches)."""
    import torch

    from mpgcn_tpu_torch.config import ServeConfig
    from mpgcn_tpu_torch.nn.mpgcn import MPGCN
    from mpgcn_tpu_torch.service.serve import KERNELS, ServeEngine
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

    for k in KERNELS.values():  # count only the main path's launches
        k.launches = 0
    tickets, i = [], 0
    for size in groups:
        batch = [eng.submit(x[j, ..., 0], int(keys[j]))
                 for j in range(i, i + size)]
        for t in batch:
            require(t.wait(120), "request not answered in 120 s")
        tickets += batch
        i += size
    torch.cuda.synchronize()
    launches = {name: k.launches for name, k in KERNELS.items()}
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
          f"{ {k: v / batches for k, v in launches.items()} }", flush=True)
    require(nonzero > 0.1, "dead ReLU head: comparisons would be vacuous")

    plain = MPGCN.from_config(eng.cfg, device=dev, lstm_impl="plain",
                              bdgcn_impl="einsum").eval()
    plain.load_state_dict(eng.model.state_dict())
    xt = torch.from_numpy(x).to(dev)
    kt = torch.from_numpy(keys.astype(np.int64)).to(dev)
    compare(f"serve:{label} rollout vs plain rollout", preds,
            rollout(plain, eng.banks, xt, kt, cfg.pred_len), ROLLOUT_TOL)
    graphs = graphs_for(eng.banks, kt, eng.model.sources)
    _, hk = eng.model(xt, graphs, return_hidden=True)
    _, hp = plain(xt, graphs, return_hidden=True)
    for m, (a, b) in enumerate(zip(hk, hp)):
        compare(f"serve:{label} branch {m} pre-head BDGCN output", a, b,
                ROLLOUT_TOL)
    return eng, launches


def busy_share(eng, md, b, dev):
    """Device busy share over 3 rollouts of bucket `b` (torch.profiler):
    device-side activity time over host wall time. Prints "not measured"
    when the profiler records no device activity."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from mpgcn_tpu_torch.train.predict import rollout

    x = torch.from_numpy(np.array(md.x[:b])).to(dev)
    k = torch.from_numpy(md.keys[:b].astype(np.int64)).to(dev)
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(3):
                rollout(eng.model, eng.banks, x, k, eng.cfg.pred_len)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
    except RuntimeError as e:
        print(f"[time] bucket-{b} device busy share: not measured ({e})")
        return
    # device-side activities only (kernels, copies, sets): the CPU ops
    # that launched them also carry device time in key_averages(), so
    # summing those would count each kernel twice
    per_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            acc = per_name.setdefault(e.name, [0.0, 0])
            acc[0] += e.time_range.elapsed_us()
            acc[1] += 1
    dev_us = sum(v[0] for v in per_name.values())
    if dev_us <= 0:
        print(f"[time] bucket-{b} device busy share: not measured (the "
              f"profiler recorded no device activity)")
        return
    n_dev = sum(v[1] for v in per_name.values())
    print(f"[time] bucket-{b} device busy share over 3 rollouts "
          f"(torch.profiler): {dev_us / wall_us:.4f} ({dev_us:.0f} us of "
          f"device activity in {wall_us:.0f} us; {n_dev / 3:.0f} device "
          f"activities per rollout)")
    top = sorted(per_name.items(), key=lambda kv: -kv[1][0])
    for name, (us, count) in top[:8]:
        print(f"[time]   {name[:60]:60s} {us:10.0f} us x{count}")


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
        busy_share(eng, md, b, dev)
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
    errors, kernel_inputs = phase_kernels(dev, np.random.default_rng(0))

    cfg = MPGCNConfig()  # reference widths: N=47, hidden 32, M=2, K=3
    data = synthetic_dataset(cfg)
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
    total = {k: launches[k] + launches2[k] for k in launches}

    times = phase_times(dev, eng, kernel_inputs)
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

    pkg = "mpgcn_tpu_torch/csrc"
    meta = {
        "lstm_infer_last": (f"{pkg}/lstm_infer.cu",
                            "mpgcn_tpu/nn/pallas_lstm.py:380"),
        "lstm_infer_collect": (f"{pkg}/lstm_infer.cu",
                               "mpgcn_tpu/nn/pallas_lstm.py:367"),
        "bdgcn_pair_fwd": (f"{pkg}/bdgcn_pair_fwd.cu",
                           "mpgcn_tpu/nn/pallas_bdgcn.py:205"),
    }
    kernels = []
    for name, (source, replaces) in meta.items():
        require(total[name] > 0, f"{name} never launched on the serve path")
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": total[name],
                        "max_abs_err": errors[name], **times[name]})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
