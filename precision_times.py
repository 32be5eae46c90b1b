#!/usr/bin/env python3
"""Time two paths of a checkout of the PyTorch port at N=47 (the reference
widths, init seed 5, the seed-0 synthetic series), with mpgcn_tpu_torch
imported from CHECKOUT and the timers of the chip_smoke.py beside this
script:

  rollouts  the f32 serve engine's captured rollouts (horizon 7) at
            buckets 1 / 2 / 4 / 8, each replay fed inputs already on the
            card: host clock, median and min of 10 replays after 2, as
            chip_smoke.py's phase 12 times them, ROUNDS times over the
            buckets. Runs on any checkout whose serve engine captures its
            rollouts as CUDA graphs.
  step      the captured train step (pred 1, batch 4, after one epoch)
            in bf16 with the loss scaler on and off, each with the step
            sentinels on and off, and in f32 with the sentinels on: host
            clock, median of 20 replays after 5, ROUNDS times in turn.
            Needs a checkout with -dtype.

    python3 precision_times.py [--root CHECKOUT] [--what rollouts|step]
                               [--rounds R]

CHECKOUT defaults to the directory of this script. Prints one JSON line a
measurement, then the card's name and power limit. To compare two
checkouts, run this once per checkout in turn, alternating them, in one
call on one card. Needs a CUDA card; imports nothing of JAX.
"""

import argparse
import importlib.util
import json
import os
import shutil
import statistics
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
SEED = 5  # the reference widths' first live init seed (chip_smoke.py)


def rollouts(smoke, dev, cfg, data, rounds):
    import numpy as np
    import torch

    from mpgcn_tpu_torch.config import ServeConfig
    from mpgcn_tpu_torch.service.serve import ServeEngine

    scfg = ServeConfig(buckets=(1, 2, 4, 8), max_wait_ms=100.0,
                       deadline_ms=0.0)
    eng = ServeEngine(cfg, data, scfg, device=dev, allow_fresh=True)
    md = eng.pipeline.modes["test"]
    graphs, out = {}, {b: [] for b in scfg.buckets}
    for key, g in eng._rollouts.graphs.graphs.items():
        # (bucket, horizon) before the precision plane, then (.., "f32"),
        # then (slot, ..) with the serving plane's two parameter slots
        if len(key) == 4:
            if key[0] != eng._rollouts.slot:
                continue
            key = key[1:]
        if key[1] == 7 and key[2:] in ((), ("f32",)):
            graphs[key[0]] = g
    smoke.require(set(graphs) == set(scfg.buckets),
                  f"rollout graphs {list(eng._rollouts.graphs.graphs)}")
    inputs = {b: (torch.from_numpy(np.array(md.x[:b])).to(dev),
                  torch.from_numpy(md.keys[:b].astype(np.int64)).to(dev))
              for b in scfg.buckets}
    for r in range(rounds):
        for b in scfg.buckets:
            x, k = inputs[b]
            med, low = smoke._host_ms(lambda: graphs[b].replay(x, k))
            out[b].append((med, low))
    eng.drain()
    eng.close()
    for b, v in out.items():
        print(json.dumps({
            "what": "rollout_graph_ms", "bucket": b, "horizon": 7,
            "medians": [round(m, 4) for m, _ in v],
            "mins": [round(lo, 4) for _, lo in v],
            "median_of_medians": round(statistics.median(
                m for m, _ in v), 4)}), flush=True)


def steps(smoke, dev, cfg, data, rounds, out_dir):
    runs = {
        "bf16 scaler on, sentinels on": dict(dtype="bfloat16",
                                             loss_scaling="dynamic"),
        "bf16 scaler off, sentinels on": dict(dtype="bfloat16",
                                              loss_scaling="none"),
        "bf16 scaler on, sentinels off": dict(dtype="bfloat16",
                                              loss_scaling="dynamic",
                                              step_sentinels=False),
        "bf16 scaler off, sentinels off": dict(dtype="bfloat16",
                                               loss_scaling="none",
                                               step_sentinels=False),
        "f32, sentinels on": dict(dtype="float32"),
    }
    tcfg = cfg.replace(pred_len=1, num_epochs=1)
    trainers = {}
    for i, (label, kw) in enumerate(runs.items()):
        tr = smoke._heal_trainer(tcfg, data, dev, out_dir, f"run{i}", **kw)
        tr.train()
        smoke.require(smoke._captured(tr, "train"),
                      f"{label}: the step is not on a graph")
        smoke.require((tr.optimizer.scaler is not None)
                      == (kw.get("loss_scaling") == "dynamic"),
                      f"{label}: scaler {tr.optimizer.scaler}")
        trainers[label] = tr
    ms = {label: [] for label in runs}
    for r in range(rounds):
        for label, tr in trainers.items():
            ms[label].append(smoke._host_ms(smoke._train_steps(tr, 30),
                                            n=20, warmup=5)[0])
    for label, v in ms.items():
        print(json.dumps({
            "what": "train_step_graph_ms", "run": label,
            "medians": [round(m, 4) for m in v],
            "median_of_medians": round(statistics.median(v), 4)}),
            flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--what", choices=("rollouts", "step"),
                    default="rollouts")
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    import torch

    if not torch.cuda.is_available():
        print("precision_times: needs a CUDA card", file=sys.stderr)
        return 2
    import mpgcn_tpu_torch
    from mpgcn_tpu_torch.config import MPGCNConfig
    from mpgcn_tpu_torch.data.loader import synthetic_dataset

    smoke.require(os.path.dirname(os.path.dirname(os.path.abspath(
        mpgcn_tpu_torch.__file__))) == root,
        f"mpgcn_tpu_torch must come from {root}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    cfg = MPGCNConfig()
    data = synthetic_dataset(cfg)
    cfg = cfg.replace(seed=SEED)
    print(f"[precision_times] {args.what} of mpgcn_tpu_torch from {root}",
          flush=True)
    if args.what == "rollouts":
        rollouts(smoke, dev, cfg, data, args.rounds)
    else:
        out = os.path.join(root, "smoke_out", "precision_times")
        shutil.rmtree(out, ignore_errors=True)
        os.makedirs(out)
        steps(smoke, dev, cfg, data, args.rounds, out)
    print(smoke.card_name_and_limit(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
