#!/usr/bin/env python3
"""Data- and model-parallel training across the cards of one machine
against one card, through the command line.

    python3 parallel_cards.py [--devices N [N ...]] [--mp M] [--epochs 2]
                              [--seed 5]

Trains ``python -m mpgcn_tpu_torch.cli -data synthetic`` on one card,
then the same command with ``-devices N -mp M -consistency 1`` for each N
(NCCL, one rank a card, an (N / M, M) mesh whose model axis shards the
origin nodes over M ranks; steps by graph, the collectives inside the
graphs; default N: every visible card, M: 1), and each checkpoint's test
mode, at the reference widths; prints each run's steps/sec, the epoch
losses' and test scores' largest relative difference, the
``consistency_ok`` epochs and the checkpoint manifest, and, last, one JSON
object of them. Exits non-zero when fewer than 2 cards are visible, a run
fails, a replica check is missing, or a difference passes 1e-5. Needs the
cards; imports nothing of JAX. Output goes under
``smoke_out/parallel_cards/``.
"""

import argparse
import json
import os
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))


def _run(argv, log):
    with open(log, "w") as f:
        proc = subprocess.run([sys.executable, "-m", "mpgcn_tpu_torch.cli",
                               *argv], cwd=HERE, stdout=f,
                              stderr=subprocess.STDOUT, timeout=900,
                              env=dict(os.environ, PYTHONPATH=HERE))
    with open(log) as f:
        out = f.read()
    if proc.returncode:
        raise SystemExit(f"{argv} exited {proc.returncode}: {out[-3000:]}")
    return out


def _scores(d):
    with open(os.path.join(d, "MPGCN_prediction_scores.txt")) as f:
        return [[float(v) for v in line.split(",")[5:]]
                for line in f.read().splitlines()]


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--devices", type=int, nargs="+", default=None)
    ap.add_argument("--mp", type=int, default=1)
    ap.add_argument("--epochs", type=int, default=2)
    ap.add_argument("--seed", type=int, default=5)
    args = ap.parse_args()
    worlds = args.devices or [torch.cuda.device_count()]
    if min(worlds) < 2 or max(worlds) > torch.cuda.device_count():
        print(f"parallel_cards: {torch.cuda.device_count()} card(s) "
              f"visible; needs 2 or more, and {max(worlds)} for the "
              f"largest world", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from mpgcn_tpu_torch.train.checkpoint import load_checkpoint
    from mpgcn_tpu_torch.utils.logging import read_events

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    root = os.path.join(HERE, "smoke_out", "parallel_cards")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    base = ["-data", "synthetic", "-seed", str(args.seed)]
    # one card first: its process builds the kernel libraries, so none
    # is built inside a timed window of the ranks
    runs = {"one": []}
    for n in worlds:
        runs[f"dp{n}"] = ["-devices", str(n), "-mp", str(args.mp)]
    sps, events = {}, {}
    for name, extra in runs.items():
        out = os.path.join(root, name)
        check = ["-consistency", "1"] if extra else []
        printed = _run(base + extra + check + ["-epoch", str(args.epochs),
                                               "-out", out],
                       out + "_train.log")
        sps[name] = float([x for x in printed.splitlines()
                           if x.startswith("steps/sec: ")][-1].split()[-1])
        _run(base + extra + ["-mode", "test", "-out", out], out + "_test.log")
        events[name] = read_events(os.path.join(out,
                                                "MPGCN_train_log.jsonl"))
    epochs = {k: [e for e in v if e["event"] == "epoch"]
              for k, v in events.items()}
    found, ok = {"card": card, "mp": args.mp, "worlds": {}}, True
    for n in worlds:
        name = f"dp{n}"
        loss_err = max(abs(a[k] - b[k]) / abs(b[k])
                       for a, b in zip(epochs[name], epochs["one"])
                       for k in ("train_loss", "validate_loss"))
        score_err = max(abs(a - b) / abs(b) for ra, rb in zip(
            _scores(os.path.join(root, name)),
            _scores(os.path.join(root, "one"))) for a, b in zip(ra, rb))
        # the last attempt's checks (a dead init's retry starts again)
        starts = [i for i, e in enumerate(events[name])
                  if e["event"] == "train_start"]
        checked = [e["epoch"] for e in events[name][starts[-1]:]
                   if e["event"] == "consistency_ok"]
        manifest = load_checkpoint(os.path.join(
            root, name, "MPGCN_od_last.pkl"))["manifest"]
        world = {"devices": n, "steps_per_sec": sps[name],
                 "loss_rel_err": loss_err, "score_rel_err": score_err,
                 "consistency_ok_epochs": checked,
                 "manifest": {k: manifest[k] for k in
                              ("process_count", "device_count", "mesh")}}
        found["worlds"][name] = world
        print(f"[parallel-cards] {n} NCCL ranks at -mp {args.mp} by graph "
              f"against one card ({card}): steps/sec {sps[name]:.2f} "
              f"against {sps['one']:.2f}; epoch losses within "
              f"{loss_err:.3g}, test scores within {score_err:.3g} "
              f"(relative); consistency_ok epochs {checked}; manifest "
              f"{world['manifest']}", flush=True)
        ok = (ok and checked == list(range(1, args.epochs + 1))
              and loss_err <= 1e-5 and score_err <= 1e-5
              and manifest["process_count"] == n
              and manifest["mesh"] == {"data": n // args.mp,
                                       "model": args.mp})
    found["steps_per_sec_one"] = sps["one"]
    print(json.dumps(found))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
