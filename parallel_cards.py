#!/usr/bin/env python3
"""Data-parallel training across the cards of one machine against one
card, through the command line.

    python3 parallel_cards.py [--devices N] [--epochs 2] [--seed 5]

Trains ``python -m mpgcn_tpu_torch.cli -data synthetic`` on one card,
then the same command with ``-devices N -consistency 1`` (NCCL, one rank
a card, steps by graph; default N: every visible card), and each
checkpoint's test mode, at the reference widths; prints each run's
steps/sec, the epoch losses' and test scores' largest relative
difference, the ``consistency_ok`` epochs and the checkpoint manifest,
and, last, one JSON object of them. Exits non-zero when fewer than 2 cards are visible,
a run fails, a replica check is missing, or a difference passes 1e-5.
Needs the cards; imports nothing of JAX. Output goes under
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
    ap.add_argument("--devices", type=int, default=None)
    ap.add_argument("--epochs", type=int, default=2)
    ap.add_argument("--seed", type=int, default=5)
    args = ap.parse_args()
    n = args.devices or torch.cuda.device_count()
    if n < 2:
        print(f"parallel_cards: {n} card(s) visible; needs 2 or more",
              file=sys.stderr)
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
    runs = {"one": [], "dp": ["-devices", str(n), "-consistency", "1"]}
    sps, events = {}, {}
    for name, extra in runs.items():
        out = os.path.join(root, name)
        printed = _run(base + extra + ["-epoch", str(args.epochs), "-out",
                                       out], out + "_train.log")
        sps[name] = float([x for x in printed.splitlines()
                           if x.startswith("steps/sec: ")][-1].split()[-1])
        _run(base + extra[:2] + ["-mode", "test", "-out", out],
             out + "_test.log")
        events[name] = read_events(os.path.join(out,
                                                "MPGCN_train_log.jsonl"))
    epochs = {k: [e for e in v if e["event"] == "epoch"]
              for k, v in events.items()}
    loss_err = max(abs(a[k] - b[k]) / abs(b[k])
                   for a, b in zip(epochs["dp"], epochs["one"])
                   for k in ("train_loss", "validate_loss"))
    score_err = max(abs(a - b) / abs(b) for ra, rb in zip(
        _scores(os.path.join(root, "dp")), _scores(os.path.join(root, "one")))
        for a, b in zip(ra, rb))
    # the last attempt's checks (a dead init's retry starts again)
    starts = [i for i, e in enumerate(events["dp"])
              if e["event"] == "train_start"]
    checked = [e["epoch"] for e in events["dp"][starts[-1]:]
               if e["event"] == "consistency_ok"]
    manifest = load_checkpoint(os.path.join(
        root, "dp", "MPGCN_od_last.pkl"))["manifest"]
    found = {"card": card, "devices": n, "steps_per_sec": sps,
             "loss_rel_err": loss_err, "score_rel_err": score_err,
             "consistency_ok_epochs": checked,
             "manifest": {k: manifest[k] for k in
                          ("process_count", "device_count", "mesh")}}
    print(f"[parallel-cards] {n} NCCL ranks by graph against one card "
          f"({card}): steps/sec {sps['dp']:.2f} against {sps['one']:.2f}; "
          f"epoch losses within {loss_err:.3g}, test scores within "
          f"{score_err:.3g} (relative); consistency_ok epochs {checked}; "
          f"manifest {found['manifest']}", flush=True)
    print(json.dumps(found))
    ok = (checked == list(range(1, args.epochs + 1)) and loss_err <= 1e-5
          and score_err <= 1e-5 and manifest["process_count"] == n)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
