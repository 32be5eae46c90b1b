#!/usr/bin/env python3
"""Time the N=500 train step on int8 tiles of a checkout of the PyTorch
port, through the phases of the chip_smoke.py beside this script: its
large-N data, live init seed, one-epoch training phase and int8 step timer
(phase_large_n_int8_times), with mpgcn_tpu_torch imported from CHECKOUT.
So a checkout whose own chip_smoke.py does not time that step is timed the
same way as one whose does, in one run on one card.

    python3 n500_int8_step.py [--root CHECKOUT]

CHECKOUT defaults to the directory of this script. Writes the training
phase's checkpoint under CHECKOUT/smoke_out/int8_step. Needs a CUDA card;
imports nothing of JAX.
"""

import argparse
import importlib.util
import os
import shutil
import sys

HERE = os.path.dirname(os.path.abspath(__file__))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE)
    root = os.path.abspath(ap.parse_args().root)
    sys.path.insert(0, root)
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    import torch

    if not torch.cuda.is_available():
        print("n500_int8_step: needs a CUDA card", file=sys.stderr)
        return 2
    import mpgcn_tpu_torch
    from mpgcn_tpu_torch.config import MPGCNConfig

    smoke.require(os.path.dirname(os.path.dirname(os.path.abspath(
        mpgcn_tpu_torch.__file__))) == root,
        f"mpgcn_tpu_torch must come from {root}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    print(f"[int8 step] mpgcn_tpu_torch from {root}", flush=True)
    cfg = MPGCNConfig(**smoke.LARGE_N)
    data = smoke.large_n_data(cfg)
    cfg = cfg.replace(seed=smoke.live_init_seed(cfg, data, dev))
    out = os.path.join(root, "smoke_out", "int8_step")
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)
    train = smoke.phase_large_n_train(dev, cfg, data, out)
    smoke.phase_large_n_int8_times(dev, train, data)
    return 0


if __name__ == "__main__":
    sys.exit(main())
