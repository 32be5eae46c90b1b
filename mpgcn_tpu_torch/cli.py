"""Command-line entry point of the port (counterpart of the train/test flow
of mpgcn_tpu/cli.py; reference Main.py:7-67).

    python -m mpgcn_tpu_torch.cli -mode train -epoch 200 -out ./output
    python -m mpgcn_tpu_torch.cli -mode test -out ./output

Runs on the card (``-GPU 0``, the default) unless ``-GPU cpu`` asks for the
CPU. Train mode trains the single-step model (pred_len is forced to 1, as
in the reference, Main.py:44-45); test mode reloads ``<out>/MPGCN_od.pkl``
and rolls out ``-pred`` steps. The data is the seeded synthetic OD series
(``-data synthetic``).
"""

from __future__ import annotations

import argparse

from mpgcn_tpu_torch.config import MPGCNConfig
from mpgcn_tpu_torch.data.loader import synthetic_dataset


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Run OD Prediction.")
    p.add_argument("-GPU", "--GPU", type=str, default="0",
                   help="card index to run on (0 = cuda:0), or 'cpu'")
    p.add_argument("-out", "--output_dir", type=str, default="./output")
    p.add_argument("-obs", "--obs_len", type=int, default=7)
    p.add_argument("-pred", "--pred_len", type=int, default=7)
    p.add_argument("-batch", "--batch_size", type=int, default=4)
    p.add_argument("-hidden", "--hidden_dim", type=int, default=32)
    p.add_argument("-loss", "--loss", type=str,
                   choices=["MSE", "MAE", "Huber"], default="MSE")
    p.add_argument("-optim", "--optimizer", type=str, default="Adam")
    p.add_argument("-lr", "--learn_rate", type=float, default=1e-4)
    p.add_argument("-dr", "--decay_rate", type=float, default=0)
    p.add_argument("-epoch", "--num_epochs", type=int, default=200)
    p.add_argument("-mode", "--mode", type=str, choices=["train", "test"],
                   default="train")
    p.add_argument("-data", "--data", type=str, choices=["synthetic"],
                   default="synthetic")
    p.add_argument("-seed", "--seed", type=int, default=0)
    p.add_argument("-shuffle", "--shuffle", action="store_true")
    p.add_argument("-sN", "--synthetic_N", type=int, default=47)
    p.add_argument("-sT", "--synthetic_T", type=int, default=425)
    return p


def device_for(gpu: str) -> str:
    """The -GPU flag as a torch device name: 'cpu', or a card index."""
    if gpu == "cpu":
        return "cpu"
    if not gpu.isdigit():
        raise SystemExit(f"-GPU {gpu!r} is neither a card index nor 'cpu'")
    return f"cuda:{gpu}"


def main(argv=None):
    from mpgcn_tpu_torch.train.trainer import ModelTrainer

    args = build_parser().parse_args(argv).__dict__
    device = device_for(args.pop("GPU"))
    args.pop("data")
    if args["mode"] == "train":
        args["pred_len"] = 1  # train the single-step model (Main.py:44-45)
    cfg = MPGCNConfig(**args)
    trainer = ModelTrainer(cfg, synthetic_dataset(cfg), device=device)
    if cfg.mode == "train":
        return trainer.train()
    return trainer.test()


if __name__ == "__main__":
    main()
