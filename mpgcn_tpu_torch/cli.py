"""Command-line entry point of the port (counterpart of the train/test flow
of mpgcn_tpu/cli.py; reference Main.py:7-67).

    python -m mpgcn_tpu_torch.cli -mode train -epoch 200 -out ./output
    python -m mpgcn_tpu_torch.cli -mode test -out ./output

Runs on the card (``-GPU 0``, the default) unless ``-GPU cpu`` asks for the
CPU. Train mode trains the single-step model (pred_len is forced to 1, as
in the reference, Main.py:44-45); test mode reloads ``<out>/MPGCN_od.pkl``
and rolls out ``-pred`` steps. The data is the seeded synthetic OD series
(``-data synthetic``). ``-kernel`` and ``-K`` pick the graph kernel and
its order, and so the support count (2 K + 1 supports for
``dual_random_walk_diffusion``). ``-bdgcn`` picks the BDGCN arm: ``auto``
(the default) measures the support banks' density and takes the
blocked-ELL arm at or below ``-sparse-threshold`` when N >=
``-sparse-min-nodes``, else the dense kernel arm.
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
    p.add_argument("-kernel", "--kernel_type", type=str,
                   choices=["chebyshev", "localpool", "random_walk_diffusion",
                            "dual_random_walk_diffusion"],
                   default="random_walk_diffusion")
    p.add_argument("-K", "--cheby_order", type=int, default=2)
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
    p.add_argument("-bdgcn", "--bdgcn_impl", type=str,
                   choices=["auto", "kernel", "einsum", "ell"],
                   default="auto",
                   help="BDGCN arm: kernel = the dense hand-written kernel, "
                        "einsum = the plain reference-shaped einsums, ell = "
                        "ELL SpMM over blocked-ELL support containers; auto "
                        "measures support density and picks ell at/below "
                        "-sparse-threshold with N >= -sparse-min-nodes, "
                        "else kernel")
    p.add_argument("-support-payload", "--support_payload", type=str,
                   choices=["f32", "bf16", "int8"], default="f32",
                   help="value payload of the blocked-ELL support tiles: "
                        "bf16 halves their bytes; int8 stores codes + one "
                        "scale per row block, dequantised at the kernels' "
                        "operand read (needs the ell arm)")
    p.add_argument("-sparse-threshold", "--sparse_density_threshold",
                   type=float, default=None,
                   help="support-bank density at or below which "
                        "-bdgcn auto goes sparse (default 0.25)")
    p.add_argument("-sparse-min-nodes", "--sparse_min_nodes", type=int,
                   default=None,
                   help="-bdgcn auto never picks the sparse arm below this "
                        "node count (default 256)")
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
    bdgcn_impl = args.pop("bdgcn_impl")
    for knob in ("sparse_density_threshold", "sparse_min_nodes"):
        if args[knob] is None:  # not given: the config default stands
            args.pop(knob)
    if args["mode"] == "train":
        args["pred_len"] = 1  # train the single-step model (Main.py:44-45)
    cfg = MPGCNConfig(**args)
    trainer = ModelTrainer(cfg, synthetic_dataset(cfg), device=device,
                           bdgcn_impl=bdgcn_impl)
    if cfg.mode == "train":
        return trainer.train()
    return trainer.test()


if __name__ == "__main__":
    main()
