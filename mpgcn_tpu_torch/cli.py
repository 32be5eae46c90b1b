"""Command-line entry point of the port (counterpart of the train/test flow
of mpgcn_tpu/cli.py; reference Main.py:7-67).

    python -m mpgcn_tpu_torch.cli -in ../data -mode train -epoch 200
    python -m mpgcn_tpu_torch.cli -in ../data -mode test
    python -m mpgcn_tpu_torch.cli serve -out ./service [--device cpu] ...
    python -m mpgcn_tpu_torch.cli fleet add|remove|list [TENANT] -out ROOT
    python -m mpgcn_tpu_torch.cli router -out ROOT [--replicas 2] -- ...
    python -m mpgcn_tpu_torch.cli daemon -spool SPOOL -out ROOT [--device cpu]
    python -m mpgcn_tpu_torch.cli supervise --procs 1 -- daemon ...
    python -m mpgcn_tpu_torch.cli stats -out ROOT [--trace ID] [--json]
    python -m mpgcn_tpu_torch.cli slo -out ROOT [--json]
    python -m mpgcn_tpu_torch.cli scenario list|gen|run ...
    python -m mpgcn_tpu_torch.cli tune run|buckets|show ...

``serve`` dispatches to the serving plane's command
(service/serve.py ``main``, the JAX ``mpgcn-tpu serve``): HTTP, canaried
hot reload of the promoted checkpoints, a clean drain on SIGTERM; with
``--fleet`` it serves every tenant of ``<out>/fleet/registry.json``.
``fleet`` edits that registry (service/registry.py ``main``, the JAX
``mpgcn-tpu fleet``). ``router`` runs the front tier over replica
processes of ``serve --fleet`` on that registry (service/router.py
``main``, the JAX ``mpgcn-tpu router``); the arguments after ``--`` go to
every replica. ``daemon`` runs the continual-learning loop
(service/daemon.py ``main``, the JAX ``mpgcn-tpu daemon``): day files
through the day gate, retrains on cadence or drift, eval-before-promote
into ``<out>/promoted/``. ``supervise`` runs the command after ``--`` as
a child and relaunches it with ``-resume`` when it dies
(resilience/supervisor.py ``main``, the JAX ``mpgcn-tpu supervise``, one
process). ``stats`` (obs/stats.py) and ``slo`` (obs/perf/slo_cli.py) read
a service root's ledgers, span log and live ``/v1/stats``; ``scenario``
(scenarios/cli.py) lists and generates the scenario profiles and runs
the federation (one daemon per profile into one fleet registry).
``tune`` (tune/cli.py, the JAX ``mpgcn-tpu tune``) measures the dispatch
crossovers on the card (``run``; ``--device cpu`` for the CPU), plans
serve's buckets from a request ledger (``buckets``) and prints the
registry (``show``); profiles are ``tuned/torch-cuda.json`` and
``tuned/torch-cpu.json`` (``$MPGCN_TUNED_DIR`` moves them). Every
``auto`` decision and serve's buckets and horizons resolve explicit flag
> tuned profile > guessed default; a tunable flag passed on the command
line (``-sparse-threshold``, ``-sparse-min-nodes``,
``-stream-chunk-mb``) is recorded in ``explicit_knobs``, so no profile
overrides it. The JAX CLI's ``perf`` and ``lint`` are not ported.

The operator flags: ``-trace DIR`` records the session in a
``torch.profiler`` window (utils/profiling.py ``trace_if``; CUDA activity
on the card) and writes its trace into DIR; ``-metrics-port P`` serves
the process registry's ``/metrics`` (obs/metrics.py ``MetricsServer``; 0
= ephemeral, printed) and runs the device sampler for the session;
``-no-obs`` turns the trainer's telemetry off (and the sidecars);
``-compile-cache DIR`` is the directory of the built kernel libraries
(obs/perf/compile_cache.py).

Data-parallel training (parallel/): ``-devices N`` (N > 1) launches N
ranks of this command (parallel/distributed.py ``launch_ranks``: the
world's environment, a rendezvous on a free loopback port), rank r on
``cuda:(GPU + r)`` over NCCL, or on the CPU over gloo under ``-GPU cpu``;
it waits, stops every rank as soon as one fails and exits with the first
nonzero code. A command started by torchrun (``WORLD_SIZE``, ``RANK``,
``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT`` in its environment) is
one rank itself, on ``cuda:(GPU + LOCAL_RANK)``: either way each rank
builds ``ParallelModelTrainer``, and rank 0 alone prints and writes.
``-devices 0|1`` trains on one device. ``-devices N -mp M`` lays the N
ranks out as an (N / M, M) mesh whose model axis shards every window's
origin nodes over M ranks (parallel/trainer.py); the mesh is checked
before any data is loaded, with the JAX CLI's messages. ``-consistency N``
digest-compares the ranks' replicas every N epochs; ``-ckpt orbax``
writes the port's directory checkpoint (train/checkpoint.py).

Runs on the card (``-GPU 0``, the default) unless ``-GPU cpu`` asks for the
CPU. Train mode trains the single-step model (pred_len is forced to 1, as
in the reference, Main.py:44-45) unless ``-multistep`` keeps ``-pred`` and
trains through the rollout; test mode reloads ``<out>/MPGCN_od.pkl`` and
rolls out ``-pred`` steps.

The data comes from ``-in`` (the reference's data directory: the OD npz,
``adjacency_matrix.npy`` and, for a 'poi' branch, a POI similarity or
feature file) under ``-data npz``, from the seeded synthetic generators
under ``-data synthetic`` (``-sN``, ``-sT``, ``-sprofile``), and under
``-data auto`` (the default) from the npz when it exists, else synthetic.
The model, data and optimizer flags (``-model -t -norm -split -nn -M
-lstm-layers -sources -lmax -clip -lrs -no-symnorm-clamp -iso -fix-dgraph
-io-retries``) and the self-healing trainer's (``-resume -multistep -accum
-dead-init -dead-init-retries -no-sentinels -skip-budget
-rollback-retries -rollback-lr-factor -watchdog``) and the precision flags
(``-dtype -loss-scaling -loss-scale-init -loss-scale-growth
-infer-precision``) and the city-scale feed's (``-fused-epilogue
-od-storage -no-stream -stream-chunk-mb -native``) and ``-faults`` (the
trainer's fault arms, resilience/faults.py) have the JAX CLI's names,
types, defaults and choices.
``-kernel`` and ``-K`` pick the graph kernel and its order, and so the
support count (2 K + 1 supports for ``dual_random_walk_diffusion``).

The arms keep the port's own names. ``-lstm``: ``auto`` and ``kernel`` run
the hand-written LSTM kernels (the JAX CLI's ``pallas``), ``plain`` the
plain PyTorch versions (its ``scan``), chosen for comparison only.
``-bdgcn``: ``auto`` (the default) measures the support banks' density
and takes the blocked-ELL arm at or below ``-sparse-threshold`` when N >=
``-sparse-min-nodes``, else the dense kernel arm; ``einsum`` and
``folded`` are the plain dense arms, ``csr`` the plain padded-CSR arm.
"""

from __future__ import annotations

import argparse
import os

from mpgcn_tpu_torch.config import MPGCNConfig


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Run OD Prediction.")
    p.add_argument("-GPU", "--GPU", type=str, default="0",
                   help="card index to run on (0 = cuda:0), or 'cpu'")
    p.add_argument("-in", "--input_dir", type=str, default="../data")
    p.add_argument("-out", "--output_dir", type=str, default="./output")
    p.add_argument("-model", "--model", type=str, choices=["MPGCN"],
                   default="MPGCN")
    p.add_argument("-t", "--time_slice", type=int, default=24,
                   help="parsed for reference-CLI parity; values other "
                        "than 24 are rejected (the reference ignores it)")
    p.add_argument("-obs", "--obs_len", type=int, default=7)
    p.add_argument("-pred", "--pred_len", type=int, default=7)
    p.add_argument("-norm", "--norm", type=str,
                   choices=["none", "minmax", "std"], default="none")
    p.add_argument("-split", "--split_ratio", type=float, nargs="+",
                   default=[6.4, 1.6, 2])
    p.add_argument("-batch", "--batch_size", type=int, default=4)
    p.add_argument("-hidden", "--hidden_dim", type=int, default=32)
    p.add_argument("-kernel", "--kernel_type", type=str,
                   choices=["chebyshev", "localpool", "random_walk_diffusion",
                            "dual_random_walk_diffusion"],
                   default="random_walk_diffusion")
    p.add_argument("-K", "--cheby_order", type=int, default=2)
    p.add_argument("-nn", "--nn_layers", type=int, default=None,
                   help="graph-conv layers per branch (gcn_num_layers; "
                        "unset keeps the reference's 3)")
    p.add_argument("-loss", "--loss", type=str,
                   choices=["MSE", "MAE", "Huber"], default="MSE")
    p.add_argument("-optim", "--optimizer", type=str, default="Adam")
    p.add_argument("-lr", "--learn_rate", type=float, default=1e-4)
    p.add_argument("-dr", "--decay_rate", type=float, default=0)
    p.add_argument("-epoch", "--num_epochs", type=int, default=200)
    p.add_argument("-mode", "--mode", type=str, choices=["train", "test"],
                   default="train")
    p.add_argument("-M", "--num_branches", type=int, default=None,
                   help="perspective branches: 1 = static graph only, 2 = "
                        "static + dynamic (the reference), 3 = + POI "
                        "similarity; default len(-sources) or 2; other M "
                        "need -sources")
    p.add_argument("-lstm-layers", "--lstm_num_layers", type=int, default=1,
                   help="stacked LSTM layers per branch")
    p.add_argument("-sources", "--branch_sources", type=str, nargs="+",
                   default=None, choices=["static", "dynamic", "poi"],
                   help="per-branch graph sources, one per branch")
    p.add_argument("-data", "--data", type=str,
                   choices=["auto", "npz", "synthetic"], default="auto",
                   help="npz = the files in -in, synthetic = the seeded "
                        "generators, auto = the npz when it exists")
    p.add_argument("-seed", "--seed", type=int, default=0)
    p.add_argument("-shuffle", "--shuffle", action="store_true")
    p.add_argument("-sN", "--synthetic_N", type=int, default=47)
    p.add_argument("-sT", "--synthetic_T", type=int, default=425)
    p.add_argument("-sprofile", "--synthetic_profile", type=str,
                   choices=["smooth", "realistic"], default="smooth",
                   help="synthetic OD statistics: smooth (every pair "
                        "active) or realistic (zero-inflated pairs, "
                        "heavy-tailed rates, dead zones)")
    p.add_argument("-lmax", "--lambda_max", default=2.0,
                   type=lambda s: None if s == "auto" else float(s),
                   help="Chebyshev Laplacian rescale: a float, or 'auto' "
                        "for power-iteration estimation")
    p.add_argument("-clip", "--clip_norm", type=float, default=0.0,
                   help="global-norm gradient clipping (0 = off)")
    p.add_argument("-lrs", "--lr_schedule", type=str,
                   choices=["none", "cosine", "exponential"], default="none")
    p.add_argument("-lstm", "--lstm_impl", type=str,
                   choices=["auto", "kernel", "plain"], default="auto",
                   help="LSTM arm: auto and kernel = the hand-written "
                        "kernels (the JAX CLI's pallas), plain = the plain "
                        "PyTorch version (its scan), for comparison")
    p.add_argument("-bdgcn", "--bdgcn_impl", type=str,
                   choices=["auto", "kernel", "einsum", "folded", "csr",
                            "ell"],
                   default="auto",
                   help="BDGCN arm: kernel = the dense hand-written kernel, "
                        "einsum = the plain reference-shaped einsums, "
                        "folded = the plain bank-free per-origin partial "
                        "products, csr = plain SpMM over padded-CSR support "
                        "containers, ell = ELL SpMM kernels over blocked-ELL "
                        "containers; auto measures support density and "
                        "picks ell at/below -sparse-threshold with N >= "
                        "-sparse-min-nodes, else kernel")
    p.add_argument("-fused-epilogue", "--fused_epilogue",
                   action="store_true",
                   help="fused epilogues (nn/fused.py): one stacked gate "
                        "matmul per LSTM step for all M branches (-lstm "
                        "plain), stacked BDGCN projection epilogues (one "
                        "destination SpMM a layer on the sparse arms), int8 "
                        "weights dequantised at their use; same math, "
                        "another summation order")
    p.add_argument("-support-payload", "--support_payload", type=str,
                   choices=["f32", "bf16", "int8"], default="f32",
                   help="value payload of the blocked-ELL support tiles: "
                        "bf16 halves their bytes; int8 stores codes + one "
                        "scale per row block, dequantised at the kernels' "
                        "operand read (needs the ell arm)")
    p.add_argument("-od-storage", "--od_storage", type=str,
                   choices=["auto", "dense", "sparse"], default="auto",
                   help="host storage of the (T, N, N) OD series: sparse "
                        "keeps one flat of non-zeros a day and densifies "
                        "only the windows a batch or chunk gathers; auto "
                        "follows the sparse arms' density rule")
    p.add_argument("-sparse-threshold", "--sparse_density_threshold",
                   type=float, default=None,
                   help="support-bank density at or below which "
                        "-bdgcn auto goes sparse (default 0.25)")
    p.add_argument("-sparse-min-nodes", "--sparse_min_nodes", type=int,
                   default=None,
                   help="-bdgcn auto never picks the sparse arm below this "
                        "node count (default 256)")
    p.add_argument("-no-symnorm-clamp", "--no_symnorm_clamp",
                   dest="symnorm_degree_clamp", action="store_false",
                   help="fail fast on zero-degree rows of the sym-norm "
                        "kernels (-iso policy) instead of mapping them to "
                        "zero support rows")
    p.add_argument("-faults", "--faults", type=str, default="",
                   help="deterministic fault-injection spec for chaos "
                        "testing, e.g. 'nan_step=3,sigterm_epoch=2' "
                        "(resilience/faults.py; $MPGCN_FAULTS is the env "
                        "equivalent)")
    p.add_argument("-io-retries", "--io_retries", type=int, default=3,
                   help="attempts per data-file read before failing with "
                        "an error naming the file")
    p.add_argument("-iso", "--isolated_nodes", type=str,
                   choices=["error", "selfloop", "ignore"], default="error",
                   help="zero-degree / non-finite graph rows at load: fail "
                        "fast, self-loop auto-clean, or keep the "
                        "reference's NaN propagation")
    p.add_argument("-fix-dgraph", "--fix_d_graph", action="store_true",
                   help="use the paper-correct D-graph (eq. 7) instead of "
                        "reproducing the reference's index bug")
    # the self-healing trainer (train/trainer.py)
    p.add_argument("-resume", "--resume", action="store_true",
                   help="resume training from the output-dir checkpoint "
                        "(params + optimizer moments + best-val epoch)")
    p.add_argument("-multistep", "--multistep", action="store_true",
                   help="train the multi-step seq2seq rollout directly "
                        "(keeps -pred in train mode instead of forcing 1; "
                        "the loss differentiates through the autoregressive "
                        "rollout)")
    p.add_argument("-dtype", "--dtype", type=str,
                   choices=["float32", "bfloat16"], default="float32",
                   help="compute dtype for the forward pass (params stay fp32)")
    p.add_argument("-loss-scaling", "--loss_scaling", type=str,
                   choices=["auto", "none", "dynamic"], default="auto",
                   help="dynamic loss scaling for mixed-precision "
                        "training (quant/scaling.py): auto = on for "
                        "-dtype bfloat16, off for float32; clean runs "
                        "are bitwise identical to 'none'")
    p.add_argument("-loss-scale-init", "--loss_scale_init", type=float,
                   default=65536.0,
                   help="initial dynamic loss scale (power of two)")
    p.add_argument("-loss-scale-growth", "--loss_scale_growth_interval",
                   type=int, default=200,
                   help="consecutive finite-grad steps before the scale "
                        "doubles")
    p.add_argument("-infer-precision", "--infer_precision", type=str,
                   choices=["auto", "f32", "bf16", "int8"], default="auto",
                   help="inference-path precision for test/predict "
                        "rollouts (quant/int8.py): int8 = per-channel "
                        "weight-quantized params dequantized inside the "
                        "forward; training numerics unaffected")
    p.add_argument("-devices", "--devices", type=int, default=0,
                   help="data-parallel devices (0 = single-device): N > 1 "
                        "launches N ranks, one device each")
    p.add_argument("-mp", "--model_parallel", type=int, default=1,
                   help="model-parallel axis size of the mesh (shards "
                        "the origin nodes of every window over M ranks); "
                        "must divide -devices")
    p.add_argument("-ckpt", "--checkpoint_backend", type=str,
                   choices=["pickle", "orbax"], default="pickle",
                   help="checkpoint format: pickle = the one-file format "
                        "both packages read; orbax = the port's directory "
                        "form (one torch.save file per section), not the "
                        "JAX orbax layout")
    p.add_argument("-consistency", "--consistency_check_every", type=int,
                   default=0,
                   help="digest-compare every rank's weights, Adam state "
                        "and banks every N epochs; a divergence rolls back "
                        "(0 = off)")
    p.add_argument("-accum", "--grad_accum", type=int, default=1,
                   help="gradient-accumulation microbatches per optimizer "
                        "step (1 = off): k interleaved chunks of "
                        "batch/k, one update")
    p.add_argument("-dead-init", "--on_dead_init", type=str,
                   choices=["warn", "error", "retry"], default="retry",
                   help="when the first trained epoch leaves every weight "
                        "unchanged and the forward is all zero (a dead "
                        "ReLU head): reseed and retry (the default), abort, "
                        "or warn and continue")
    p.add_argument("-dead-init-retries", "--dead_init_retries", type=int,
                   default=3,
                   help="reseed attempts under -dead-init retry before "
                        "giving up")
    p.add_argument("-no-sentinels", "--no_step_sentinels",
                   dest="step_sentinels", action="store_false",
                   help="turn off the per-step non-finite sentinels (on: a "
                        "step whose loss or new state is non-finite is "
                        "undone inside the step; clean runs are bitwise "
                        "identical either way)")
    p.add_argument("-skip-budget", "--skip_budget", type=int, default=0,
                   help="sentinel-skipped train steps tolerated per epoch "
                        "before the epoch is declared bad (quarantine + "
                        "restore + rollback/stop)")
    p.add_argument("-rollback-retries", "--rollback_retries", type=int,
                   default=0,
                   help="bad-epoch rollback budget: quarantine the bad "
                        "state, restore the last good checkpoint, shrink "
                        "the LR and retry up to N times (0 = stop)")
    p.add_argument("-rollback-lr-factor", "--rollback_lr_factor",
                   type=float, default=0.5,
                   help="multiply learn_rate by this on each rollback "
                        "retry (1.0 keeps it)")
    p.add_argument("-watchdog", "--watchdog_secs", type=float, default=0.0,
                   help="hang watchdog deadline in seconds: with no epoch "
                        "heartbeat in it, dump all thread stacks, write an "
                        "emergency checkpoint from the last host copy and "
                        "exit 113 (0 = off; must exceed one epoch on the "
                        "scan executor, one chunk on the stream executor)")
    # the city-scale feed
    p.add_argument("-no-stream", "--no_epoch_stream", dest="epoch_stream",
                   action="store_false",
                   help="turn off the chunked-stream epoch executor for "
                        "modes over the epoch-scan budget: they run one "
                        "step, one copy and one host sync at a time")
    p.add_argument("-stream-chunk-mb", "--stream_chunk_mb", type=float,
                   default=None,
                   help="device budget per stream chunk in MB (gathered "
                        "x + y + keys; at most two chunks on the device: "
                        "the computing one and the staged one); 0 or unset "
                        "takes the epoch-scan budget")
    p.add_argument("-native", "--native_host", type=str,
                   choices=["auto", "off"], default="auto",
                   help="C++/OpenMP host kernels for the window gather and "
                        "the day-of-week mean (auto: when they build; off: "
                        "numpy)")
    # the operator surface
    p.add_argument("-trace", "--trace_dir", type=str, default=None,
                   help="torch.profiler trace output dir: the whole "
                        "session in one window (CPU activity, and CUDA "
                        "activity on the card; each step annotated), "
                        "written there as <host>_<pid>.<ms>.pt.trace.json")
    p.add_argument("-no-obs", "--no_obs", dest="obs_metrics",
                   action="store_false",
                   help="turn the trainer's telemetry off: its metrics "
                        "series, the SLO engine, the registry snapshot in "
                        "the epoch events, the device sampler and the "
                        "-metrics-port sidecar")
    p.add_argument("-compile-cache", "--compile_cache_dir", type=str,
                   default="",
                   help="directory of the built kernel libraries "
                        "(obs/perf/compile_cache.py): a second process "
                        "loads them instead of building them; hit, miss "
                        "and size series ride the metrics registry "
                        "($MPGCN_COMPILE_CACHE is the env equivalent; "
                        "unset: native/_build/)")
    p.add_argument("-metrics-port", "--metrics_port", type=int,
                   default=None,
                   help="serve GET /metrics (Prometheus text of the "
                        "process registry) from a stdlib HTTP sidecar on "
                        "this port (0 = ephemeral, printed at startup; "
                        "unset = off)")
    return p


def device_for(gpu: str) -> str:
    """The -GPU flag as a torch device name: 'cpu', or a card index."""
    if gpu == "cpu":
        return "cpu"
    if not gpu.isdigit():
        raise SystemExit(f"-GPU {gpu!r} is neither a card index nor 'cpu'")
    return f"cuda:{gpu}"


#: the tunable knobs that have a flag (mpgcn_tpu/cli.py:456-458)
TUNABLE_FLAGS = ("sparse_density_threshold", "sparse_min_nodes",
                 "stream_chunk_mb")

#: flags that pick the device, the arms, resume and the session's
#: sidecars, not config fields
RUN_FLAGS = ("GPU", "lstm_impl", "bdgcn_impl", "resume", "trace_dir",
             "metrics_port", "devices", "model_parallel")


def config_from_args(args: dict) -> MPGCNConfig:
    """The config the parsed flags ``args`` give, as mpgcn_tpu/cli.py
    builds it (:464-482). Consumes the flags that are not config fields;
    any other dest that names no field raises."""
    for flag in RUN_FLAGS:
        args.pop(flag, None)
    multistep = args.pop("multistep", False)
    # a tunable flag the user passed is explicit, even at its default
    # value, so a tuned profile never overrides it; one not given leaves
    # the config default for the profile to resolve (tune/registry.py)
    args["explicit_knobs"] = tuple(k for k in TUNABLE_FLAGS
                                   if args.get(k) is not None)
    for knob in TUNABLE_FLAGS:
        if args[knob] is None:  # not given: the config default stands
            args.pop(knob)
    if args["mode"] == "train" and not multistep:
        args["pred_len"] = 1  # train the single-step model (Main.py:44-45)
    args["reproduce_d_graph_bug"] = not args.pop("fix_d_graph")
    if args["num_branches"] is None:
        # a source lineup defines M; given both, the config checks them
        args["num_branches"] = (len(args["branch_sources"])
                                if args["branch_sources"] else 2)
    nn_layers = args.pop("nn_layers")
    if nn_layers is not None:
        args["gcn_num_layers"] = nn_layers
    return MPGCNConfig(**args)


def main(argv=None):
    import sys

    argv = sys.argv[1:] if argv is None else list(argv)
    if argv and argv[0] == "serve":
        from mpgcn_tpu_torch.service.serve import main as serve_main

        raise SystemExit(serve_main(argv[1:]))
    if argv and argv[0] == "fleet":
        # tenant-registry surgery for `serve --fleet` (no device needed)
        from mpgcn_tpu_torch.service.registry import main as fleet_main

        raise SystemExit(fleet_main(argv[1:]))
    if argv and argv[0] == "router":
        # the front tier over N `serve --fleet` replica processes
        # (service/router.py): it never imports torch, its replicas do
        from mpgcn_tpu_torch.service.router import main as router_main

        raise SystemExit(router_main(argv[1:]))
    if argv and argv[0] == "supervise":
        # the process supervisor (resilience/supervisor.py): it starts
        # and watches the command after `--`, and imports no torch
        from mpgcn_tpu_torch.resilience.supervisor import (
            main as supervise_main,
        )

        raise SystemExit(supervise_main(argv[1:]))
    if argv and argv[0] == "daemon":
        # the continual-learning loop (service/daemon.py)
        from mpgcn_tpu_torch.service.daemon import main as daemon_main

        raise SystemExit(daemon_main(argv[1:]))
    if argv and argv[0] == "stats":
        # the read surface over ledgers, span logs and a live /v1/stats
        from mpgcn_tpu_torch.obs.stats import main as stats_main

        raise SystemExit(stats_main(argv[1:]))
    if argv and argv[0] == "slo":
        # the SLO state of a serving root, live or from its ledger
        from mpgcn_tpu_torch.obs.perf.slo_cli import main as slo_main

        raise SystemExit(slo_main(argv[1:]))
    if argv and argv[0] == "tune":
        # self-tuning dispatch (tune/): `run` measures the crossovers on
        # the card, `buckets` plans the serving shapes from a request
        # ledger, `show` prints the registry; only `run` imports torch
        from mpgcn_tpu_torch.tune.cli import main as tune_main

        raise SystemExit(tune_main(argv[1:]))
    if argv and argv[0] == "scenario":
        # profiles and spools (no torch); `run` trains through the daemon
        from mpgcn_tpu_torch.scenarios.cli import main as scenario_main

        raise SystemExit(scenario_main(argv[1:]))
    # torch is imported from here on: the subcommands above import it
    # only when they need it (`fleet`, `router`, `supervise`, `stats`,
    # `slo`, `tune show|buckets`, `scenario list|gen` never)
    from mpgcn_tpu_torch.data.loader import load_dataset
    from mpgcn_tpu_torch.device import resolve_device
    from mpgcn_tpu_torch.obs.perf import compile_cache
    from mpgcn_tpu_torch.parallel.distributed import (
        initialize,
        launch_ranks,
        local_rank,
        world_from_env,
    )
    from mpgcn_tpu_torch.train.trainer import ModelTrainer
    from mpgcn_tpu_torch.utils.profiling import trace_if

    args = build_parser().parse_args(argv).__dict__
    # no card, no data loading: the device is checked first
    device = resolve_device(device_for(args["GPU"]))
    world, devices = world_from_env(), args["devices"]
    rank0 = world is None or int(os.environ.get("RANK", "0")) == 0
    # the mesh, before any data is loaded (mpgcn_tpu/cli.py:500-521; a
    # world launched from outside, torchrun's, is the JAX multi-host run)
    mp = args["model_parallel"]
    if mp < 1:
        raise SystemExit(f"-mp {mp} is invalid: the model axis "
                         f"needs at least 1 device")
    if mp > 1 and world is None and devices <= 1:
        raise SystemExit(
            f"-mp {mp} needs a multi-device mesh: pass "
            f"-devices N (a multiple of {mp}) or run "
            f"multi-host; a single-device run has no model axis")
    if world is not None:
        if world % mp:
            raise SystemExit(
                f"-mp {mp} does not divide the global device "
                f"count ({world})")
    elif devices and devices % mp:
        raise SystemExit(f"-devices {devices} is not divisible by "
                         f"-mp {mp}")
    if world is None and devices > 1:
        if device.type == "cuda":
            import torch

            visible = torch.cuda.device_count() - device.index
            if devices > visible:
                raise SystemExit(f"requested {devices} devices, only "
                                 f"{visible} visible")
        raise SystemExit(launch_ranks(argv, devices))
    if world is not None:
        # one rank of a world launched from outside (torchrun) or by
        # launch_ranks above; rank 0 alone prints
        if device.type == "cuda":
            import torch

            device = resolve_device(f"cuda:{device.index + local_rank()}")
            torch.cuda.set_device(device)
        initialize(backend="nccl" if device.type == "cuda" else "gloo")
        if not rank0:
            sys.stdout = open(os.devnull, "w")
    lstm_impl = "plain" if args["lstm_impl"] == "plain" else "kernel"
    bdgcn_impl, resume = args["bdgcn_impl"], args["resume"]
    trace_dir, metrics_port = args["trace_dir"], args["metrics_port"]
    cfg = config_from_args(args)
    # the kernel-library directory before anything is built
    compile_cache.enable(cfg.compile_cache_dir or None)
    os.makedirs(cfg.output_dir, exist_ok=True)
    data, data_input = load_dataset(cfg)
    cfg = cfg.replace(num_nodes=data["OD"].shape[1])
    if world is not None:
        from mpgcn_tpu_torch.parallel import ParallelModelTrainer, make_mesh

        trainer = ParallelModelTrainer(
            cfg, data, lstm_impl=lstm_impl, bdgcn_impl=bdgcn_impl,
            data_container=data_input,
            mesh=make_mesh(model_parallel=mp, device=device))
    else:
        trainer = ModelTrainer(cfg, data, device=device,
                               lstm_impl=lstm_impl, bdgcn_impl=bdgcn_impl,
                               data_container=data_input)
    # the sidecars ride the whole session; -no-obs keeps both off with
    # the trainer's own telemetry
    sidecar = sampler = None
    if cfg.obs_metrics and rank0:
        from mpgcn_tpu_torch.obs.device import DeviceSampler
        from mpgcn_tpu_torch.obs.metrics import MetricsServer, default_registry

        sampler = DeviceSampler().start()
        if metrics_port is not None:
            sidecar = MetricsServer([default_registry()],
                                    port=metrics_port).start()
            print(f"[obs] /metrics on "
                  f"http://{sidecar.host}:{sidecar.port}/metrics",
                  flush=True)
    try:
        with trace_if(trace_dir, device):
            if cfg.mode == "train":
                return trainer.train(resume=resume)
            return trainer.test()
    finally:
        if sampler is not None:
            sampler.stop()
        if sidecar is not None:
            sidecar.stop()


if __name__ == "__main__":
    main()
