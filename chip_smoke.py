#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. build every kernel of mpgcn_tpu_torch/csrc/ with nvcc for sm_90a and
     print the ptxas register / shared-memory / spill report;
  2. hold each kernel against its plain PyTorch version on the card, at
     the shapes the serve and training paths give it and at odd sizes
     (the backward kernels with and without a dcs cotangent, and twice,
     to show that dW is bit-equal from run to run; the inference LSTM
     entries on x_proj and in their fused form from x, which at input
     width 1 must equal the x_proj form fed the torch projection bit for
     bit);
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
     with exactly M*L = 2 launches of each LSTM training entry and M*3 = 6
     of each BDGCN entry per step (each backward entry sums its dW inside
     its one launch), moves every parameter, its loss falls, its checkpoint
     is written, and a fresh trainer in test mode reloads it, rolls out 7
     steps and appends finite scores;
  5. the sparse path: the ELL SpMM kernels (forward, dX, dBlocks, each on
     f32, bf16 and int8 tiles where the entry takes them) against their
     plain versions at the large-N shapes (the banks of the N=500, density
     0.05 configuration: stack 3 or 6, NB=63, MB=2, F=32,000 or 16,000)
     and at odd sizes, the forward, dX and dBlocks twice (bit-equal), dX
     and int8 dX at the static shape also against float64;
     dBlocks through torch.autograd.grad with respect to the tiles of a
     pad-free container;
  6. large-N train: MPGCN at N=500 (banded density 0.05, batch 2, hidden
     32, M=2, K=3) with bdgcn_impl="auto", which must resolve to "ell"; the
     kernel arms' loss and gradients on one batch against the dense plain
     arms in float64 and f32; one epoch with exact per-step launch counts
     (M * 3 * (1 + K) = 24 ell_fwd and 24 ell_bwd_dx, no dense BDGCN
     kernel), every parameter moved; test mode reloads and rolls out 7
     steps;
  7. large-N serve: a ServeEngine with buckets (1, 2) on the ELL banks
     answers test windows, matching the dense plain rollout; then with
     int8 tiles (resident-support reduction >= 3), and 3 int8 training
     steps;
  8. time each kernel beside its bound, its plain version and the fastest
     single PyTorch library call (the fused LSTM layer also beside the
     projection and kernel it replaces), the rollout per bucket with its
     device activities, the train step (N=47; N=500 on the ELL arm and on
     the dense kernel arm that "auto" passes over), and the device's busy
     share;
  9. after them, so that every phase above runs as it did without it: the
     wide widths (the LSTM forwards' wide kernels and the BPTT's split-TF32
     engine path; K-BDGCN's products at widths past the reference ones).
     The six LSTM and K-BDGCN
     entries against their plain versions at H = 65, 96, 128, 256 and
     1,030 and (K, C, H) = (7, 128, 128), (6, 65, 33), (9, 16, 16),
     (3, 32, 128), static and dynamic, one launch per call, dW bit for bit
     against dw_reduce_plain of the partials and a second run; then the
     wide model (hidden 128, dual_random_walk_diffusion of order 3, so
     K = 7 supports; N = 47, batch 4, the first live init seed): a
     bucket-8 ServeEngine batch against the plain rollout, the gradients
     against float64, 20 training steps against the plain arms' losses,
     the CLI (one epoch and test mode, N = 20) through the kernels; and
     the six entries' times (lstm_infer_last also fused from x), the
     bucket-8 rollout and the train step at the wide model's shapes;
 10. the N=500 train step on int8 tiles, and the LSTM entries'
     times at the N=500 step's shapes (R = 500,000 sequences, T = 7,
     H = 32; the inference layer on x_proj and fused from x) beside
     nn.LSTM at that batch, with the resident kernels' registers and
     spills;
 11. last, the reference command on a dataset file: the reference's data
     directory written under smoke_out/reference_cli/data (the OD npz of
     synthetic_od(T=455, N=47, seed 0), of which the loader keeps the
     trailing 425 days, the adjacency and the POI features), then
     `python -m mpgcn_tpu_torch.cli -GPU 0 -in DIR -data npz` driven
     twice, each from the first live init seed of its configuration:
     (a) the defaults (M=2, 1 LSTM layer, -norm none) and (b) -M 3
     -lstm-layers 2 -nn 2 -norm minmax -split 7 1 2 -clip 1.0 -lrs
     cosine (the poi branch from the features file). Each trains 2
     epochs with exact launches per train and validation step, moves
     every parameter, its loss falls, its checkpoint records the
     normalizer (minmax: the min and max of log1p of the 425 days);
     test mode rolls out 7 steps with exact launches and appends finite
     scores, and test mode with the plain arms (-lstm plain -bdgcn
     einsum) on a copy of the checkpoint launches no kernel and agrees
     to rtol 1e-4. Steps/sec and test-mode times are printed with the
     card's name and power limit; run (b) trains 3 more times, without
     -clip, with it and without it, to read what the clip costs a step;
 12. after them all, the epoch executor and the CUDA graphs (every
     ModelTrainer and ServeEngine above already ran on them: the scan
     executor with its train and eval steps captured, a rollout graph per
     (batch or bucket, horizon)): (a) N=47 trains 3 epochs on the scan
     executor and on the per-step executor from the same init, equal bit
     for bit epoch by epoch (losses, weights, Adam's state), each epoch
     with exactly S x a step's launches, epoch 2 under
     torch.cuda.set_sync_debug_mode("error") up to its one read; test
     mode through a graph equal to the eager rollout; (b) every serve
     bucket's rollout graph equal to the eager rollout, with its
     launches; (c) the wide configuration: 5 train and 4 eval steps by
     graph equal to train_step / eval_step, and its bucket-8 rollout
     graph; (d) N=500 on the ELL arm: one epoch on the scan executor,
     uncaptured as its dispatch line says, equal to the per-step one.
     Times by graph and eager (steps, rollouts, busy shares);
 13. after them all, the self-healing trainer at the reference widths
     (cfg's live init seed, the scan executor with graphs): (a) 3 epochs
     with the step sentinels on and off equal bit for bit (losses,
     weights, Adam's state, the rate, step_t), the step's time by graph
     with and without them; (b) NaN input windows at train step 5: the
     replayed step is undone bit for bit inside the graph (step_t does
     not move, its loss is NaN), by graph equal to per step; with
     skip_budget 1 the epoch completes; with skip_budget 0 and
     rollback_retries 1 a postmortem, a restore, the rate halved, a retry
     and a stop, the events in the JAX trainer's order; (c) -multistep
     -pred 6 (BASELINE config 3): 2 epochs by graph equal per step bit
     for bit, 6 x a one-step step's launches, one step's gradients
     against float64, step times and busy share; (d) -accum 2: at N=47 by
     graph equal per step, matching the full batch (rtol 1e-5), at N=500
     (the ELL arm) one step's gradients matching the full batch's, peak
     device bytes for k = 1 and 2; (e) 2 epochs and a resume to 4 equal 4
     straight epochs bit for bit by graph; (f) the heads forced dead:
     'error' raises after epoch 1, 'retry' reseeds and trains; (g)
     -watchdog 60 completes without firing, with its per-epoch host copy
     timed;
 14. after them all, the precision plane (-dtype bfloat16, the loss
     scaler, remat, -infer-precision): (a) each bf16 entry (the three
     LSTM forwards, the BPTT, K-BDGCN forward and backward) against its
     plain twin run in float64 on the same bf16 operands with the same
     rounding points, at the N=47 serve and train shapes, the wide ones
     (H = 128, K = 7) and the N=500 LSTM shapes (R = 500,000), with its
     time beside its bound at 2-byte storage (products at the bf16
     tensor rate), the f32 form's time on the same values, its plain
     twin's and nn.LSTM / torch.einsum in bf16; (b) the reference command
     of phase 11 run (a) with -dtype bfloat16: 2 epochs with exact bf16
     launches a step and test mode, steps/sec, the final loss scale, the
     scaler's skips and the validation RMSE beside run (a)'s (within
     10%); (c) an Inf forced into the scaled gradients of two bf16 steps
     inside the captured step: skipped, the scale halved, by graph equal
     per step bit for bit; (d) BASELINE config 5 as benchmarks/large_n.py
     drives it (N=500, ELL arm, bf16 and remat): gradients against f32,
     launches with each forward entry twice (remat), step ms and peak
     device bytes beside f32 without remat; (e) rollouts by graph at
     buckets 1/2/4/8 with -infer-precision bf16 and int8 (ms, max |delta|
     from the f32 rollout, each graph equal to the eager rollout) and
     ServeEngine.submit in each mode;
 15. after them all, [city-feed], the city-scale feed at the N=500
     configuration (its earlier phases hold the series dense on the host,
     as they always have): (a) the fused epilogue on the ELL kernels: the
     fused destination SpMM at F = 96,000 (static) and 48,000 (per
     sample) bit for bit against the per-origin SpMMs at F = 32,000 /
     16,000, forward and dX, f32 and int8 tiles, with their times beside
     the bound; the fused model's loss and gradients against the plain
     arms in f32 and float64 and against the unfused ELL arm; exact
     launches (a fused step: ell_fwd 18 = 12 + 6 run again inside the
     checkpoint, ell_bwd_dx 12; a bucket-2 rollout ell_fwd 84); step and
     rollout times and peak bytes, fused against unfused; (b) the stream
     executor, od_storage='sparse', -native auto, 64 MB chunks, against
     the scan executor on dense storage from the same init, one epoch
     bit for bit, at most two chunks resident, one pacing wait a chunk
     and no other host sync under set_sync_debug_mode("error"); the same
     at N=47 by graph (2 epochs, 1 MB chunks); epoch seconds, peak bytes,
     the series' host bytes; (c) the csr arm: one epoch by graph and a
     bucket-2 ServeEngine batch against the ELL arm to 1e-4, step and
     rollout times beside it; (d) the native host gather against numpy,
     equal bytes and both times. Every time carries the card's name and
     power limit.
 16. after them all, [serve-http], the serving plane at the reference
     widths (N=47, hidden 32, M=2, K=3, buckets 1/2/4/8, horizon 7), the
     train phase's checkpoint promoted through the real slot and ledger:
     (a) a load generator over the in-process HTTP front, 64 requests on
     test windows a run from C = 1, 4 and 16 keep-alive clients, with the
     double-buffered feed on and off: every answer ok and equal to the
     eager rollout of its window alone to 1e-5, the graph count unmoved;
     requests/s, HTTP round-trip p50/p99, the engine's p50/p99 from
     /v1/stats, the spans' queue and model p50/p99, batches, pad waste
     and the interpreter's GC pauses per run; (b) canaried hot reload of
     the model trained one epoch more (poll 0.05 s, canary fraction
     0.25, 16 canary requests): canary-started then promoted, a quarter
     of the batches on the canary, then answers bit for bit those of an
     engine started on the candidate; a poison_reload engine rejects the
     candidate (rejected-smoke) and a canary gone non-finite on live
     traffic rolls back, the incumbent's answers bit-identical; the
     graph count the same through all of it; the time from the slot's
     write to promotion and of each in-place weight copy; (c) the
     command, python -m mpgcn_tpu_torch.cli serve -faults flood_qps=200,
     as a subprocess: typed outcomes over HTTP, /metrics with
     serve_requests and the slo_ families, SIGTERM -> exit 0, "drained
     (clean)" and the postmortem beside the ledgers.
 17. after them all, [fleet], the in-process multi-tenant fleet at the
     reference widths (buckets 1/2/4/8, horizon 7): four tenants added by
     `python -m mpgcn_tpu_torch.cli fleet add` (a: the train phase's
     checkpoint, b: phase 16's fourth-epoch candidate, c and d: a's
     weights with seeded perturbations, each written by the port's save
     with its integrity records), each promoted with its ledger row; each
     checkpoint served alone by a ServeEngine, held against the plain
     arms in float64. (a) `serve --fleet` as its own process: every
     tenant's answers equal its checkpoint's engine's (max abs 0), an
     unknown tenant and a body without one get 404, 4 graphs for 4
     tenants, 14 lstm_infer_last and 42 bdgcn_pair_fwd launches a batch
     (its /v1/stats); with one tenant (in process) a body without one is
     that tenant's request; (c) 64 requests a run from C = 1 and 4 clients
     over the 4 tenants: requests/s and round-trip p50/p99 in total and
     per tenant, the startup and the graph bytes, SIGTERM -> exit 0.
     (b) in-process fleets, one fault domain at a time, every other
     tenant's answers bit-identical and its breaker closed through each:
     poison_reload on b (rolled back) while a promotes the same
     candidate; a quota flood on c; d's model failing (breaker open, 429,
     recovered by its half-open probe); a torn slot on b at startup
     (unavailable, then recovered by a re-promotion); the graph count
     unmoved. One batch's launches and device activities (profiler), the
     in-place parameter copy (CUDA events) at N=47 and at the wide
     configuration's size, the bucket-1 rollout with and without it, and
     the resident bytes a tenant in f32 and int8.
 18. after them all, [router], the front tier over phase 17's tenants:
     (a) the Router (service/router.py) and its HTTP front in this
     process over 2 `serve --fleet` replica processes on the card
     (smoke_obs 7, smoke_nodes 47): 64 requests a run from C = 1, 16
     clients through the router and straight to r0 (req/s, round trip,
     the replica engine's and the router's own p50), every answer bit-
     equal to phase 17's references; kill -9 of r1 mid-load (no request
     fails; the card's used bytes back before the restart allocates;
     death -> re-admitted, in the ledger's order died / restart / bound /
     admitted), a partition of r1 (its breaker trips, the prober closes
     it), a rolling deploy under load (drain -> re-admitted a replica),
     one spawn (spawn -> admitted, a C = 16 load over 3 replicas) and
     two retires, then C = 1, 16 over 1 replica; every incarnation: 4
     graphs, its graph captures equal to the first one's, no kernel
     library built; each replica's device memory (nvidia-smi by pid, its
     graphs' pool, the card's used bytes); (b) `python -m
     mpgcn_tpu_torch.cli router` as its own process over 2 replicas:
     up, answers bit-equal at C = 1, 16 (req/s), SIGTERM -> exit 0 and
     no replica left. The replicas' lstm_infer_last and bdgcn_pair_fwd
     launches,
     each incarnation read once admitted and again before it stops, join
     the kernels line.
 19. after them all, [daemon], the continual-learning daemon at the
     reference widths (N=47, hidden 32, batch 4, obs 7, M=2, K=3
     supports): (a) `python -m mpgcn_tpu_torch.cli supervise --procs 1
     -- daemon ... -faults kill_retrain=2` on 48 spooled days of
     synthetic_od(seed 0), day 20 corrupt, six days a cycle, 20 epochs a
     retrain: a thread integrity-loads the promoted slot throughout (no
     load may fail); the supervisor's generations end -9, then 0; day 20
     is quarantined; attempt 2 dies after its first epoch and leaves no
     gate row, the relaunched daemon retrains the rest; every promoted
     row has cand_loss <= inc_loss (1 + tol); every retrain launches
     exactly 2 of each LSTM training entry and 6 of each BDGCN entry a
     train step and 2 lstm_infer_last and 6 bdgcn_pair_fwd an eval step
     or rollout forward (retrain_done's metrics), builds no kernel
     library, and leaves memory_reserved flat across the relaunched
     process's retrains; seconds a retrain, graph captures a retrain,
     kill -> relaunch -> first retrain; (b) `serve --capture-flows` on
     that root: one request a new day (day_slot 48..54), then a daemon
     with --capture-ledger stitches the closed days (48..53) into day
     files bit-equal to the frames sent, retrains and promotes; the
     server's canary takes the new slot (promotion -> serve reload) and
     then answers bit-equal to a ServeEngine built here on the promoted
     checkpoint; SIGTERM -> exit 0. The daemon's and the server's
     launches join the kernels line.
 20. after them all, [ops], the operator surface and the scenario engine
     (N = 47 reference widths on the npz tree it writes; the profiles'
     N = 20, obs 5, hidden 32): (a) `python -m mpgcn_tpu_torch.cli -in
     DIR -epoch 2 -metrics-port 0 -compile-cache C` on a C that holds
     three of the path's four kernel libraries (phase 1's builds, to keep
     the smoke inside its limit): it builds bdgcn_pair_fwd and the host
     library there (its /metrics scraped while it trains); then the same
     with `-trace T`, the second process on C (0 libraries built, one
     hit a library); then with `-no-obs` in this process: launches equal
     in all three, losses bit-equal, every epoch event with `metrics` but
     under -no-obs; the trace holds CUDA kernels, each launched entry's
     eager launches by name, the path's hand kernels, at least as many
     hand-kernel activities as counted launches (the replays in it) and
     the steps' annotations; steps/s with and without the profiler,
     each process's seconds cold and warm; (b) `serve --profile
     taxi-midtown -trace T2`: 6 requests, `stats` and `slo` live and
     offline, `stats --trace` stitches request -> batcher -> model, the
     trace holds the replayed kernels and the batches' annotations; (c)
     `scenario run` over taxi-midtown, bike-harbor and metro-loop on
     the card: every tenant promotes, no library built, seconds a
     retrain, `memory_reserved` flat across the tenants, `stats` on the
     root has its federation section; then `transfer_ab(taxi-riverside,
     taxi-midtown's promoted checkpoint)`: steps to promote warm
     against scratch; (d) `scenario gen`, then `daemon --profile
     metro-loop --metrics-port 0`, scraped while it runs. The
     processes' launches join the kernels line.
 21. after them all, [tune], self-tuning dispatch on a profile directory
     under smoke_out/tune/ (every phase before it runs with
     $MPGCN_TUNED_DIR on a directory that does not exist, so on the
     guessed defaults): (a) `python -m mpgcn_tpu_torch.cli tune run`
     with every harness meaningful on the card at its JAX shape (the
     sparse crossover: kernel on dense storage against ell on sparse
     storage at N = 300, hidden 16, batch 1, bf16 + remat, densities
     0.02-0.3; the stream chunk grid and scan against stream at T = 320,
     N = 6, hidden 8): each curve, the profile's platform torch-cuda and
     its provenance (the card's name and power limit), the launches of
     every hand kernel that ran; (b) the train CLI's config with -bdgcn
     auto -od-storage auto on phase 15's banded N=500 series at hidden
     32, batch 4, one epoch: the [dispatch] line's arm follows the tuned
     threshold and the [tune] line names the tuned profile; with
     -sparse-threshold 0.25 it names the explicit knob; (c) `tune
     buckets --platform cuda --write` on the request ledger of phase 16
     (c)'s serve command (its flood's batched arrivals and 64 HTTP
     requests; (a)'s HTTP-bound ledgers hold groups of one), then
     `serve` on the card on that profile: serve_start and /v1/stats list
     the planned buckets, 2 slots x buckets x horizons graphs, 32
     requests answered; each part's seconds.

The second-to-last line is a JSON object listing each kernel; the last
line is {"ok": true, "device": {...}}. Exits non-zero without a card, and
when run from a directory that holds no mpgcn_tpu_torch package.
"""

import contextlib
import copy
import json
import os
import shutil
import signal
import subprocess
import sys
import threading
import time
import types

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published peaks (NVIDIA data sheet): device memory rate, the
# f32 rate of the CUDA cores (the kernels' f32 FMA) and the dense TF32 rate
# of the tensor cores (the ELL and K-BDGCN kernels' split TF32 products)
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOP_PER_S = 67e12
PEAK_TF32_FLOP_PER_S = 495e12

LSTM_TOL = dict(rtol=1e-5, atol=1e-5)    # 7 steps of f32, other sum order
BDGCN_TOL = dict(rtol=1e-5, atol=1e-5)   # f32 sums of K^2 N C products
ROLLOUT_TOL = dict(rtol=1e-4, atol=1e-4)  # 7 autoregressive f32 steps
# dW sums R*T (LSTM) or B*M*N (BDGCN) products in another order than the
# plain version: rtol 1e-5 with an atol of 2e-6 x the largest |dW| entry
DW_RTOL, DW_ATOL_SCALE = 1e-5, 2e-6
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
    "bdgcn_pair_bwd": ("cuda_bdgcn", "BDGCN_PAIR_BWD", "bdgcn_pair_bwd.cu",
                       "mpgcn_tpu/nn/pallas_bdgcn.py:233"),
    "ell_fwd": ("cuda_ell", "ELL_FWD", "ell_spmm.cu",
                "mpgcn_tpu/sparse/pallas_ell.py:180"),
    "ell_fwd_q": ("cuda_ell", "ELL_FWD_Q", "ell_spmm.cu",
                  "mpgcn_tpu/sparse/pallas_ell.py:247"),
    "ell_bwd_dx": ("cuda_ell", "ELL_BWD_DX", "ell_spmm.cu",
                   "mpgcn_tpu/sparse/pallas_ell.py:195"),
    "ell_bwd_dx_q": ("cuda_ell", "ELL_BWD_DX_Q", "ell_spmm.cu",
                     "mpgcn_tpu/sparse/pallas_ell.py:263"),
    "ell_bwd_dblk": ("cuda_ell", "ELL_BWD_DBLK", "ell_spmm.cu",
                     "mpgcn_tpu/sparse/pallas_ell.py:212"),
    # the bf16 forms (-dtype bfloat16, -infer-precision bf16): the same
    # TPU kernels in their bf16 dtype
    "lstm_infer_last_bf16": ("cuda_lstm", "LSTM_INFER_LAST_BF16",
                             "lstm_infer.cu",
                             "mpgcn_tpu/nn/pallas_lstm.py:380"),
    "lstm_infer_collect_bf16": ("cuda_lstm", "LSTM_INFER_COLLECT_BF16",
                                "lstm_infer.cu",
                                "mpgcn_tpu/nn/pallas_lstm.py:367"),
    "lstm_train_fwd_bf16": ("cuda_lstm", "LSTM_TRAIN_FWD_BF16",
                            "lstm_train.cu",
                            "mpgcn_tpu/nn/pallas_lstm.py:414"),
    "lstm_train_bwd_bf16": ("cuda_lstm", "LSTM_TRAIN_BWD_BF16",
                            "lstm_train.cu",
                            "mpgcn_tpu/nn/pallas_lstm.py:519"),
    "bdgcn_pair_fwd_bf16": ("cuda_bdgcn", "BDGCN_PAIR_FWD_BF16",
                            "bdgcn_pair_fwd.cu",
                            "mpgcn_tpu/nn/pallas_bdgcn.py:205"),
    "bdgcn_pair_bwd_bf16": ("cuda_bdgcn", "BDGCN_PAIR_BWD_BF16",
                            "bdgcn_pair_bwd.cu",
                            "mpgcn_tpu/nn/pallas_bdgcn.py:233"),
}
TRAIN_KERNELS = ("lstm_train_fwd", "lstm_train_bwd", "bdgcn_pair_bwd",
                 "lstm_train_fwd_bf16", "lstm_train_bwd_bf16",
                 "bdgcn_pair_bwd_bf16")
ELL_TRAIN_KERNELS = ("ell_bwd_dx", "ell_bwd_dx_q", "ell_bwd_dblk")
#: row blocks per row group of the ELL forward (csrc/ell_spmm.cu kGroupRB)
FWD_GROUP_RB = 8
#: F columns of one dX block's tile (csrc/ell_spmm.cu kDxTF)
DX_TF = 128
# the large-N configuration (benchmarks/large_n.py --format ell --density
# 0.05): 60 synthetic days over 500 zones projected onto a band, batch 2
# (the phases before [city-feed] hold the series dense on the host, as
# they always have: od_storage 'auto' would store it sparse at this N)
LARGE_N = dict(synthetic_T=60, synthetic_N=500, batch_size=2,
               od_storage="dense")
LARGE_N_DENSITY = 0.05
#: a branch whose FC+ReLU head outputs fewer non-zeros than this on the
#: first training batch counts as dead: its gradients are all 0, so the
#: gradient checks and the training run would not reach its kernels
LIVE_SHARE = 0.1


def kernels():
    """name -> the CudaKernel entry (its launch count lives there)."""
    from mpgcn_tpu_torch.nn import cuda_bdgcn, cuda_lstm
    from mpgcn_tpu_torch.sparse import cuda_ell

    mods = {"cuda_lstm": cuda_lstm, "cuda_bdgcn": cuda_bdgcn,
            "cuda_ell": cuda_ell}
    return {n: getattr(mods[m], a) for n, (m, a, _, _) in
            KERNEL_META.items()}


def reset_counts():
    for k in kernels().values():
        k.launches = 0


def read_counts():
    import torch

    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return {n: k.launches for n, k in kernels().items()}


def require(cond, msg):
    if not cond:
        raise RuntimeError(f"chip smoke check failed: {msg}")


def bound(bytes_moved, flops, peak_flop_per_s=PEAK_F32_FLOP_PER_S):
    t_bytes = bytes_moved / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / peak_flop_per_s * 1e3
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


def ptxas_kernel(source, name):
    """(registers, "stores/loads") of the kernel whose mangled name holds
    ``name`` in the ptxas report of csrc/<source>.cu from this run's
    build; "not measured" where the library was built before."""
    from mpgcn_tpu_torch.native import build

    lines = build.ptxas_reports.get(source, "").splitlines()
    regs = spills = "not measured"
    inside = False
    for line in lines:
        if "Compiling entry function" in line:
            inside = name in line
        elif inside and "spill stores" in line:
            nums = [w for w in line.replace(",", " ").split() if w.isdigit()]
            spills = f"{nums[1]}/{nums[2]}" if len(nums) >= 3 else line
        elif inside and "Used" in line and "registers" in line:
            regs = line.split("Used")[1].split("registers")[0].strip()
    return regs, spills


def check_fused(dev, T, R, H, F, label):
    """The inference entries' fused form (x, w_ih and b instead of x_proj)
    at (T, R, H, F) against its plain version, on inputs of its own seed,
    and at F = 1 bit for bit against the x_proj form fed the torch
    projection. Returns the worst error by entry and the inputs."""
    import torch

    from mpgcn_tpu_torch.nn import cuda_lstm

    rng = np.random.default_rng(T * R + H + F)
    s = 1 / np.sqrt(H)
    x, w_ih, b, w = (torch.from_numpy(np.asarray(a, np.float32)).to(dev)
                     for a in (rng.normal(size=(R, T, F)),
                               rng.uniform(-s, s, (4 * H, F)),
                               rng.uniform(-s, s, 4 * H),
                               rng.uniform(-s, s, (H, 4 * H))))
    err = {}
    for collect, name in ((False, "lstm_infer_last"),
                          (True, "lstm_infer_collect")):
        tag = (f"K-LSTM {label}fused {name.split('_')[-1]} T={T} R={R} "
               f"H={H} F={F}")
        out = cuda_lstm.lstm_layer_infer_fused(x, w_ih, b, w, collect)
        torch.cuda.synchronize()
        err[name] = compare(tag, out, cuda_lstm.lstm_layer_infer_fused_plain(
            x, w_ih, b, w, collect), LSTM_TOL)
        if F == 1:
            x_proj = torch.matmul(x.transpose(0, 1), w_ih.t()) + b
            require(torch.equal(out, cuda_lstm.lstm_layer_infer(
                x_proj, w, collect)), f"{tag}: differs from the x_proj form")
            print(f"[check] {tag}: bit-equal to the x_proj form fed the "
                  f"torch projection", flush=True)
    return err, (x, w_ih, b, w)


def phase_kernels(dev, rng):
    """Each kernel against its plain version at the serve shapes (the
    inference LSTM entries on x_proj and in their fused form); returns
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
    for f in (1, 3):
        fused_err, fused_in = check_fused(dev, T, R, H, f, "")
        for name, e in fused_err.items():
            err[name] = max(err[name], e)
        if f == 1:
            fused_inputs = fused_in

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
    return err, {"lstm": (xp, w), "lstm_fused": fused_inputs,
                 "bdgcn": inputs["static"],
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

    # each backward entry ends with the fixed-order sum of its per-block dW
    # partials, inside its one launch: dW must equal dw_reduce_plain of the
    # partials it wrote, to the last bit, at the training step's shapes
    xp, w, hs, cs, dhs = inputs["lstm"]
    h1, g, wr, dout = inputs["bdgcn"]
    for name, (_, dw, part) in (
            ("K-LSTM-train bwd", cuda_lstm.lstm_layer_bwd_partials(
                xp, w, hs, cs, dhs, None)),
            ("K-BDGCN-bwd", cuda_bdgcn.folded_pair_project_bwd_partials(
                h1, g, wr, dout))):
        torch.cuda.synchronize()
        require(torch.equal(dw, cuda_lstm.dw_reduce_plain(part)),
                f"{name}: the in-launch dW sum differs from the ordered sum "
                f"of its partials")
        print(f"[check] {name}: dW over P={part.shape[0]} partials of "
              f"{dw.numel()} equals dw_reduce_plain of them, bit for bit "
              f"(summed in the same launch)", flush=True)
    return err, inputs


def dense_banks(banks: dict) -> dict:
    """The banks as dense (..., N, N) stacks: blocked-ELL containers hold
    the transposed operators, dequantised here for an int8 payload."""
    import torch

    from mpgcn_tpu_torch.sparse.formats import BlockedELL

    return {k: torch.from_numpy(np.ascontiguousarray(np.swapaxes(
                b.to_dense(), -1, -2))).to(b.device)
            if isinstance(b, BlockedELL) else b for k, b in banks.items()}


def serve_phase(label, cfg, data, dev, groups, expect_per_batch,
                expect_buckets, buckets=(1, 2, 4, 8)):
    """Drive a ServeEngine through `groups` of concurrent requests; check
    the buckets dispatched, finiteness, agreement with the plain rollout
    (dense plain arms on the same supports, dequantised for int8 tiles)
    and the launch counts. Returns (engine, launches)."""
    import torch

    from mpgcn_tpu_torch.config import ServeConfig
    from mpgcn_tpu_torch.nn.mpgcn import MPGCN
    from mpgcn_tpu_torch.service.serve import ServeEngine
    from mpgcn_tpu_torch.train.predict import graphs_for, rollout

    # fresh seeded weights; the 100 ms window coalesces each group of
    # concurrent submits into one batch, so every bucket dispatches
    scfg = ServeConfig(buckets=buckets, max_wait_ms=100.0, deadline_ms=0.0,
                       output_dir=os.path.join(HERE, "smoke_out",
                                               "serve", label))
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
    require(all(launches[n] == 0 for n in TRAIN_KERNELS + ELL_TRAIN_KERNELS),
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
    pbanks = dense_banks(eng.banks)
    xt = torch.from_numpy(x).to(dev)
    kt = torch.from_numpy(keys.astype(np.int64)).to(dev)
    compare(f"serve:{label} rollout vs plain rollout", preds,
            rollout(plain, pbanks, xt, kt, cfg.pred_len), ROLLOUT_TOL)
    _, hk = eng.model(xt, graphs_for(eng.banks, kt, eng.model.sources),
                      return_hidden=True, inference=True)
    _, hp = plain(xt, graphs_for(pbanks, kt, plain.sources),
                  return_hidden=True, inference=True)
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


def bdgcn_fwd_bound(h1, g, wr):
    """K-BDGCN's bound at these inputs: h1, Gk, Wr read and out written once;
    the least work, projecting by Wr first, 2 B M N (K^2 C H + K N H)
    operations, run as 3 split TF32 products on the tensor cores. Returns
    (bound ms, bounded by, a note with the CUDA-core bound and the bytes of
    the U scratch)."""
    K, B, M, N, C = h1.shape
    H = wr.shape[-1]
    nbytes = 4 * (h1.numel() + g.numel() + wr.numel() + B * M * N * H)
    ops = 2 * B * M * N * (K * K * C * H + K * N * H)
    b_ms, b_by = bound(nbytes, 3 * ops, PEAK_TF32_FLOP_PER_S)
    return b_ms, b_by, (f"TF32 operations 3 x {ops}; CUDA-core bound "
                        f"{bound(nbytes, ops)[0]:.5f} ms; U scratch "
                        f"{4 * K * B * M * N * H} bytes")


def bdgcn_bwd_bound(h1, g, wr, dout):
    """K-BDGCN-bwd's bound: h1, Gk, Wr, dout read and dh1, dW written once;
    the least work, Z_d = G_d dout (K N H per row) then dh1 and dW (K^2 C H
    each per row), 2 B M N (K N H + 2 K^2 C H) operations, as 3 split TF32
    products. Returns (bound ms, bounded by, a note with the CUDA-core bound
    and the bytes of the Z scratch)."""
    K, B, M, N, C = h1.shape
    H = wr.shape[-1]
    nbytes = 4 * (2 * h1.numel() + dout.numel() + g.numel() + 2 * wr.numel())
    ops = 2 * B * M * N * (K * N * H + 2 * K * K * C * H)
    b_ms, b_by = bound(nbytes, 3 * ops, PEAK_TF32_FLOP_PER_S)
    return b_ms, b_by, (f"TF32 operations 3 x {ops}; CUDA-core bound "
                        f"{bound(nbytes, ops)[0]:.5f} ms; Z scratch "
                        f"{4 * K * B * M * N * H} bytes")


def lstm_wide_fwd_bound(T, R, H, nbytes):
    """The wide LSTM forward's bound: nbytes moved once; the recurrent
    product at the T - 1 steps that need one (h_{-1} = 0, so step 0 has
    none), as 3 split TF32 products on the tensor cores (the fused form's
    K = F projection, 2 T R 4H F operations, is left out: 0.1% at F = 1).
    Returns (bound ms, bounded by, a note with the CUDA-core bound)."""
    ops = 2 * max(T - 1, 0) * R * H * 4 * H
    core = bound(nbytes, ops)
    b_ms, b_by = bound(nbytes, 3 * ops, PEAK_TF32_FLOP_PER_S)
    return b_ms, b_by, (f"TF32 bound, 3 x {ops} operations; CUDA-core bound "
                        f"{core[0]:.5f} ms ({core[1]})")


def lstm_bwd_bound(T, R, H, engine):
    """The BPTT's bound at these shapes: x_proj, hs, cs, dhs and w read
    once, dx_proj and dW written once (the model path hands no dcs); the
    three recurrent products (gates, dh, dW) at the T - 1 steps that need
    them (h_{-1} = 0, so step 0 has none), as f32 FMA on the CUDA cores
    (the resident kernel) or as 3 split TF32 products on the tensor cores
    (the engine path, ``engine``). Returns (bound ms, bounded by, a note
    with both bounds)."""
    G = 4 * H
    nbytes = 4 * (2 * T * R * G + 3 * T * R * H + 2 * H * G)
    ops = 3 * 2 * max(T - 1, 0) * R * H * G
    core = bound(nbytes, ops)
    tf32 = bound(nbytes, 3 * ops, PEAK_TF32_FLOP_PER_S)
    b_ms, b_by = tf32 if engine else core
    return b_ms, b_by, (f"CUDA-core bound {core[0]:.5f} ms ({core[1]}); "
                        f"3-split TF32 bound {tf32[0]:.5f} ms ({tf32[1]})")


#: idle seconds between each end of a profiler window and the calls in it
PAD_S = 0.05


def device_activities(fn, n=5, tries=5, expect=None):
    """Device activities (kernels, copies, sets) per call of ``fn`` over
    ``n`` calls (torch.profiler): their number per call, and a note with
    each name's count and device time per call. The calls are recorded
    after a warm-up step whose trace is dropped: the profiler has been
    seen to miss the first device activity of its window, to miss one or
    two activities of a window of five 5 ms calls, and, once in a run,
    to record no device activity at all in its window (every call here
    launches at least one kernel). So the calls sit PAD_S of idle time
    inside each end of the window, and a window with no activity, or one
    whose count per call is not ``expect``, is recorded again, up to
    ``tries`` windows in all; the last is returned."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    fn()
    torch.cuda.synchronize()
    for attempt in range(tries):
        names = {}
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1)) as prof:
            fn()
            torch.cuda.synchronize()
            prof.step()
            time.sleep(PAD_S)
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
            time.sleep(PAD_S)
            prof.step()
        for e in prof.events():
            if (e.device_type == torch.autograd.DeviceType.CUDA
                    and not getattr(e, "is_user_annotation", False)):
                name = e.name.replace("void ", "").replace(
                    "(anonymous namespace)::", "").split("(")[0]
                acc = names.setdefault(name, [0, 0.0])
                acc[0] += 1
                acc[1] += e.time_range.elapsed_us()
        per_call = sum(v[0] for v in names.values()) / n
        if names and expect in (None, per_call):
            break
        print(f"[time] the profiler recorded {per_call:g} device activities "
              f"a call in window {attempt + 1} of {tries}", flush=True)
    return per_call, (f"{per_call:g} ("
                      + ", ".join(f"{k} x{c / n:g} {us / n:.1f} us"
                                  for k, (c, us) in names.items()) + ")")


def lstm_bwd_time(dev, xp, w, hs, cs, dhs, iters, plain_iters, lib_bwd):
    """lstm_train_bwd's entry at these inputs (the model path hands no
    dcs), called directly: its time, the plain and library times and its
    bound; and a note with P, both bounds, the scratch bytes and the
    device launches of one call."""
    from mpgcn_tpu_torch.nn import cuda_lstm

    T, R, G = xp.shape
    H = G // 4
    P = cuda_lstm.bwd_blocks(R, H, dev)
    dxp = xp.new_empty(xp.shape)
    part = xp.new_empty((P, H, G))
    dw = xp.new_empty((H, G))
    scratch = cuda_lstm.bwd_scratch(R, H, dev)
    engine = scratch is not None
    b_ms, b_by, note = lstm_bwd_bound(T, R, H, engine)

    def call():
        cuda_lstm.LSTM_TRAIN_BWD.launch(
            (xp, w, hs, cs, dhs, None, dxp, part, dw, scratch), (T, R, H, P))

    entry = dict(
        ms=time_ms(call, iters=iters),
        plain_ms=time_ms(lambda: cuda_lstm.lstm_layer_bwd_plain(
            xp, w, hs, cs, dhs, None), iters=plain_iters),
        library_ms=lib_bwd, bound_ms=b_ms, bound_by=b_by)
    scratch_bytes = 0 if scratch is None else 4 * scratch.numel()
    want = 2 * T + 1 if engine else 1
    per_call, launches = device_activities(call, expect=want)
    require(per_call == want, f"lstm_train_bwd at T={T} R={R} H={H}: "
            f"{per_call:g} device launches per call, not {want}")
    note = (f"P={P}, {'split-TF32 engine' if engine else 'resident kernel'}"
            f"; {note}; scratch {scratch_bytes} bytes; device launches per "
            f"call {launches}")
    return entry, note


def fused_time(label, inputs, lib_ms, iters=50, plain_iters=10):
    """The fused inference layer from x (h_T only) at these inputs: its
    time beside its bound (its recurrent and projection FMAs, or x, the
    weights and h_T once), the plain version's, the x_proj form's fed the
    torch projection (what the model ran before the fusion: product, bias
    add and kernel), and nn.LSTM's (cuDNN, projection included)."""
    import torch

    from mpgcn_tpu_torch.nn import cuda_lstm

    x, w_ih, b, w = inputs
    R, T, F = x.shape
    H = w.shape[0]
    b_ms, b_by = bound(4 * (x.numel() + w_ih.numel() + b.numel()
                            + w.numel() + R * H),
                       2 * T * R * 4 * H * (H + F))
    entry = dict(
        ms=time_ms(lambda: cuda_lstm.lstm_layer_infer_fused(
            x, w_ih, b, w, False), iters=iters),
        unfused_ms=time_ms(lambda: cuda_lstm.lstm_layer_infer(
            torch.matmul(x.transpose(0, 1), w_ih.t()) + b, w, False),
            iters=iters),
        plain_ms=time_ms(lambda: cuda_lstm.lstm_layer_infer_fused_plain(
            x, w_ih, b, w, False), iters=plain_iters, warmup=1),
        library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by)
    print(f"[time] {label} lstm_infer_last fused from x (T={T}, R={R}, "
          f"H={H}, F={F}; unfused_ms: the torch projection, its bias add "
          f"and the kernel on x_proj; library torch.nn.LSTM, projection "
          f"included): {json.dumps(entry)}", flush=True)


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
        b_ms, b_by, extra = bdgcn_fwd_bound(h1, g, wr)
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
        K, B, M, N, C = h1.shape
        print(f"[time] K-BDGCN {label} B={B} N={N} ({extra}; library "
              f"torch.einsum): {json.dumps(entry)}")
    for name in ("lstm_infer_last", "lstm_infer_collect"):
        print(f"[time] K-LSTM {name}: {json.dumps(times[name])}")
    fused_time("N=47 serve", kin["lstm_fused"], lib_ms)

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
    b = eng.scfg.buckets[-1]
    x = torch.from_numpy(np.array(md.x[:b])).to(dev)
    k = torch.from_numpy(md.keys[:b].astype(np.int64)).to(dev)
    _, acts = device_activities(
        lambda: rollout(eng.model, eng.banks, x, k, eng.cfg.pred_len), n=3)
    print(f"[time] bucket-{b} rollout device activities per call: {acts}",
          flush=True)

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


def _per_step(cfg, train: bool, impl: str = "kernel") -> dict:
    """Launches of one training step (train) or one validation step on the
    dense kernel arm, or on the ELL arm (impl "ell": 1 + K SpMMs per BDGCN
    layer, on the int8 entries for an int8 payload; with
    cfg.fused_epilogue 1 + 1, and a training step's backward runs the
    destination SpMM once more, inside its checkpoint); the csr arm
    launches no BDGCN kernel."""
    M, L, G = cfg.num_branches, cfg.lstm_num_layers, cfg.gcn_num_layers
    counts = dict.fromkeys(KERNEL_META, 0)
    if train:
        counts.update(lstm_train_fwd=M * L, lstm_train_bwd=M * L)
    else:
        counts.update(lstm_infer_last=M, lstm_infer_collect=M * (L - 1))
    if impl == "csr":
        return counts
    if impl == "ell":
        q = "_q" if cfg.support_payload == "int8" else ""
        fused = cfg.fused_epilogue
        spmm = M * G * (1 + (1 if fused else cfg.support_K))
        counts[f"ell_fwd{q}"] = spmm + (M * G if fused and train else 0)
        if train:
            counts[f"ell_bwd_dx{q}"] = spmm
    else:
        counts["bdgcn_pair_fwd"] = M * G
        if train:
            counts["bdgcn_pair_bwd"] = M * G
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
        model = MPGCN.from_config(tcfg.replace(seed=seed), device=dev,
                                  bdgcn_impl=pipe.bdgcn_impl)
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


def batch_grads(model, tr, batch, f64, dev):
    """(loss, {name: grad}, the last ReLU's mask per branch) of the masked
    MSE batch loss of ``model`` on ``tr``'s banks (float64 inputs, supports
    and residual when ``f64``); a target of several frames is the
    multi-step loss, through the differentiable rollout."""
    import torch

    from mpgcn_tpu_torch.train.objectives import elementwise_loss
    from mpgcn_tpu_torch.train.predict import graphs_for

    model.zero_grad(set_to_none=True)
    xb, yb, kb = tr._tensors(batch)
    g = graphs_for(tr.banks, kb, model.sources)
    if f64:
        g = [tuple(t.double() for t in G) if isinstance(G, tuple)
             else G.double() for G in g]
        xb, yb = xb.double(), yb.double()
    pred, hidden = model(xb, g, return_hidden=True, inference=False)
    if yb.shape[1] > 1:
        # the multi-step objective: the rollout over y's frames (the masks
        # are the first step's)
        from mpgcn_tpu_torch.train.predict import rollout_train

        pred = rollout_train(model, g, xb, yb.shape[1])
    # the trainer's MSE, with the residual kept in float64 for the
    # reference (elementwise_loss upcasts to f32 only)
    err = ((pred - yb) ** 2 if f64 else elementwise_loss("MSE", pred, yb))
    per = err.reshape(len(pred), -1).mean(1)
    mask = (torch.arange(len(pred), device=dev) < batch.size).to(per.dtype)
    loss = (per * mask).sum() / batch.size
    loss.backward()
    out = {n: p.grad.detach().clone() for n, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    return (float(loss.detach()), out,
            [h.detach()[:batch.size] > 0 for h in hidden])


def grad_check(label, batch, kern, plain, ref64, dev):
    """The kernel arms' and the plain arms' f32 loss and gradients against
    the plain arms in float64, and against each other: rtol 1e-4 with an
    atol of 1e-4 x each tensor's largest entry; prints the last-layer ReLU
    entries that fall on the other side of zero than in float64."""
    import torch

    lk, gk, mk = batch_grads(kern.model, kern, batch, False, dev)
    lp, gp, mp = batch_grads(plain.model, plain, batch, False, dev)
    l64, g64, m64 = batch_grads(ref64, plain, batch, True, dev)
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
          + ", ".join(f"{k} {v:.3e} ({n})" for k, (v, n) in worst.items())
          + f"; last-ReLU entries on the other side of zero than in "
            f"float64: kernel {flips['kernel']}, plain {flips['plain']} of "
            f"{sum(m.numel() for m in m64)}; no gradient all zero",
          flush=True)


def phase_train(dev, cfg, data, out_dir):
    """The training path at the reference configuration (train mode trains
    the single-step model: pred_len 1), fresh seeded weights. Returns the
    launches of the training run and of the test-mode run, and trainers
    for the timing phase."""
    import torch

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
    for label, batch in (("full batch", full),
                         ("padded batch (size 3 of 4)", partial)):
        grad_check(label, batch, kern, plain, ref64, dev)

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
    b_ms, b_by = bound(4 * (T * R * G + H * G + 2 * T * R * H),
                       2 * T * R * H * G)
    times["lstm_train_fwd"] = dict(
        ms=time_ms(lambda: cuda_lstm.lstm_layer_train(xp, w)),
        plain_ms=time_ms(lambda: cuda_lstm.lstm_layer_train_plain(xp, w),
                         iters=10),
        library_ms=lib_fwd, bound_ms=b_ms, bound_by=b_by)
    times["lstm_train_bwd"], note = lstm_bwd_time(dev, xp, w, hs, cs, dhs,
                                                  50, 10, lib_bwd)
    print(f"[time] K-LSTM-train backward wrapper (one call: BPTT and its "
          f"dW sum; allocations): "
          f"{time_ms(lambda: cuda_lstm.lstm_layer_bwd(xp, w, hs, cs, dhs, None)):.4f}"
          f" ms; {note}; library calls: torch.nn.LSTM (cuDNN, input "
          f"projection included) forward and backward at R={R}, T={T}, "
          f"H={H}")

    for key, eq in (("bdgcn", "obmcl,dce,odlh->bmeh"),
                    ("bdgcn_dynamic", "obmcl,bdce,odlh->bmeh")):
        h1, g, wr, dout = kin[key]
        K, B, M, N, C = h1.shape
        Hh = wr.shape[-1]
        P = cuda_bdgcn.bwd_blocks(B * M * N, K, C, Hh, dev)
        dh1 = torch.empty_like(h1)
        z = torch.empty((K, B, M, N, Hh), dtype=torch.float32, device=dev)
        prt = torch.empty((P, K, K, C, Hh), dtype=torch.float32, device=dev)
        dW = torch.empty((K, K, C, Hh), dtype=torch.float32, device=dev)
        b_ms, b_by, extra = bdgcn_bwd_bound(h1, g, wr, dout)
        h1r = h1.clone().requires_grad_()
        wrr = wr.clone().requires_grad_()
        ref = torch.einsum(eq, h1r, g[0] if key == "bdgcn" else g, wrr)
        entry = dict(
            ms=time_ms(lambda: cuda_bdgcn.BDGCN_PAIR_BWD.launch(
                (h1, g, wr, dout, dh1, z, prt, dW),
                (K, B, M, N, C, Hh, g.shape[0], P))),
            plain_ms=time_ms(lambda: cuda_bdgcn.folded_pair_project_bwd_plain(
                h1, g, wr, dout), iters=10),
            library_ms=time_ms(lambda: torch.autograd.grad(
                ref, (h1r, wrr), dout, retain_graph=True), iters=10),
            bound_ms=b_ms, bound_by=b_by)
        label = "static" if key == "bdgcn" else "dynamic"
        print(f"[time] K-BDGCN-bwd {label} B={B} N={N} (one entry: dW sum "
              f"over P={P} partials in the same launch; {extra}; library "
              f"autograd through torch.einsum): {json.dumps(entry)}")
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


# --- the wide widths ----------------------------------------------------------

#: the wide configuration: hidden 128 (w_hh^T past a block's shared memory)
#: and dual_random_walk_diffusion of order 3 (K = 2 * 3 + 1 = 7 supports),
#: at the reference N = 47 and batch 4
WIDE = dict(hidden_dim=128, kernel_type="dual_random_walk_diffusion",
            cheby_order=3)
#: LSTM (T, R, H) beyond the resident kernels: the wide model's serve
#: (bucket 8) and training shapes at H = 128, then the other widths the
#: JAX kernels take and the card refused before (H = 1,030 past a block's
#: 1,024 threads)
WIDE_LSTM = [(7, 8 * 47 * 47, 128), (7, 4 * 47 * 47, 128), (7, 1001, 65),
             (5, 333, 96), (3, 257, 256), (2, 9, 1030)]
#: K-BDGCN (K, B, N, C, H) past the reference widths: the wide model's
#: serve (B = 8) and training (B = 4) shapes, then ragged tiles and depths
WIDE_BDGCN = [(7, 8, 47, 128, 128), (7, 4, 47, 128, 128), (6, 2, 33, 65, 33),
              (9, 2, 21, 16, 16), (3, 2, 47, 32, 128)]


def _dw_bits(name, dw, part, dw2):
    """A fused dW sum equals dw_reduce_plain of its partials and a second
    run, bit for bit."""
    import torch

    from mpgcn_tpu_torch.nn import cuda_lstm

    require(torch.equal(dw, cuda_lstm.dw_reduce_plain(part)),
            f"{name}: the in-launch dW sum differs from the ordered sum of "
            f"its partials")
    require(torch.equal(dw, dw2), f"{name}: two runs differ")
    print(f"[check] {name}: dW over P={part.shape[0]} partials equals "
          f"dw_reduce_plain of them and a second run, bit for bit",
          flush=True)


def phase_wide_kernels(dev, rng):
    """The six LSTM and K-BDGCN entries against their plain versions at the
    wide widths (WIDE_LSTM, WIDE_BDGCN; static and dynamic supports), each
    once per call; the backward entries' dW bit for
    bit against dw_reduce_plain of their partials and over two runs.
    Returns the per-entry worst error and the timing inputs."""
    import torch

    from mpgcn_tpu_torch.nn import cuda_bdgcn, cuda_lstm

    def dev_t(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev)

    t0 = time.perf_counter()
    names = ("lstm_infer_last", "lstm_infer_collect", "lstm_train_fwd",
             "lstm_train_bwd", "bdgcn_pair_fwd", "bdgcn_pair_bwd")
    err = dict.fromkeys(names, 0.0)
    entries = kernels()
    inputs = {}
    for T, R, H in WIDE_LSTM:
        tag = f"T={T} R={R} H={H}"
        xp = dev_t(rng.normal(size=(T, R, 4 * H)))
        w = dev_t(rng.normal(size=(H, 4 * H)) / np.sqrt(H))
        before = {n: entries[n].launches for n in names}
        for collect, name in ((False, "lstm_infer_last"),
                              (True, "lstm_infer_collect")):
            out = cuda_lstm.lstm_layer_infer(xp, w, collect)
            torch.cuda.synchronize()
            err[name] = max(err[name], compare(
                f"K-LSTM wide {name.split('_')[-1]} {tag}", out,
                cuda_lstm.lstm_layer_infer_plain(xp, w, collect), LSTM_TOL))
        hs, cs = cuda_lstm.lstm_layer_train(xp, w)
        torch.cuda.synchronize()
        hp, cp = cuda_lstm.lstm_layer_train_plain(xp, w)
        err["lstm_train_fwd"] = max(
            err["lstm_train_fwd"],
            compare(f"K-LSTM-train wide fwd hs {tag}", hs, hp, LSTM_TOL),
            compare(f"K-LSTM-train wide fwd cs {tag}", cs, cp, LSTM_TOL))
        dhs = dev_t(rng.normal(size=(T, R, H)))
        dcs = dev_t(rng.normal(size=(T, R, H))) if R < 5000 else None
        dxp, dw, part = cuda_lstm.lstm_layer_bwd_partials(xp, w, hs, cs,
                                                          dhs, dcs)
        torch.cuda.synchronize()
        dxr, dwr = cuda_lstm.lstm_layer_bwd_plain(xp, w, hs, cs, dhs, dcs)
        err["lstm_train_bwd"] = max(
            err["lstm_train_bwd"],
            compare(f"K-LSTM-train wide bwd dx_proj {tag}", dxp, dxr,
                    LSTM_TOL),
            compare(f"K-LSTM-train wide bwd dW_hh^T {tag}", dw, dwr, None))
        after = {n: entries[n].launches - before[n] for n in names}
        require(after == {**dict.fromkeys(names[:4], 1),
                          "bdgcn_pair_fwd": 0, "bdgcn_pair_bwd": 0},
                f"K-LSTM wide {tag}: launches {after}, one per call")
        for name, e in check_fused(dev, T, R, H, 1, "wide ")[0].items():
            err[name] = max(err[name], e)
        if H == 128:
            _dw_bits(f"K-LSTM-train wide bwd {tag}", dw, part,
                     cuda_lstm.lstm_layer_bwd(xp, w, hs, cs, dhs, dcs)[1])
            inputs["lstm_serve" if R == 8 * 47 * 47 else "lstm_train"] = (
                xp, w, hs, cs, dhs)
        del xp, w, hs, cs, hp, cp, dhs, dcs, dxp, dw, part, dxr, dwr

    for K, B, N, C, H in WIDE_BDGCN:
        for dynamic in (False, True):
            tag = (f"{'dynamic' if dynamic else 'static'} K={K} B={B} N={N} "
                   f"C={C} H={H}")
            h1 = dev_t(rng.normal(size=(K, B, N, N, C)))
            g = dev_t(rng.random((B if dynamic else 1, K, N, N)) / N * 2)
            wr = dev_t(rng.normal(size=(K, K, C, H)) / np.sqrt(K * K * C))
            dout = dev_t(rng.normal(size=(B, N, N, H)))
            before = {n: entries[n].launches for n in names[4:]}
            out = cuda_bdgcn.folded_pair_project(h1, g, wr)
            dh1, dW, part = cuda_bdgcn.folded_pair_project_bwd_partials(
                h1, g, wr, dout)
            torch.cuda.synchronize()
            after = {n: entries[n].launches - before[n] for n in names[4:]}
            require(after == {"bdgcn_pair_fwd": 1, "bdgcn_pair_bwd": 1},
                    f"K-BDGCN wide {tag}: launches {after}, one per call")
            err["bdgcn_pair_fwd"] = max(err["bdgcn_pair_fwd"], compare(
                f"K-BDGCN wide {tag}", out,
                cuda_bdgcn.folded_pair_project_plain(h1, g, wr), BDGCN_TOL))
            r1, rW = cuda_bdgcn.folded_pair_project_bwd_plain(h1, g, wr, dout)
            err["bdgcn_pair_bwd"] = max(
                err["bdgcn_pair_bwd"],
                compare(f"K-BDGCN-bwd wide dh1 {tag}", dh1, r1, BDGCN_TOL),
                compare(f"K-BDGCN-bwd wide dW {tag}", dW, rW, None))
            if (K, C, H) == (7, 128, 128):
                _dw_bits(f"K-BDGCN-bwd wide {tag}", dW, part,
                         cuda_bdgcn.folded_pair_project_bwd(h1, g, wr,
                                                            dout)[1])
                if not dynamic:
                    inputs[f"bdgcn_B{B}"] = (h1, g, wr, dout)
    print(f"[wide] kernel checks in {time.perf_counter() - t0:.1f}s",
          flush=True)
    return err, inputs


def phase_wide_model(dev, data, out_dir):
    """The wide configuration (WIDE) at N = 47, batch 4, from the first
    live init seed: a ServeEngine answers one bucket-8 batch through the
    kernels, matching the plain rollout over horizon 7; the kernel and
    plain arms' gradients against float64; 20 training steps whose losses
    track the plain arms'; then the CLI trains one epoch and tests on a
    small synthetic set (N = 20). Returns each run's launches and the
    timing state."""
    import torch

    from mpgcn_tpu_torch import cli
    from mpgcn_tpu_torch.config import MPGCNConfig
    from mpgcn_tpu_torch.train.trainer import ModelTrainer

    t0 = time.perf_counter()
    cfg = MPGCNConfig(**WIDE)
    require(cfg.support_K == 7, f"K = {cfg.support_K}")
    # at hidden 128 a branch's FC+ReLU head is live on every entry or on
    # none, so live seeds are rarer than at the reference widths
    cfg = cfg.replace(seed=live_init_seed(cfg, data, dev, tries=64))
    eng, serve_counts = serve_phase(
        "wide", cfg, data, dev, groups=(8,),
        expect_per_batch={"lstm_infer_last": 14, "lstm_infer_collect": 0,
                          "bdgcn_pair_fwd": 42},
        expect_buckets=(8,), buckets=(8,))

    tcfg = cfg.replace(pred_len=1, output_dir=out_dir)
    kern = ModelTrainer(tcfg, data, device=dev)
    plain = ModelTrainer(tcfg, data, device=dev, lstm_impl="plain",
                         bdgcn_impl="einsum")
    plain.model.load_state_dict(kern.model.state_dict())
    batches = list(kern.pipeline.batches("train", pad_to_full=True))
    ref64 = copy.deepcopy(plain.model).double()
    grad_check("wide (hidden 128, K=7) full batch", batches[0], kern, plain,
               ref64, dev)
    del ref64
    curve = {"kernel": [], "plain": []}
    reset_counts()
    for batch in batches[:20]:
        curve["kernel"].append(kern.train_step(batch))
    train_counts = read_counts()
    for batch in batches[:20]:
        curve["plain"].append(plain.train_step(batch))
    require(train_counts == _scaled(_per_step(tcfg, True), 20),
            f"20 wide training steps launched {train_counts}")
    ck, cp = np.array(curve["kernel"]), np.array(curve["plain"])
    rel = float(np.max(np.abs(ck - cp) / np.abs(cp)))
    print(f"[wide] first 20 step losses, kernel arms: "
          f"{[round(v, 6) for v in curve['kernel']]}; max relative "
          f"difference from the plain arms {rel:.3e} (rtol "
          f"{LOSS_CURVE_RTOL})", flush=True)
    require(np.all(np.isfinite(ck)) and rel <= LOSS_CURVE_RTOL,
            "the wide kernel arms' loss curve leaves the plain arms'")
    print(f"[wide] serve, gradient check and 20 steps in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    t0 = time.perf_counter()

    cli_out = os.path.join(out_dir, "cli")
    os.makedirs(cli_out)
    argv = ["-GPU", "0", "-data", "synthetic", "-hidden", "128", "-kernel",
            "dual_random_walk_diffusion", "-K", "3", "-sN", "20", "-sT",
            "60", "-epoch", "1", "-out", cli_out]
    reset_counts()
    hist = cli.main(argv)
    cli_train = read_counts()
    res = cli.main(argv + ["-mode", "test"])
    cli_test = _add(read_counts(), _scaled(cli_train, -1))
    require(all(cli_train[n] > 0 for n in ("lstm_train_fwd",
                                           "lstm_train_bwd", "bdgcn_pair_fwd",
                                           "bdgcn_pair_bwd"))
            and cli_test["lstm_infer_last"] > 0
            and np.all(np.isfinite(hist["train"]))
            and len(res["test"]["RMSE_by_horizon"]) == 7,
            f"the wide CLI run: train launches {cli_train}, test launches "
            f"{cli_test}, losses {hist}")
    print(f"[wide] CLI -hidden 128 -kernel dual_random_walk_diffusion -K 3 "
          f"(N=20): one epoch, losses {hist}; test RMSE "
          f"{res['test']['RMSE']:.6f}; launches train "
          f"{ {n: v for n, v in cli_train.items() if v} }, test "
          f"{ {n: v for n, v in cli_test.items() if v} } in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    return dict(counts=[serve_counts, train_counts, cli_train, cli_test],
                eng=eng, trainer=kern, batches=batches)


def phase_wide_times(dev, kin, wide):
    """The six entries at the wide model's shapes (hidden 128, K = 7, N =
    47), lstm_infer_last also fused from x (F = 1, the form the wide
    model's first layer runs): kernel, plain and library times (CUDA
    events) beside their bounds (the split-TF32 entries' TF32 bound, the
    CUDA-core bound beside it); the wide rollout at bucket 8 and train
    step on the host clock."""
    import statistics

    import torch

    from mpgcn_tpu_torch.nn import cuda_bdgcn, cuda_lstm
    from mpgcn_tpu_torch.train.predict import rollout

    times, notes = {}, {}
    xp, w, *_ = kin["lstm_serve"]
    T, R, G = xp.shape
    H = G // 4
    lib = torch.nn.LSTM(1, H, batch_first=True).to(dev)
    seq = torch.randn((R, T, 1), device=dev)
    with torch.no_grad():
        lib_ms = time_ms(lambda: lib(seq), iters=10)
    for collect, name in ((False, "lstm_infer_last"),
                          (True, "lstm_infer_collect")):
        b_ms, b_by, notes[name] = lstm_wide_fwd_bound(
            T, R, H, xp.numel() * 4 + w.numel() * 4
            + (T if collect else 1) * R * H * 4)
        times[name] = dict(
            ms=time_ms(lambda: cuda_lstm.lstm_layer_infer(xp, w, collect),
                       iters=10),
            plain_ms=time_ms(lambda: cuda_lstm.lstm_layer_infer_plain(
                xp, w, collect), iters=5),
            library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by)
    # the form the wide model's first layer runs: fused from x (F = 1)
    gen = torch.Generator(device=dev).manual_seed(128)
    s = 1 / H ** 0.5
    x, w_ih, bias = (torch.randn((R, T, 1), generator=gen, device=dev),
                     (torch.rand((G, 1), generator=gen, device=dev) * 2 - 1)
                     * s,
                     (torch.rand((G,), generator=gen, device=dev) * 2 - 1)
                     * s)
    name = "lstm_infer_last fused from x (F=1)"
    b_ms, b_by, notes[name] = lstm_wide_fwd_bound(
        T, R, H, 4 * (x.numel() + w_ih.numel() + bias.numel() + w.numel()
                      + R * H))
    times[name] = dict(
        ms=time_ms(lambda: cuda_lstm.lstm_layer_infer_fused(
            x, w_ih, bias, w, False), iters=10),
        plain_ms=time_ms(lambda: cuda_lstm.lstm_layer_infer_fused_plain(
            x, w_ih, bias, w, False), iters=5),
        library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by)
    xp, w, hs, cs, dhs = kin["lstm_train"]
    T, R, G = xp.shape
    lib = torch.nn.LSTM(1, H, batch_first=True).to(dev)
    seq = torch.randn((R, T, 1), device=dev, requires_grad=True)
    lib_fwd = time_ms(lambda: lib(seq), iters=10)
    out, _ = lib(seq)
    gout = torch.randn_like(out)
    lib_params = [seq, *lib.parameters()]
    lib_bwd = time_ms(lambda: torch.autograd.grad(out, lib_params, gout,
                                                  retain_graph=True),
                      iters=10)
    b_ms, b_by, notes["lstm_train_fwd"] = lstm_wide_fwd_bound(
        T, R, H, 4 * (T * R * G + H * G + 2 * T * R * H))
    times["lstm_train_fwd"] = dict(
        ms=time_ms(lambda: cuda_lstm.lstm_layer_train(xp, w), iters=10),
        plain_ms=time_ms(lambda: cuda_lstm.lstm_layer_train_plain(xp, w),
                         iters=5),
        library_ms=lib_fwd, bound_ms=b_ms, bound_by=b_by)
    times["lstm_train_bwd"], notes["lstm_train_bwd"] = lstm_bwd_time(
        dev, xp, w, hs, cs, dhs, 10, 5, lib_bwd)
    serve_rows = kin["lstm_serve"][0].shape[1]
    for name in times:
        rows = R if "train" in name else serve_rows
        print(f"[time] wide {name} T={T} R={rows} H={H} ({notes[name]}; "
              f"library torch.nn.LSTM, cuDNN, input projection included): "
              f"{json.dumps(times[name])}", flush=True)

    for key, name in (("bdgcn_B8", "bdgcn_pair_fwd"),
                      ("bdgcn_B4", "bdgcn_pair_bwd")):
        h1, g, wr, dout = kin[key]
        K, B, M, N, C = h1.shape
        Hh = wr.shape[-1]
        eq = "obmcl,dce,odlh->bmeh"
        if name == "bdgcn_pair_fwd":
            b_ms, b_by, extra = bdgcn_fwd_bound(h1, g, wr)
            entry = dict(
                ms=time_ms(lambda: cuda_bdgcn.folded_pair_project(h1, g, wr),
                           iters=10),
                plain_ms=time_ms(lambda: cuda_bdgcn.folded_pair_project_plain(
                    h1, g, wr), iters=3),
                library_ms=time_ms(lambda: torch.einsum(eq, h1, g[0], wr),
                                   iters=3),
                bound_ms=b_ms, bound_by=b_by)
        else:
            P = cuda_bdgcn.bwd_blocks(B * M * N, K, C, Hh, dev)
            dh1 = torch.empty_like(h1)
            z = torch.empty((K, B, M, N, Hh), dtype=torch.float32,
                            device=dev)
            prt = torch.empty((P, K, K, C, Hh), dtype=torch.float32,
                              device=dev)
            dW = torch.empty((K, K, C, Hh), dtype=torch.float32, device=dev)
            b_ms, b_by, extra = bdgcn_bwd_bound(h1, g, wr, dout)
            h1r = h1.clone().requires_grad_()
            wrr = wr.clone().requires_grad_()
            ref = torch.einsum(eq, h1r, g[0], wrr)
            entry = dict(
                ms=time_ms(lambda: cuda_bdgcn.BDGCN_PAIR_BWD.launch(
                    (h1, g, wr, dout, dh1, z, prt, dW),
                    (K, B, M, N, C, Hh, g.shape[0], P)), iters=10),
                plain_ms=time_ms(
                    lambda: cuda_bdgcn.folded_pair_project_bwd_plain(
                        h1, g, wr, dout), iters=3),
                library_ms=time_ms(lambda: torch.autograd.grad(
                    ref, (h1r, wrr), dout, retain_graph=True), iters=3),
                bound_ms=b_ms, bound_by=b_by)
            extra = f"dW over P={P} partials; {extra}"
        times[name] = entry
        lib = ("autograd through torch.einsum" if name == "bdgcn_pair_bwd"
               else "torch.einsum")
        print(f"[time] wide {name} static K={K} B={B} N={N} C={C} H={Hh} "
              f"({extra}; library {lib}): {json.dumps(entry)}", flush=True)

    eng = wide["eng"]
    md = eng.pipeline.modes["test"]
    x = torch.from_numpy(np.array(md.x[:8])).to(dev)
    k = torch.from_numpy(md.keys[:8].astype(np.int64)).to(dev)
    samples = []
    for i in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rollout(eng.model, eng.banks, x, k, eng.cfg.pred_len)
        torch.cuda.synchronize()
        if i >= 1:
            samples.append((time.perf_counter() - t0) * 1e3)
    steps = _step_ms(wide["trainer"], wide["batches"], 5, 1)
    print(f"[time] wide rollout (bucket 8, horizon 7, host clock, median of "
          f"4 after 1 warm-up): {statistics.median(samples):.3f} ms; wide "
          f"train step (batch 4, median of 5 after 1): "
          f"{statistics.median(steps):.3f} ms", flush=True)
    return times


# --- the sparse path ----------------------------------------------------------

#: ELL SpMM forward and dX: f32 sums of up to MB x 128 products, in another
#: order than the plain version's per-slot einsums; the forward's TF32
#: products split each f32 operand into two TF32 parts (about 2^-21
#: relative per product)
ELL_TOL = dict(rtol=1e-5, atol=1e-5)
#: odd sizes: (stack, tile width, pattern, F, per-sample X) -- ragged N over
#: several column blocks, MB = 1 (block diagonal), MB = the column-block
#: count (dense), F not a multiple of any tile
ELL_ODD = [((3, 21, 21), 8, "random", 5, False),
           ((2, 3, 21, 21), 8, "random", 700, True),
           ((3, 64, 64), 8, "diagonal", 513, False),
           ((2, 40, 40), 16, "dense", 37, True)]


def large_n_data(cfg):
    """The large-N data: cfg's synthetic series projected onto a band of
    density LARGE_N_DENSITY (benchmarks/large_n.py --density 0.05)."""
    from mpgcn_tpu_torch.data.loader import apply_density, synthetic_dataset

    data = synthetic_dataset(cfg)
    apply_density(data, LARGE_N_DENSITY)
    return data


def _odd_container(dev, shape, bc, pattern, rng):
    from mpgcn_tpu_torch.sparse.formats import ell_from_dense

    N = shape[-1]
    A = rng.normal(size=shape).astype(np.float32)
    if pattern == "random":
        A *= rng.random(shape) < 0.3
        A[..., 1, :] = 0.0
    elif pattern == "diagonal":  # row block i meets column block i only
        A *= np.arange(N)[:, None] // bc == np.arange(N)[None, :] // bc
    return ell_from_dense(A, br=8, bc=bc).to(dev)


def check_ell(tag, ell, X, dout, x_div, err):
    """ell_fwd / ell_bwd_dx (or their int8 entries) against the plain
    versions, each twice (bit-equal); updates err per entry."""
    import torch

    from mpgcn_tpu_torch.sparse import cuda_ell
    from mpgcn_tpu_torch.sparse.kernels import flat_stack

    cols, tiles, scale, t_ptr, t_slot = flat_stack(ell)
    q = "_q" if scale is not None else ""
    n = ell.n_rows
    out = cuda_ell.ell_fwd(cols, tiles, t_ptr, t_slot, X, n, x_div, scale)
    dx = cuda_ell.ell_bwd_dx(cols, tiles, t_ptr, t_slot, dout, ell.n_cols,
                             x_div, scale)
    torch.cuda.synchronize()
    err[f"ell_fwd{q}"] = max(err[f"ell_fwd{q}"], compare(
        f"ELL fwd{q} {tag}", out,
        cuda_ell.ell_fwd_plain(cols, tiles, X, n, x_div, scale), ELL_TOL))
    out2 = cuda_ell.ell_fwd(cols, tiles, t_ptr, t_slot, X, n, x_div, scale)
    require(torch.equal(out, out2), f"ELL fwd{q} {tag}: two runs differ")
    del out, out2
    err[f"ell_bwd_dx{q}"] = max(err[f"ell_bwd_dx{q}"], compare(
        f"ELL dX{q} {tag}", dx, cuda_ell.ell_bwd_dx_plain(
            cols, tiles, dout, ell.n_cols, x_div, scale), ELL_TOL))
    dx2 = cuda_ell.ell_bwd_dx(cols, tiles, t_ptr, t_slot, dout, ell.n_cols,
                              x_div, scale)
    require(torch.equal(dx, dx2), f"ELL dX{q} {tag}: two runs differ")
    print(f"[check] ELL fwd{q} and dX{q} {tag}: bit-equal over two runs",
          flush=True)


def check_dx_float64(tag, ell, dout, x_div):
    """ell_bwd_dx (or its int8 entry) against the plain version in float64
    (tiles, scales and dout widened; the int8 codes are exact), at
    ELL_TOL: the split-TF32 products and the f32 sums against the exact
    sum."""
    import torch

    from mpgcn_tpu_torch.sparse import cuda_ell
    from mpgcn_tpu_torch.sparse.kernels import flat_stack

    cols, tiles, scale, t_ptr, t_slot = flat_stack(ell)
    q = "_q" if scale is not None else ""
    dx = cuda_ell.ell_bwd_dx(cols, tiles, t_ptr, t_slot, dout, ell.n_cols,
                             x_div, scale)
    torch.cuda.synchronize()
    ref = cuda_ell.ell_bwd_dx_plain(
        cols, tiles if q else tiles.double(), dout.double(), ell.n_cols,
        x_div, scale.double() if q else None)
    compare(f"ELL dX{q} {tag} against float64", dx.double(), ref, ELL_TOL)


def phase_ell_kernels(dev, banks, rng):
    """The five ELL entries against their plain versions: at the large-N
    shapes (the static bank (3, 63, 2, 8, 128) with one X of F = B N C =
    32,000; the dynamic O bank gathered for a batch of 2, (6, 63, 2, 8,
    128), with per-sample X of F = N C = 16,000) on f32, bf16 and int8
    tiles, and at odd sizes; dBlocks through torch.autograd.grad with
    respect to the tiles of a pad-free N=500 container (the path of its
    counted launches). Returns (errors, dBlocks launches, timing inputs)."""
    import torch

    from mpgcn_tpu_torch.sparse import cuda_ell
    from mpgcn_tpu_torch.sparse.formats import (
        BlockedELL,
        ell_from_dense,
        pack_payload,
    )
    from mpgcn_tpu_torch.sparse.kernels import ell_spmm, flat_stack

    def dev_t(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev)

    err = {n: 0.0 for n in ("ell_fwd", "ell_fwd_q", "ell_bwd_dx",
                            "ell_bwd_dx_q", "ell_bwd_dblk")}
    B, C = LARGE_N["batch_size"], 32
    keys = torch.tensor([0, 3], device=dev)
    static, dyn = banks["static"], banks["o"][keys]
    N = static.n_cols
    inputs = {}
    for label, ell, xs in (("static", static, (N, B * N * C)),
                           ("dynamic", dyn, (B, N, N * C))):
        S = int(np.prod(ell.block_cols.shape[:-2]))
        X = dev_t(rng.normal(size=xs)).reshape(-1, N, xs[-1])
        dout = dev_t(rng.normal(size=(S, N, xs[-1])))
        for payload in ("f32", "bf16", "int8"):
            packed = pack_payload(ell, payload)
            tag = (f"{label} {payload} S={S} NB={ell.block_cols.shape[-2]} "
                   f"MB={ell.pad_blocks} F={xs[-1]}")
            check_ell(tag, packed, X, dout, S // X.shape[0], err)
            if label == "static":
                inputs[payload] = (packed, X, dout)
            if label == "static" and payload != "bf16":
                check_dx_float64(tag, packed, dout, S // X.shape[0])
    for shape, bc, pattern, F, per_sample in ELL_ODD:
        ell = _odd_container(dev, shape, bc, pattern, rng)
        S = int(np.prod(shape[:-2]))
        G = shape[0] if per_sample else 1
        X = dev_t(rng.normal(size=(G, shape[-1], F)))
        dout = dev_t(rng.normal(size=(S, shape[-1], F)))
        for payload in ("f32", "bf16", "int8"):
            check_ell(f"{pattern} {shape} bc={bc} MB={ell.pad_blocks} "
                      f"F={F} {payload}", pack_payload(ell, payload), X,
                      dout, S // G, err)
        cols = flat_stack(ell)[0]
        d1 = cuda_ell.ell_bwd_dblk(cols, X, dout, bc, S // G)
        torch.cuda.synchronize()
        err["ell_bwd_dblk"] = max(err["ell_bwd_dblk"], compare(
            f"ELL dBlocks {pattern} {shape} F={F}", d1,
            cuda_ell.ell_bwd_dblk_plain(cols, X, dout, bc, S // G), None))
        require(torch.equal(d1, cuda_ell.ell_bwd_dblk(cols, X, dout, bc,
                                                       S // G)),
                "ELL dBlocks: two runs differ")

    # row 9's path: the support cotangent of a pad-free container
    A = rng.normal(size=(3, N, N)).astype(np.float32)
    full = ell_from_dense(A).to(dev)
    require(full.pad_blocks == -(-N // 128), "the container has pad slots")
    X = dev_t(rng.normal(size=(N, B * N * C)))
    dout = dev_t(rng.normal(size=(3, N, B * N * C)))
    blocks = full.blocks.clone().requires_grad_()
    el = BlockedELL(full.block_cols, blocks, full.t_ptr, full.t_slot, N, N)
    reset_counts()
    (dblk,) = torch.autograd.grad((ell_spmm(el, X) * dout).sum(), blocks)
    counts = read_counts()
    require(counts["ell_bwd_dblk"] == 1 and counts["ell_bwd_dx"] == 0,
            f"the dBlocks path launched {counts}")
    cols = full.block_cols
    err["ell_bwd_dblk"] = max(err["ell_bwd_dblk"], compare(
        f"ELL dBlocks pad-free S=3 NB={cols.shape[1]} MB={cols.shape[2]} "
        f"F={X.shape[1]} (torch.autograd.grad)", dblk,
        cuda_ell.ell_bwd_dblk_plain(cols, X[None], dout, 128, 3), None))
    d2 = cuda_ell.ell_bwd_dblk(cols, X[None], dout, 128, 3)
    require(torch.equal(dblk, d2), "ELL dBlocks: two runs differ")
    print("[check] ELL dBlocks pad-free: bit-equal over two runs; the "
          f"autograd path launched {counts['ell_bwd_dblk']} dBlocks and "
          f"{counts['ell_fwd']} forward", flush=True)
    inputs["dblk"] = (full, X[None], dout)
    return err, counts["ell_bwd_dblk"], inputs


def phase_large_n_train(dev, cfg, data, out_dir):
    """The large-N training path (bdgcn_impl='auto', which must resolve to
    'ell'): gradients against the dense plain arms, one epoch with exact
    launch counts, test mode. Returns the launches, the trained trainer
    and its training batches."""
    import torch

    from mpgcn_tpu_torch.train.trainer import ModelTrainer
    from mpgcn_tpu_torch.utils.convert import read_checkpoint

    tcfg = cfg.replace(pred_len=1, num_epochs=1, output_dir=out_dir)
    kern = ModelTrainer(tcfg, data, device=dev)
    density = kern.pipeline.support_density
    require(kern.bdgcn_impl == "ell" and 0.04 < density < 0.055,
            f"auto resolved to {kern.bdgcn_impl} at density {density}")
    shapes = {k: (tuple(b.blocks.shape), tuple(b.t_slot.shape))
              for k, b in kern.banks.items()}
    print(f"[large-N] auto resolved to ell at support density "
          f"{density:.4f}; banks (tiles, transposed index): {shapes}; "
          f"support {kern.pipeline.support_stats()}", flush=True)
    plain = ModelTrainer(tcfg, data, device=dev, lstm_impl="plain",
                         bdgcn_impl="einsum")
    plain.model.load_state_dict(kern.model.state_dict())
    batches = list(kern.pipeline.batches("train", pad_to_full=True))
    ref64 = copy.deepcopy(plain.model).double()
    t0 = time.perf_counter()
    grad_check(f"large-N N={kern.cfg.num_nodes} batch "
               f"{tcfg.batch_size}", batches[0], kern, plain, ref64, dev)
    print(f"[large-N] gradient check in {time.perf_counter() - t0:.1f}s",
          flush=True)
    del ref64, kern, plain
    torch.cuda.empty_cache()

    # the main path: a fresh trainer takes one epoch
    tr = ModelTrainer(tcfg, data, device=dev)
    init = {n: p.detach().clone() for n, p in tr.model.named_parameters()}
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts()
    t0 = time.perf_counter()
    hist = tr.train()
    counts = read_counts()
    train_s = time.perf_counter() - t0
    steps = tr.global_step
    evals = tr.pipeline.num_batches("validate")
    require(steps == tr.pipeline.num_batches("train"),
            f"{steps} training steps in one epoch")
    expect = _add(_scaled(_per_step(tcfg, True, "ell"), steps),
                  _scaled(_per_step(tcfg, False, "ell"), evals))
    require(counts == expect,
            f"the large-N epoch launched {counts}, expected {expect}")
    frozen = [n for n, p in tr.model.named_parameters()
              if torch.equal(p.detach(), init[n])]
    require(not frozen, f"parameters the epoch never moved: {frozen}")
    require(all(np.isfinite(hist["train"] + hist["validate"])),
            "non-finite epoch loss")
    per = {n: v for n, v in _per_step(tcfg, True, "ell").items() if v}
    print(f"[large-N] one epoch ({steps} steps, {evals} validation steps) "
          f"in {train_s:.1f}s; train loss {hist['train']}, validation "
          f"{hist['validate']}; launches per step {per}; peak device "
          f"memory {torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB",
          flush=True)
    ckpt = read_checkpoint(os.path.join(out_dir, "MPGCN_od.pkl"))
    require(ckpt["epoch"] == tr.best_epoch == 1,
            f"checkpoint epoch {ckpt['epoch']}")

    test_cfg = cfg.replace(pred_len=7, mode="test", output_dir=out_dir)
    tt = ModelTrainer(test_cfg, data, device=dev)
    reset_counts()
    t0 = time.perf_counter()
    res = tt.test()
    test_counts = read_counts()
    n_batches = sum(tt.pipeline.num_batches(m) for m in ("train", "test"))
    expect = _scaled(_per_step(test_cfg, False, "ell"), 7 * n_batches)
    require(test_counts == expect,
            f"large-N test mode launched {test_counts}, expected {expect}")
    scores = {m: {k: res[m][k] for k in ("MSE", "RMSE", "MAE", "MAPE")}
              for m in ("train", "test")}
    require(all(np.isfinite(list(v.values())).all()
                for v in scores.values()), f"non-finite scores {scores}")
    require(len(res["test"]["RMSE_by_horizon"]) == 7, "no 7-step scores")
    print(f"[large-N] test mode reloaded epoch {ckpt['epoch']}, rolled out "
          f"7 steps over {n_batches} batches in "
          f"{time.perf_counter() - t0:.1f}s: {json.dumps(scores)}",
          flush=True)
    return dict(train_counts=counts, test_counts=test_counts, trainer=tr,
                batches=batches)


def phase_int8_train(dev, cfg, data, batches):
    """3 training steps on int8 tiles: the int8 entries' training path."""
    from mpgcn_tpu_torch.train.trainer import ModelTrainer

    tcfg = cfg.replace(pred_len=1, support_payload="int8")
    tr = ModelTrainer(tcfg, data, device=dev)
    reset_counts()
    losses = [tr.train_step(b) for b in batches[:3]]
    counts = read_counts()
    expect = _scaled(_per_step(tcfg, True, "ell"), 3)
    require(counts == expect,
            f"3 int8 steps launched {counts}, expected {expect}")
    require(np.all(np.isfinite(losses)), f"int8 losses {losses}")
    print(f"[large-N] 3 int8-payload training steps: losses {losses}; "
          f"launches {({n: v for n, v in counts.items() if v})}", flush=True)
    return counts


def _library_spmm(name, A, rhs):
    """The single PyTorch calls computing A @ rhs for the dense (padded)
    operator A: torch.matmul on A, and a sparse BSR matmul (8 x 8 blocks:
    cuSPARSE takes square blocks only) where this torch runs f32 BSR on
    CUDA. Returns {which: fn}."""
    import torch

    calls = {"torch.matmul (dense)": lambda: torch.matmul(A, rhs)}
    try:
        bsr = A.to_sparse_bsr((8, 8))
        (bsr @ rhs).sum().item()
        calls["BSR (8, 8) @ dense"] = lambda: bsr @ rhs
    except (RuntimeError, NotImplementedError) as e:
        print(f"[time] {name}: f32 BSR matmul not available on this torch "
              f"({str(e).splitlines()[0][:100]})")
    return calls


def _library_ms(calls):
    """Each library call's time; library_ms is the fastest."""
    each = {k: time_ms(fn, iters=10, warmup=2) for k, fn in calls.items()}
    return min(each.values()), each


def _ell_ops(cols, tiles, n_rows, n_cols, F):
    """The work of an ELL SpMM on this container: 2 F times the operator
    entries that its populated tiles cover inside the (n_rows, n_cols)
    operator (the rows and columns that pad the last row and column block
    are layout, not work). Returns (operations, populated slots)."""
    import torch

    S, NB, MB = cols.shape
    br, bc = tiles.shape[-2:]
    pop = (tiles != 0).reshape(S, NB, MB, -1).any(-1)
    rows = (n_rows - br * torch.arange(NB, device=cols.device)).clamp(max=br)
    width = (n_cols - bc * cols.long()).clamp(max=bc)
    return (2 * F * int((pop * rows[None, :, None] * width).sum()),
            int(pop.sum()))


def _x_slab_bytes(cols, tiles, t_ptr, t_slot, n_cols, F):
    """X bytes the forward reads per launch, computed from the container:
    the one-row-block schedule (one X slab of BC rows per slot, pad slots
    included) and the row-group schedule of csrc/ell_spmm.cu (per slice,
    row group of FWD_GROUP_RB row blocks and column block that one of the
    group's populated slots names, the rows of the columns, rounded out to
    multiples of 8, in which one of those tiles is non-zero). Rows past
    n_cols are not read."""
    S, NB, MB = cols.shape
    bc = tiles.shape[-1]
    c_np = cols.cpu().numpy()
    old = int(np.minimum(bc, n_cols - bc * c_np).sum())
    ptr, slot = t_ptr.cpu().numpy(), t_slot.cpu().numpy()
    nz = (tiles != 0).any(-2).reshape(S, NB * MB, bc).cpu().numpy()
    new = 0
    for s in range(S):
        for c in range(ptr.shape[1] - 1):
            run = slot[s, ptr[s, c]:ptr[s, c + 1]]
            for g in np.unique(run // MB // FWD_GROUP_RB):
                used = np.flatnonzero(
                    nz[s, run[run // MB // FWD_GROUP_RB == g]].any(0))
                if used.size:
                    k0, k1 = used[0] // 8 * 8, -(-(used[-1] + 1) // 8) * 8
                    new += max(0, min(k1, n_cols - bc * c) - k0)
    return old * F * 4, new * F * 4


def _dblk_staged_bytes(cols, bc, n_rows, n_cols, F, x_div):
    """Bytes dBlocks stages per launch, computed from the container's column
    ids: X under the one-slot-per-block schedule (a slab of the slot's
    column block per slot, pad slots included) and under the slot-tile
    schedule of csrc/ell_spmm.cu (one slab per tile of up to DBLK_SLOTS
    slots of an X group on one column block), and dout (each slot's 8 rows
    once in both). Rows past n_rows or n_cols are not read."""
    from mpgcn_tpu_torch.sparse.cuda_ell import DBLK_SLOTS

    S, NB, MB = cols.shape
    c_np = cols.cpu().numpy()
    rows_x = np.minimum(bc, n_cols - bc * np.arange(-(-n_cols // bc)))
    old = int(rows_x[c_np].sum())
    per_group = c_np.reshape(S // x_div, -1)
    new = sum(-(-int((grp == c).sum()) // DBLK_SLOTS) * int(rows_x[c])
              for grp in per_group for c in range(len(rows_x)))
    rows_d = np.minimum(8, n_rows - 8 * np.arange(NB))
    dout_rows = int(rows_d.sum()) * S * MB
    return old * F * 4, new * F * 4, dout_rows * F * 4


def _dx_staged_bytes(cols, tiles, n_rows, F):
    """Bytes dX stages per launch, computed from the container: per
    populated slot its tile once per F tile of DX_TF columns and its row
    block's dout rows (those inside n_rows) once. Returns (staged bytes,
    the dout bytes of those reads)."""
    S, NB, MB = cols.shape
    pop = (tiles != 0).reshape(S, NB, MB, -1).any(-1).cpu().numpy()
    rows = np.minimum(8, n_rows - 8 * np.arange(NB))
    tile_bytes = tiles[0, 0, 0].numel() * tiles.element_size()
    d_bytes = int((pop * rows[None, :, None]).sum()) * F * 4
    return int(pop.sum()) * -(-F // DX_TF) * tile_bytes + d_bytes, d_bytes


def phase_ell_times(dev, kin):
    """The ELL entries at the large-N static shape: kernel (CUDA events),
    plain, the fastest single library call, and the bound from this run's
    container: ``_ell_ops`` operations (all of the operator, 2 S N N F,
    for dBlocks on the pad-free container); X, output, tiles (and ids,
    scales or index) bytes. The forward and dBlocks run on the TF32 tensor
    cores, in 3 products per f32 product (2 on int8 codes), and so does
    dX: their operations bound is that many times the operations at the
    TF32 peak; the CUDA-core bound (the operations at the f32 peak) is
    printed beside it."""
    import torch

    from mpgcn_tpu_torch.sparse import cuda_ell

    from mpgcn_tpu_torch.sparse.kernels import flat_stack

    times = {}
    for payload, q in (("f32", ""), ("int8", "_q")):
        ell, X, dout = kin[payload]
        cols, tiles, scale, t_ptr, t_slot = flat_stack(ell)
        S, NB, MB = cols.shape
        bc = tiles.shape[-1]
        G, N, F = X.shape
        ops, pop = _ell_ops(cols, tiles, N, N, F)
        small = (tiles.numel() * tiles.element_size() + cols.numel() * 4
                 + (0 if scale is None else scale.numel() * 4))
        # the library operand: the stacked dense operator (dequantised),
        # padded to whole tiles
        dense = torch.nn.functional.pad(
            torch.from_numpy(ell.to_dense()).to(dev),
            (0, -(-N // bc) * bc - N, 0, NB * 8 - N))
        Xp = torch.nn.functional.pad(X[0], (0, 0, 0, dense.shape[2] - N))
        dp = torch.nn.functional.pad(dout, (0, 0, 0, NB * 8 - N))
        lib_f, each_f = _library_ms(_library_spmm(
            f"ell_fwd{q}", dense.reshape(-1, dense.shape[2]), Xp))
        lib_b, each_b = _library_ms(_library_spmm(
            f"ell_bwd_dx{q}",
            dense.permute(2, 0, 1).reshape(dense.shape[2], -1).contiguous(),
            dp.reshape(-1, F)))
        fwd_bytes = 4 * (X.numel() + S * N * F) + small + 4 * (
            t_ptr.numel() + t_slot.numel())
        passes = 3 if scale is None else 2
        b_ms, b_by = bound(fwd_bytes, passes * ops, PEAK_TF32_FLOP_PER_S)
        cuda_core_ms = bound(fwd_bytes, ops)[0]
        slab_old, slab_new = _x_slab_bytes(cols, tiles, t_ptr, t_slot, N, F)
        times[f"ell_fwd{q}"] = dict(
            ms=time_ms(lambda: cuda_ell.ell_fwd(cols, tiles, t_ptr, t_slot, X,
                                                N, S // G, scale),
                       iters=20, warmup=3),
            plain_ms=time_ms(lambda: cuda_ell.ell_fwd_plain(
                cols, tiles, X, N, S // G, scale), iters=3, warmup=1),
            library_ms=lib_f, bound_ms=b_ms, bound_by=b_by)
        # dX: dout read once, dX written once; on the TF32 tensor cores in
        # the forward's passes. Beside it the CUDA-core bound and the bytes
        # with each populated slot's own read of its 8 dout rows
        dx_bytes = 4 * (dout.numel() + G * N * F) + small + 4 * (
            t_ptr.numel() + t_slot.numel())
        b_ms, b_by = bound(dx_bytes, passes * ops, PEAK_TF32_FLOP_PER_S)
        dx_core_ms = bound(dx_bytes, ops)[0]
        staged, reread = _dx_staged_bytes(cols, tiles, N, F)
        reread_ms = bound(dx_bytes - 4 * dout.numel() + reread, 0)[0]
        times[f"ell_bwd_dx{q}"] = dict(
            ms=time_ms(lambda: cuda_ell.ell_bwd_dx(
                cols, tiles, t_ptr, t_slot, dout, N, S // G, scale),
                iters=20, warmup=3),
            plain_ms=time_ms(lambda: cuda_ell.ell_bwd_dx_plain(
                cols, tiles, dout, N, S // G, scale), iters=3, warmup=1),
            library_ms=lib_b, bound_ms=b_ms, bound_by=b_by)
        for k in (f"ell_fwd{q}", f"ell_bwd_dx{q}"):
            fwd = "fwd" in k
            extra = (f"TF32 operations {passes} x {ops}; CUDA-core bound "
                     f"{cuda_core_ms:.5f} ms (operations); X slabs staged "
                     f"per launch: {slab_old} bytes one per slot (a row "
                     f"block per grid cell), {slab_new} bytes one per row "
                     f"group and column block, its non-zero columns; "
                     if fwd else
                     f"TF32 operations {passes} x {ops}; CUDA-core bound "
                     f"{dx_core_ms:.5f} ms (operations); bytes bound with "
                     f"each slot's own read of its dout rows ({reread} "
                     f"bytes of dout) {reread_ms:.5f} ms; staged per "
                     f"launch: {staged} bytes (each populated tile once per "
                     f"{DX_TF}-column F tile, its dout rows once "
                     f"per slot); ")
            print(f"[time] {k} {payload} S={S} NB={NB} MB={MB} F={F}, "
                  f"{pop} of {S * NB * MB} slots populated, {ops} "
                  f"operations; {extra}library calls "
                  f"{json.dumps(each_f if fwd else each_b)}: "
                  f"{json.dumps(times[k])}", flush=True)
        del dense
    full, X, dout = kin["dblk"]
    cols = full.block_cols
    S, NB, MB = cols.shape
    F = X.shape[-1]
    N = full.n_cols
    # 2 S N^2 F operations, on the TF32 tensor cores in 3 split products;
    # the CUDA-core bound (one f32 product) printed beside it
    ops = 2 * S * N * N * F
    dblk_bytes = 4 * (X.numel() + dout.numel() + S * NB * MB * 8 * 128
                      + cols.numel())
    b_ms, b_by = bound(dblk_bytes, 3 * ops, PEAK_TF32_FLOP_PER_S)
    cuda_core_ms = bound(dblk_bytes, ops)[0]
    x_old, x_new, d_bytes = _dblk_staged_bytes(cols, 128, N, N, F, S)
    times["ell_bwd_dblk"] = dict(
        ms=time_ms(lambda: cuda_ell.ell_bwd_dblk(cols, X, dout, 128, S),
                   iters=20, warmup=3),
        plain_ms=time_ms(lambda: cuda_ell.ell_bwd_dblk_plain(
            cols, X, dout, 128, S), iters=3, warmup=1),
        # the container is pad-free: dBlocks is the dense dA = dout X^T
        library_ms=time_ms(lambda: torch.matmul(dout, X[0].t()), iters=10,
                           warmup=2),
        bound_ms=b_ms, bound_by=b_by)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    print(f"[time] ell_bwd_dblk pad-free S={S} NB={NB} MB={MB} F={F}, "
          f"{cuda_ell.dblk_chunks(S, NB, MB, S, F, sms)} F chunks; TF32 "
          f"operations 3 x {ops}; CUDA-core bound {cuda_core_ms:.5f} ms "
          f"(operations); staged per launch: X {x_old} bytes one slab per "
          f"slot (a slot per block), {x_new} bytes one per tile of "
          f"{cuda_ell.DBLK_SLOTS} slots on a column block; dout {d_bytes} "
          f"bytes in both; library torch.matmul (dense dA = dout X^T): "
          f"{json.dumps(times['ell_bwd_dblk'])}", flush=True)
    return times


def _step_ms(tr, batches, n, warmup):
    """Host-clock ms of each of n synchronised train steps after warm-ups."""
    import torch

    samples = []
    for i in range(warmup + n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tr.train_step(batches[i % len(batches)])
        torch.cuda.synchronize()
        if i >= warmup:
            samples.append((time.perf_counter() - t0) * 1e3)
    return samples


def phase_large_n_times(dev, train, eng, data):
    """The large-N train step and bucket-2 rollout on the host clock, and
    the device's busy share over each; then the same step on the dense
    kernel arm that bdgcn_impl='auto' passes over here."""
    import statistics

    import torch

    from mpgcn_tpu_torch.train.predict import rollout
    from mpgcn_tpu_torch.train.trainer import ModelTrainer

    tr, batches = train["trainer"], train["batches"]
    samples = _step_ms(tr, batches, 6, 2)
    ell_ms = statistics.median(samples)
    print(f"[time] large-N train step (N=500, batch 2, ELL arm, host clock "
          f"around a synchronised step, median of 6 after 2 warm-ups): "
          f"{ell_ms:.3f} ms (min {min(samples):.3f}, "
          f"max {max(samples):.3f})", flush=True)
    busy_share("large-N train step", lambda: tr.train_step(batches[0]), 3)
    dense = ModelTrainer(tr.cfg, data, device=dev, bdgcn_impl="kernel")
    dense.model.load_state_dict(tr.model.state_dict())
    samples = _step_ms(dense, batches, 2, 1)
    print(f"[time] large-N train step on the dense kernel arm "
          f"(bdgcn_impl='kernel', K-BDGCN; same shapes and weights, median "
          f"of 2 after 1 warm-up): {statistics.median(samples):.3f} ms, "
          f"{statistics.median(samples) / ell_ms:.2f}x the ELL arm's",
          flush=True)
    del dense
    torch.cuda.empty_cache()
    md = eng.pipeline.modes["test"]
    x = torch.from_numpy(np.array(md.x[:2])).to(dev)
    k = torch.from_numpy(md.keys[:2].astype(np.int64)).to(dev)
    samples = []
    for i in range(6):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rollout(eng.model, eng.banks, x, k, 7)
        torch.cuda.synchronize()
        if i >= 1:
            samples.append((time.perf_counter() - t0) * 1e3)
    print(f"[time] large-N rollout (bucket 2, horizon 7, host clock, median "
          f"of 5 after 1 warm-up): {statistics.median(samples):.3f} ms",
          flush=True)
    _, acts = device_activities(
        lambda: rollout(eng.model, eng.banks, x, k, 7), n=2)
    print(f"[time] large-N rollout device activities per call: {acts}",
          flush=True)
    busy_share("large-N bucket-2 rollout",
               lambda: rollout(eng.model, eng.banks, x, k, 7), 2)


def phase_large_n_int8_times(dev, train, data):
    """The large-N train step on int8 tiles (support_payload='int8', the
    shapes and weights of ``train``, phase_large_n_train's result) on the
    host clock, as phase_large_n_times takes the f32 one, and the device's
    busy share over it."""
    import statistics

    import torch

    from mpgcn_tpu_torch.train.trainer import ModelTrainer

    tr, batches = train["trainer"], train["batches"]
    q8 = ModelTrainer(tr.cfg.replace(support_payload="int8"), data,
                      device=dev)
    q8.model.load_state_dict(tr.model.state_dict())
    samples = _step_ms(q8, batches, 6, 2)
    print(f"[time] large-N train step on int8 tiles (support_payload="
          f"'int8', same shapes and weights, median of 6 after 2 "
          f"warm-ups): {statistics.median(samples):.3f} ms (min "
          f"{min(samples):.3f}, max {max(samples):.3f})", flush=True)
    busy_share("large-N int8 train step", lambda: q8.train_step(batches[0]),
               3)
    del q8
    torch.cuda.empty_cache()


def phase_large_n_lstm_times(dev):
    """The LSTM entries at the N=500 step's shapes (R = B N^2 = 500,000
    sequences, T = 7, H = 32; their resident kernels): lstm_train_fwd and
    lstm_train_bwd (2 launches a train step each) and lstm_infer_last (14
    a bucket-2 rollout), each beside its bound, its plain version and
    nn.LSTM (cuDNN) at the same batch, "not measured" where cuDNN refuses
    it. Inputs from a seeded generator on the card."""
    import torch

    from mpgcn_tpu_torch.nn import cuda_lstm

    T, H = 7, 32
    R = LARGE_N["batch_size"] * LARGE_N["synthetic_N"] ** 2
    G = 4 * H
    gen = torch.Generator(device=dev).manual_seed(500)
    xp = torch.randn((T, R, G), generator=gen, device=dev)
    w = torch.randn((H, G), generator=gen, device=dev) / H ** 0.5
    dhs = torch.randn((T, R, H), generator=gen, device=dev)
    lib = torch.nn.LSTM(1, H, batch_first=True).to(dev)
    seq = torch.randn((R, T, 1), generator=gen, device=dev,
                      requires_grad=True)
    lib_fwd = lib_bwd = lib_infer = None
    try:
        with torch.no_grad():
            lib_infer = time_ms(lambda: lib(seq), iters=5, warmup=1)
        lib_fwd = time_ms(lambda: lib(seq), iters=5, warmup=1)
        out, _ = lib(seq)
        gout = torch.randn_like(out)
        params = [seq, *lib.parameters()]
        lib_bwd = time_ms(lambda: torch.autograd.grad(
            out, params, gout, retain_graph=True), iters=5, warmup=1)
        del out, gout
    except RuntimeError as e:
        print(f"[time] N=500 LSTM: nn.LSTM at batch {R} not measured "
              f"({str(e).splitlines()[0][:120]})", flush=True)
    times = {}
    b_ms, b_by = bound(4 * (T * R * G + H * G + R * H), 2 * T * R * H * G)
    times["lstm_infer_last"] = dict(
        ms=time_ms(lambda: cuda_lstm.lstm_layer_infer(xp, w, False),
                   iters=10),
        plain_ms=time_ms(lambda: cuda_lstm.lstm_layer_infer_plain(
            xp, w, False), iters=2, warmup=1),
        library_ms=lib_infer, bound_ms=b_ms, bound_by=b_by)
    b_ms, b_by = bound(4 * (T * R * G + H * G + 2 * T * R * H),
                       2 * T * R * H * G)
    times["lstm_train_fwd"] = dict(
        ms=time_ms(lambda: cuda_lstm.lstm_layer_train(xp, w), iters=10),
        plain_ms=time_ms(lambda: cuda_lstm.lstm_layer_train_plain(xp, w),
                         iters=2, warmup=1),
        library_ms=lib_fwd, bound_ms=b_ms, bound_by=b_by)
    hs, cs = cuda_lstm.lstm_layer_train(xp, w)
    times["lstm_train_bwd"], note = lstm_bwd_time(dev, xp, w, hs, cs, dhs,
                                                  10, 2, lib_bwd)
    gen = torch.Generator(device=dev).manual_seed(501)
    s = 1 / H ** 0.5
    fused_time("N=500", (
        torch.randn((R, T, 1), generator=gen, device=dev),
        (torch.rand((G, 1), generator=gen, device=dev) * 2 - 1) * s,
        (torch.rand((G,), generator=gen, device=dev) * 2 - 1) * s,
        w), lib_infer, iters=10, plain_iters=2)
    fwd = {f"{mode} {form}": ptxas_kernel(src, f"lstm_fwd_kernelILi{m}ELi{f}EfE")
           for mode, src, m in (("last", "lstm_infer", 0),
                                ("collect", "lstm_infer", 1),
                                ("train", "lstm_train", 2))
           for form, f in (("x_proj", 0), ("fused F=1", 1))
           if not (m == 2 and f)}
    print("[time] N=500 resident forward (csrc/lstm_fwd.cuh) registers and "
          "spill stores/loads in bytes: " + "; ".join(
              f"{k} {r} regs, {sp}" for k, (r, sp) in fwd.items()),
          flush=True)
    index = cuda_lstm.device_index(dev)
    regs, spills = ptxas_kernel("lstm_train", "lstm_train_bwd_kernelIfE")
    note += (f"; resident kernel: {regs} registers, spill stores/loads "
             f"{spills} bytes, {cuda_lstm.bwd_smem_bytes(index, H)} bytes "
             f"of shared memory a block, {cuda_lstm._max_bwd_blocks(index, H)}"
             f" blocks co-resident")
    for name, entry in times.items():
        print(f"[time] N=500 {name} (T={T}, R={R}, H={H}; library "
              f"torch.nn.LSTM at batch {R}"
              f"{'; ' + note if name == 'lstm_train_bwd' else ''}): "
              f"{json.dumps(entry)}", flush=True)


#: the reference command's runs on a dataset file (phase 11): (a) the
#: defaults, (b) the model-shape, data and optimizer flags, M = 3 putting
#: the poi branch (read from the features file) on the path
REF_CLI_RUNS = {
    "a": ["-epoch", "2"],
    "b": ["-M", "3", "-lstm-layers", "2", "-nn", "2", "-norm", "minmax",
          "-split", "7", "1", "2", "-clip", "1.0", "-lrs", "cosine",
          "-epoch", "2"],
}
#: days in the written npz: more than the 425 the loader keeps
REF_CLI_DAYS = 455
#: test-mode scores of one checkpoint, kernel arms against plain arms
REF_CLI_SCORE_RTOL = 1e-4


def card_name_and_limit() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    smi = shutil.which("nvidia-smi")
    require(smi is not None, "nvidia-smi not found")
    return subprocess.run(
        [smi, "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True
    ).stdout.strip().splitlines()[0]


def write_reference_tree(path):
    """The reference's data directory at ``path``: the OD npz (one row of
    47 x 47 counts a day, ``synthetic_od(T=455, N=47, seed 0)``), the
    adjacency and the POI features; returns the OD series."""
    import scipy.sparse as ss

    from mpgcn_tpu_torch.data.loader import (
        ADJ_NAME,
        NPZ_NAME,
        POI_FEAT_NAME,
        REFERENCE_N,
        synthetic_adjacency,
        synthetic_od,
        synthetic_poi_features,
    )

    n = REFERENCE_N
    od = synthetic_od(REF_CLI_DAYS, n, 0)
    ss.save_npz(os.path.join(path, NPZ_NAME),
                ss.csr_matrix(od.reshape(REF_CLI_DAYS, n * n)))
    np.save(os.path.join(path, ADJ_NAME), synthetic_adjacency(n, 0))
    np.save(os.path.join(path, POI_FEAT_NAME), synthetic_poi_features(n))
    return od


class _Tee:
    """stdout that is also kept, to read the lines the CLI prints."""

    def __init__(self, out):
        self.out, self.lines = out, []

    def write(self, s):
        self.lines.append(s)
        return self.out.write(s)

    def flush(self):
        self.out.flush()


def _cli(argv):
    """cli.main(argv) on the card: (its return value, its launches, the
    host seconds it took, what it printed)."""
    import contextlib

    from mpgcn_tpu_torch import cli

    tee = _Tee(sys.stdout)
    reset_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(tee):
        ret = cli.main(argv)
    counts = read_counts()
    return ret, counts, time.perf_counter() - t0, "".join(tee.lines)


def _scores(out_dir):
    with open(os.path.join(out_dir, "MPGCN_prediction_scores.txt")) as f:
        lines = [line.strip().split(", ") for line in f]
    require([line[0] for line in lines] == ["train", "test"],
            f"score file lines {lines}")
    return np.array([[float(v) for v in line[5:]] for line in lines])


def phase_reference_cli(dev, out_dir):
    """The reference command on a dataset file: write the npz tree, then
    for runs (a) and (b) train 2 epochs with ``python -m
    mpgcn_tpu_torch.cli -GPU 0 -in DIR -data npz ...`` from the first live
    init seed of the run's configuration, with exact launch counts, every
    parameter moved, a falling loss and the checkpoint's normalizer
    record; then test mode (7-step rollouts, exact launches, finite
    scores), and test mode on a copy of the checkpoint with the plain arms
    (-lstm plain -bdgcn einsum), whose scores must agree. Returns each
    run's launches."""
    import torch

    from mpgcn_tpu_torch import cli
    from mpgcn_tpu_torch.data.loader import REFERENCE_DAYS, load_dataset
    from mpgcn_tpu_torch.data.pipeline import DataPipeline
    from mpgcn_tpu_torch.nn.mpgcn import MPGCN
    from mpgcn_tpu_torch.utils.convert import params_from_jax, read_checkpoint

    tree = os.path.join(out_dir, "data")
    os.makedirs(tree)
    od = write_reference_tree(tree)
    log_days = np.log(od[-REFERENCE_DAYS:] + 1.0)
    all_counts, card = [], card_name_and_limit()
    for run, flags in REF_CLI_RUNS.items():
        base = ["-GPU", "0", "-in", tree, "-data", "npz"] + flags
        t0 = time.perf_counter()
        cfg = cli.config_from_args(
            cli.build_parser().parse_args(base).__dict__)
        data, _ = load_dataset(cfg)
        load_s = time.perf_counter() - t0
        require(data["OD"].shape == (REFERENCE_DAYS, 47, 47, 1),
                f"run ({run}): OD {data['OD'].shape}")
        cfg = cfg.replace(num_nodes=data["OD"].shape[1])
        seed = live_init_seed(cfg, data, dev)
        run_dir = os.path.join(out_dir, run)
        argv = base + ["-seed", str(seed), "-out", run_dir]
        tcfg = cfg.replace(seed=seed)
        pipe = DataPipeline(tcfg, data, dev)
        init = MPGCN.from_config(tcfg, device="cpu").state_dict()

        hist, train_counts, train_s, printed = _cli(argv)
        steps = tcfg.num_epochs * pipe.num_batches("train")
        evals = len(hist["validate"]) * pipe.num_batches("validate")
        per_step = _per_step(tcfg, True)
        expect = _add(_scaled(per_step, steps),
                      _scaled(_per_step(tcfg, False), evals))
        require(train_counts == expect,
                f"run ({run}): training launched {train_counts}, expected "
                f"{expect}")
        require(all(np.isfinite(hist["train"] + hist["validate"]))
                and hist["train"][-1] < hist["train"][0],
                f"run ({run}): epoch losses {hist}")
        sps = _steps_per_sec(printed)
        ckpt = read_checkpoint(os.path.join(run_dir, "MPGCN_od.pkl"))
        require(ckpt["epoch"] >= 1, f"run ({run}): checkpoint epoch "
                                    f"{ckpt['epoch']}")
        trained = params_from_jax(ckpt["params"])
        frozen = [n for n, v in init.items() if torch.equal(v, trained[n])]
        require(not frozen, f"run ({run}): parameters never moved: {frozen}")
        norm = {"kind": tcfg.norm, "state": {}}
        if tcfg.norm == "minmax":
            norm["state"] = {"min": float(log_days.min()),
                             "max": float(log_days.max())}
        require(ckpt["extra"]["normalizer"] == norm,
                f"run ({run}): normalizer record "
                f"{ckpt['extra']['normalizer']}, expected {norm}")

        plain_dir = run_dir + "_plain"
        os.makedirs(plain_dir)
        shutil.copy(os.path.join(run_dir, "MPGCN_od.pkl"), plain_dir)
        test = argv + ["-mode", "test"]
        res, test_counts, test_s, _ = _cli(test)
        tpipe = DataPipeline(tcfg.replace(pred_len=7, mode="test"), data,
                             dev)
        rollouts = sum(tpipe.num_batches(m) for m in ("train", "test"))
        per_rollout = _scaled(_per_step(tcfg, False), 7)
        require(test_counts == _scaled(per_rollout, rollouts),
                f"run ({run}): test mode launched {test_counts}, expected "
                f"{rollouts} x {per_rollout}")
        scores = _scores(run_dir)
        require(np.isfinite(scores).all()
                and len(res["test"]["RMSE_by_horizon"]) == 7,
                f"run ({run}): scores {scores}")
        _, plain_counts, plain_s, _ = _cli(
            [plain_dir if a == run_dir else a for a in test]
            + ["-lstm", "plain", "-bdgcn", "einsum"])
        require(not any(plain_counts.values()),
                f"run ({run}): the plain arms launched {plain_counts}")
        plain_scores = _scores(plain_dir)
        rel = float(np.max(np.abs(scores - plain_scores)
                           / np.abs(plain_scores)))
        require(rel <= REF_CLI_SCORE_RTOL,
                f"run ({run}): kernel scores {scores} vs plain "
                f"{plain_scores} (max rel {rel:.3e})")
        print(f"[ref-cli] ({run}) {' '.join(flags)} -seed {seed}: "
              f"M={tcfg.num_branches} L={tcfg.lstm_num_layers} "
              f"G={tcfg.gcn_num_layers} norm={tcfg.norm}; {steps} steps, "
              f"{evals} validation steps; epoch losses {hist}; launches "
              f"per train step {_nz(per_step)}, per 7-step rollout "
              f"{_nz(per_rollout)} ({rollouts} rollouts); test scores "
              f"(MSE, RMSE, MAE, MAPE) {scores.tolist()}; plain arms max "
              f"rel difference {rel:.3e} (rtol {REF_CLI_SCORE_RTOL})",
              flush=True)
        print(f"[ref-cli] ({run}) timing on {card}: steps/sec {sps} "
              f"(the CLI's, after its warm-up steps); train {train_s:.1f}s "
              f"host clock; test mode {test_s:.3f}s host clock for "
              f"{rollouts} 7-step rollouts ({test_s / rollouts * 1e3:.3f} "
              f"ms each, data load and bank build included; the load "
              f"alone {load_s:.3f}s); plain-arm test mode {plain_s:.3f}s",
              flush=True)
        if "-clip" in flags:
            clip_cost(argv, run_dir, run, sps, card)
        all_counts += [train_counts, test_counts]
    return all_counts


def _steps_per_sec(printed: str) -> str:
    """The CLI's own steps/sec reading in what it printed."""
    sps = [line.split()[-1] for line in printed.splitlines()
           if line.startswith("steps/sec:")]
    require(len(sps) == 1, "no steps/sec line")
    return sps[0]


def clip_cost(argv, run_dir, run, first_sps, card):
    """What the global-norm clip costs a train step: the run's training
    again without ``-clip``, with it, and without it (fresh output
    directories, the same seed and data), beside the first run's
    steps/sec."""
    at = argv.index("-clip")
    bare = argv[:at] + argv[at + 2:]
    readings = [("-clip", first_sps)]
    for i, (label, args) in enumerate((("no -clip", bare), ("-clip", argv),
                                       ("no -clip", bare))):
        out = f"{run_dir}_clip{i}"
        hist, _, _, printed = _cli([out if a == run_dir else a
                                    for a in args])
        require(all(np.isfinite(hist["train"])),
                f"run ({run}) {label}: epoch losses {hist}")
        readings.append((label, _steps_per_sec(printed)))
    print(f"[ref-cli] ({run}) the clip's cost on {card}: steps/sec "
          + ", ".join(f"{v} ({label})" for label, v in readings)
          + " (in this order)", flush=True)


def _nz(counts: dict) -> dict:
    return {n: v for n, v in counts.items() if v}


# --- the epoch executor and the CUDA graphs -----------------------------------

def _state(tr):
    """Copies of a trainer's weights and of Adam's state."""
    return ({n: p.detach().clone() for n, p in tr.model.named_parameters()},
            [{k: v.clone() for k, v in st.items()}
             for st in tr.optimizer.state.values()])


def _require_same_state(a, b, label):
    """Weights and Adam's moments and step counts equal bit for bit."""
    import torch

    (wa, sa), (wb, sb) = a, b
    diff = [n for n in wa if not torch.equal(wa[n], wb[n])]
    require(not diff, f"{label}: the weights differ: {diff}")
    require(len(sa) == len(sb) in (0, len(wa))
            and all(torch.equal(x[k], y[k]) for x, y in zip(sa, sb)
                    for k in ("exp_avg", "exp_avg_sq", "step")),
            f"{label}: Adam's state differs")


def _record_epochs(tr):
    """Wrap the trainer's epoch call: each epoch's mean, launches, host
    seconds and state after it, in order."""
    from mpgcn_tpu_torch.train.trainer import epoch_mean

    log, run_epoch = [], tr._run_epoch

    def run(mode, exec_path, rng):
        reset_counts()
        t0 = time.perf_counter()
        losses, sizes = run_epoch(mode, exec_path, rng)
        counts = read_counts()
        log.append(dict(mode=mode, exec=exec_path,
                        loss=epoch_mean(losses, sizes), counts=counts,
                        s=time.perf_counter() - t0, state=_state(tr)))
        return losses, sizes

    tr._run_epoch = run
    return log


def _guard_syncs(tr, calls):
    """Run the scan epochs numbered in ``calls`` (1-based, in the order
    the trainer runs them) under torch.cuda.set_sync_debug_mode("error")
    up to their one read of the step losses, which runs after it: a host
    sync inside the epoch raises."""
    import torch

    n, dispatch = [0], tr._dispatch_epoch

    def run(*args):
        n[0] += 1
        guard = n[0] in calls
        if guard:
            torch.cuda.set_sync_debug_mode("error")
        try:
            return dispatch(*args)
        finally:
            if guard:
                torch.cuda.set_sync_debug_mode(0)

    tr._dispatch_epoch = run


def _host_ms(fn, n=10, warmup=2):
    """Median and min host-clock ms of n synchronised calls of fn."""
    import statistics

    import torch

    samples = []
    for i in range(warmup + n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        if i >= warmup:
            samples.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(samples), min(samples)


def _train_steps(tr, n, captured=True):
    """A call that runs one train step of the trainer's scan executor on
    the epoch index it holds: by replaying its captured step, or with
    ``captured=False`` by its eager body. The rate table is first grown
    to cover n more steps (which drops the graph that read the old
    table: it is captured again here, one more step); the device counter
    goes back to slot 0 after slot S - 1, so the gather never leaves the
    epoch index. At most n calls."""
    opt, ep = tr.optimizer, tr._epochs["train"]
    opt.reserve(opt.count + n + 1)
    tr._check_storage()
    ep.t.zero_()
    if captured and tr._graphs.get("train") is None:
        tr._exec_step("train", ep, True)
        opt.advance(1)
    g = tr._graphs.get("train")
    S, done, slot = ep.sizes.shape[0], [0], [int(ep.t)]

    def fn():
        require(done[0] < n, "more steps than the rate table was grown for")
        if slot[0] >= S:
            ep.t.zero_()
            slot[0] = 0
        slot[0] += 1
        done[0] += 1
        if captured:
            g.replay()
        else:
            tr._train_body(ep)
        opt.advance(1)

    return fn


def phase_executor(dev, cfg, data, out_dir, card):
    """(a) The reference configuration (N=47; cfg's live init seed) trains
    3 epochs twice from the same init, on the scan executor with its
    steps as CUDA graphs and on the per-step executor: the epoch losses,
    the weights and Adam's state after every epoch equal bit for bit, each
    epoch launches exactly S x a step's kernels, and epoch 2 (train and
    validate) runs with no host sync before its read; test mode rolls out
    through a graph that equals the eager rollout. Times: the epochs, the
    train step by graph, by the eager executor body and by train_step,
    with the device's busy share. Returns the launches."""
    import torch

    from mpgcn_tpu_torch.train.predict import rollout
    from mpgcn_tpu_torch.train.trainer import ModelTrainer

    tcfg = cfg.replace(pred_len=1, num_epochs=3)
    runs = {}
    for name, scan in (("graphs", True), ("per_step", False)):
        d = os.path.join(out_dir, name)
        os.makedirs(d)
        tr = ModelTrainer(tcfg.replace(epoch_scan=scan, output_dir=d), data,
                          device=dev)
        init = _state(tr)
        log = _record_epochs(tr)
        if scan:
            _guard_syncs(tr, {3, 4})
        t0 = time.perf_counter()
        hist = tr.train()
        runs[name] = dict(tr=tr, init=init, log=log, hist=hist,
                          s=time.perf_counter() - t0,
                          sps=tr.steps_per_sec())
    g, p = runs["graphs"], runs["per_step"]
    _require_same_state(g["init"], p["init"], "the two inits")
    tg = g["tr"]
    require(tg.graph_refusal is None
            and set(tg._graphs.graphs) == {"train", "validate"},
            f"graphs captured: {list(tg._graphs.graphs)}")
    require(g["hist"] == p["hist"],
            f"epoch losses: graphs {g['hist']}, per step {p['hist']}")
    S = {m: tg.pipeline.num_batches(m) for m in ("train", "validate")}
    total = {}
    for i, (eg, es) in enumerate(zip(g["log"], p["log"])):
        mode = eg["mode"]
        label = f"epoch {i // 2 + 1} {mode}"
        require(mode == es["mode"] and eg["exec"] == "scan"
                and es["exec"] == "per_step", f"{label}: executors "
                f"{eg['exec']} / {es['exec']}")
        require(eg["loss"] == es["loss"], f"{label}: loss {eg['loss']} "
                f"by graphs, {es['loss']} per step")
        _require_same_state(eg["state"], es["state"], label)
        expect = _scaled(_per_step(tcfg, mode == "train"), S[mode])
        require(eg["counts"] == expect == es["counts"],
                f"{label}: launches {eg['counts']} by graphs, "
                f"{es['counts']} per step, expected {expect}")
        total = _add(total, eg["counts"])
    print(f"[graphs] (a) N=47, 3 epochs from init seed {tcfg.seed}: the "
          f"scan executor with its train and eval steps as CUDA graphs "
          f"equals the per-step executor bit for bit (epoch losses "
          f"{g['hist']}, the weights and Adam's state after every epoch); "
          f"launches per epoch S x a step's (train S={S['train']}: "
          f"{_nz(_per_step(tcfg, True))}, validate S={S['validate']}: "
          f"{_nz(_per_step(tcfg, False))}); epoch 2 ran under "
          f"torch.cuda.set_sync_debug_mode('error') up to its one read",
          flush=True)
    ep_s = {name: [round(e["s"], 4) for e in r["log"]]
            for name, r in runs.items()}
    print(f"[graphs] (a) epoch host seconds on {card} (train, validate by "
          f"epoch; epoch 1 by graphs holds 2 eager steps and each "
          f"capture): graphs {ep_s['graphs']}, per step "
          f"{ep_s['per_step']}; train() {g['s']:.2f}s / {p['s']:.2f}s; "
          f"steps/sec {g['sps']:.2f} / {p['sps']:.2f}", flush=True)

    # test mode through a graph per (batch, horizon)
    tt = ModelTrainer(cfg.replace(pred_len=7, mode="test",
                                  output_dir=os.path.join(out_dir, "graphs")),
                      data, device=dev)
    reset_counts()
    res = tt.test()
    counts = read_counts()
    n_batches = sum(tt.pipeline.num_batches(m) for m in ("train", "test"))
    expect = _scaled(_per_step(tt.cfg, False), 7 * n_batches)
    require(counts == expect and set(tt._graphs.graphs) == {
        (tcfg.batch_size, 7, "f32")}, f"test mode: launches {counts}, graphs "
        f"{list(tt._graphs.graphs)}")
    md = tt.pipeline.modes["test"]
    x, k = md.x[:tcfg.batch_size], md.keys[:tcfg.batch_size]
    got = torch.from_numpy(tt.predict(x, k))
    ref = rollout(tt.model, tt.banks, torch.from_numpy(np.array(x)).to(dev),
                  torch.from_numpy(k.astype(np.int64)).to(dev), 7).cpu()
    require(torch.equal(got, ref), "the test-mode rollout graph differs "
            "from the eager rollout")
    print(f"[graphs] (a) test mode: {n_batches} rollouts through one graph "
          f"(batch {tcfg.batch_size}, horizon 7), equal to the eager "
          f"rollout; test RMSE {res['test']['RMSE']:.6f}", flush=True)
    total = _add(total, counts)

    # the step's times
    batches = list(tg.pipeline.batches("train", pad_to_full=True))
    replay = _train_steps(tg, 30)
    g_ms = _host_ms(replay, n=20, warmup=5)
    body = _train_steps(tg, 30, captured=False)
    e_ms = _host_ms(body, n=20, warmup=5)
    pt = p["tr"]
    s_ms = _host_ms(lambda: pt.train_step(batches[0]), n=20, warmup=5)
    print(f"[time] N=47 train step on {card} (host clock around a "
          f"synchronised step, median / min of 20 after 5): by graph "
          f"{g_ms[0]:.3f} / {g_ms[1]:.3f} ms; the executor's eager body "
          f"(device gather, no read) {e_ms[0]:.3f} / {e_ms[1]:.3f} ms; "
          f"train_step (host batch, loss read) {s_ms[0]:.3f} / "
          f"{s_ms[1]:.3f} ms", flush=True)
    busy_share("N=47 train step by graph", _train_steps(tg, 5), 5)
    busy_share("N=47 train step, eager executor body",
               _train_steps(tg, 5, captured=False), 5)
    busy_share("N=47 train step, train_step", lambda: pt.train_step(
        batches[0]), 5)
    return total


def phase_graph_rollouts(dev, eng, card):
    """(b) The serve engine of phase 3 (N=47, buckets 1-8, horizon 7): each
    bucket's captured rollout equals the eager rollout bit for bit and
    launches what the eager one does; their times, and the busy share by
    graph. Returns the launches."""
    import torch

    from mpgcn_tpu_torch.train.predict import rollout

    graphs = eng._rollouts.graphs
    # both parameter slots' rollouts, captured at startup
    require(set(graphs.graphs) == {(s, b, 7, "f32") for s in (0, 1)
                                   for b in eng.scfg.buckets},
            f"serve graphs {list(graphs.graphs)}")
    slot = eng._rollouts.slot
    md = eng.pipeline.modes["test"]
    per = _scaled(_per_step(eng.cfg, False), 7)
    total, times = {}, {}
    for b in eng.scfg.buckets:
        xh = torch.from_numpy(np.array(md.x[:b]))
        kh = torch.from_numpy(md.keys[:b].astype(np.int64))
        x, k = xh.to(dev), kh.to(dev)
        reset_counts()
        got = eng._rollouts.run(xh, kh, 7)
        counts = read_counts()
        ref = rollout(eng.model, eng.banks, x, k, 7).cpu()
        require(torch.equal(got, ref),
                f"bucket {b}: the rollout graph differs from eager "
                f"(max abs {float((got - ref).abs().max()):.3e})")
        require(counts == per, f"bucket {b}: the replay launched {counts}, "
                               f"expected {per}")
        total = _add(total, counts)
        g = graphs.get((slot, b, 7, "f32"))
        times[b] = (_host_ms(lambda: g.replay(x, k)),
                    _host_ms(lambda: rollout(eng.model, eng.banks, x, k, 7)))
    print(f"[graphs] (b) every bucket's rollout graph (horizon 7) equals "
          f"the eager rollout bit for bit, with {_nz(per)} launches a "
          f"replay", flush=True)
    print(f"[time] N=47 rollout on {card} (horizon 7, host clock, median / "
          f"min of 10 after 2; inputs on the card): "
          + "; ".join(f"bucket {b} by graph {gt[0]:.3f} / {gt[1]:.3f} ms, "
                      f"eager {et[0]:.3f} / {et[1]:.3f} ms"
                      for b, (gt, et) in times.items()), flush=True)
    for b in (eng.scfg.buckets[0], eng.scfg.buckets[-1]):
        g = graphs.get((slot, b, 7, "f32"))
        x = torch.from_numpy(np.array(md.x[:b])).to(dev)
        k = torch.from_numpy(md.keys[:b].astype(np.int64)).to(dev)
        busy_share(f"bucket-{b} rollout by graph", lambda: g.replay(x, k), 3)
    return total


def phase_graph_wide(dev, data, seed, card):
    """(c) The wide configuration (hidden 128, K = 7; the engine BPTT and
    the cooperative dW launches inside the graph): five train steps by
    graph (two eager warm-ups, the capture, three replays) equal five
    train_step calls bit for bit, four eval steps equal eval_step, and
    the bucket-8 rollout graph equals the eager rollout. Times: the step
    and the rollout by graph, and the step with the step sentinels on
    and off. Returns the launches."""
    import torch

    from mpgcn_tpu_torch.config import MPGCNConfig
    from mpgcn_tpu_torch.train.predict import rollout
    from mpgcn_tpu_torch.train.trainer import ModelTrainer

    tcfg = MPGCNConfig(**WIDE, seed=seed, pred_len=1)
    a = ModelTrainer(tcfg, data, device=dev)
    b = ModelTrainer(tcfg.replace(epoch_scan=False), data, device=dev)
    _require_same_state(_state(a), _state(b), "the wide inits")
    total = {}
    for mode, n in (("train", 5), ("validate", 4)):
        is_train = mode == "train"
        ep = a._epoch_state(mode)
        ep.load(*a._epoch_index(mode, False, None))
        reset_counts()
        for _ in range(n):
            a._exec_step(mode, ep, is_train)
        counts = read_counts()
        if is_train:
            a.optimizer.advance(n)
        step = b.train_step if is_train else b.eval_step
        ref = np.array([step(x) for x in list(
            b.pipeline.batches(mode, pad_to_full=True))[:n]], np.float32)
        got = ep.losses[:n].cpu().numpy()
        require(np.array_equal(got, ref), f"wide {mode}: losses {got} by "
                                          f"graph, {ref} eager")
        require(a._graphs.get(mode) is not None, f"wide {mode}: no graph")
        expect = _scaled(_per_step(tcfg, is_train), n)
        require(counts == expect, f"wide {mode}: {n} steps launched "
                                  f"{counts}, expected {expect}")
        total = _add(total, counts)
    _require_same_state(_state(a), _state(b), "wide, after 5 steps")
    md = a.pipeline.modes["test"]
    x, k = np.array(md.x[:8]), md.keys[:8]
    a.predict(x, k, 7)  # the eager warm-up, then the capture
    reset_counts()
    got = torch.from_numpy(a.predict(x, k, 7))
    counts = read_counts()
    xd = torch.from_numpy(x).to(dev)
    kd = torch.from_numpy(k.astype(np.int64)).to(dev)
    ref = rollout(a.model, a.banks, xd, kd, 7).cpu()
    require(torch.equal(got, ref), "wide: the bucket-8 rollout graph "
                                   "differs from eager")
    require(counts == _scaled(_per_step(tcfg, False), 7),
            f"wide rollout replay launched {counts}")
    total = _add(total, counts)
    print(f"[graphs] (c) wide (hidden 128, K = 7, seed {seed}): 5 train "
          f"steps and 4 eval steps by graph equal train_step / eval_step "
          f"bit for bit (losses, weights, Adam's state), launches S x a "
          f"step's; the bucket-8 rollout graph equals eager", flush=True)
    step = _host_ms(_train_steps(a, 12), n=10, warmup=2)
    g = a._graphs.get((8, 7, "f32"))
    roll = _host_ms(lambda: g.replay(xd, kd), n=5, warmup=1)
    eager = _host_ms(lambda: rollout(a.model, a.banks, xd, kd, 7), n=5,
                     warmup=1)
    print(f"[time] wide on {card} (host clock, median / min): train step "
          f"by graph {step[0]:.3f} / {step[1]:.3f} ms (10 after 2); "
          f"bucket-8 rollout by graph {roll[0]:.3f} / {roll[1]:.3f} ms, "
          f"eager {eager[0]:.3f} / {eager[1]:.3f} ms (5 after 1)",
          flush=True)
    off = ModelTrainer(tcfg.replace(step_sentinels=False), data, device=dev)
    ep = off._epoch_state("train")
    ep.load(*off._epoch_index("train", False, None))
    for _ in range(3):  # two eager warm-ups, then the capture
        off._exec_step("train", ep, True)
    off.optimizer.advance(3)
    require(_captured(off, "train") and off.optimizer.guard is None
            and a.optimizer.guard is not None,
            "wide: the sentinels-off step is not on a graph")
    ms = [_host_ms(_train_steps(tr, 12), n=10, warmup=2)[0]
          for tr in (a, off, a, off)]
    on_ms, off_ms = (ms[0] + ms[2]) / 2, (ms[1] + ms[3]) / 2
    print(f"[time] wide train step by graph on {card}, median of 10 after "
          f"2, in the order sentinels on, off, on, off: "
          f"{', '.join(f'{v:.3f}' for v in ms)} ms; the sentinel's cost "
          f"{on_ms - off_ms:+.3f} ms ({on_ms:.3f} against {off_ms:.3f})",
          flush=True)
    return total


def phase_graph_large_n(dev, cfg, data, out_dir):
    """(d) N=500 on the ELL arm: one epoch on the scan executor, which
    runs its steps eagerly (no graph: the ELL marks) and says so on its
    dispatch line, equals one epoch per step bit for bit. Returns the
    launches."""
    import contextlib

    from mpgcn_tpu_torch.train.trainer import ModelTrainer

    tcfg = cfg.replace(pred_len=1, num_epochs=1)
    runs = {}
    for name, scan in (("scan", True), ("per_step", False)):
        d = os.path.join(out_dir, name)
        os.makedirs(d)
        tr = ModelTrainer(tcfg.replace(epoch_scan=scan, output_dir=d), data,
                          device=dev)
        log = _record_epochs(tr)
        tee = _Tee(sys.stdout)
        with contextlib.redirect_stdout(tee):
            hist = tr.train()
        line = next(l for l in "".join(tee.lines).splitlines()
                    if l.startswith("[dispatch] epoch_exec:"))
        runs[name] = dict(tr=tr, log=log, hist=hist, line=line)
    s, p = runs["scan"], runs["per_step"]
    require(s["tr"].bdgcn_impl == "ell" and s["tr"]._graphs is None
            and s["line"].startswith("[dispatch] epoch_exec: train=scan, "
                                     "validate=scan")
            and "scan steps: eager (bdgcn_impl=ell" in s["line"],
            f"N=500 dispatch: {s['line']}")
    require(s["hist"] == p["hist"], f"N=500 epoch losses {s['hist']} on "
                                    f"the scan executor, {p['hist']} per "
                                    f"step")
    total = {}
    for es, ep in zip(s["log"], p["log"]):
        _require_same_state(es["state"], ep["state"],
                            f"N=500 {es['mode']}")
        require(es["counts"] == ep["counts"],
                f"N=500 {es['mode']}: launches {es['counts']} / "
                f"{ep['counts']}")
        total = _add(total, es["counts"])
    print(f"[graphs] (d) N=500: {s['line']}; one epoch equals the per-step "
          f"executor bit for bit (losses {s['hist']}); epoch seconds scan "
          f"{[round(e['s'], 3) for e in s['log']]}, per step "
          f"{[round(e['s'], 3) for e in p['log']]}", flush=True)
    return total


# --- the self-healing trainer ------------------------------------------------

def _heal_trainer(cfg, data, dev, out_dir, name, **kw):
    from mpgcn_tpu_torch.train.trainer import ModelTrainer

    d = os.path.join(out_dir, name)
    os.makedirs(d, exist_ok=True)
    return ModelTrainer(cfg.replace(output_dir=d, **kw), data, device=dev)


def _captured(tr, *modes) -> bool:
    """Each of ``modes`` has its step captured as a graph."""
    return tr._graphs is not None and all(tr._graphs.get(m) is not None
                                          for m in modes)


def _guarded(tr):
    """Copies of what an update writes: the weights, Adam's moments and
    steps, the rate and the device step counter."""
    return [t.detach().clone() for t in tr.optimizer.guarded()]


def _same(a, b) -> bool:
    import torch

    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


def _poison_rows(tr, step):
    """NaN input windows for the rows of unshuffled train step ``step``,
    in a copy of the trainer's training windows."""
    md = tr.pipeline.modes["train"]
    bs = tr.cfg.batch_size
    x = np.array(md.x)
    x[step * bs: (step + 1) * bs] = np.nan
    md.x = x


def _events(tr) -> list:
    from mpgcn_tpu_torch.utils.logging import read_events

    return read_events(os.path.join(tr.cfg.output_dir,
                                    "MPGCN_train_log.jsonl"))


def _raises(fn, exc) -> str:
    """The message of the ``exc`` that fn must raise."""
    try:
        fn()
    except exc as e:
        return str(e)
    require(False, f"{fn} did not raise {exc.__name__}")


def heal_sentinels(dev, cfg, data, out_dir, card):
    """(a) 3 epochs by graph with the step sentinels on and off: equal bit
    for bit (epoch losses, weights, Adam's state, the rate, step_t), with
    the same launches; the step's time by graph with and without them."""
    tcfg = cfg.replace(pred_len=1, num_epochs=3)
    runs = {}
    for on in (True, False):
        tr = _heal_trainer(tcfg, data, dev, out_dir, f"sentinels_{on}",
                           step_sentinels=on)
        reset_counts()
        hist = tr.train()
        runs[on] = (tr, hist, read_counts())
    (ton, hon, con), (toff, hoff, coff) = runs[True], runs[False]
    require(_captured(ton, "train", "validate")
            and ton.optimizer.guard is not None
            and toff.optimizer.guard is None,
            "the sentinel runs are not on graphs")
    require(hon == hoff, f"epoch losses with sentinels {hon}, without "
                         f"{hoff}")
    require(_same(_guarded(ton), _guarded(toff)),
            "sentinels on and off leave different weights or Adam state")
    S = {m: ton.pipeline.num_batches(m) for m in ("train", "validate")}
    expect = _add(_scaled(_per_step(tcfg, True), 3 * S["train"]),
                  _scaled(_per_step(tcfg, False), 3 * S["validate"]))
    require(con == coff == expect, f"launches {con} / {coff}, expected "
                                   f"{expect}")
    ms, eager = [], []
    for tr in (ton, toff, ton, toff):
        ms.append(_host_ms(_train_steps(tr, 30), n=20, warmup=5)[0])
    for tr in (ton, toff, ton, toff):
        eager.append(_host_ms(_train_steps(tr, 30, captured=False), n=20,
                              warmup=5)[0])
    on_ms, off_ms = (ms[0] + ms[2]) / 2, (ms[1] + ms[3]) / 2
    print(f"[heal] (a) N=47, 3 epochs by graph from init seed {tcfg.seed}: "
          f"step sentinels on equal off bit for bit (epoch losses {hon}, "
          f"weights, Adam's state, rate, step_t "
          f"{int(ton.optimizer.step_t)}), launches equal", flush=True)
    print(f"[time] N=47 train step by graph on {card}, median of 20 after "
          f"5, in the order on, off, on, off: "
          f"{', '.join(f'{v:.3f}' for v in ms)} ms; the sentinel's cost "
          f"{on_ms - off_ms:+.3f} ms ({on_ms:.3f} against {off_ms:.3f}); "
          f"the executor's eager body, same order: "
          f"{', '.join(f'{v:.3f}' for v in eager)} ms", flush=True)
    busy_share(f"N=47 train step by graph, sentinels on, on {card},",
               _train_steps(ton, 5), 5)
    return _add(con, coff)


def heal_nan_window(dev, cfg, data, out_dir):
    """(b) NaN input windows at train step 5 (a replay): the step is
    skipped, the state after it equals the state before it bit for bit
    and step_t does not move, its loss is NaN; by graph and per step the
    epoch ends equal; with skip_budget 1 the epoch completes; with
    skip_budget 0 and rollback_retries 1 the run quarantines a postmortem,
    restores, halves the rate, retries and stops, its events in the JAX
    trainer's order."""
    from mpgcn_tpu_torch.resilience.rollback import postmortem_path

    step = 5
    tcfg = cfg.replace(pred_len=1, num_epochs=1, skip_budget=1)
    g = _heal_trainer(tcfg, data, dev, out_dir, "nan_graph")
    e = _heal_trainer(tcfg, data, dev, out_dir, "nan_eager",
                      epoch_scan=False)
    for tr in (g, e):
        _poison_rows(tr, step)
    ep = g._epoch_state("train")
    idx, sizes = g._epoch_index("train", False, None)
    g.optimizer.reserve(len(sizes))
    ep.load(idx, sizes)
    reset_counts()
    for i in range(len(sizes)):
        before = _guarded(g) if i == step else None
        g._exec_step("train", ep, True)
        if i == step:
            require(_captured(g, "train"),
                    "the poisoned step is not a replay")
            require(_same(before, _guarded(g)),
                    "the skipped step changed the weights or Adam's state")
            require(int(g.optimizer.step_t) == step,
                    f"step_t {int(g.optimizer.step_t)} after the skip")
    g.optimizer.advance(len(sizes))
    counts = read_counts()
    lg = ep.losses.cpu().numpy()
    le = np.array([e.train_step(b) for b in e.pipeline.batches(
        "train", pad_to_full=True)], np.float32)
    require(np.isnan(lg[step]) and np.isfinite(np.delete(lg, step)).all(),
            f"the loss stream {lg}")
    require(np.array_equal(lg, le, equal_nan=True),
            "the loss streams by graph and per step differ")
    require(_same(_guarded(g), _guarded(e)),
            "by graph and per step the epoch ends in different states")
    print(f"[heal] (b) NaN windows at train step {step} of "
          f"{len(sizes)}: skipped inside the replayed graph (the state "
          f"after it equals the state before it bit for bit, step_t stays "
          f"{step}, its loss NaN); the epoch by graph equals the per-step "
          f"executor's bit for bit; step_t {int(g.optimizer.step_t)}, "
          f"host count {g.optimizer.count}", flush=True)
    t1 = _heal_trainer(tcfg, data, dev, out_dir, "nan_budget1")
    _poison_rows(t1, step)
    h1 = t1.train()
    skips = [r["skipped_steps"] for r in _events(t1) if r["event"] == "epoch"]
    require(len(h1["train"]) == 1 and np.isfinite(h1["train"]).all()
            and skips == [1], f"skip_budget 1: {h1}, skips {skips}")
    t0 = _heal_trainer(tcfg, data, dev, out_dir, "nan_rollback",
                       num_epochs=2, skip_budget=0, rollback_retries=1)
    _poison_rows(t0, step)
    lr = t0.cfg.learn_rate
    h0 = t0.train()
    names = [r["event"] for r in _events(t0)]
    post = postmortem_path(t0.cfg.output_dir, "MPGCN", 1)
    require(names == ["train_start", "nan_abort", "rollback", "train_start",
                      "nan_abort"], f"rollback events {names}")
    require(os.path.exists(post) and len(h0["train"]) == 1,
            f"postmortem {post}, history {h0}")
    require(t0.cfg.learn_rate == 0.5 * lr and float(
        t0.optimizer.lr_table[0]) == float(np.float32(0.5 * lr)),
        f"the rate after the rollback: {t0.cfg.learn_rate}")
    require(all(bool(p.isfinite().all()) for p in t0.model.parameters()),
            "non-finite weights after the rollback")
    print(f"[heal] (b) skip_budget 1: the epoch completes (skipped steps "
          f"{skips}); skip_budget 0, rollback_retries 1: events {names}, "
          f"postmortem {os.path.basename(post)}, rate {lr} -> "
          f"{t0.cfg.learn_rate}, weights restored and finite", flush=True)
    return counts


def heal_multistep(dev, cfg, data, out_dir, card):
    """(c) -multistep -pred 6 (BASELINE config 3): 2 epochs by graph equal
    2 epochs per step bit for bit, each step launching 6 x a one-step
    step's kernels; one step's gradients of the kernel arms and the plain
    arms against the plain arms in float64; step times and busy share."""
    from mpgcn_tpu_torch.train.trainer import ModelTrainer

    mcfg = cfg.replace(pred_len=6, num_epochs=2)
    per = {True: _scaled(_per_step(mcfg, True), 6),
           False: _scaled(_per_step(mcfg, False), 6)}
    require(_nz(per[True]) == {"lstm_train_fwd": 12, "lstm_train_bwd": 12,
                               "bdgcn_pair_fwd": 36, "bdgcn_pair_bwd": 36},
            f"multi-step launches per train step {per[True]}")
    runs = {}
    for name, scan in (("graphs", True), ("per_step", False)):
        tr = _heal_trainer(mcfg, data, dev, out_dir, f"multistep_{name}",
                           epoch_scan=scan)
        log = _record_epochs(tr)
        runs[name] = dict(tr=tr, log=log, hist=tr.train())
    g, p = runs["graphs"], runs["per_step"]
    tg = g["tr"]
    require(tg.pipeline.modes["train"].y.shape[1] == 6
            and _captured(tg, "train", "validate"),
            "the multi-step run is not on graphs or not on 6 frames")
    require(g["hist"] == p["hist"], f"multi-step epoch losses: graphs "
                                    f"{g['hist']}, per step {p['hist']}")
    total = {}
    for eg, es in zip(g["log"], p["log"]):
        mode = eg["mode"]
        _require_same_state(eg["state"], es["state"], f"multi-step {mode}")
        expect = _scaled(per[mode == "train"], tg.pipeline.num_batches(mode))
        require(eg["counts"] == es["counts"] == expect,
                f"multi-step {mode}: launches {eg['counts']} / "
                f"{es['counts']}, expected {expect}")
        total = _add(_add(total, eg["counts"]), es["counts"])
    require(g["hist"]["train"][-1] < g["hist"]["train"][0],
            "the multi-step train loss does not fall")
    print(f"[heal] (c) -multistep -pred 6, 2 epochs: by graph equal per "
          f"step bit for bit (epoch losses {g['hist']}); launches per train "
          f"step {_nz(per[True])}, per validation step {_nz(per[False])}",
          flush=True)
    kern = _heal_trainer(mcfg, data, dev, out_dir, "multistep_grad")
    plain = ModelTrainer(mcfg.replace(output_dir=kern.cfg.output_dir), data,
                         device=dev, lstm_impl="plain", bdgcn_impl="einsum")
    plain.model.load_state_dict(kern.model.state_dict())
    ref64 = copy.deepcopy(plain.model).double()
    md = kern.pipeline.modes["train"]
    bs = mcfg.batch_size
    grad_check("multi-step (6 frames) full batch",
               _batch(md, np.arange(bs), bs), kern, plain, ref64, dev)
    batch = next(p["tr"].pipeline.batches("train", pad_to_full=True))
    g_ms = _host_ms(_train_steps(tg, 30), n=20, warmup=5)
    e_ms = _host_ms(lambda: p["tr"].train_step(batch), n=20, warmup=5)
    print(f"[time] multi-step (6 frames) train step on {card}, median / "
          f"min of 20 after 5: by graph {g_ms[0]:.3f} / {g_ms[1]:.3f} ms, "
          f"train_step {e_ms[0]:.3f} / {e_ms[1]:.3f} ms", flush=True)
    busy_share(f"multi-step (6 frames) train step by graph on {card},",
               _train_steps(tg, 5), 5)
    busy_share(f"multi-step (6 frames) train_step on {card},",
               lambda: p["tr"].train_step(batch), 5)
    return total


def _step_grads(tr, batch, k):
    """Loss, gradients and peak device bytes of one step's forward and
    backward with grad_accum k."""
    import torch

    tr.cfg = tr.cfg.replace(grad_accum=k)
    x, y, keys = tr._tensors(batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    loss = tr._loss_and_grads(x, y, keys, tr._size(batch))
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    grads = {n: p.grad.detach().clone()
             for n, p in tr.model.named_parameters()}
    tr.optimizer.zero_grad(set_to_none=True)
    return float(loss), grads, peak


def _require_close_grads(label, a, b, rtol=1e-5, atol_scale=1e-6):
    """Loss at rtol; each gradient at rtol with an atol of atol_scale x its
    largest entry. Returns the worst max_abs_err / max|g|."""
    import torch

    (la, ga, _), (lb, gb, _) = a, b
    require(abs(la - lb) <= rtol * abs(lb), f"{label}: loss {la} vs {lb}")
    worst = 0.0
    for n, g in gb.items():
        scale = float(g.abs().max())
        err = float((ga[n] - g).abs().max())
        worst = max(worst, err / scale if scale else err)
        require(torch.allclose(ga[n], g, rtol=rtol,
                               atol=atol_scale * scale),
                f"{label}: the gradient of {n} differs (max abs err "
                f"{err:.3e}, max |g| {scale:.3e})")
    return worst


@contextlib.contextmanager
def _captured_blocks():
    """The (entry, rows, P) that the BPTT's and K-BDGCN backward's
    wrappers hand their cooperative launches while a step is captured:
    the P of each launch the graph replays."""
    import torch

    from mpgcn_tpu_torch.nn import cuda_bdgcn, cuda_lstm

    seen = []
    rules = {cuda_lstm: cuda_lstm.bwd_blocks,
             cuda_bdgcn: cuda_bdgcn.bwd_blocks}

    def spy(mod, rule):
        def blocks(rows, *args):
            P = rule(rows, *args)
            if torch.cuda.is_current_stream_capturing():
                seen.append((mod.__name__.rsplit(".", 1)[1], rows, P))
            return P
        return blocks

    for mod, rule in rules.items():
        mod.bwd_blocks = spy(mod, rule)
    try:
        yield seen
    finally:
        for mod, rule in rules.items():
            mod.bwd_blocks = rule


def _kernel_grids(fn, name, path, tries=3):
    """The grids of the device kernels whose name holds ``name`` over two
    calls of fn, from torch.profiler's trace (written to ``path``); a
    window that recorded none of them is recorded again."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            time.sleep(PAD_S)
            fn()
            fn()
            torch.cuda.synchronize()
            time.sleep(PAD_S)
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
        grids = [tuple(e["args"]["grid"]) for e in events
                 if e.get("cat") == "kernel" and name in e.get("name", "")
                 and "grid" in e.get("args", {})]
        if grids:
            return grids
    return []


def heal_accum(dev, cfg, data, cfg_l, data_l, out_dir):
    """(d) -accum 2: at N=47 one epoch by graph equals one per step bit for
    bit, each step launching twice a full-batch step's training kernels
    on half the rows, and matches the full batch (epoch losses, one
    step's loss and gradients: rtol 1e-5); at N=500 (the ELL arm, batch
    2) one step's loss and gradients match the full batch's; peak device
    bytes of a step for k = 1 and 2. The captured steps' cooperative dW
    launches (BPTT, K-BDGCN backward) take the smaller P of half the rows:
    the P their wrappers hand the launch during the capture, and the grid
    of the BPTT's replayed launches in the profiler's trace."""
    from mpgcn_tpu_torch.nn import cuda_bdgcn, cuda_lstm
    from mpgcn_tpu_torch.train.trainer import ModelTrainer

    acfg = cfg.replace(pred_len=1, num_epochs=1, grad_accum=2)
    runs = {}
    for name, kw in (("k2_graphs", {}), ("k2_per_step",
                                         dict(epoch_scan=False)),
                     ("k1_graphs", dict(grad_accum=1))):
        tr = _heal_trainer(acfg, data, dev, out_dir, f"accum_{name}", **kw)
        log = _record_epochs(tr)
        with _captured_blocks() as blocks:
            hist = tr.train()
        runs[name] = dict(tr=tr, log=log, hist=hist, blocks=blocks)
    g, p, f = runs["k2_graphs"], runs["k2_per_step"], runs["k1_graphs"]
    require(_captured(g["tr"], "train", "validate"),
            "the accumulating run is not on graphs")
    require(g["hist"] == p["hist"], f"-accum 2 epoch losses: graphs "
                                    f"{g['hist']}, per step {p['hist']}")
    total = {}
    S = g["tr"].pipeline.num_batches("train")
    for eg, es in zip(g["log"], p["log"]):
        mode = eg["mode"]
        _require_same_state(eg["state"], es["state"], f"-accum 2 {mode}")
        expect = (_scaled(_per_step(acfg, True), 2 * S) if mode == "train"
                  else _scaled(_per_step(acfg, False),
                               g["tr"].pipeline.num_batches(mode)))
        require(eg["counts"] == es["counts"] == expect,
                f"-accum 2 {mode}: launches {eg['counts']} / "
                f"{es['counts']}, expected {expect}")
        total = _add(_add(total, eg["counts"]), es["counts"])
    for mode in ("train", "validate"):
        require(np.allclose(g["hist"][mode], f["hist"][mode], rtol=1e-5,
                            atol=0), f"-accum 2 {mode} losses "
                f"{g['hist'][mode]} against the full batch's "
                f"{f['hist'][mode]}")
    k2 = _heal_trainer(acfg, data, dev, out_dir, "accum_step")
    batch = next(k2.pipeline.batches("train", pad_to_full=True))
    one = {k: _step_grads(k2, batch, k) for k in (1, 2)}
    worst = _require_close_grads("N=47 -accum 2", one[2], one[1])
    H, bs, n = cfg.hidden_dim, cfg.batch_size, k2.cfg.num_nodes
    R = bs * n * n
    P = {r: (cuda_lstm.bwd_blocks(r, H, dev),
             cuda_bdgcn.bwd_blocks(r, cfg.support_K, H, H, dev))
         for r in (R, R // 2)}
    require(P[R // 2][0] < P[R][0] and P[R // 2][1] < P[R][1],
            f"the dW blocks P by the rule do not shrink with R: {P}")
    for run, r in ((g, R // 2), (f, R)):
        expect = {("cuda_lstm", r, P[r][0]), ("cuda_bdgcn", r, P[r][1])}
        require(run["blocks"] and set(run["blocks"]) == expect,
                f"the captured train step's cooperative launches took "
                f"(entry, rows, P) {sorted(set(run['blocks']))}, expected "
                f"{sorted(expect)}")
    grids = _kernel_grids(_train_steps(g["tr"], 8), "lstm_train_bwd_kernel",
                          os.path.join(out_dir, "accum_trace.json"))
    require(grids and set(grids) == {(P[R // 2][0], 1, 1)},
            f"-accum 2: the replayed BPTT's grids {sorted(set(grids))}, "
            f"expected P = {P[R // 2][0]} blocks")
    print(f"[heal] (d) -accum 2, N=47: one epoch by graph equals per step "
          f"bit for bit (losses {g['hist']}), matches the full batch "
          f"({f['hist']}; one step's gradients worst max_abs_err / max|g| "
          f"{worst:.3e}); launches per train step "
          f"{_nz(_scaled(_per_step(acfg, True), 2))}; BPTT and K-BDGCN dW "
          f"blocks P handed to the captured launches at R = {R} / "
          f"{R // 2} (k = 1 / 2): {P[R]} / {P[R // 2]}, the replayed BPTT's "
          f"grid {grids[0]} ({len(grids)} launches profiled); peak "
          f"device bytes of a step k=1 {one[1][2]}, k=2 {one[2][2]}",
          flush=True)
    tl = ModelTrainer(cfg_l.replace(pred_len=1, output_dir=os.path.join(
        out_dir, "accum_large_n")), data_l, device=dev)
    require(tl.bdgcn_impl == "ell", f"N=500 arm {tl.bdgcn_impl}")
    batch = next(tl.pipeline.batches("train", pad_to_full=True))
    big = {k: _step_grads(tl, batch, k) for k in (1, 2)}
    # the loss at rtol 1e-5; each dW is a sum over B N^2 = 500,000 rows that
    # the chunks reassociate (~2e-5 of max|g| in f32): the gradient
    # check's tolerances
    worst = _require_close_grads("N=500 -accum 2", big[2], big[1],
                                 rtol=GRAD_RTOL, atol_scale=GRAD_ATOL_SCALE)
    require(abs(big[2][0] - big[1][0]) <= 1e-5 * abs(big[1][0]),
            f"N=500 -accum 2: loss {big[2][0]} vs {big[1][0]}")
    print(f"[heal] (d) -accum 2, N=500 (ELL arm, batch 2): one step's loss "
          f"{big[2][0]:.7f} matches the full batch's ({big[1][0]:.7f}, rtol "
          f"1e-5), its gradients at rtol {GRAD_RTOL}, atol "
          f"{GRAD_ATOL_SCALE} x max|g| (worst max_abs_err / max|g| "
          f"{worst:.3e}); peak "
          f"device bytes of a step k=1 {big[1][2]}, k=2 {big[2][2]}",
          flush=True)
    del tl
    return total


def heal_resume(dev, cfg, data, out_dir, card):
    """(e) 2 epochs, then resume to 4, equals 4 straight epochs bit for bit
    by graph (shuffled: the resume replays the shuffle stream); the time
    of a rolling checkpoint's save."""
    rcfg = cfg.replace(pred_len=1, shuffle=True)
    straight = _heal_trainer(rcfg, data, dev, out_dir, "resume_straight",
                             num_epochs=4)
    hs = straight.train()
    first = _heal_trainer(rcfg, data, dev, out_dir, "resume_cut",
                          num_epochs=2)
    h1 = first.train()
    resumed = _heal_trainer(rcfg, data, dev, out_dir, "resume_cut",
                            num_epochs=4)
    h2 = resumed.train(resume=True)
    require(_captured(resumed, "train", "validate"),
            "the resumed run is not on graphs")
    for mode in ("train", "validate"):
        require(h1[mode] + h2[mode] == hs[mode],
                f"resumed {mode} losses {h1[mode] + h2[mode]}, straight "
                f"{hs[mode]}")
    require(_same(_guarded(straight), _guarded(resumed)),
            "the resumed run ends in another state than the straight one")
    snap = _host_ms(straight._snapshot, n=10, warmup=2)
    loop = _host_ms(lambda: straight._save_last(4, 0.0, 4, 10), n=10,
                    warmup=2)
    straight._writer.flush()

    def write():
        straight._save_last(4, 0.0, 4, 10)
        straight._writer.flush()

    disk = _host_ms(write, n=10, warmup=2)
    print(f"[heal] (e) 2 epochs, then resume to 4, equal 4 straight epochs "
          f"bit for bit by graph (losses {hs})", flush=True)
    print(f"[time] a rolling checkpoint on {card} (median / min of 10): the "
          f"host copy of the state {snap[0]:.3f} / {snap[1]:.3f} ms; what "
          f"the loop waits for (copy, hand-off to the writer thread) "
          f"{loop[0]:.3f} / {loop[1]:.3f} ms; to the disk (pickle, fsync, "
          f"rename) {disk[0]:.3f} / {disk[1]:.3f} ms", flush=True)


def heal_dead_init(dev, cfg, data, out_dir):
    """(f) The FC heads forced dead: 'error' raises DeadInitError after
    epoch 1 and flags the rolling checkpoint; 'retry' reseeds and trains
    a live run."""
    import torch

    from mpgcn_tpu_torch.train.trainer import DeadInitError
    from mpgcn_tpu_torch.utils.convert import read_checkpoint

    def kill(tr):
        with torch.no_grad():
            for br in tr.model.branches:
                for prm in br.fc.parameters():
                    prm.copy_(-prm.abs() - 0.1)

    dcfg = cfg.replace(pred_len=1, num_epochs=2)
    te = _heal_trainer(dcfg, data, dev, out_dir, "dead_error",
                       on_dead_init="error")
    kill(te)
    msg = _raises(te.train, DeadInitError)
    last = read_checkpoint(os.path.join(te.cfg.output_dir,
                                        "MPGCN_od_last.pkl"))
    require("no parameter changed over epoch 1" in msg
            and last["extra"].get("dead_init") is True
            and "dead_init" in [r["event"] for r in _events(te)],
            f"dead init, error: {msg}")
    tr = _heal_trainer(dcfg, data, dev, out_dir, "dead_retry",
                       on_dead_init="retry", num_epochs=1)
    kill(tr)
    h = tr.train()
    require(tr.cfg.seed != dcfg.seed and not tr._dead_init_detected
            and len(h["train"]) == 1 and np.isfinite(h["train"]).all()
            and not tr._forward_all_zero(),
            f"dead init, retry: seed {tr.cfg.seed}, history {h}")
    print(f"[heal] (f) dead heads: 'error' raised DeadInitError after "
          f"epoch 1 ({msg[:60]}...), the rolling checkpoint flagged; "
          f"'retry' reseeded to seed {tr.cfg.seed} and trained a live run "
          f"(train loss {h['train']})", flush=True)


def heal_watchdog(dev, cfg, data, out_dir, card):
    """(g) -watchdog 60: 2 epochs complete without the watchdog firing; the
    host copy of the state it takes each epoch, in ms."""
    tr = _heal_trainer(cfg, data, dev, out_dir, "watchdog", pred_len=1,
                       num_epochs=2, watchdog_secs=60.0)
    h = tr.train()
    names = [r["event"] for r in _events(tr)]
    require(len(h["train"]) == 2 and "watchdog_timeout" not in names
            and len(tr.watchdog_sync_ms) == 3 and tr._watchdog is None,
            f"watchdog run: {h}, events {names}")
    copy = _host_ms(tr._snapshot, n=10, warmup=2)
    print(f"[heal] (g) -watchdog 60: 2 epochs, no fire; its state updates "
          f"on {card} at arming and after each epoch "
          f"{[round(v, 3) for v in tr.watchdog_sync_ms]} ms (after an epoch "
          f"it takes the epoch's checkpoint snapshot); the host copy of the "
          f"state {copy[0]:.3f} / {copy[1]:.3f} ms (median / min of 10)",
          flush=True)


def phase_self_healing(dev, cfg, data, cfg_l, data_l, out_dir, card):
    """Phase 13: the self-healing trainer, (a)-(g), at the reference widths
    (N=47, cfg's live init seed) on the scan executor with graphs, (d)
    also at N=500. Returns the launches."""
    total = heal_sentinels(dev, cfg, data, out_dir, card)
    total = _add(total, heal_nan_window(dev, cfg, data, out_dir))
    total = _add(total, heal_multistep(dev, cfg, data, out_dir, card))
    total = _add(total, heal_accum(dev, cfg, data, cfg_l, data_l, out_dir))
    heal_resume(dev, cfg, data, out_dir, card)
    heal_dead_init(dev, cfg, data, out_dir)
    heal_watchdog(dev, cfg, data, out_dir, card)
    return total


# --- the precision plane ------------------------------------------------------

#: the bf16 rate of the H100's tensor cores, dense (NVIDIA data sheet): what
#: the bf16 entries' products could run at
PEAK_BF16_FLOP_PER_S = 989e12
#: the bf16 entries against their plain twins in float64 on the same bf16
#: operands with the same rounding points: a sum within f32 rounding of a
#: bf16 rounding boundary rounds the other way in one of them (2^-8
#: relative), which the LSTM carries into later steps through h: rtol 2^-7
#: and atol 2^-6 (4 bf16 ulps at 1.0), the atol x the largest entry where
#: the outputs are not O(1). dW (f32 sums) at the f32 dW tolerance where
#: both sides read the same bf16 operands (the BPTT), at 2^-10 x its
#: largest entry where they pass through a bf16 rounding of their own
#: (K-BDGCN's Z)
BF16_TOL = dict(rtol=2 ** -7, atol=2 ** -6)
BF16_KERNELS = ("lstm_infer_last_bf16", "lstm_infer_collect_bf16",
                "lstm_train_fwd_bf16", "lstm_train_bwd_bf16",
                "bdgcn_pair_fwd_bf16", "bdgcn_pair_bwd_bf16")


def compare_bf16(name, out, ref, scale=1.0):
    """A bf16 entry's output against its float64 twin at BF16_TOL."""
    return compare(name, out.double(), ref.double(),
                   dict(rtol=BF16_TOL["rtol"],
                        atol=BF16_TOL["atol"] * scale))


def _bf16_inputs(dev, rng, shape, scale=1.0, uniform=None):
    """A seeded bf16 tensor on the card: normal x scale, or uniform in
    +-``uniform`` (the model's LSTM init)."""
    import torch

    a = (rng.uniform(-uniform, uniform, shape) if uniform is not None
         else rng.normal(size=shape) * scale)
    return torch.from_numpy(a.astype(np.float32)).to(dev).bfloat16()


def _lstm_lib(dev, H, R, T, train):
    """nn.LSTM (cuDNN) in bf16 over R sequences of T steps from input
    width 1 (projection included): its forward time, and with ``train``
    its backward's."""
    import torch

    lib = torch.nn.LSTM(1, H, batch_first=True).to(dev).bfloat16()
    seq = torch.randn((R, T, 1), device=dev, dtype=torch.bfloat16,
                      requires_grad=train)
    if not train:
        with torch.no_grad():
            return time_ms(lambda: lib(seq), iters=10, warmup=2), None
    fwd = time_ms(lambda: lib(seq), iters=10, warmup=2)
    out, _ = lib(seq)
    gout = torch.randn_like(out)
    params = [seq, *lib.parameters()]
    bwd = time_ms(lambda: torch.autograd.grad(out, params, gout,
                                              retain_graph=True),
                  iters=10, warmup=2)
    return fwd, bwd


def precision_lstm(dev, rng, errors, times):
    """(a) for the LSTM entries: each bf16 form against its float64 twin
    at the N=47 serve (R = 17,672) and train (R = 8,836) shapes, the wide
    ones (H = 128) and the N=500 step's (R = 500,000); its time beside the
    f32 form's on the same values, its plain twin's (f32 compute), its
    bound at 2-byte storage (products at the bf16 tensor rate) and nn.LSTM
    in bf16. The N=47 shapes' numbers are the kernels line's."""
    import torch

    from mpgcn_tpu_torch.nn import cuda_lstm as L

    f64 = torch.float64
    for label, T, R, H in (("N=47 serve", 7, 17672, 32),
                           ("wide serve", 7, 17672, 128),
                           ("N=500", 7, 500000, 32)):
        s = 1 / np.sqrt(H)
        G = 4 * H
        xp = _bf16_inputs(dev, rng, (T, R, G))
        w = _bf16_inputs(dev, rng, (H, G), uniform=s)
        x = _bf16_inputs(dev, rng, (R, T, 1))
        w_ih = _bf16_inputs(dev, rng, (G, 1), uniform=s)
        b = _bf16_inputs(dev, rng, (G,), uniform=2 * s)
        lib_ms, _ = _lstm_lib(dev, H, R, T, False)
        big = R > 100000
        for collect, name in ((False, "lstm_infer_last_bf16"),
                              (True, "lstm_infer_collect_bf16")):
            out = L.lstm_layer_infer(xp, w, collect)
            e = compare_bf16(f"{name} {label} T={T} R={R} H={H}", out,
                             L.lstm_layer_infer_plain(xp, w, collect,
                                                      acc=f64))
            errors[name] = max(errors.get(name, 0.0), e)
            fo = L.lstm_layer_infer_fused(x, w_ih, b, w, collect)
            e = compare_bf16(f"{name} fused F=1 {label}", fo,
                             L.lstm_layer_infer_fused_plain(
                                 x, w_ih, b, w, collect, acc=f64))
            errors[name] = max(errors[name], e)
            del out, fo
            b_ms, b_by = bound(2 * (xp.numel() + w.numel()
                                    + (T if collect else 1) * R * H),
                               2 * (T - 1) * R * H * G, PEAK_BF16_FLOP_PER_S)
            xp32, w32 = xp.float(), w.float()
            entry = dict(
                ms=time_ms(lambda: L.lstm_layer_infer(xp, w, collect),
                           iters=10 if big else 50),
                plain_ms=time_ms(lambda: L.lstm_layer_infer_plain(
                    xp, w, collect), iters=3, warmup=1),
                bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms)
            f32_ms = time_ms(lambda: L.lstm_layer_infer(xp32, w32, collect),
                             iters=10 if big else 50)
            del xp32, w32
            print(f"[precision] (a) {name} {label} (T={T}, R={R}, H={H}, "
                  f"on x_proj; library torch.nn.LSTM in bf16, projection "
                  f"included): {json.dumps(entry)}; the f32 form on the "
                  f"same values {f32_ms:.4f} ms", flush=True)
            if label == "N=47 serve":
                times[name] = entry
            if not collect:
                fb_ms, fb_by = bound(2 * (x.numel() + w_ih.numel() + b.numel()
                                          + w.numel() + R * H),
                                     2 * T * R * G + 2 * (T - 1) * R * H * G,
                                     PEAK_BF16_FLOP_PER_S)
                x32, wi32, b32, w32 = (t.float() for t in (x, w_ih, b, w))
                print(f"[precision] (a) {name} fused from x (F=1) {label}: "
                      f"{time_ms(lambda: L.lstm_layer_infer_fused(x, w_ih, b, w, False), iters=10 if big else 50):.4f}"
                      f" ms, the f32 form "
                      f"{time_ms(lambda: L.lstm_layer_infer_fused(x32, wi32, b32, w32, False), iters=10 if big else 50):.4f}"
                      f" ms, bound {fb_ms:.5f} ms ({fb_by})", flush=True)
                del x32, wi32, b32, w32
        del xp, x
        torch.cuda.empty_cache()
    for label, T, R, H in (("N=47 train", 7, 8836, 32),
                           ("wide train", 7, 8836, 128),
                           ("N=500", 7, 500000, 32)):
        s = 1 / np.sqrt(H)
        G = 4 * H
        big = R > 100000
        xp = _bf16_inputs(dev, rng, (T, R, G))
        w = _bf16_inputs(dev, rng, (H, G), uniform=s)
        hs, cs = L.lstm_layer_train(xp, w)
        rh, rc = L.lstm_layer_train_plain(xp, w, acc=f64)
        e = max(compare_bf16(f"lstm_train_fwd_bf16 hs {label}", hs, rh),
                compare_bf16(f"lstm_train_fwd_bf16 cs {label}", cs, rc,
                             float(rc.abs().max())))
        errors["lstm_train_fwd_bf16"] = max(
            errors.get("lstm_train_fwd_bf16", 0.0), e)
        del rh, rc
        dhs = _bf16_inputs(dev, rng, (T, R, H))
        dxp, dw, part = L.lstm_layer_bwd_partials(xp, w, hs, cs, dhs, None)
        rx, rw = L.lstm_layer_bwd_plain(xp, w, hs, cs, dhs, None, acc=f64)
        e = max(compare_bf16(f"lstm_train_bwd_bf16 dx_proj {label}", dxp,
                             rx, float(rx.abs().max())),
                compare(f"lstm_train_bwd_bf16 dW {label} (f32 sum)",
                        dw.double(), rw, None))
        errors["lstm_train_bwd_bf16"] = max(
            errors.get("lstm_train_bwd_bf16", 0.0), e)
        require(torch.equal(L.dw_reduce_plain(part), dw),
                f"lstm_train_bwd_bf16 {label}: dW is not the ordered sum "
                f"of its partials")
        del dxp, rx, part
        lib_f, lib_b = _lstm_lib(dev, H, R, T, True)
        fb_ms, fb_by = bound(2 * (xp.numel() + w.numel() + 2 * T * R * H),
                             2 * (T - 1) * R * H * G, PEAK_BF16_FLOP_PER_S)
        xp32, w32, hs32, cs32, dhs32 = (t.float()
                                        for t in (xp, w, hs, cs, dhs))
        it = 10 if big else 50
        fwd = dict(ms=time_ms(lambda: L.lstm_layer_train(xp, w), iters=it),
                   plain_ms=time_ms(lambda: L.lstm_layer_train_plain(xp, w),
                                    iters=3, warmup=1),
                   bound_ms=fb_ms, bound_by=fb_by, library_ms=lib_f)
        f32_fwd = time_ms(lambda: L.lstm_layer_train(xp32, w32), iters=it)
        bb_ms, bb_by = bound(2 * (2 * T * R * G + 3 * T * R * H + H * G)
                             + 4 * H * G, 3 * 2 * (T - 1) * R * H * G,
                             PEAK_BF16_FLOP_PER_S)
        bwd = dict(ms=time_ms(lambda: L.lstm_layer_bwd(
                       xp, w, hs, cs, dhs, None), iters=it),
                   plain_ms=time_ms(lambda: L.lstm_layer_bwd_plain(
                       xp, w, hs, cs, dhs, None), iters=3, warmup=1),
                   bound_ms=bb_ms, bound_by=bb_by, library_ms=lib_b)
        f32_bwd = time_ms(lambda: L.lstm_layer_bwd(
            xp32, w32, hs32, cs32, dhs32, None), iters=it)
        engine = L.bwd_on_engine(L.device_index(dev), H)
        print(f"[precision] (a) lstm_train_fwd_bf16 {label} (T={T}, R={R}, "
              f"H={H}; library torch.nn.LSTM forward in bf16): "
              f"{json.dumps(fwd)}; the f32 form {f32_fwd:.4f} ms",
              flush=True)
        print(f"[precision] (a) lstm_train_bwd_bf16 {label} "
              f"({'engine path: hs and w_hh^T widened first' if engine else 'resident kernel'}, "
              f"P={L.bwd_blocks(R, H, dev, torch.bfloat16)}; library "
              f"torch.nn.LSTM backward in bf16): {json.dumps(bwd)}; the f32 "
              f"form {f32_bwd:.4f} ms (P={L.bwd_blocks(R, H, dev)})",
              flush=True)
        if label == "N=47 train":
            times["lstm_train_fwd_bf16"] = fwd
            times["lstm_train_bwd_bf16"] = bwd
        del xp, w, hs, cs, dhs, xp32, w32, hs32, cs32, dhs32
        torch.cuda.empty_cache()


def precision_bdgcn(dev, rng, errors, times):
    """(a) for K-BDGCN: the bf16 forward and backward against their
    float64 twins at the N=47 serve (B = 8) and train (B = 4) shapes and
    the wide ones (K = 7, C = H = 128), static and dynamic; times beside
    the f32 forms', the plain twins' (f32 compute), their bounds at 2-byte
    storage and torch.einsum in bf16 (autograd through it for the
    backward). The static N=47 shapes' numbers are the kernels line's."""
    import torch

    from mpgcn_tpu_torch.nn import cuda_bdgcn as KB
    from mpgcn_tpu_torch.nn.cuda_lstm import dw_reduce_plain

    f64 = torch.float64
    for label, K, B, N, C, H in (("N=47 serve", 3, 8, 47, 32, 32),
                                 ("N=47 train", 3, 4, 47, 32, 32),
                                 ("wide serve", 7, 8, 47, 128, 128),
                                 ("wide train", 7, 4, 47, 128, 128)):
        for dynamic in (False, True):
            h1 = _bf16_inputs(dev, rng, (K, B, N, N, C))
            g = (torch.from_numpy((rng.random((B if dynamic else 1, K, N, N))
                                   / N * 2).astype(np.float32))
                 .to(dev).bfloat16())
            wr = _bf16_inputs(dev, rng, (K, K, C, H),
                              scale=1 / np.sqrt(K * K * C))
            kind = "dynamic" if dynamic else "static"
            eq = ("obmcl,bdce,odlh->bmeh" if dynamic
                  else "obmcl,dce,odlh->bmeh")
            gl = g if dynamic else g[0]
            ops = 2 * B * N * N * (K * K * C * H + K * N * H)
            out = KB.folded_pair_project(h1, g, wr)
            ref = KB.folded_pair_project_plain(h1, g, wr, acc=f64)
            e = compare_bf16(f"bdgcn_pair_fwd_bf16 {label} {kind}", out, ref,
                             float(ref.abs().max()))
            errors["bdgcn_pair_fwd_bf16"] = max(
                errors.get("bdgcn_pair_fwd_bf16", 0.0), e)
            if "serve" in label:
                b_ms, b_by = bound(2 * (h1.numel() + g.numel() + wr.numel()
                                        + B * N * N * H), ops,
                                   PEAK_BF16_FLOP_PER_S)
                h32, g32, w32 = h1.float(), g.float(), wr.float()
                entry = dict(
                    ms=time_ms(lambda: KB.folded_pair_project(h1, g, wr)),
                    plain_ms=time_ms(lambda: KB.folded_pair_project_plain(
                        h1, g, wr), iters=5, warmup=1),
                    bound_ms=b_ms, bound_by=b_by,
                    library_ms=time_ms(lambda: torch.einsum(eq, h1, gl, wr),
                                       iters=5, warmup=1))
                f32_ms = time_ms(lambda: KB.folded_pair_project(h32, g32,
                                                                w32))
                print(f"[precision] (a) bdgcn_pair_fwd_bf16 {label} {kind} "
                      f"(K={K}, B={B}, N={N}, C={C}, H={H}; operands "
                      f"widened into f32 scratch, U and out rounded; "
                      f"library torch.einsum in bf16): {json.dumps(entry)}; "
                      f"the f32 form {f32_ms:.4f} ms", flush=True)
                if label == "N=47 serve" and not dynamic:
                    times["bdgcn_pair_fwd_bf16"] = entry
                continue
            dout = _bf16_inputs(dev, rng, (B, N, N, H))
            dh1, dW, part = KB.folded_pair_project_bwd_partials(h1, g, wr,
                                                                dout)
            r1, rW = KB.folded_pair_project_bwd_plain(h1, g, wr, dout,
                                                      acc=f64)
            e = max(compare_bf16(f"bdgcn_pair_bwd_bf16 dh1 {label} {kind}",
                                 dh1, r1, float(r1.abs().max())),
                    compare(f"bdgcn_pair_bwd_bf16 dW {label} {kind} (f32 "
                            f"sum)", dW.double(), rW,
                            dict(rtol=BF16_TOL["rtol"],
                                 atol=2 ** -10 * float(rW.abs().max()))))
            errors["bdgcn_pair_bwd_bf16"] = max(
                errors.get("bdgcn_pair_bwd_bf16", 0.0), e)
            require(torch.equal(dw_reduce_plain(part), dW),
                    f"bdgcn_pair_bwd_bf16 {label}: dW is not the ordered sum "
                    f"of its partials")
            bops = 2 * B * N * N * (K * N * H + 2 * K * K * C * H)
            b_ms, b_by = bound(2 * (2 * h1.numel() + dout.numel() + g.numel()
                                    + wr.numel()) + 4 * wr.numel(), bops,
                               PEAK_BF16_FLOP_PER_S)
            h1r = h1.clone().requires_grad_()
            wrr = wr.clone().requires_grad_()
            lref = torch.einsum(eq, h1r, gl, wrr)
            h32, g32, w32, d32 = (t.float() for t in (h1, g, wr, dout))
            entry = dict(
                ms=time_ms(lambda: KB.folded_pair_project_bwd(h1, g, wr,
                                                              dout)),
                plain_ms=time_ms(lambda: KB.folded_pair_project_bwd_plain(
                    h1, g, wr, dout), iters=3, warmup=1),
                bound_ms=b_ms, bound_by=b_by,
                library_ms=time_ms(lambda: torch.autograd.grad(
                    lref, (h1r, wrr), dout, retain_graph=True), iters=5,
                    warmup=1))
            f32_ms = time_ms(lambda: KB.folded_pair_project_bwd(h32, g32,
                                                                w32, d32))
            print(f"[precision] (a) bdgcn_pair_bwd_bf16 {label} {kind} "
                  f"(K={K}, B={B}, N={N}, C={C}, H={H}; dW cast after its "
                  f"f32 sum; library autograd through torch.einsum in "
                  f"bf16): {json.dumps(entry)}; the f32 form {f32_ms:.4f} "
                  f"ms", flush=True)
            if label == "N=47 train" and not dynamic:
                times["bdgcn_pair_bwd_bf16"] = entry
        torch.cuda.empty_cache()


def _per_step_bf16(cfg, train: bool, impl: str = "kernel",
                   remat: bool = False) -> dict:
    """``_per_step`` in bf16: the same launches on the bf16 entries (the
    ELL arm keeps its f32 entries on widened X); with ``remat`` each
    training forward entry launches twice a step (its forward, and again
    inside the backward)."""
    counts = _per_step(cfg, train, impl)
    out = dict.fromkeys(KERNEL_META, 0)
    for name, v in counts.items():
        key = f"{name}_bf16" if f"{name}_bf16" in KERNEL_META else name
        twice = remat and train and name in ("lstm_train_fwd",
                                             "bdgcn_pair_fwd", "ell_fwd")
        out[key] += 2 * v if twice else v
    return out


def precision_cli(dev, out_dir, card):
    """(b) The reference command with -dtype bfloat16 on the dataset tree
    phase 11 wrote, its run (a) flags and live seed: 2 epochs (exact bf16
    launches a step, by graph) and test mode at -infer-precision auto
    (bf16 rollouts), beside run (a)'s f32 validation RMSE. Returns the
    launches."""
    from mpgcn_tpu_torch import cli
    from mpgcn_tpu_torch.data.loader import load_dataset
    from mpgcn_tpu_torch.data.pipeline import DataPipeline
    from mpgcn_tpu_torch.utils.convert import read_checkpoint
    from mpgcn_tpu_torch.utils.logging import read_events

    tree = os.path.join(out_dir, "data")
    f32_dir = os.path.join(out_dir, "a")
    seed = read_checkpoint(os.path.join(f32_dir, "MPGCN_od.pkl"))[
        "extra"]["seed"]
    run_dir = os.path.join(out_dir, "a_bf16")
    argv = (["-GPU", "0", "-in", tree, "-data", "npz"] + REF_CLI_RUNS["a"]
            + ["-dtype", "bfloat16", "-seed", str(seed), "-out", run_dir])
    cfg = cli.config_from_args(cli.build_parser().parse_args(argv).__dict__)
    data, _ = load_dataset(cfg)
    cfg = cfg.replace(num_nodes=data["OD"].shape[1])
    pipe = DataPipeline(cfg, data, dev)
    hist, counts, train_s, printed = _cli(argv)
    steps = cfg.num_epochs * pipe.num_batches("train")
    evals = len(hist["validate"]) * pipe.num_batches("validate")
    expect = _add(_scaled(_per_step_bf16(cfg, True), steps),
                  _scaled(_per_step_bf16(cfg, False), evals))
    require(counts == expect, f"bf16 CLI: training launched "
            f"{_nz(counts)}, expected {_nz(expect)}")
    require(all(np.isfinite(hist["train"] + hist["validate"]))
            and hist["train"][-1] < hist["train"][0],
            f"bf16 CLI: epoch losses {hist}")
    ev = read_events(os.path.join(run_dir, "MPGCN_train_log.jsonl"), "epoch")
    ev32 = read_events(os.path.join(f32_dir, "MPGCN_train_log.jsonl"),
                       "epoch")
    rmse16 = float(np.sqrt(ev[-1]["validate_loss"]))
    rmse32 = float(np.sqrt(ev32[-1]["validate_loss"]))
    require(rmse16 <= 1.10 * rmse32, f"bf16 validation RMSE {rmse16} vs "
            f"f32 {rmse32}: past 10%")
    res, test_counts, test_s, _ = _cli(argv + ["-mode", "test"])
    tpipe = DataPipeline(cfg.replace(pred_len=7, mode="test"), data, dev)
    rollouts = sum(tpipe.num_batches(m) for m in ("train", "test"))
    want = _scaled(_per_step_bf16(cfg, False), 7 * rollouts)
    require(test_counts == want, f"bf16 CLI test mode launched "
            f"{_nz(test_counts)}, expected {_nz(want)}")
    scores = _scores(run_dir)
    require(np.isfinite(scores).all(), f"bf16 CLI scores {scores}")
    print(f"[precision] (b) the reference command -dtype bfloat16 (run "
          f"(a) flags, seed {seed}) on {card}: steps/sec "
          f"{_steps_per_sec(printed)}; train {train_s:.1f}s host clock; "
          f"epoch losses {hist}; final loss scale {ev[-1]['loss_scale']}, "
          f"scaler skips {ev[-1]['scaler_skipped_steps']}; validation RMSE "
          f"{rmse16:.5f} beside the f32 run's {rmse32:.5f} "
          f"({rmse16 / rmse32:.4f}x); launches per train step "
          f"{_nz(_per_step_bf16(cfg, True))}; test mode (bf16 rollouts) "
          f"{test_s:.3f}s for {rollouts} rollouts, scores (MSE, RMSE, MAE, "
          f"MAPE) {scores.tolist()}", flush=True)
    return _add(counts, test_counts)


def precision_overflow(dev, cfg, data, out_dir):
    """(c) bf16 training at N=47 with an overflow forced into the scaled
    gradients of two steps inside the captured step: a hook multiplies
    one weight's gradient by a device scalar, 1 but Inf at steps 3 and 6
    (the captured step reads it). Those steps are skipped by the scaler
    (weights and Adam's state kept, the scale halved, the loss finite and
    unmarked). 8 steps by graph equal 8 per-step steps bit for bit, the
    scaler's state included."""
    import torch

    from mpgcn_tpu_torch.train.trainer import ModelTrainer

    tcfg = cfg.replace(pred_len=1, dtype="bfloat16")
    trs, poison = {}, {}
    for name, scan in (("graphs", True), ("per_step", False)):
        d = os.path.join(out_dir, f"overflow_{name}")
        os.makedirs(d)
        trs[name] = tr = ModelTrainer(tcfg.replace(epoch_scan=scan,
                                                   output_dir=d), data,
                                      device=dev)
        poison[name] = t = torch.ones((), device=dev)
        next(tr.model.parameters()).register_hook(lambda g, t=t: g * t)
    a, b = trs["graphs"], trs["per_step"]
    n, bad = 8, (3, 6)
    ep = a._epoch_state("train")
    ep.load(*a._epoch_index("train", False, None))
    for i in range(n):
        poison["graphs"].fill_(float("inf") if i in bad else 1.0)
        a._exec_step("train", ep, True)
    a.optimizer.advance(n)
    got = ep.losses[:n].cpu().numpy()
    ref = []
    for i, x in enumerate(list(b.pipeline.batches(
            "train", pad_to_full=True))[:n]):
        poison["per_step"].fill_(float("inf") if i in bad else 1.0)
        ref.append(b.train_step(x))
    ref = np.array(ref, np.float32)
    require(a._graphs.get("train") is not None, "overflow: no train graph")
    require(np.array_equal(got, ref) and np.isfinite(got).all(),
            f"overflow: losses by graph {got}, per step {ref}")
    _require_same_state(_state(a), _state(b), "overflow")
    st, st_b = a.optimizer.scaler.stats(), b.optimizer.scaler.stats()
    require(st == st_b, f"overflow: scaler {st} by graph, {st_b} per step")
    require(st["skipped_steps"] == len(bad)
            and st["scale"] == tcfg.loss_scale_init / 2 ** len(bad)
            and int(a.optimizer.step_t) == n - len(bad),
            f"overflow: scaler {st}, step_t {int(a.optimizer.step_t)}")
    print(f"[precision] (c) bf16 (N=47, seed {tcfg.seed}), an Inf forced "
          f"into the scaled gradients of steps {list(bad)} inside the "
          f"replayed step: both skipped by the scaler (scale "
          f"{tcfg.loss_scale_init} -> {st['scale']}, step_t "
          f"{int(a.optimizer.step_t)} after {n} steps; losses finite and "
          f"unmarked); by graph equal per step bit for bit (losses "
          f"{got.tolist()}, weights, Adam's state, the scaler)", flush=True)
    del a, b, trs
    torch.cuda.empty_cache()


def precision_large_n(dev, cfg_l, data_l, out_dir, card):
    """(d) BASELINE config 5 as benchmarks/large_n.py drives it: N=500 on
    the ELL arm in bf16 with remat. One batch's gradients against the f32
    step's (same weights; 5e-2 of each one's largest entry); launches a
    step with the forwards twice (remat); step ms (host clock, median of
    4 after 2) and peak device bytes of a step's forward and backward,
    beside f32 without remat in this run."""
    import statistics

    import torch

    from mpgcn_tpu_torch.train.trainer import ModelTrainer

    trs = {}
    for name, kw in (("f32", {}), ("bf16_remat", dict(dtype="bfloat16",
                                                       remat=True))):
        d = os.path.join(out_dir, f"large_n_{name}")
        os.makedirs(d)
        trs[name] = ModelTrainer(cfg_l.replace(pred_len=1, output_dir=d,
                                               **kw), data_l, device=dev)
    a, b = trs["bf16_remat"], trs["f32"]
    require(a.bdgcn_impl == "ell" and a.model.remat
            and a.model.compute_dtype == torch.bfloat16,
            f"large-N bf16: impl {a.bdgcn_impl}, remat {a.model.remat}")
    b.model.load_state_dict(a.model.state_dict())
    batches = list(a.pipeline.batches("train", pad_to_full=True))[:4]
    peaks, grads = {}, {}
    for name, tr in trs.items():
        x, y, keys = tr._tensors(batches[0])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        reset_counts()
        tr._loss_and_grads(x, y, keys, tr._size(batches[0]))
        counts = read_counts()
        peaks[name] = torch.cuda.max_memory_allocated(dev)
        grads[name] = {n: p.grad.detach().clone()
                       for n, p in tr.model.named_parameters()}
        tr.optimizer.zero_grad(set_to_none=True)
        if name == "bf16_remat":
            want = _per_step_bf16(a.cfg, True, "ell", remat=True)
            require(counts == want, f"large-N bf16 remat step launched "
                    f"{_nz(counts)}, expected {_nz(want)}")
            launches = counts
    scale = a.optimizer.scaler.stats()["scale"]
    worst = 0.0
    for n, g in grads["bf16_remat"].items():
        ref = grads["f32"][n] * scale
        top = float(ref.abs().max())
        err = float((g - ref).abs().max()) / max(top, 1e-30)
        require(err <= 5e-2, f"large-N bf16 gradient {n}: {err:.3e} of its "
                             f"largest entry from the f32 one")
        worst = max(worst, err)
    ms = {}
    for name, tr in trs.items():
        ms[name] = statistics.median(_step_ms(tr, batches, 4, 2))
    require(all(np.isfinite(float(p.detach().float().abs().max()))
                for p in a.model.parameters()), "large-N bf16: non-finite")
    print(f"[precision] (d) N=500 (BASELINE config 5, ELL arm, batch 2) on "
          f"{card}: bf16 with remat, step {ms['bf16_remat']:.3f} ms, peak "
          f"device bytes of a step's forward and backward "
          f"{peaks['bf16_remat'] / 1e9:.3f} GB; f32 without remat (same "
          f"weights, this run) {ms['f32']:.3f} ms, "
          f"{peaks['f32'] / 1e9:.3f} GB ({peaks['bf16_remat'] / peaks['f32']:.3f}"
          f"x); scaled bf16 gradients within {worst:.3e} of each f32 "
          f"gradient's largest entry (x the scale {scale}); launches per "
          f"bf16 step {_nz(launches)} (remat: each forward entry twice)",
          flush=True)
    total = _add(launches, {})
    del a, b, trs, grads
    torch.cuda.empty_cache()
    return total


def precision_rollouts(dev, cfg, data, card):
    """(e) Rollouts by graph at buckets 1/2/4/8 with -infer-precision bf16
    and int8 (N=47, fresh weights from cfg's live seed, as the f32 engine
    of phase 3 has them): ms per bucket by graph (host clock, median of 5
    after 1) beside the f32 graphs', max |delta| from the f32 rollout
    (under 0.05, the JAX bound), each graph equal to the eager rollout at
    its precision bit for bit; then ServeEngine.submit in each mode, and
    at bf16 with 2 LSTM layers (the collect entry). Returns the
    launches of the submits."""
    import torch

    from mpgcn_tpu_torch.config import ServeConfig
    from mpgcn_tpu_torch.service.serve import ServeEngine
    from mpgcn_tpu_torch.train.predict import rollout

    scfg = ServeConfig(buckets=(1, 2, 4, 8), max_wait_ms=100.0,
                       deadline_ms=0.0)
    engines, total = {}, {}
    svc = os.path.join(HERE, "smoke_out", "serve", "precision")
    for ip in ("f32", "bf16", "int8"):
        engines[ip] = ServeEngine(cfg.replace(infer_precision=ip), data,
                                  scfg.replace(output_dir=os.path.join(
                                      svc, ip)),
                                  device=dev, allow_fresh=True)
    md = engines["f32"].pipeline.modes["test"]
    summary = {}
    for b in scfg.buckets:
        x = torch.from_numpy(np.array(md.x[:b]))
        k = torch.from_numpy(md.keys[:b].astype(np.int64))
        ref = engines["f32"]._rollouts.run(x, k, 7)
        row = {}
        for ip, eng in engines.items():
            prec = eng._precision
            g = eng._rollouts.graphs.get(eng._rollouts._key(b, 7, prec))
            require(g is not None, f"no {ip} rollout graph for bucket {b}")
            got = eng._rollouts.run(x, k, 7, prec)
            eager = rollout(eng.model, eng.banks, x.to(dev), k.to(dev), 7,
                            prec.dtype, prec.params).cpu()
            require(torch.equal(got, eager), f"{ip} bucket {b}: the graph "
                    f"differs from the eager rollout")
            delta = float((got - ref).abs().max())
            require(delta < 0.05, f"{ip} bucket {b}: max |delta| {delta} "
                                  f"from f32")
            xd, kd = x.to(dev), k.to(dev)
            ms = _host_ms(lambda: g.replay(xd, kd), n=5, warmup=1)[0]
            row[ip] = (ms, delta)
        summary[b] = row
    print(f"[precision] (e) N=47 rollouts by graph on {card} (horizon 7, "
          f"host clock median of 5; max |delta| from the f32 rollout): "
          + "; ".join(f"bucket {b}: " + ", ".join(
              f"{ip} {ms:.3f} ms ({d:.3e})" for ip, (ms, d) in row.items())
              for b, row in summary.items())
          + f"; int8 round-trip error "
            f"{engines['int8'].quant_max_abs_error:.3e}", flush=True)
    x = np.array(md.x[:3])
    for ip, eng in engines.items():
        reset_counts()
        tickets = [eng.submit(x[i, ..., 0], int(md.keys[i]))
                   for i in range(3)]
        for t in tickets:
            require(t.wait(120) and t.ok, f"{ip} submit: {t.outcome}")
        counts = read_counts()
        bf = ip == "bf16"
        require(counts["bdgcn_pair_fwd_bf16" if bf else "bdgcn_pair_fwd"]
                > 0 and counts["bdgcn_pair_fwd" if bf else
                               "bdgcn_pair_fwd_bf16"] == 0,
                f"{ip} submit launched {_nz(counts)}")
        total = _add(total, counts)
        eng.drain()
        eng.close()
    two = ServeEngine(cfg.replace(infer_precision="bf16", lstm_num_layers=2),
                      data, scfg.replace(output_dir=os.path.join(svc, "two")),
                      device=dev, allow_fresh=True)
    reset_counts()
    t = two.submit(x[0, ..., 0], int(md.keys[0]))
    require(t.wait(120) and t.ok and np.isfinite(t.pred).all(),
            f"2-layer bf16 submit: {t.outcome}")
    counts = read_counts()
    require(counts["lstm_infer_collect_bf16"] == 7 * cfg.num_branches,
            f"2-layer bf16 submit launched {_nz(counts)}")
    total = _add(total, counts)
    two.drain()
    two.close()
    print(f"[precision] (e) ServeEngine.submit answered 3 requests at each "
          f"of f32, bf16 and int8 (bf16 on the bf16 kernels, int8 on the "
          f"f32 ones over codes dequantized inside the graph) and one at "
          f"bf16 with 2 LSTM layers; launches {_nz(total)}", flush=True)
    return total


def phase_precision(dev, cfg, data, cfg_l, data_l, out_dir, ref_dir, card):
    """Phase 14: the precision plane, (a)-(e). Returns (errors, times,
    launches) of the bf16 entries' main paths ((b), (d), (e))."""
    import torch

    torch.cuda.empty_cache()
    rng = np.random.default_rng(1600)
    errors, times = {}, {}
    precision_lstm(dev, rng, errors, times)
    precision_bdgcn(dev, rng, errors, times)
    total = precision_cli(dev, ref_dir, card)
    precision_overflow(dev, cfg, data, out_dir)
    total = _add(total, precision_large_n(dev, cfg_l, data_l, out_dir, card))
    total = _add(total, precision_rollouts(dev, cfg, data, card))
    return errors, times, total

# --- the city-scale feed ----------------------------------------------------

def _bits_equal(a, b) -> bool:
    import torch

    return a.shape == b.shape and bool(torch.equal(a, b))


def city_fused_widths(dev, banks, label, card):
    """(a) The fused destination SpMM at the widths the fused epilogue
    gives it, N=500, B=2, K=3, C=32: static, X (500, K B N C = 96,000)
    shared by the K supports; dynamic, one X (500, K N C = 48,000) per
    sample. Its output and dX must equal, bit for bit, the per-origin
    SpMMs' at F = 32,000 / 16,000 for the same columns (the same kernel
    on the same operands), and a slice of columns holds against the
    plain version. Returns nothing: these launches are checks, not a
    main path."""
    import torch

    from mpgcn_tpu_torch.sparse import cuda_ell
    from mpgcn_tpu_torch.sparse.kernels import ell_spmm, flat_stack

    gen = torch.Generator(device=dev).manual_seed(19)
    K, B, N, C = 3, 2, 500, 32
    keys = torch.tensor([1, 4], device=dev)
    for form, G, lead, f_o in (("static", banks["static"], (), B * N * C),
                               ("dynamic", banks["d"][keys], (B,), N * C)):
        F = K * f_o
        hf = torch.randn(lead + (N, F), device=dev, generator=gen)
        hf.requires_grad_()
        out = ell_spmm(G, hf)
        dout = torch.randn(out.shape, device=dev, generator=gen)
        out.backward(dout)
        for o in range(K):
            cols = slice(o * f_o, (o + 1) * f_o)
            ho = hf.detach()[..., cols].contiguous().requires_grad_()
            oo = ell_spmm(G, ho)
            oo.backward(dout[..., cols].contiguous())
            require(_bits_equal(out.detach()[..., cols], oo.detach()),
                    f"[city-feed] {label} {form}: the fused SpMM's columns "
                    f"of origin {o} differ from its own SpMM's")
            require(_bits_equal(hf.grad[..., cols], ho.grad),
                    f"[city-feed] {label} {form}: the fused dX's columns "
                    f"of origin {o} differ from its own dX's")
        # a slice of the columns against the plain versions
        cols_f, tiles, scale, t_ptr, t_slot = flat_stack(G)
        S = cols_f.shape[0]
        x_div = S // (B if lead else 1)
        X3 = hf.detach()[..., :512].reshape(-1, N, 512).contiguous()
        ref = cuda_ell.ell_fwd_plain(cols_f, tiles, X3, G.n_rows, x_div,
                                     scale)
        compare(f"[city-feed] {label} {form} fused SpMM (F = {F}) vs plain, "
                f"first 512 columns", out.detach().reshape(S, N, F)[..., :512],
                ref, BDGCN_TOL)
        d3 = dout.reshape(S, N, F)[..., :512].contiguous()
        dref = cuda_ell.ell_bwd_dx_plain(cols_f, tiles, d3, G.n_cols, x_div,
                                         scale)
        compare(f"[city-feed] {label} {form} fused dX vs plain, first 512 "
                f"columns", hf.grad.reshape(-1, N, F)[..., :512], dref,
                BDGCN_TOL)
        print(f"[city-feed] (a) {label} {form}: the fused destination SpMM "
              f"at F = {F} ({tuple(out.shape)}, "
              f"{out.numel() * 4 / 1e6:.0f} MB out) equals the {K} "
              f"per-origin SpMMs at F = {f_o} bit for bit, forward and dX "
              f"({card})", flush=True)
        # the kernels at these widths (CUDA events): one launch at F
        # against the K per-origin launches at F / K, beside the bound
        X_f = hf.detach().reshape(-1, N, F)
        d_f = dout.reshape(S, N, F)
        parts = [slice(o * f_o, (o + 1) * f_o) for o in range(K)]
        X_o = [hf.detach()[..., c].reshape(-1, N, f_o).contiguous()
               for c in parts]
        d_o = [dout[..., c].reshape(S, N, f_o).contiguous() for c in parts]
        args = (cols_f, tiles, t_ptr, t_slot)

        def fwd(x):
            return cuda_ell.ell_fwd(*args, x, N, x_div, scale)

        def dx(d):
            return cuda_ell.ell_bwd_dx(*args, d, N, x_div, scale)

        ms = {"fwd": time_ms(lambda: fwd(X_f), iters=10, warmup=2),
              "fwd_k": time_ms(lambda: [fwd(x) for x in X_o], iters=10,
                               warmup=2),
              "dx": time_ms(lambda: dx(d_f), iters=10, warmup=2),
              "dx_k": time_ms(lambda: [dx(d) for d in d_o], iters=10,
                              warmup=2)}
        ops, _ = _ell_ops(cols_f, tiles, N, N, F)
        small = (tiles.numel() * tiles.element_size() + cols_f.numel() * 4
                 + (0 if scale is None else scale.numel() * 4)
                 + 4 * (t_ptr.numel() + t_slot.numel()))
        passes = 3 if scale is None else 2
        b_f = bound(4 * (X_f.numel() + S * N * F) + small, passes * ops,
                    PEAK_TF32_FLOP_PER_S)
        b_d = bound(4 * (d_f.numel() + X_f.numel()) + small, passes * ops,
                    PEAK_TF32_FLOP_PER_S)
        print(f"[time] city-feed (a) {label} {form} at F = {F} (CUDA events, "
              f"means of 10): forward {ms['fwd']:.4f} ms against {K} "
              f"launches at F = {f_o} {ms['fwd_k']:.4f} ms (bound "
              f"{b_f[0]:.4f} ms, {b_f[1]}); dX {ms['dx']:.4f} ms against "
              f"{ms['dx_k']:.4f} ms (bound {b_d[0]:.4f} ms, {b_d[1]}) "
              f"({card})", flush=True)
        del hf, out, dout, X_f, d_f, X_o, d_o
        torch.cuda.empty_cache()


def _peak_step_bytes(tr, batch):
    """(peak device bytes allocated while one train step runs, what was
    allocated before it)."""
    import torch

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    tr.train_step(batch)
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated(), base


def _rollout_ms(tr, x, k, n=4):
    import statistics

    from mpgcn_tpu_torch.train.predict import rollout

    samples = [_host_ms(lambda: rollout(tr.model, tr.banks, x, k, 7),
                        n=1, warmup=0)[0] for _ in range(n)]
    return statistics.median(samples)


def city_fused(dev, cfg_l, data_l, card):
    """(a) The fused epilogue on the ELL arm at N=500: the fused SpMM's
    widths bit for bit; the fused model's loss and gradients against the
    plain arms (f32 and float64) and against the unfused ELL arm, in f32
    and on int8 tiles; exact launches of a step, a bucket-2 rollout and an
    int8 step, fused and unfused; step and rollout times and peak bytes,
    fused against unfused. Returns the launches of its main paths."""
    import statistics

    import torch

    from mpgcn_tpu_torch.train.trainer import ModelTrainer

    tcfg = cfg_l.replace(pred_len=1)
    unf = ModelTrainer(tcfg, data_l, device=dev)
    fus = ModelTrainer(tcfg.replace(fused_epilogue=True), data_l, device=dev)
    fus.model.load_state_dict(unf.model.state_dict())
    require(unf.bdgcn_impl == fus.bdgcn_impl == "ell",
            f"N=500 arms {unf.bdgcn_impl} / {fus.bdgcn_impl}")
    city_fused_widths(dev, fus.banks, "f32 tiles", card)
    batches = list(unf.pipeline.batches("train", pad_to_full=True))[:3]
    plain = ModelTrainer(tcfg, data_l, device=dev, lstm_impl="plain",
                         bdgcn_impl="einsum")
    plain.model.load_state_dict(unf.model.state_dict())
    ref64 = copy.deepcopy(plain.model).double()
    grad_check("city-feed N=500 fused ELL", batches[0], fus, plain, ref64,
               dev)
    del ref64, plain
    torch.cuda.empty_cache()
    lu, gu, _ = batch_grads(unf.model, unf, batches[0], False, dev)
    lf, gf, _ = batch_grads(fus.model, fus, batches[0], False, dev)
    require(abs(lf - lu) <= GRAD_RTOL * abs(lu), f"fused loss {lf} vs {lu}")
    for name, g in gu.items():
        scale = float(g.abs().max())
        require(torch.allclose(gf[name], g, rtol=GRAD_RTOL,
                               atol=GRAD_ATOL_SCALE * scale),
                f"[city-feed] fused vs unfused gradient of {name}")
    print(f"[city-feed] (a) fused ELL loss {lf:.7f} against unfused "
          f"{lu:.7f}; every gradient agrees (rtol {GRAD_RTOL}, atol "
          f"{GRAD_ATOL_SCALE} x max|g|)", flush=True)

    total = {}
    counts = {}
    for name, tr in (("unfused", unf), ("fused", fus)):
        reset_counts()
        tr.train_step(batches[1])
        counts[name, "step"] = read_counts()
        require(counts[name, "step"] == _per_step(tr.cfg, True, "ell"),
                f"[city-feed] {name} step launched "
                f"{_nz(counts[name, 'step'])}, expected "
                f"{_nz(_per_step(tr.cfg, True, 'ell'))}")
        md = tr.pipeline.modes["test"]
        x = torch.from_numpy(np.array(md.x[:2])).to(dev)
        k = torch.from_numpy(md.keys[:2].astype(np.int64)).to(dev)
        reset_counts()
        tr.predict(x.cpu().numpy(), k.cpu().numpy(), 7)
        counts[name, "rollout"] = read_counts()
        want = _scaled(_per_step(tr.cfg, False, "ell"), 7)
        require(counts[name, "rollout"] == want,
                f"[city-feed] {name} bucket-2 rollout launched "
                f"{_nz(counts[name, 'rollout'])}, expected {_nz(want)}")
        total = _add(total, _add(counts[name, "step"],
                                 counts[name, "rollout"]))
    print(f"[city-feed] (a) launches: step unfused "
          f"{_nz(counts['unfused', 'step'])}, fused "
          f"{_nz(counts['fused', 'step'])} (the fused backward runs the "
          f"destination SpMM again inside its checkpoint); bucket-2 "
          f"rollout unfused {_nz(counts['unfused', 'rollout'])}, fused "
          f"{_nz(counts['fused', 'rollout'])}", flush=True)

    # int8 tiles: the widths, the gradients against the unfused int8 arm,
    # and the launches of an int8 step
    q_unf = ModelTrainer(tcfg.replace(support_payload="int8"), data_l,
                         device=dev)
    q_fus = ModelTrainer(tcfg.replace(support_payload="int8",
                                      fused_epilogue=True), data_l,
                         device=dev)
    for tr in (q_unf, q_fus):
        tr.model.load_state_dict(unf.model.state_dict())
    city_fused_widths(dev, q_fus.banks, "int8 tiles", card)
    lu, gu, _ = batch_grads(q_unf.model, q_unf, batches[0], False, dev)
    lf, gf, _ = batch_grads(q_fus.model, q_fus, batches[0], False, dev)
    require(abs(lf - lu) <= GRAD_RTOL * abs(lu), f"int8 loss {lf} vs {lu}")
    for name, g in gu.items():
        scale = float(g.abs().max())
        require(torch.allclose(gf[name], g, rtol=GRAD_RTOL,
                               atol=GRAD_ATOL_SCALE * scale),
                f"[city-feed] int8 fused vs unfused gradient of {name}")
    q_counts = {}
    for name, tr in (("unfused", q_unf), ("fused", q_fus)):
        reset_counts()
        tr.train_step(batches[1])
        q_counts[name] = read_counts()
        require(q_counts[name] == _per_step(tr.cfg, True, "ell"),
                f"[city-feed] int8 {name} step launched "
                f"{_nz(q_counts[name])}")
        total = _add(total, q_counts[name])
    print(f"[city-feed] (a) int8 tiles: fused loss {lf:.7f} against "
          f"unfused {lu:.7f}, gradients agree; a step launches unfused "
          f"{_nz(q_counts['unfused'])}, fused {_nz(q_counts['fused'])}",
          flush=True)
    del q_unf, q_fus
    torch.cuda.empty_cache()

    # times and peak bytes, fused against unfused, alternated
    md = unf.pipeline.modes["test"]
    x = torch.from_numpy(np.array(md.x[:2])).to(dev)
    k = torch.from_numpy(md.keys[:2].astype(np.int64)).to(dev)
    step = {"unfused": [], "fused": []}
    roll = {"unfused": [], "fused": []}
    peak = {}
    for name, tr in (("unfused", unf), ("fused", fus)) * 2:
        step[name] += _step_ms(tr, batches, 3, 1)
        roll[name].append(_rollout_ms(tr, x, k, 2))
        peak[name] = _peak_step_bytes(tr, batches[0])
    med = {n: statistics.median(v) for n, v in step.items()}
    rmed = {n: statistics.median(v) for n, v in roll.items()}
    print(f"[time] city-feed (a) N=500 ELL train step, host clock around a "
          f"synchronised step, medians of 6 (two alternated rounds of 3 "
          f"after a warm-up): fused {med['fused']:.3f} ms, unfused "
          f"{med['unfused']:.3f} ms ({med['fused'] / med['unfused']:.3f}x); "
          f"bucket-2 rollout (7 steps, eager) fused {rmed['fused']:.3f} ms, "
          f"unfused {rmed['unfused']:.3f} ms "
          f"({rmed['fused'] / rmed['unfused']:.3f}x); peak device bytes "
          f"of a step fused {peak['fused'][0] / 1e9:.3f} GB, unfused "
          f"{peak['unfused'][0] / 1e9:.3f} GB (the step's own: "
          f"{(peak['fused'][0] - peak['fused'][1]) / 1e9:.3f} / "
          f"{(peak['unfused'][0] - peak['unfused'][1]) / 1e9:.3f} GB over "
          f"{peak['unfused'][1] / 1e9:.3f} GB resident) ({card})",
          flush=True)
    busy_share("city-feed fused N=500 train step",
               lambda: fus.train_step(batches[0]), 2)
    return total


def _guard_stream(tr, guarded):
    """Run the stream epochs numbered in ``guarded`` (1-based) under
    torch.cuda.set_sync_debug_mode("error"), lifted only inside the
    executor's pacing waits, which are counted: a host sync anywhere else
    inside the epoch raises. Returns the list of (mode, waits) per
    stream epoch."""
    import torch

    log, n = [], [0]
    run, wait = tr._run_epoch_stream, tr._host_wait

    def counted_wait(event):
        log[-1][1] += 1
        mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode(0)
        try:
            wait(event)
        finally:
            torch.cuda.set_sync_debug_mode(mode)

    def guarded_run(mode, *args):
        n[0] += 1
        log.append([mode, 0])
        on = n[0] in guarded
        if on:
            torch.cuda.set_sync_debug_mode("error")
        try:
            return run(mode, *args)
        finally:
            if on:
                torch.cuda.set_sync_debug_mode(0)

    tr._host_wait = counted_wait
    tr._run_epoch_stream = guarded_run
    return log


def _stream_against_scan(dev, label, cfg, data, stream_kw, scan_kw, out_dir,
                         guarded, card):
    """Train ``cfg`` on the stream executor (``stream_kw``) and on the scan
    executor (``scan_kw``) from the same init: the epochs equal bit for
    bit (losses, weights, Adam's state, launches), at most two chunks
    resident, one pacing wait a chunk after the first and no other host
    sync inside a guarded epoch. Returns (launches, stream trainer, the
    per-run seconds and peak bytes)."""
    import contextlib

    import torch

    from mpgcn_tpu_torch.train.trainer import ModelTrainer

    runs = {}
    for name, kw in (("scan", scan_kw), ("stream", stream_kw)):
        d = os.path.join(out_dir, f"{label}_{name}")
        os.makedirs(d)
        tr = ModelTrainer(cfg.replace(output_dir=d, **kw), data, device=dev)
        if name == "stream":
            tr.model.load_state_dict(runs["scan"]["init"])
            waits = _guard_stream(tr, guarded)
        log = _record_epochs(tr)
        init = {n: p.detach().clone() for n, p in
                tr.model.state_dict().items()}
        tee = _Tee(sys.stdout)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(tee):
            hist = tr.train()
        secs = time.perf_counter() - t0
        line = next(l for l in "".join(tee.lines).splitlines()
                    if l.startswith("[dispatch] epoch_exec:"))
        # what the run adds over what was resident before it (the scan
        # trainer stays resident through the stream run)
        runs[name] = dict(tr=tr, log=log, hist=hist, line=line, secs=secs,
                          init=init,
                          peak=torch.cuda.max_memory_allocated() - base)
    s, c = runs["stream"], runs["scan"]
    require(s["line"].startswith("[dispatch] epoch_exec: train=stream(")
            and "validate=stream(" in s["line"],
            f"[city-feed] {label} stream dispatch: {s['line']}")
    require(c["line"].startswith("[dispatch] epoch_exec: train=scan"),
            f"[city-feed] {label} scan dispatch: {c['line']}")
    require(s["hist"] == c["hist"],
            f"[city-feed] {label}: epoch losses {s['hist']} on the stream "
            f"executor, {c['hist']} on the scan executor")
    total = {}
    for es, ec in zip(s["log"], c["log"]):
        _require_same_state(es["state"], ec["state"],
                            f"[city-feed] {label} {es['mode']}")
        require(es["counts"] == ec["counts"],
                f"[city-feed] {label} {es['mode']}: launches "
                f"{_nz(es['counts'])} / {_nz(ec['counts'])}")
        total = _add(total, es["counts"])
    stats = s["tr"]._stream_stats
    for mode, st in stats.items():
        require(st["max_resident_chunks"] <= 2,
                f"[city-feed] {label} {mode}: {st}")
    plan = {m: s["tr"]._stream_plan(m) for m in ("train", "validate")}
    want = [[m, plan[m][0] - 1] for _ in range(cfg.num_epochs)
            for m in ("train", "validate")]
    require(waits == want, f"[city-feed] {label}: pacing waits {waits}, "
                           f"expected {want}")
    print(f"[city-feed] (b) {label}: {s['line']}; one epoch on the stream "
          f"executor equals the scan executor bit for bit (losses "
          f"{s['hist']}, weights, Adam's state, launches); host waits per "
          f"epoch {waits} (+ the one read of the losses), no other sync "
          f"in the guarded epochs {sorted(guarded)}; last epoch's counters "
          f"{json.dumps(stats)}", flush=True)
    print(f"[time] city-feed (b) {label}: epoch seconds stream "
          f"{[round(e['s'], 4) for e in s['log']]}, scan "
          f"{[round(e['s'], 4) for e in c['log']]} (train, validate per "
          f"epoch); train() {s['secs']:.3f} / {c['secs']:.3f} s; peak "
          f"device bytes a run adds over what was resident before it: "
          f"stream {s['peak'] / 1e9:.3f} GB, scan {c['peak'] / 1e9:.3f} GB "
          f"({card})", flush=True)
    return total, s["tr"]


def city_stream(dev, cfg, data, cfg_l, data_l, out_dir, card):
    """(b) The stream executor: N=500 (ELL arm, eager) on sparse host
    storage with the native host kernels, chunks of 64 MB, against the
    scan executor on dense storage; N=47 (the dense kernel arm, steps
    replayed from CUDA graphs) against the scan executor, two epochs.
    Returns the launches."""
    from mpgcn_tpu_torch.native import host

    lcfg = cfg_l.replace(pred_len=1, num_epochs=1)
    stream_kw = dict(od_storage="sparse", native_host="auto",
                     epoch_scan_max_mb=0.0, stream_chunk_mb=64.0)
    total, tr = _stream_against_scan(dev, "N=500", lcfg, data_l, stream_kw,
                                     dict(od_storage="dense"), out_dir,
                                     {1, 2}, card)
    require(tr._graphs is None and tr.pipeline.od_storage == "sparse",
            "N=500 stream run: expected the uncaptured ELL arm on sparse "
            "storage")
    require(tr._stream_plan("train")[0] >= 3,
            f"N=500: {tr._stream_plan('train')} chunks x steps")
    require(host.available(), f"the host library did not build: "
                              f"{host.unavailable_reason()}")
    dense = data_l["OD"].nbytes
    sparse = tr.pipeline.od_series.nbytes
    print(f"[city-feed] (b) N=500 host series: sparse {sparse / 1e6:.3f} MB "
          f"against dense {dense / 1e6:.3f} MB ({dense / sparse:.1f}x); "
          f"{tr.pipeline.dispatch_line('kernel')}", flush=True)
    # N=47: about 1 MB chunks (3 steps of x + y at batch 4)
    ncfg = cfg.replace(pred_len=1, num_epochs=2)
    t47, tr47 = _stream_against_scan(
        dev, "N=47", ncfg, data, dict(epoch_scan_max_mb=0.0,
                                      stream_chunk_mb=1.0),
        {}, out_dir, {3, 4}, card)
    require(tr47._graphs is not None
            and tr47._graphs.get("train-stream") is not None
            and tr47._graphs.get("validate-stream") is not None,
            "N=47 stream steps were not replayed from CUDA graphs")
    return _add(total, t47)


def city_csr(dev, cfg_l, data_l, out_dir, card):
    """(c) The csr arm at N=500: one training epoch (its steps captured as
    CUDA graphs), a bucket-2 ServeEngine batch, both held against the ELL
    arm from the same weights to 1e-4; step and rollout times beside the
    ELL arm's (the 'auto' crossover). Returns the launches."""
    import statistics

    import torch

    from mpgcn_tpu_torch.config import ServeConfig
    from mpgcn_tpu_torch.service.serve import ServeEngine
    from mpgcn_tpu_torch.train.predict import graphs_for
    from mpgcn_tpu_torch.train.trainer import ModelTrainer

    tcfg = cfg_l.replace(pred_len=1, num_epochs=1,
                         output_dir=os.path.join(out_dir, "csr"))
    os.makedirs(tcfg.output_dir)
    csr = ModelTrainer(tcfg, data_l, device=dev, bdgcn_impl="csr")
    ell = ModelTrainer(tcfg.replace(output_dir=os.path.join(out_dir, "ell")),
                       data_l, device=dev)
    ell.model.load_state_dict(csr.model.state_dict())
    batches = list(csr.pipeline.batches("train", pad_to_full=True))[:3]
    x, _, keys = csr._tensors(batches[0])
    with torch.no_grad():
        a = csr.model(x, graphs_for(csr.banks, keys, csr.model.sources))
        b = ell.model(x, graphs_for(ell.banks, keys, ell.model.sources))
    compare("[city-feed] (c) N=500 csr forward vs ell", a, b, ROLLOUT_TOL)
    reset_counts()
    t0 = time.perf_counter()
    hist = csr.train()
    counts = read_counts()
    train_s = time.perf_counter() - t0
    require(all(np.isfinite(hist["train"] + hist["validate"])),
            f"csr epoch losses {hist}")
    steps = csr.pipeline.num_batches("train")
    evals = csr.pipeline.num_batches("validate")
    want = _add(_scaled(_per_step(tcfg, True, "csr"), steps),
                _scaled(_per_step(tcfg, False, "csr"), evals))
    require(counts == want, f"csr epoch launched {_nz(counts)}, expected "
                            f"{_nz(want)}")
    ell.model.load_state_dict(csr.model.state_dict())
    require(csr._graphs is not None, f"csr steps uncaptured: "
                                     f"{csr.graph_refusal}")
    print(f"[city-feed] (c) N=500 csr arm: one epoch ({steps} steps, steps "
          f"by graph) in {train_s:.2f}s, losses "
          f"{hist}; launches {_nz(counts)}", flush=True)
    # serve bucket 2 from the trained weights on both arms
    preds = {}
    scfg = ServeConfig(buckets=(2,), max_wait_ms=100.0, deadline_ms=0.0,
                       output_dir=os.path.join(out_dir, "serve"))
    for impl in ("csr", "ell"):
        eng = ServeEngine(cfg_l.replace(pred_len=7), data_l, scfg,
                          device=dev, bdgcn_impl=impl,
                          init_ckpt=os.path.join(tcfg.output_dir,
                                                 "MPGCN_od.pkl"))
        md = eng.pipeline.modes["test"]
        tickets = [eng.submit(md.x[j, ..., 0], int(md.keys[j]))
                   for j in range(2)]
        for t in tickets:
            require(t.wait(300) and t.ok, f"{impl} request: {t.outcome}")
        preds[impl] = torch.from_numpy(np.stack([t.pred for t in tickets]))
        eng.drain()
        eng.close()
    require(bool(torch.isfinite(preds["csr"]).all())
            and float((preds["csr"] != 0).float().mean()) > 0.1,
            "csr served predictions dead or non-finite")
    compare("[city-feed] (c) N=500 bucket-2 served rollout, csr vs ell",
            preds["csr"], preds["ell"], ROLLOUT_TOL)
    # times: the step and the bucket-2 rollout, csr against ell
    md = csr.pipeline.modes["test"]
    xs, ks = np.array(md.x[:2]), md.keys[:2]
    step = {"csr": [], "ell": []}
    roll = {"csr": [], "ell": []}
    for name, tr in (("csr", csr), ("ell", ell)) * 2:
        step[name] += _step_ms(tr, batches, 2, 1)
        roll[name].append(_host_ms(lambda: tr.predict(xs, ks, 7), n=2,
                                   warmup=1)[0])
    med = {n: statistics.median(v) for n, v in step.items()}
    rmed = {n: statistics.median(v) for n, v in roll.items()}
    how = "by graph" if csr._graphs is not None else "eager"
    print(f"[time] city-feed (c) N=500 train step (host clock, medians of "
          f"4 in two alternated rounds) csr {med['csr']:.3f} ms ({how}), "
          f"ell {med['ell']:.3f} ms (eager): csr/ell "
          f"{med['csr'] / med['ell']:.3f}x; bucket-2 rollout (7 steps) csr "
          f"{rmed['csr']:.3f} ms ({how}), ell {rmed['ell']:.3f} ms "
          f"(eager): {rmed['csr'] / rmed['ell']:.3f}x ({card})", flush=True)
    return counts


def city_native(dev, cfg_l, data_l, card):
    """(d) The native host gather against numpy at the N=500 batch (2
    windows) and chunk (4 steps x 2) gathers: equal bytes, and both
    times."""
    from mpgcn_tpu_torch.data.pipeline import DataPipeline

    # dense banks: the gathers do not need the ELL packing
    pipes = {n: DataPipeline(cfg_l.replace(pred_len=1, native_host=n),
                             data_l, dev, bdgcn_impl="kernel")
             for n in ("auto", "off")}
    require(pipes["auto"].host_gather == "native",
            f"-native auto did not take the host library: "
            f"{pipes['auto'].dispatch_line('kernel')}")
    rng = np.random.default_rng(19)
    n = len(pipes["auto"].modes["train"])
    parts = []
    for label, size in (("batch", 2), ("chunk", 8)):
        sel = rng.permutation(n)[:size]
        outs, ms = {}, {}
        for name, pipe in pipes.items():
            outs[name] = pipe.gather_xy("train", sel)
            samples = []
            for _ in range(10):
                t0 = time.perf_counter()
                pipe.gather_xy("train", sel)
                samples.append((time.perf_counter() - t0) * 1e3)
            ms[name] = sorted(samples)[len(samples) // 2]
        for a, b in zip(outs["auto"], outs["off"]):
            require(a.tobytes() == b.tobytes(),
                    f"[city-feed] native {label} gather differs from numpy")
        mb = sum(a.nbytes for a in outs["auto"]) / 1e6
        parts.append(f"{label} ({size} windows, {mb:.1f} MB) native "
                     f"{ms['auto']:.3f} ms, numpy {ms['off']:.3f} ms")
    print(f"[city-feed] (d) the native gather equals numpy byte for byte; "
          f"host medians of 10: {'; '.join(parts)} ({card})", flush=True)


def phase_city_feed(dev, cfg, data, cfg_l, data_l, out_dir, card):
    """Phase 15, [city-feed]: the city-scale feed at N=500 (and N=47 for
    the graphs), (a)-(d). Returns the launches of its main paths."""
    import torch

    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    total = city_fused(dev, cfg_l, data_l, card)
    torch.cuda.empty_cache()
    total = _add(total, city_stream(dev, cfg, data, cfg_l, data_l, out_dir,
                                    card))
    torch.cuda.empty_cache()
    total = _add(total, city_csr(dev, cfg_l, data_l, out_dir, card))
    torch.cuda.empty_cache()
    city_native(dev, cfg_l, data_l, card)
    print(f"[city-feed] phase took {time.perf_counter() - t0:.1f}s ({card})",
          flush=True)
    return total


# --- phase 16: the serving plane over HTTP -----------------------------------

#: the rollout graphs a phase-16 engine captures: 2 parameter slots x
#: buckets (1, 2, 4, 8) x horizon 7
SERVE_GRAPHS = 8


def _serve_front(eng, make_handler=None):
    """The HTTP front of ``eng`` (serve's, or ``make_handler``'s) on
    127.0.0.1, an ephemeral port."""
    from http.server import ThreadingHTTPServer

    from mpgcn_tpu_torch.service.serve import _make_handler

    class _Server(ThreadingHTTPServer):
        daemon_threads = True

    httpd = _Server(("127.0.0.1", 0), (make_handler or _make_handler)(eng))
    threading.Thread(target=httpd.serve_forever, daemon=True,
                     name="smoke-http").start()
    return httpd


class _GCPauses:
    """Counts the interpreter's garbage collections and their pauses
    while it is entered (``gc.callbacks``): a full collection walks every
    object the process holds, and this process holds every phase's."""

    def __enter__(self):
        import gc

        self.pauses, self._t0 = [], None

        def cb(phase, info):
            if phase == "start":
                self._t0 = time.perf_counter()
            elif self._t0 is not None:
                self.pauses.append((info["generation"],
                                    (time.perf_counter() - self._t0) * 1e3))
                self._t0 = None

        self._cb = cb
        gc.callbacks.append(cb)
        return self

    def __exit__(self, *exc):
        import gc

        gc.callbacks.remove(self._cb)

    def line(self) -> str:
        full = [ms for g, ms in self.pauses if g == 2]
        return (f"{len(self.pauses)} collections ({len(full)} full), "
                f"longest pause "
                f"{max((ms for _, ms in self.pauses), default=0.0):.1f} ms")


def _http_load(port, bodies, clients, per_client):
    """``clients`` threads, each with one keep-alive connection, send
    ``per_client`` requests in turn (window (c * per_client + j) mod
    len(bodies)); each answer is read as bytes inside the timed loop and
    parsed after it, so the generator's own JSON decoding does not hold
    the interpreter while the server runs. Returns [(window, status,
    payload, round-trip ms)] and the wall seconds."""
    import http.client

    results = [None] * (clients * per_client)
    errors = []

    def client(c):
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
        try:
            for j in range(per_client):
                i = c * per_client + j
                w = i % len(bodies)
                t0 = time.perf_counter()
                conn.request("POST", "/v1/predict", body=bodies[w],
                             headers={"Content-Type": "application/json"})
                r = conn.getresponse()
                data = r.read()
                results[i] = (w, r.status, data,
                              (time.perf_counter() - t0) * 1e3)
        except Exception as e:  # reported below, after the join
            errors.append(f"client {c}: {type(e).__name__}: {e}")
        finally:
            conn.close()

    threads = [threading.Thread(target=client, args=(c,))
               for c in range(clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    require(not errors, f"load generator failed: {errors[:3]}")
    return [(w, st, json.loads(raw), ms) for w, st, raw, ms in results], wall


def _pct(values):
    v = sorted(values)
    return v[len(v) // 2], v[min(len(v) - 1, int(len(v) * 0.99))]


def _serve_one_by_one(eng, md, windows):
    out = []
    for w in windows:
        t = eng.submit(md.x[w, ..., 0], int(md.keys[w]), deadline_ms=0)
        require(t.wait(120) and t.ok, f"request {w}: {t.outcome} "
                                      f"{t.error}")
        out.append((t.pred, t.canary))
    return out


def serve_http_load(dev, cfg, data, promote, incumbent, out_dir, card):
    """(a) 64 requests over HTTP a run, from C = 1, 4 and 16 clients, the
    feed double buffered and not. Returns the launches."""
    import torch

    from mpgcn_tpu_torch.config import ServeConfig
    from mpgcn_tpu_torch.obs.trace import spans_path
    from mpgcn_tpu_torch.service.serve import ServeEngine
    from mpgcn_tpu_torch.train.predict import rollout
    from mpgcn_tpu_torch.utils.logging import read_events

    total, bodies, refs = {}, None, None
    for db in (True, False):
        svc = os.path.join(out_dir, f"load_db{int(db)}")
        promote(svc, incumbent)
        eng = ServeEngine(cfg, data, ServeConfig(
            output_dir=svc, buckets=(1, 2, 4, 8), max_wait_ms=2.0,
            deadline_ms=0.0, max_queue=256, reload_poll_secs=0.0,
            double_buffer=db), device=dev)
        httpd = _serve_front(eng)
        try:
            require((eng.batchers[7].stage_fn is not None)
                    == (db and dev.type == "cuda"),
                    "the staged upload is on exactly with double_buffer")
            md = eng.pipeline.modes["test"]
            if bodies is None:
                n = min(len(md), 64)
                bodies = [json.dumps({"x": md.x[w, ..., 0].tolist(),
                                      "key": int(md.keys[w])}).encode()
                          for w in range(n)]
                # each window's eager rollout alone, on the card
                refs = [rollout(eng.model, eng.banks,
                                torch.from_numpy(np.array(md.x[w:w + 1]))
                                .to(dev),
                                torch.tensor([int(md.keys[w])],
                                             device=dev), 7)[0].cpu().numpy()
                        for w in range(n)]
            print(f"[serve-http] (a) engine double_buffer={db}: "
                  f"{eng.stats()['traces']} rollout graphs (2 slots x 4 "
                  f"buckets), second slot adds "
                  f"{json.dumps(eng.stats()['second_slot_bytes'])} bytes",
                  flush=True)
            for clients in (1, 4, 16):
                st0 = eng.stats()
                with eng._lock:  # this run's latency window only
                    eng._lat_ms.clear()
                    for d in eng._lat_by_h.values():
                        d.clear()
                reset_counts()
                t_wall = time.time()
                with _GCPauses() as gcp:
                    res, wall = _http_load(httpd.server_address[1], bodies,
                                           clients, 64 // clients)
                total = _add(total, read_counts())
                st = eng.stats()
                spans = [r for r in read_events(spans_path(svc), "span")
                         if r["t0"] >= t_wall - 1e-3]
                queue = _pct([r["dur_ms"] for r in spans
                              if r["name"] == "serve.batcher"])
                model = _pct([r["dur_ms"] for r in spans
                              if r["name"] == "serve.model"])
                bad = [(w, s, p.get("outcome")) for w, s, p, _ in res
                       if s != 200 or p.get("outcome") != "ok"]
                require(not bad, f"answers not ok: {bad[:4]}")
                err = max(float(np.max(np.abs(np.asarray(p["pred"])
                                              - refs[w])))
                          for w, _, p, _ in res)
                require(all(np.allclose(np.asarray(p["pred"]), refs[w],
                                        rtol=1e-5, atol=1e-5)
                            for w, _, p, _ in res),
                        f"an answer differs from its window's eager "
                        f"rollout (max abs {err:.3e})")
                require(st["traces"] == st0["traces"] == SERVE_GRAPHS,
                        f"graphs {st0['traces']} -> {st['traces']}")
                rt50, rt99 = _pct([r[3] for r in res])
                live = st["pad_waste"]["live"] - st0["pad_waste"]["live"]
                padded = (st["pad_waste"]["padded"]
                          - st0["pad_waste"]["padded"])
                n_req = len(res)
                print(f"[serve-http] (a) C={clients} double_buffer={db}: "
                      f"{n_req} requests in {wall:.3f}s = "
                      f"{n_req / wall:.1f} req/s; HTTP round trip p50 "
                      f"{rt50:.3f} ms p99 {rt99:.3f} ms; engine (/v1/stats)"
                      f" p50 {st['latency_ms']['p50']:.3f} ms p99 "
                      f"{st['latency_ms']['p99']:.3f} ms; "
                      f"spans p50/p99: queue {queue[0]:.3f}/{queue[1]:.3f} "
                      f"ms, model {model[0]:.3f}/{model[1]:.3f} ms; "
                      f"{st['batches'] - st0['batches']} batches, pad waste "
                      f"{(padded - live) / padded:.4f}; GC {gcp.line()}; "
                      f"max abs error {err:.3e} vs the eager rollout "
                      f"alone; traces {st0['traces']} -> {st['traces']} "
                      f"({card})", flush=True)
        finally:
            httpd.shutdown()
            httpd.server_close()
            eng.drain()
            eng.close()
    return total, bodies


def serve_http_reload(dev, cfg, data, promote, incumbent, train_dir,
                      out_dir, card):
    """(b) canary then promotion of the model trained one epoch more; a
    poisoned reload and a canary rollback. Returns the launches."""
    import torch

    from mpgcn_tpu_torch.config import ServeConfig
    from mpgcn_tpu_torch.resilience.faults import FaultPlan
    from mpgcn_tpu_torch.service.reload import CanaryReloader
    from mpgcn_tpu_torch.service.serve import ServeEngine, reloads_ledger_path
    from mpgcn_tpu_torch.train.trainer import ModelTrainer
    from mpgcn_tpu_torch.utils.convert import read_checkpoint
    from mpgcn_tpu_torch.utils.logging import read_events

    # the candidate: the train phase's run resumed for one more epoch
    cand_dir = os.path.join(out_dir, "candidate")
    shutil.copytree(train_dir, cand_dir)
    tr = ModelTrainer(cfg.replace(pred_len=1, num_epochs=4,
                                  output_dir=cand_dir), data, device=dev)
    tr.train(resume=True)
    cand = os.path.join(cand_dir, "MPGCN_od_last.pkl")
    require(read_checkpoint(cand)["epoch"] == 4,
            "the candidate is not the 4th epoch's weights")
    del tr

    base = dict(buckets=(1, 2, 4, 8), max_wait_ms=2.0, deadline_ms=0.0,
                max_queue=256)
    total = {}
    svc = os.path.join(out_dir, "reload")
    promote(svc, incumbent)
    scfg = ServeConfig(output_dir=svc, reload_poll_secs=0.05,
                       canary_fraction=0.25, canary_requests=16,
                       reload_tolerance=1.0, **base)
    eng = ServeEngine(cfg, data, scfg, device=dev)
    ref = ServeEngine(cfg, data, ServeConfig(
        output_dir=os.path.join(out_dir, "reload_ref"), reload_poll_secs=0,
        **base), device=dev, init_ckpt=cand)
    place_ms = []
    place = eng._place

    def timed_place(tree):
        t0 = time.perf_counter()
        slot = place(tree)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        place_ms.append((time.perf_counter() - t0) * 1e3)
        return slot

    eng._place = timed_place
    rel = CanaryReloader(eng, scfg)
    try:
        md = eng.pipeline.modes["test"]
        n0 = eng.stats()["traces"]
        reset_counts()
        before = _serve_one_by_one(eng, md, range(4))
        rel.start()
        t_write = time.perf_counter()
        h = promote(svc, cand)
        while eng.canary_hash != h:
            require(time.perf_counter() - t_write < 60,
                    "the reloader never started the canary")
            time.sleep(0.005)
        t_canary = time.perf_counter()
        flags, w = [], 0
        while eng.incumbent_hash != h:
            require(len(flags) < 400, "the canary never promoted")
            flags += [c for _, c in _serve_one_by_one(
                eng, md, [w % len(md)])]
            w += 1
        t_promoted = time.perf_counter()
        rel.stop()
        events = [e["event"] for e in read_events(reloads_ledger_path(svc))]
        require(events == ["reload_canary", "reload_promoted"],
                f"reload ledger {events}")
        share = sum(flags) / len(flags)
        require(abs(share - 0.25) < 0.05 and sum(flags) == 16,
                f"canary batches {sum(flags)} of {len(flags)}")
        require(eng.stats()["traces"] == n0 == SERVE_GRAPHS,
                f"graphs {n0} -> {eng.stats()['traces']}")
        after = _serve_one_by_one(eng, md, range(8))
        want = _serve_one_by_one(ref, md, range(8))
        require(all(np.array_equal(a, b) for (a, _), (b, _) in
                    zip(after, want)),
                "after promotion the answers differ from an engine "
                "started on the candidate")
        require(not np.array_equal(after[0][0], before[0][0]),
                "the promoted weights answer as the incumbent did")
        total = _add(total, read_counts())
        print(f"[serve-http] (b) hot reload: canary-started then promoted "
              f"({events}); {sum(flags)} of {len(flags)} batches on the "
              f"canary ({share:.3f}); slot written -> canary "
              f"{(t_canary - t_write) * 1e3:.1f} ms -> promoted "
              f"{(t_promoted - t_canary) * 1e3:.1f} ms (poll every 50 ms, "
              f"{len(flags)} one-request batches); in-place weight copy "
              f"into the idle slot {', '.join(f'{m:.3f}' for m in place_ms)}"
              f" ms; answers after promotion bit for bit those of an engine"
              f" started on the candidate; traces {n0} -> "
              f"{eng.stats()['traces']} ({card})", flush=True)
    finally:
        rel.stop()
        eng.drain()
        eng.close()
        ref.drain()
        ref.close()

    # a poisoned reload, then a canary that goes non-finite on live traffic
    svc = os.path.join(out_dir, "poison")
    promote(svc, incumbent)
    faults = FaultPlan.parse("poison_reload=1")
    eng = ServeEngine(cfg, data, ServeConfig(output_dir=svc,
                                             reload_poll_secs=0, **base),
                      device=dev, faults=faults)
    try:
        md = eng.pipeline.modes["test"]
        n0 = eng.stats()["traces"]
        reset_counts()
        before = _serve_one_by_one(eng, md, range(4))
        promote(svc, cand)
        action = CanaryReloader(eng, eng.scfg, faults=faults).poll()
        require(action == "rejected-smoke", f"poisoned reload: {action}")
        after = _serve_one_by_one(eng, md, range(4))
        require(all(np.array_equal(a, b) for (a, _), (b, _) in
                    zip(before, after)),
                "the incumbent's answers moved across a rejected reload")
        eng.install_canary(eng._place(read_checkpoint(cand)["params"]),
                           "nan-canary", 99)
        with torch.no_grad():
            for p in eng._models[eng._canary.slot].parameters():
                p.fill_(float("nan"))
        # canary_fraction 0.25: one batch in four is the canary's
        again = []
        while eng.canary_hash is not None:
            require(len(again) < 8, "the canary never took a batch")
            again += _serve_one_by_one(eng, md, [len(again) % 4])
        require(eng.stats()["reloads"]["rolled_back"] == 2,
                f"no rollback: {eng.stats()['reloads']}")
        require(all(np.array_equal(a, before[i % 4][0]) and not c
                    for i, (a, c) in enumerate(again)),
                "a batch the failed canary took was not served again on "
                "the incumbent bit for bit")
        require(eng.stats()["traces"] == n0 == SERVE_GRAPHS,
                f"graphs {n0} -> {eng.stats()['traces']}")
        total = _add(total, read_counts())
        print(f"[serve-http] (b) poison_reload=1: {action}, the "
              f"incumbent's answers bit-identical before and after; a "
              f"canary gone non-finite on live traffic rolled back, its "
              f"batch served again on the incumbent bit for bit; traces "
              f"{n0} -> {eng.stats()['traces']} ({card})", flush=True)
    finally:
        eng.drain()
        eng.close()
    return total


def serve_http_command(dev, cfg, promote, incumbent, bodies, out_dir,
                       card):
    """(c) the serve command as a subprocess: a flood of 200, typed
    outcomes, /metrics, SIGTERM -> exit 0 and a postmortem."""
    import urllib.request

    from mpgcn_tpu_torch.service.batcher import OK, SHED_OUTCOMES
    from mpgcn_tpu_torch.service.serve import (
        http_info_path,
        requests_ledger_path,
    )
    from mpgcn_tpu_torch.utils.logging import read_events

    svc = os.path.join(out_dir, "command")
    promote(svc, incumbent)
    argv = [sys.executable, "-m", "mpgcn_tpu_torch.cli", "serve",
            "--device", dev.type, "-out", svc, "-pred", str(cfg.pred_len), "-hidden",
            str(cfg.hidden_dim), "-M", str(cfg.num_branches), "-K",
            str(cfg.cheby_order), "-seed", "0", "-sN",
            str(cfg.synthetic_N), "-sT", str(cfg.synthetic_T),
            "--buckets", "1,2,4,8", "--max-queue", "64", "-faults",
            "flood_qps=200", "--reload-poll-secs", "0.5"]
    env = dict(os.environ, PYTHONPATH=HERE)
    env.pop("MPGCN_FAULTS", None)
    log_out = open(os.path.join(out_dir, "command.stdout"), "w")
    log_err = open(os.path.join(out_dir, "command.stderr"), "w")
    t0 = time.perf_counter()
    proc = subprocess.Popen(argv, cwd=HERE, env=env, stdout=log_out,
                            stderr=log_err)
    try:
        info = http_info_path(svc)
        while not os.path.exists(info):
            require(proc.poll() is None, f"serve exited {proc.returncode}")
            require(time.perf_counter() - t0 < 300, "serve never came up")
            time.sleep(0.1)
        up_s = time.perf_counter() - t0
        with open(info) as f:
            port = json.load(f)["port"]
        res, wall = _http_load(port, bodies, 4, 16)
        outcomes = {}
        for _, status, p, _ in res:
            outcomes[p["outcome"]] = outcomes.get(p["outcome"], 0) + 1
            require(p["outcome"] == OK or p["outcome"] in SHED_OUTCOMES,
                    f"untyped outcome {status} {p}")
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                    timeout=60) as r:
            text = r.read().decode()
        for fam in ("mpgcn_serve_requests_total", "mpgcn_slo_state",
                    "mpgcn_slo_burn_rate", "mpgcn_cuda_program_builds"):
            require(fam in text, f"/metrics lacks {fam}")
        proc.send_signal(15)  # SIGTERM
        rc = proc.wait(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        log_out.close()
        log_err.close()
    with open(os.path.join(out_dir, "command.stdout")) as f:
        stdout = f.read()
    require(rc == 0, f"serve exited {rc} on SIGTERM")
    require("drained (clean)" in stdout, "serve did not drain clean")
    require(os.path.exists(os.path.join(svc, "serve",
                                        "flight_recorder.json")),
            "no postmortem beside the ledgers")
    rows = [r for r in read_events(requests_ledger_path(svc), "request")]
    ledger = {}
    for r in rows:
        ledger[r["outcome"]] = ledger.get(r["outcome"], 0) + 1
    require(set(ledger) <= {OK} | set(SHED_OUTCOMES),
            f"untyped ledger outcomes {ledger}")
    print(f"[serve-http] (c) the serve command (flood_qps=200, max queue "
          f"64): up in {up_s:.1f}s; 64 HTTP requests from 4 clients "
          f"{outcomes} in {wall:.3f}s; ledger outcomes {ledger}; /metrics "
          f"carries serve_requests and the slo_ families; SIGTERM -> exit "
          f"0, drained (clean), flight_recorder.json beside the ledgers "
          f"({card})", flush=True)


def phase_serve_http(dev, cfg, data, train_dir, out_dir, card):
    """Phase 16 (module docstring). Returns the launches of (a) and
    (b)."""
    from mpgcn_tpu_torch.service.promote import (
        candidate_hash,
        ledger_path,
        promote_checkpoint,
        promoted_path,
    )
    from mpgcn_tpu_torch.utils.logging import JsonlLogger

    incumbent = os.path.join(train_dir, "MPGCN_od.pkl")
    require(os.path.exists(incumbent), f"no train checkpoint {incumbent}")
    attempts = {}

    def promote(svc, path):
        """Install ``path`` into ``svc``'s slot with its ledger row."""
        slot = promoted_path(svc)
        promote_checkpoint(path, slot)
        attempts[svc] = attempts.get(svc, 0) + 1
        led = ledger_path(svc)
        os.makedirs(os.path.dirname(led), exist_ok=True)
        h = candidate_hash(slot)
        JsonlLogger(led).log("gate", attempt=attempts[svc], promoted=True,
                             candidate_hash=h)
        return h

    t0 = time.perf_counter()
    total, bodies = serve_http_load(dev, cfg, data, promote, incumbent,
                                    out_dir, card)
    total = _add(total, serve_http_reload(dev, cfg, data, promote,
                                          incumbent, train_dir, out_dir,
                                          card))
    serve_http_command(dev, cfg, promote, incumbent, bodies, out_dir, card)
    print(f"[serve-http] phase 16 took {time.perf_counter() - t0:.1f}s; "
          f"launches {_nz(total)}", flush=True)
    return total


# --- phase 17: the in-process multi-tenant fleet ------------------------------

FLEET_TENANTS = ("a", "b", "c", "d")


def _map_tree(tree, fn):
    if isinstance(tree, dict):
        return {k: _map_tree(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_tree(v, fn) for v in tree)
    return fn(tree)


def _perturbed_ckpt(src, dst, seed, scale=0.01):
    """``src``'s weights times (1 + scale * N(0, 1)) from ``seed``, written
    by the port's save (manifest and integrity records)."""
    from mpgcn_tpu_torch.train.checkpoint import (
        checkpoint_payload,
        load_checkpoint,
        write_checkpoint,
    )

    ckpt = load_checkpoint(src)
    rng = np.random.default_rng(seed)
    params = _map_tree(ckpt["params"], lambda a: (np.asarray(a) * (
        1 + scale * rng.standard_normal(np.shape(a)))).astype(np.float32))
    write_checkpoint(dst, checkpoint_payload(params, ckpt["epoch"],
                                             ckpt.get("extra"), None, "gpu"))
    return dst


def _fleet_promote(root, tid, path, attempt):
    """Install ``path`` into tenant ``tid``'s slot with its ledger row."""
    from mpgcn_tpu_torch.service.promote import (
        candidate_hash,
        ledger_path,
        promote_checkpoint,
        promoted_path,
    )
    from mpgcn_tpu_torch.service.registry import TenantRegistry
    from mpgcn_tpu_torch.utils.logging import JsonlLogger

    troot = TenantRegistry.load(root).tenant_root(tid)
    slot = promoted_path(troot)
    promote_checkpoint(path, slot)
    JsonlLogger(ledger_path(troot)).log("gate", attempt=attempt,
                                        promoted=True,
                                        candidate_hash=candidate_hash(slot))


def _fleet_ask(eng, tid, md, windows):
    """Answers of ``tid`` for test ``windows``, one request at a time."""
    out = []
    for w in windows:
        t = eng.submit(tid, md.x[w, ..., 0], int(md.keys[w]), deadline_ms=0)
        require(t.wait(120), f"tenant {tid} request {w} not answered")
        out.append(t)
    return out


def _same_preds(a, b) -> bool:
    return all(np.array_equal(x, y) for x, y in zip(a, b))


def fleet_references(dev, cfg, data, ckpts, windows):
    """Each checkpoint served alone by a ServeEngine: its answers for
    ``windows`` one by one (bucket 1), and for a batch of them against the
    plain arms in float64. Returns ({tenant: [pred]}, the test split)."""
    import torch

    from mpgcn_tpu_torch.config import ServeConfig
    from mpgcn_tpu_torch.nn.mpgcn import MPGCN
    from mpgcn_tpu_torch.service.serve import ServeEngine
    from mpgcn_tpu_torch.train.predict import rollout

    refs, md = {}, None
    for tid, path in ckpts.items():
        eng = ServeEngine(cfg, data, ServeConfig(
            output_dir=os.path.join(HERE, "smoke_out", "fleet", "ref", tid),
            buckets=(1, 2, 4, 8), deadline_ms=0.0, reload_poll_secs=0.0),
            device=dev, init_ckpt=path)
        try:
            md = eng.pipeline.modes["test"]
            refs[tid] = [p for p, _ in _serve_one_by_one(eng, md, windows)]
            plain = MPGCN.from_config(eng.cfg, device=dev, lstm_impl="plain",
                                      bdgcn_impl="einsum").eval()
            plain.load_state_dict(eng.model.state_dict())
            plain = plain.double()
            banks = {k: v.double() for k, v in dense_banks(eng.banks).items()}
            sel = np.asarray(list(windows))
            x = torch.from_numpy(np.array(md.x[sel])).to(dev)
            k = torch.from_numpy(md.keys[sel].astype(np.int64)).to(dev)
            ref64 = rollout(plain, banks, x.double(), k, 7)
            compare(f"fleet tenant {tid}: its answers vs the float64 plain "
                    f"rollout", torch.from_numpy(np.stack(refs[tid]))
                    .to(dev).double(), ref64, ROLLOUT_TOL)
        finally:
            eng.drain()
            eng.close()
    return refs, md


def fleet_serve_args(cfg, device):
    """``serve --fleet``'s arguments past ``-out`` for phase 17's tenants:
    the reference widths, buckets 1-8, no deadline, no reload polling."""
    return ["--device", device, "-pred", str(cfg.pred_len), "-hidden",
            str(cfg.hidden_dim), "-M", str(cfg.num_branches), "-K",
            str(cfg.cheby_order), "-seed", "0", "-sN", str(cfg.synthetic_N),
            "-sT", str(cfg.synthetic_T), "--buckets", "1,2,4,8",
            "--max-queue", "256", "--deadline-ms", "0",
            "--reload-poll-secs", "0"]


def fleet_command(dev, cfg, root, refs, md, windows, out_dir, card):
    """(a) and (c): ``serve --fleet`` as its own process on the card."""
    from mpgcn_tpu_torch.service.serve import http_info_path

    argv = [sys.executable, "-m", "mpgcn_tpu_torch.cli", "serve", "--fleet",
            "-out", root, *fleet_serve_args(cfg, dev.type)]
    env = dict(os.environ, PYTHONPATH=HERE)
    env.pop("MPGCN_FAULTS", None)
    log_out = open(os.path.join(out_dir, "command.stdout"), "w")
    log_err = open(os.path.join(out_dir, "command.stderr"), "w")
    t0 = time.perf_counter()
    proc = subprocess.Popen(argv, cwd=HERE, env=env, stdout=log_out,
                            stderr=log_err)
    launches = {}
    try:
        info = http_info_path(root)
        while not os.path.exists(info):
            require(proc.poll() is None, f"serve --fleet exited "
                                         f"{proc.returncode}")
            require(time.perf_counter() - t0 < 300, "the fleet never came up")
            time.sleep(0.1)
        up_s = time.perf_counter() - t0
        with open(info) as f:
            base = "http://127.0.0.1:{port}".format(**json.load(f))

        def get(path):
            return _get(base, path)

        def post(body):
            return _post(base, body)

        st0 = json.loads(get("/v1/stats"))
        n_graphs = 4  # buckets 1, 2, 4, 8 at horizon 7
        require(st0["traces"] == n_graphs, f"{st0['traces']} graphs for 4 "
                                           f"tenants, expected {n_graphs}")
        require(sorted(t for t, v in st0["tenants"].items() if v["available"])
                == list(FLEET_TENANTS), f"tenants {st0['tenants'].keys()}")
        # (a) every tenant's answers equal its checkpoint's engine's
        for tid in FLEET_TENANTS:
            preds = []
            for w in windows:
                code, p = post({"x": md.x[w, ..., 0].tolist(),
                                "key": int(md.keys[w]), "tenant": tid})
                require(code == 200 and p["tenant"] == tid,
                        f"tenant {tid}: {code} {p.get('outcome')}")
                preds.append(np.asarray(p["pred"], np.float32))
            err = max(float(np.max(np.abs(a - b)))
                      for a, b in zip(preds, refs[tid]))
            require(err == 0.0, f"tenant {tid}: max abs {err:.3e} against "
                                f"its checkpoint served alone")
        x0 = {"x": md.x[0, ..., 0].tolist(), "key": int(md.keys[0])}
        code, p = post({**x0, "tenant": "tokyo"})
        require(code == 404 and p["outcome"] == "rejected-unknown-tenant",
                f"unknown tenant: {code} {p}")
        code, p = post(x0)
        require(code == 404, f"no tenant field with 4 tenants: {code}")
        st1 = json.loads(get("/v1/stats"))
        batches = st1["batches"] - st0["batches"]
        launches = {k: st1["kernel_launches"][k] - st0["kernel_launches"][k]
                    for k in st1["kernel_launches"]}
        require(launches["lstm_infer_last"] == 14 * batches
                and launches["bdgcn_pair_fwd"] == 42 * batches
                and sum(launches.values()) == 56 * batches,
                f"{launches} for {batches} batches")
        print(f"[fleet] (a) serve --fleet up in {up_s:.1f}s (engine startup "
              f"{st0['startup_s']}s, graphs {st0['traces']} for 4 tenants, "
              f"graph bytes {json.dumps(st0['graph_bytes'])}); each "
              f"tenant's {len(windows)} answers equal its checkpoint "
              f"served alone by ServeEngine (max abs 0); unknown tenant "
              f"404, no tenant field 404; {batches} batches launched "
              f"{_nz(launches)} (14 lstm_infer_last and 42 bdgcn_pair_fwd "
              f"a batch) ({card})", flush=True)
        # (c) requests/s and round trips, 64 requests a run over 4 tenants
        n_win = min(16, len(md))
        bodies = [json.dumps({"x": md.x[i % n_win, ..., 0].tolist(),
                              "key": int(md.keys[i % n_win]),
                              "tenant": FLEET_TENANTS[i % 4]}).encode()
                  for i in range(64)]
        port = int(base.rsplit(":", 1)[1])
        for clients in (1, 4):
            s0 = json.loads(get("/v1/stats"))
            res, wall = _http_load(port, bodies, clients, 64 // clients)
            s1 = json.loads(get("/v1/stats"))
            bad = [(w, st, p.get("outcome")) for w, st, p, _ in res
                   if st != 200 or p.get("outcome") != "ok"]
            require(not bad, f"answers not ok: {bad[:4]}")
            for w, _, p, _ in res:
                tid = FLEET_TENANTS[w % 4]
                require(p["tenant"] == tid, f"request {w} answered by "
                                            f"{p['tenant']}")
            per = {}
            for w, _, p, ms in res:
                per.setdefault(p["tenant"], []).append(ms)
            rt50, rt99 = _pct([r[3] for r in res])
            for k in s1["kernel_launches"]:
                launches[k] += (s1["kernel_launches"][k]
                                - s0["kernel_launches"][k])
            require(s1["traces"] == n_graphs, f"graphs {s1['traces']}")
            print(f"[fleet] (c) C={clients} over 4 tenants: 64 requests in "
                  f"{wall:.3f}s = {64 / wall:.1f} req/s, round trip p50 "
                  f"{rt50:.3f} ms p99 {rt99:.3f} ms; per tenant "
                  + "; ".join(f"{t} {len(v) / wall:.1f} req/s p50 "
                              f"{_pct(v)[0]:.3f} p99 {_pct(v)[1]:.3f} ms"
                              for t, v in sorted(per.items()))
                  + f"; {s1['batches'] - s0['batches']} batches; graphs "
                  f"{s1['traces']} ({card})", flush=True)
        text = get("/metrics")
        for line in ("mpgcn_serve_traces 4", 'mpgcn_serve_breaker_state{'
                     'tenant="a"} 0', "mpgcn_serve_tenant_resident_bytes"):
            require(line in text, f"/metrics lacks {line}")
        proc.send_signal(15)  # SIGTERM
        rc = proc.wait(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        log_out.close()
        log_err.close()
    with open(os.path.join(out_dir, "command.stdout")) as f:
        stdout = f.read()
    require(rc == 0 and "drained (clean)" in stdout,
            f"serve --fleet exited {rc} on SIGTERM")
    return launches


def fleet_blast_radius(dev, cfg, data, ckpts, refs, md, windows, out_dir,
                       card):
    """(b) one fault domain at a time on in-process fleets of the same
    four checkpoints; the per-batch copy, the profiler window and the
    resident bytes. Returns the launches."""
    import torch

    from mpgcn_tpu_torch.config import FleetConfig
    from mpgcn_tpu_torch.nn.mpgcn import MPGCN
    from mpgcn_tpu_torch.resilience.faults import FaultPlan
    from mpgcn_tpu_torch.service.fleet import (
        FleetEngine,
        FleetReloader,
        _flat,
    )
    from mpgcn_tpu_torch.service.registry import TenantRegistry

    root = os.path.join(out_dir, "blast")
    reg = TenantRegistry.load(root)
    for tid in FLEET_TENANTS:
        reg.add(tid, **({"quota": 4} if tid == "c" else {}))
        _fleet_promote(root, tid, ckpts[tid], 1)
    fcfg = FleetConfig(output_dir=root, buckets=(1, 2, 4, 8),
                       deadline_ms=0.0, max_queue=8, reload_poll_secs=0.0,
                       canary_requests=0, reload_tolerance=1.0,
                       breaker_threshold=3, breaker_cooldown_s=0.2)
    cand = _perturbed_ckpt(ckpts["a"], os.path.join(out_dir, "e.pkl"), 3)
    total = {}
    reset_counts()
    eng = FleetEngine(cfg, data, fcfg, reg, device=dev,
                      faults=FaultPlan.parse("poison_reload=1,"
                                             "fault_tenant=1"))
    n_graphs = eng.trace_count
    try:
        def answers():
            return {t: [k.pred for k in _fleet_ask(eng, t, md, windows)]
                    for t in FLEET_TENANTS}

        def require_calm(base, skip, label):
            now = answers()
            for t in FLEET_TENANTS:
                if t in skip:
                    continue
                require(_same_preds(now[t], base[t]),
                        f"{label}: tenant {t}'s answers moved")
                require(eng.tenants[t].breaker.state_name == "closed",
                        f"{label}: tenant {t}'s breaker "
                        f"{eng.tenants[t].breaker.state_name}")
            require(eng.trace_count == n_graphs,
                    f"{label}: graphs {n_graphs} -> {eng.trace_count}")
            return now

        base = answers()
        for t in FLEET_TENANTS:
            require(_same_preds(base[t], refs[t]),
                    f"in-process tenant {t} differs from its engine")
        # poison_reload on tenant b; the same candidate promotes on a
        rel = FleetReloader(eng)
        for t in ("a", "b"):
            _fleet_promote(root, t, cand, 2)
        acts = rel.poll_all()
        require(acts["a"] == "canary-started" and acts["b"] ==
                "rejected-smoke", f"reload actions {acts}")
        now = require_calm(base, {"a"}, "poison_reload on b")
        require(not _same_preds(now["a"], base["a"]), "a did not promote")
        base = now
        # a quota flood on tenant c (quota 4, queue 8)
        flood = [eng.submit("c", md.x[0, ..., 0], int(md.keys[0]))
                 for _ in range(60)]
        for t in flood:
            require(t.wait(120), "a flood request hung")
        shed = {t.outcome for t in flood} - {"ok"}
        require(shed and shed <= {"shed-tenant-quota", "shed-queue-full"},
                f"flood outcomes {shed}")
        stats = eng.stats()["tenants"]
        require(all(stats[t]["quota"]["shed"] == 0 for t in "abd")
                and stats["c"]["quota"]["shed"] > 0,
                f"quota sheds {[stats[t]['quota'] for t in FLEET_TENANTS]}")
        base = require_calm(base, set(), "quota flood on c")
        # tenant d's model fails: its breaker trips, then recovers
        ts = eng.tenants["d"]
        good = ts.incumbent.params
        ts.incumbent.params = {k: v * float("nan") for k, v in good.items()}
        outs = [t.outcome for t in _fleet_ask(eng, "d", md, range(3))]
        require(outs == ["error-nonfinite"] * 3, f"d failing: {outs}")
        require(eng.submit("d", md.x[0, ..., 0], int(md.keys[0])).outcome
                == "rejected-breaker-open", "d's breaker did not open")
        require_calm(base, {"d"}, "d's breaker open")
        ts.incumbent.params = good
        time.sleep(0.25)
        require([t.ok for t in _fleet_ask(eng, "d", md, range(1))] == [True],
                "d's half-open probe failed")
        require(ts.breaker.state_name == "closed", "d's breaker not closed")
        base = require_calm(base, set(), "d recovered")
        total = _add(total, read_counts())
        # one batch: launches, the profiler window, the copy's cost
        x1 = np.array(md.x[:1])
        k1 = md.keys[:1].astype(np.int64)
        pa = eng.tenants["a"].incumbent.params
        reset_counts()
        eng._run(pa, x1, k1, 7)
        one = read_counts()
        require(one["lstm_infer_last"] == 14 and one["bdgcn_pair_fwd"] == 42
                and sum(one.values()) == 56, f"one batch launched {one}")
        total = _add(total, one)
        acts_n, note = device_activities(lambda: eng._run(pa, x1, k1, 7))
        copy_ms = time_ms(lambda: eng._copy_in(pa))
        copy_one = _host_ms(lambda: eng._copy_in(pa))
        copy_bytes = sum(t.numel() * t.element_size()
                         for ts in eng._dst.values() for t in ts)
        xg = torch.from_numpy(x1)
        kg = torch.from_numpy(k1)
        with_copy = _host_ms(lambda: eng._run(pa, x1, k1, 7))
        without = _host_ms(lambda: eng._rollouts.replay(xg, kg, 7,
                                                        eng._precision))
        st = eng.stats()
        print(f"[fleet] (b) blast radius on 4 tenants: poison_reload on b "
              f"rejected-smoke while a promoted the same candidate; a quota "
              f"flood on c shed {sorted(shed)}; d's breaker opened after 3 "
              f"error-nonfinite, answered 429-typed, and closed on its "
              f"half-open probe; every other tenant's answers bit-identical "
              f"and its breaker closed through each; graphs {n_graphs} "
              f"throughout ({card})", flush=True)
        print(f"[fleet] one bucket-1 batch: {_nz(one)} launches; profiler "
              f"window: {note} device activities; the in-place parameter "
              f"copy {copy_bytes} B: {copy_ms * 1e3:.2f} us a call (CUDA "
              f"events over 50 calls back to back: the host's issue rate "
              f"where it exceeds the device time), {copy_one[0] * 1e3:.1f} / "
              f"{copy_one[1] * 1e3:.1f} us one synchronised call (host "
              f"clock, median / min); bucket-1 rollout with the copy "
              f"{with_copy[0]:.3f} / {with_copy[1]:.3f} ms, the graph alone "
              f"{without[0]:.3f} / {without[1]:.3f} ms (host clock, median "
              f"/ min); resident bytes per tenant (f32) "
              f"{ {t: v['resident_bytes'] for t, v in st['tenants'].items()} }"
              f"; shared graph bytes {json.dumps(st['graph_bytes'])} "
              f"({card})", flush=True)
    finally:
        eng.drain()
        eng.close()
    # a torn slot at startup: b unavailable, recovered by a re-promotion
    reset_counts()
    eng = FleetEngine(cfg, data, fcfg, TenantRegistry.load(root), device=dev,
                      faults=FaultPlan.parse("corrupt_tenant_slot=1,"
                                             "fault_tenant=1"))
    try:
        require(eng.submit("b", md.x[0, ..., 0], int(md.keys[0])).outcome
                == "rejected-tenant-unavailable", "b not unavailable")
        for t in "acd":
            require(_same_preds([k.pred for k in _fleet_ask(eng, t, md, windows)],
                          base[t]), f"tenant {t} moved beside a torn b")
        _fleet_promote(root, "b", ckpts["b"], 3)
        acts = FleetReloader(eng).poll_all()
        require(acts["b"] == "canary-started", f"b recovery: {acts}")
        require(_same_preds([k.pred for k in _fleet_ask(eng, "b", md, windows)],
                      base["b"]), "recovered b differs from its checkpoint")
        require(eng.trace_count == n_graphs, "graphs moved on recovery")
        total = _add(total, read_counts())
        print(f"[fleet] (b) corrupt_tenant_slot on b: b answered "
              f"rejected-tenant-unavailable (503), a, c, d bit-identical; "
              f"a re-promotion recovered b without a restart, its answers "
              f"its checkpoint's; graphs {eng.trace_count} ({card})",
              flush=True)
    finally:
        eng.drain()
        eng.close()
    # one tenant: a request without a tenant field is its request
    solo = os.path.join(out_dir, "solo")
    TenantRegistry.load(solo).add("b")
    _fleet_promote(solo, "b", ckpts["b"], 1)
    reset_counts()
    eng = FleetEngine(cfg, data, fcfg.replace(output_dir=solo, buckets=(1,)),
                      TenantRegistry.load(solo), device=dev)
    try:
        t = eng.submit(None, md.x[0, ..., 0], int(md.keys[0]))
        require(t.wait(120) and t.ok and t.tenant == "b"
                and np.array_equal(t.pred, refs["b"][0]),
                f"one tenant, no tenant field: {t.outcome} {t.tenant}")
        total = _add(total, read_counts())
        print(f"[fleet] one tenant: a request without a tenant field is "
              f"answered by it, bit for bit its checkpoint's engine's "
              f"({card})", flush=True)
    finally:
        eng.drain()
        eng.close()
    # resident bytes at int8, and the copy on the wide configuration
    reset_counts()
    eng = FleetEngine(cfg.replace(infer_precision="int8"), data,
                      fcfg.replace(buckets=(1,)), TenantRegistry.load(root),
                      device=dev)
    try:
        t = _fleet_ask(eng, "a", md, range(1))[0]
        require(t.ok and np.isfinite(t.pred).all(), "int8 fleet answer")
        int8 = {t: v["resident_bytes"]
                for t, v in eng.stats()["tenants"].items()}
        copy8 = time_ms(lambda: eng._copy_in(eng.tenants["a"].incumbent
                                             .params))
        _, note8 = device_activities(lambda: eng._copy_in(
            eng.tenants["a"].incumbent.params))
        total = _add(total, read_counts())
    finally:
        eng.drain()
        eng.close()
    wide = MPGCN.from_config(cfg.replace(**WIDE, num_nodes=47), device=dev)
    dst = list(wide.parameters())
    src = [p.detach().clone() for p in dst]
    wide_bytes = sum(p.numel() * p.element_size() for p in dst)

    def wide_copy():
        with torch.no_grad():
            torch._foreach_copy_(dst, src)

    wide_ms = time_ms(wide_copy)
    print(f"[fleet] resident bytes per tenant at int8 {int8} (f32 above); "
          f"the int8 copy {copy8 * 1e3:.2f} us, device activities {note8}; "
          f"the wide configuration's "
          f"copy (hidden 128, K = 7) {wide_bytes} B: {wide_ms * 1e3:.2f} us "
          f"(CUDA events, mean of 50) ({card})", flush=True)
    del wide, dst, src
    return total


def phase_fleet(dev, cfg, data, train_dir, cand, out_dir, card):
    """Phase 17 (module docstring). Returns the launches and what phase 18
    reuses: the fleet root, the references, the test split, the windows."""
    t0 = time.perf_counter()
    root = os.path.join(out_dir, "svc")
    incumbent = os.path.join(train_dir, "MPGCN_od.pkl")
    ckpts = {"a": incumbent, "b": cand,
             "c": _perturbed_ckpt(incumbent, os.path.join(out_dir, "c.pkl"),
                                  1),
             "d": _perturbed_ckpt(incumbent, os.path.join(out_dir, "d.pkl"),
                                  2)}
    env = dict(os.environ, PYTHONPATH=HERE)
    for tid in FLEET_TENANTS:
        subprocess.run([sys.executable, "-m", "mpgcn_tpu_torch.cli", "fleet",
                        "add", tid, "-out", root], cwd=HERE, env=env,
                       check=True, capture_output=True, timeout=120)
        _fleet_promote(root, tid, ckpts[tid], 1)
    listed = json.loads(subprocess.run(
        [sys.executable, "-m", "mpgcn_tpu_torch.cli", "fleet", "list", "-out",
         root], cwd=HERE, env=env, check=True, capture_output=True,
        text=True, timeout=120).stdout)
    require(sorted(listed["tenants"]) == list(FLEET_TENANTS),
            f"fleet list: {listed}")
    windows = range(4)
    refs, md = fleet_references(dev, cfg, data, ckpts, windows)
    total = fleet_command(dev, cfg, root, refs, md, windows, out_dir, card)
    total = _add(total, fleet_blast_radius(dev, cfg, data, ckpts, refs, md,
                                           windows, out_dir, card))
    print(f"[fleet] phase 17 took {time.perf_counter() - t0:.1f}s; launches "
          f"{_nz(total)}", flush=True)
    return total, {"root": root, "refs": refs, "md": md, "windows": windows}


# --- phase 18: the router tier over serve --fleet replicas ---------------------

#: rollout graphs a replica captures: buckets 1, 2, 4, 8 at horizon 7
REPLICA_GRAPHS = 4
#: the clients of phase 18's load runs (no C = 4 run: the smoke keeps
#: inside its time limit with phase 21)
ROUTER_CLIENTS = (1, 16)


def _get(base, path, timeout=60):
    import urllib.request

    with urllib.request.urlopen(base + path, timeout=timeout) as r:
        return r.read().decode()


def _post(base, body, timeout=120):
    import urllib.error
    import urllib.request

    req = urllib.request.Request(
        base + "/v1/predict", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.load(r)
    except urllib.error.HTTPError as e:
        return e.code, json.load(e)


def _metric(text, name, labels=""):
    """One sample of a Prometheus text page; 0 when the family is there
    but not the labelled child (a counter child appears on its first
    increment)."""
    require(f"# TYPE {name} " in text, f"/metrics has no {name}")
    key = f"{name}{{{labels}}}" if labels else name
    for line in text.splitlines():
        if line.startswith(key + " "):
            return float(line.split()[-1])
    return 0.0


def _replica_read(base):
    """One replica incarnation's counters: /v1/stats (pid, graphs, batches,
    kernel launches) and /metrics (program builds by kind)."""
    st = json.loads(_get(base, "/v1/stats"))
    text = _get(base, "/metrics")
    return {"traces": st["traces"], "batches": st["batches"],
            "launches": dict(st["kernel_launches"]),
            "startup_s": st["startup_s"],
            "kernel_library": _metric(text, "mpgcn_cuda_program_builds_total",
                                      'kind="kernel_library"'),
            "cuda_graph": _metric(text, "mpgcn_cuda_program_builds_total",
                                  'kind="cuda_graph"'),
            "graph_bytes": st["graph_bytes"]}


def _gpu_apps():
    """{pid: MiB} of the card's compute processes, as nvidia-smi lists
    them (pids of this machine's namespace, or none)."""
    out = subprocess.run(
        [shutil.which("nvidia-smi"), "--query-compute-apps=pid,used_memory",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60).stdout
    apps = {}
    for line in out.strip().splitlines():
        parts = [p.strip() for p in line.split(",")]
        if len(parts) == 2 and parts[0].isdigit():
            apps[int(parts[0])] = parts[1]
    return apps


def _device_used():
    """Bytes in use on the card, every process's (cudaMemGetInfo)."""
    import torch

    free, total = torch.cuda.mem_get_info(0)
    return total - free


def _router_plan(fleet):
    """64 requests over the 4 tenants and the reference windows: (tenant,
    window, body bytes)."""
    md, win = fleet["md"], list(fleet["windows"])
    plan = []
    for i in range(64):
        tid, w = FLEET_TENANTS[i % 4], win[(i // 4) % len(win)]
        plan.append((tid, w, json.dumps(
            {"x": md.x[w, ..., 0].tolist(), "key": int(md.keys[w]),
             "tenant": tid}).encode()))
    return plan


def _check_answers(label, res, plan, refs):
    """Every answer 200, its tenant's, and bit-equal to its checkpoint's
    ServeEngine answer (phase 17's references)."""
    bad = []
    for i, st, p, _ in res:
        tid, w, _ = plan[i]
        if st != 200 or p.get("tenant") != tid or not np.array_equal(
                np.asarray(p["pred"], np.float32), refs[tid][w]):
            bad.append((i, tid, w, st, p.get("outcome")))
    require(not bad, f"{label}: {len(bad)} answers failed or differ from "
                     f"the references: {bad[:4]}")


def _load_run(label, port, plan, fleet, clients, ledger=None):
    """64 requests from ``clients`` keep-alive clients; every answer
    checked. Returns (req/s, round-trip p50, p99, engine p50, router
    p50): the engine's latency_ms from the answers, the router's own from
    its ledger's route rows (None straight to a replica)."""
    n0 = len(ledger()) if ledger else 0
    res, wall = _http_load(port, [b for _, _, b in plan], clients,
                           len(plan) // clients)
    _check_answers(label, res, plan, fleet["refs"])
    rt50, rt99 = _pct([r[3] for r in res])
    eng50 = _pct([r[2]["latency_ms"] for r in res])[0]
    own50 = None
    if ledger:
        rows = [r for r in ledger()[n0:] if r["event"] == "route"]
        own50 = _pct([r["latency_ms"] for r in rows])[0]
    return len(res) / wall, rt50, rt99, eng50, own50


class _Background:
    """Requests from 4 keep-alive clients in turn until stopped, each
    answer checked; for the rolling deploy."""

    def __init__(self, port, plan):
        self.port, self.plan = port, plan
        self.stop_ev = threading.Event()
        self.results, self.errors = [], []
        self.thread = threading.Thread(target=self._run, daemon=True)

    def _run(self):
        while not self.stop_ev.is_set():
            try:
                res, _ = _http_load(self.port, [b for _, _, b in self.plan],
                                    4, 4)
                self.results += res
            except Exception as e:  # reported by stop()
                self.errors.append(f"{type(e).__name__}: {e}")
                return

    def __enter__(self):
        self.thread.start()
        return self

    def __exit__(self, *exc):
        self.stop_ev.set()
        self.thread.join(180)


class _Watch:
    """Reads each replica incarnation's counters once it is admitted
    (``baseline``) and just before the router stops it (kill or
    terminate), and after a kill polls the card's used bytes until the
    dead process's memory is back. ``quiet`` says that no request is in
    flight (set by the phase around its loads)."""

    def __init__(self):
        self.reads, self.kills, self._threads = [], [], []
        self.errors, self.first = [], {}
        self.footprint = 0
        self.quiet = True

    def baseline(self, h):
        r = _replica_read(h.proc.base_url)
        self.first[(h.idx, h.proc.generation)] = r
        return r

    def attach(self, h):
        import time as _time

        proc = h.proc
        kill, terminate = proc.kill, proc.terminate

        def read(why):
            if proc.alive and proc.base_url:
                try:
                    r = _replica_read(proc.base_url)
                except Exception as e:  # required empty after the phase
                    self.errors.append(f"r{proc.idx} generation "
                                       f"{proc.generation}: "
                                       f"{type(e).__name__}: {e}")
                    return
                base = self.first.get((proc.idx, proc.generation))
                if base is None:
                    self.errors.append(f"r{proc.idx} generation "
                                       f"{proc.generation} stopped before "
                                       f"its baseline read")
                    return
                self.reads.append(_since(base, r, proc, why, self.quiet))

        def on_kill():
            read("kill")
            row = {"replica": proc.idx, "pid": proc.pid,
                   "used_before": _device_used(), "t": _time.perf_counter()}
            kill()
            row["t_reaped"] = _time.perf_counter()
            self.kills.append(row)
            t = threading.Thread(target=self._freed, args=(row,), daemon=True)
            t.start()
            self._threads.append(t)

        def on_terminate(timeout_s=30.0):
            read("terminate")
            return terminate(timeout_s=timeout_s)

        proc.kill, proc.terminate = on_kill, on_terminate

    def _freed(self, row):
        """Seconds from the kill until the card's used bytes fall by half
        a replica's footprint; the pid's presence in nvidia-smi then."""
        deadline = row["t"] + 20.0
        while time.perf_counter() < deadline:
            used = _device_used()
            if used <= row["used_before"] - self.footprint // 2:
                row["freed_s"] = time.perf_counter() - row["t"]
                row["used_after"] = used
                row["pid_listed"] = row["pid"] in _gpu_apps()
                return
            time.sleep(0.02)
        row["freed_s"] = None

    def join(self):
        for t in self._threads:
            t.join(30)


def _since(base, r, proc, why, idle):
    """An incarnation's launches and batches between two reads."""
    return {"replica": proc.idx, "generation": proc.generation, "why": why,
            "idle": idle, "batches": r["batches"] - base["batches"],
            "launches": {k: v - base["launches"][k]
                         for k, v in r["launches"].items()}}


def _replica_check(label, r, graph_builds):
    require(r["traces"] == REPLICA_GRAPHS,
            f"{label}: {r['traces']} graphs, expected {REPLICA_GRAPHS}")
    require(r["kernel_library"] == 0,
            f"{label} built {r['kernel_library']:.0f} kernel libraries")
    require(r["cuda_graph"] == graph_builds > 0,
            f"{label}: {r['cuda_graph']:.0f} graph captures, the first "
            f"incarnation {graph_builds:.0f}")


def _wait_for(cond, secs, what):
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < secs:
        if cond():
            return time.perf_counter() - t0
        time.sleep(0.05)
    require(False, f"timed out after {secs}s waiting for {what}")


def _log_tail(h, n=3000):
    path = os.path.join(h.proc.root, f"replica_gen{h.proc.generation - 1}.log")
    try:
        with open(path) as f:
            return f.read()[-n:]
    except OSError as e:
        return f"<no log: {e}>"


def router_in_process(cfg, fleet, plan, card):
    """(a): the Router and its HTTP front in this process over replicas
    of ``serve --fleet`` on the card. Returns the launches."""
    from mpgcn_tpu_torch.config import RouterConfig
    from mpgcn_tpu_torch.resilience.faults import FaultPlan
    from mpgcn_tpu_torch.service.router import ADMITTED, Router, _make_handler

    refs, root = fleet["refs"], fleet["root"]
    rcfg = RouterConfig(
        output_dir=root, replicas=2, min_replicas=1, max_replicas=3,
        probe_interval_s=0.25, probe_timeout_s=5.0, breaker_threshold=2,
        breaker_cooldown_s=0.5, deadline_ms=0.0, connect_timeout_s=30.0,
        ready_timeout_s=300.0, drain_timeout_s=60.0,
        smoke_obs=cfg.obs_len, smoke_nodes=cfg.synthetic_N)
    env = dict(os.environ, PYTHONPATH=HERE)
    env.pop("MPGCN_FAULTS", None)
    watch = _Watch()
    used0 = _device_used()
    t0 = time.perf_counter()
    rt = Router(rcfg, fleet_serve_args(cfg, "cuda"), env=env)
    ledger_path = os.path.join(root, "router", "router.jsonl")

    def ledger():
        with open(ledger_path) as f:
            return [json.loads(line) for line in f]

    httpd = None
    try:
        rt.start()
        for h in rt.handles.values():
            watch.attach(h)
        require(rt.wait_ready(300.0), "replicas never admitted: " + " | ".join(
            _log_tail(h) for h in rt.handles.values()))
        up_s = time.perf_counter() - t0
        watch.footprint = (_device_used() - used0) // 2
        require(watch.footprint > 100 * 2**20, f"2 replicas added "
                f"{2 * watch.footprint} bytes to the card's used memory")
        apps = _gpu_apps()
        first = {i: watch.baseline(h) for i, h in rt.handles.items()}
        graph_builds = first[0]["cuda_graph"]
        for i, r in first.items():
            _replica_check(f"r{i} generation 1", r, graph_builds)
        mem = {f"r{i}": apps.get(h.proc.pid, "not listed")
               for i, h in rt.handles.items()}
        print(f"[router] (a) 2 replicas admitted {up_s:.1f}s after the "
              f"launch (health + smoke probe); each {REPLICA_GRAPHS} graphs, "
              f"{graph_builds:.0f} graph captures, 0 kernel libraries built; "
              f"device memory a replica: nvidia-smi --query-compute-apps "
              f"{mem} MiB by pid, its graphs' pool "
              f"{json.dumps(first[0]['graph_bytes'])} bytes, "
              f"{watch.footprint / 2**20:.0f} MiB of the card's used bytes "
              f"(cudaMemGetInfo before and after) ({card})", flush=True)
        watch.quiet = False
        httpd = _serve_front(rt, _make_handler)
        port = httpd.server_address[1]
        base = f"http://127.0.0.1:{port}"

        # every tenant's answers through the router, both replicas serving
        n0 = len(ledger())
        for tid in FLEET_TENANTS:
            for w in fleet["windows"]:
                code, p = _post(base, {"x": fleet["md"].x[w, ..., 0].tolist(),
                                       "key": int(fleet["md"].keys[w]),
                                       "tenant": tid})
                require(code == 200 and np.array_equal(
                    np.asarray(p["pred"], np.float32), refs[tid][w]),
                    f"tenant {tid} window {w} through the router: {code} "
                    f"{p.get('outcome')}")
        served = {(r["tenant"], r["replica"]) for r in ledger()[n0:]
                  if r["event"] == "route"}
        require(all((t, i) in served for t in FLEET_TENANTS for i in (0, 1)),
                f"each tenant served by both replicas: {sorted(served)}")

        # requests/s: through the router (2 replicas), straight to r0
        r0_port = rt.handles[0].proc.port
        loads = {}
        for clients in ROUTER_CLIENTS:
            loads[("router2", clients)] = _load_run(
                f"router C={clients}", port, plan, fleet, clients, ledger)
            loads[("direct", clients)] = _load_run(
                f"r0 C={clients}", r0_port, plan, fleet, clients)
        for clients in ROUTER_CLIENTS:
            a, d = loads[("router2", clients)], loads[("direct", clients)]
            print(f"[router] (a) C={clients}: through the router over 2 "
                  f"replicas {a[0]:.1f} req/s, round trip p50 {a[1]:.3f} ms "
                  f"p99 {a[2]:.3f}, replica engine p50 {a[3]:.3f}, router's "
                  f"own p50 {a[4]:.3f}; straight to r0 {d[0]:.1f} req/s, "
                  f"p50 {d[1]:.3f} p99 {d[2]:.3f}, engine p50 {d[3]:.3f}; "
                  f"the router adds {a[1] - d[1]:.3f} ms to the p50 round "
                  f"trip ({card})", flush=True)

        # kill -9 of r1 at the 10th request of a 48-request load
        n = rt._n_routed
        rt.faults = FaultPlan.parse(
            f"kill_replica={n + 10},partition_replica={n + 70},"
            f"fault_replica=1,partition_secs=1.5")
        res, _ = _http_load(port, [b for _, _, b in plan[:48]], 4, 12)
        _check_answers("across the kill", res, plan, refs)
        require(len(watch.kills) == 1, f"kill_replica fired "
                                       f"{len(watch.kills)} times")
        kill = watch.kills[0]
        h1 = rt.handles[1]
        _wait_for(lambda: h1.state == ADMITTED and h1.proc.generation == 2,
                  300, "r1's re-admission: " + _log_tail(h1))
        death_s = time.perf_counter() - kill["t"]
        watch.join()
        require(kill.get("freed_s") is not None,
                f"the killed replica's memory never came back: {kill}")
        rows = [r for r in ledger() if r.get("replica") == 1]
        events = [r["event"] for r in rows]
        i_died = events.index("replica_died")
        want = ["replica_died", "replica_restart", "replica_bound",
                "replica_admitted"]
        require([e for e in events[i_died:] if e in want] == want,
                f"r1's re-admission order {events[i_died:]}")
        t_of = {e: rows[i_died + events[i_died:].index(e)]["t"] for e in want}
        r1g2 = watch.baseline(h1)
        _replica_check("r1 generation 2 (after kill -9)", r1g2, graph_builds)
        print(f"[router] (a) kill -9 of r1 (pid {kill['pid']}) at request "
              f"{n + 10}: 48 answers all 200 and bit-equal to the "
              f"references; its memory back {kill['freed_s']:.3f}s after the "
              f"kill (card used {kill['used_before'] / 2**20:.0f} -> "
              f"{kill['used_after'] / 2**20:.0f} MiB, pid listed then: "
              f"{kill['pid_listed']}), the restart launched "
              f"{t_of['replica_restart'] - t_of['replica_died']:.3f}s after "
              f"the death was seen; death -> re-admitted {death_s:.1f}s "
              f"(ledger died -> admitted "
              f"{t_of['replica_admitted'] - t_of['replica_died']:.1f}s); "
              f"generation 2: {r1g2['traces']} graphs, "
              f"{r1g2['cuda_graph']:.0f} captures, "
              f"{r1g2['kernel_library']:.0f} kernel libraries built, engine "
              f"startup {r1g2['startup_s']}s ({card})", flush=True)

        # a partition of r1 at request n + 70 of a 32-request load
        trips0 = h1.breaker.trips
        res, _ = _http_load(port, [b for _, _, b in plan[:32]], 4, 8)
        _check_answers("across the partition", res, plan, refs)
        t_part = time.perf_counter()
        _wait_for(lambda: h1.breaker.trips > trips0, 30,
                  "the partition to trip r1's breaker")
        _wait_for(lambda: h1.breaker.state_name == "closed"
                  and not rt._is_partitioned(h1), 30,
                  "the prober to close r1's breaker")
        print(f"[router] (a) partition of r1 at request {n + 70} (1.5 s): 32 "
              f"answers all 200 and bit-equal; breaker tripped and closed "
              f"again by the prober {time.perf_counter() - t_part:.2f}s after "
              f"the load ({card})", flush=True)

        # a rolling deploy under load
        with _Background(port, plan) as bg:
            dep = rt.rolling_deploy()
        require(not bg.errors, f"background load: {bg.errors}")
        require(dep["ok"] and dep["deployed"] == [0, 1], f"deploy {dep}")
        _check_answers("during the rolling deploy", bg.results, plan, refs)
        rows = ledger()
        drains = {}
        for r in rows:
            if r["event"] == "deploy_drain":
                drains[r["replica"]] = r["t"]
            elif r["event"] == "deploy_readmitted":
                drains[r["replica"]] = r["t"] - drains[r["replica"]]
        for i in (0, 1):
            _replica_check(f"r{i} after the deploy",
                           watch.baseline(rt.handles[i]), graph_builds)
        slo = rt.slo.tick()
        print(f"[router] (a) rolling deploy under load: "
              f"{len(bg.results)} answers all 200 and bit-equal; drain -> "
              f"re-admitted r0 {drains[0]:.1f}s, r1 {drains[1]:.1f}s; "
              f"generations {[rt.handles[i].proc.generation for i in (0, 1)]}"
              f"; router SLO "
              f"{[(e['name'], e['state']) for e in slo['slos']]} ({card})",
              flush=True)

        # one spawn and two retires: 2 -> 3 -> 2 -> 1 replicas
        t1 = time.perf_counter()
        rt._scale_up()
        h2 = rt.handles[max(rt.handles)]
        watch.attach(h2)
        _wait_for(lambda: h2.state == ADMITTED, 300,
                  "the spawned replica: " + _log_tail(h2))
        spawn_s = time.perf_counter() - t1
        _replica_check(f"r{h2.idx} (spawned)", watch.baseline(h2),
                       graph_builds)
        loads[("router3", 16)] = _load_run(
            "router, 3 replicas, C=16", port, plan, fleet, 16, ledger)
        watch.quiet = True
        retire = []
        for _ in range(2):
            victim = max(i for i, h in rt.handles.items()
                         if h.state == ADMITTED)
            t1 = time.perf_counter()
            rt._scale_down()
            _wait_for(lambda: not rt.handles[victim].proc.alive, 120,
                      f"r{victim} to exit")
            retire.append((victim, time.perf_counter() - t1))
        print(f"[router] (a) scale-up: r{h2.idx} spawned -> admitted "
              f"{spawn_s:.1f}s; over 3 replicas "
              + f"C=16 {loads[('router3', 16)][0]:.1f} req/s (p50 "
              f"{loads[('router3', 16)][1]:.3f} ms); scale-down: "
              + ", ".join(f"r{i} retired (drained, exited) in {s:.2f}s"
                          for i, s in retire) + f" ({card})", flush=True)
        watch.quiet = False
        for clients in ROUTER_CLIENTS:
            loads[("router1", clients)] = _load_run(
                f"router, 1 replica, C={clients}", port, plan, fleet, clients,
                ledger)
            a1, a2 = loads[("router1", clients)], loads[("router2", clients)]
            print(f"[router] (a) C={clients}: through the router over 1 "
                  f"replica {a1[0]:.1f} req/s, round trip p50 {a1[1]:.3f} ms "
                  f"p99 {a1[2]:.3f}, engine p50 {a1[3]:.3f}, router's own p50 "
                  f"{a1[4]:.3f}; over 2 replicas {a2[0]:.1f} req/s "
                  f"({a2[0] / a1[0]:.2f}x) ({card})", flush=True)
        watch.quiet = True
    finally:
        if httpd is not None:
            httpd.shutdown()
            httpd.server_close()
        rt.close()
    watch.join()
    require(not watch.errors, f"replica reads failed: {watch.errors}")
    require(not any(h.proc.alive for h in rt.handles.values()),
            "a replica outlived the router")
    return _incarnation_launches("(a)", watch.reads)


def _incarnation_launches(label, reads):
    """The replicas' launches, each incarnation's from its baseline read
    (admitted, idle) to its read before it stopped; where that read was
    idle too, exactly 14 lstm_infer_last and 42 bdgcn_pair_fwd a batch."""
    total = {}
    for r in reads:
        lc = r["launches"]
        if r["idle"]:
            require(lc["lstm_infer_last"] == 14 * r["batches"]
                    and lc["bdgcn_pair_fwd"] == 42 * r["batches"]
                    and sum(lc.values()) == 56 * r["batches"],
                    f"{label} r{r['replica']} generation {r['generation']}: "
                    f"{_nz(lc)} for {r['batches']} batches")
        total = _add(total, lc)
    require(total.get("lstm_infer_last", 0) > 0
            and total.get("bdgcn_pair_fwd", 0) > 0,
            f"{label}: the replicas launched no kernel: {total}")
    print(f"[router] {label} {len(reads)} replica incarnations, each read "
          f"once admitted and before it stopped: "
          + "; ".join(f"r{r['replica']} gen {r['generation']} ({r['why']}"
                      f"{', idle' if r['idle'] else ', under load'}) "
                      f"{r['batches']} batches, {_nz(r['launches'])}"
                      for r in reads), flush=True)
    return total


def router_command(cfg, fleet, plan, out_dir, card, n_replicas):
    """(b): ``python -m mpgcn_tpu_torch.cli router`` as its own process
    over ``n_replicas`` replicas: up, answers bit-equal, requests/s at
    ROUTER_CLIENTS, SIGTERM -> exit 0 with no replica left. Returns the
    launches and the loads."""
    from mpgcn_tpu_torch.service.registry import TenantRegistry
    from mpgcn_tpu_torch.service.router import router_info_path

    root = os.path.join(out_dir, f"svc_cli{n_replicas}")
    src = TenantRegistry.load(fleet["root"], missing_ok=False)
    TenantRegistry(root, {t: {**e, "root": os.path.abspath(e["root"])}
                          for t, e in src.tenants.items()}).save()
    argv = [sys.executable, "-m", "mpgcn_tpu_torch.cli", "router", "-out",
            root, "--replicas", str(n_replicas), "--smoke-obs",
            str(cfg.obs_len),
            "--smoke-nodes", str(cfg.synthetic_N), "--deadline-ms", "0",
            "--connect-timeout", "30", "--ready-timeout", "300", "--",
            *fleet_serve_args(cfg, "cuda")]
    env = dict(os.environ, PYTHONPATH=HERE)
    env.pop("MPGCN_FAULTS", None)
    out_path = os.path.join(out_dir, f"router{n_replicas}.stdout")
    err_path = os.path.join(out_dir, f"router{n_replicas}.stderr")
    log_out, log_err = open(out_path, "w"), open(err_path, "w")
    t0 = time.perf_counter()
    proc = subprocess.Popen(argv, cwd=HERE, env=env, stdout=log_out,
                            stderr=log_err)
    reads, pids = [], []
    try:
        info = router_info_path(root)
        while not os.path.exists(info):
            require(proc.poll() is None, f"router exited {proc.returncode}")
            require(time.perf_counter() - t0 < 300, "the router never came up")
            time.sleep(0.1)
        up_s = time.perf_counter() - t0
        with open(info) as f:
            port = json.load(f)["port"]
        base = f"http://127.0.0.1:{port}"
        hz = json.loads(_get(base, "/healthz"))
        require(hz["status"] == "serving" and hz["admitted"] == n_replicas,
                f"/healthz {hz}")
        st = json.loads(_get(base, "/v1/stats"))
        replicas = sorted(st["replicas"].items())
        first = {}
        for name, r in replicas:
            require(r["state"] == "admitted", f"{name}: {r}")
            first[name] = _replica_read(f"http://127.0.0.1:{r['port']}")
            _replica_check(f"command {name}", first[name],
                           first[name]["cuda_graph"])
            pids.append(r["pid"])
        loads = {c: _load_run(f"router command C={c}", port, plan, fleet, c)
                 for c in ROUTER_CLIENTS}
        for name, r in replicas:
            reads.append(_since(
                first[name], _replica_read(f"http://127.0.0.1:{r['port']}"),
                types.SimpleNamespace(idx=int(name[1:]),
                                      generation=r["generation"]),
                "before SIGTERM", True))
        text = _get(base, "/metrics")
        require(_metric(text, "mpgcn_router_replicas_admitted")
                == n_replicas, "/metrics: router_replicas_admitted")
        print(f"[router] (b) python -m mpgcn_tpu_torch.cli router --replicas "
              f"{n_replicas}: up in {up_s:.1f}s (admitted, router/http.json "
              f"written); " + "; ".join(
                  f"C={c} {v[0]:.1f} req/s, round trip p50 {v[1]:.3f} ms "
                  f"p99 {v[2]:.3f}, engine p50 {v[3]:.3f}"
                  for c, v in loads.items()) + f"; {64 * len(loads)} "
              f"answers bit-equal to the references ({card})", flush=True)
        proc.send_signal(15)  # SIGTERM
        rc = proc.wait(timeout=180)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        log_out.close()
        log_err.close()
    with open(out_path) as f:
        stdout = f.read()
    require(rc == 0 and "[router] stopped; exiting 0." in stdout,
            f"router exited {rc} on SIGTERM")
    left = []
    for pid in pids:
        try:
            os.kill(pid, 0)
            left.append(pid)
        except ProcessLookupError:
            pass
    require(not left, f"replica processes left running: {left}")
    print(f"[router] (b) SIGTERM: drained, exit 0, replicas {pids} gone "
          f"({card})", flush=True)
    return _incarnation_launches(f"(b) {n_replicas}", reads), loads


def phase_router(cfg, fleet, out_dir, card):
    """Phase 18 (module docstring). Returns the replicas' launches."""
    t0 = time.perf_counter()
    plan = _router_plan(fleet)
    total = router_in_process(cfg, fleet, plan, card)
    launches, _ = router_command(cfg, fleet, plan, out_dir, card, 2)
    total = _add(total, launches)
    print(f"[router] phase 18 took {time.perf_counter() - t0:.1f}s; replica "
          f"launches {_nz(total)}", flush=True)
    return total


# --- phase 19: the continual-learning daemon ----------------------------------

#: (a)'s spool: synthetic_od(seed 0) days at N=47, day 20 corrupt (row 0
#: NaN); six days a cycle, so the window grows to 30 days over the cycles
#: and one process retrains several times
DAEMON_DAYS, DAEMON_CORRUPT = 48, 20
DAEMON_FLAGS = ["--window-days", "30", "--holdout-days", "2", "--val-days",
                "2", "--retrain-cadence", "3", "--ingest-batch", "6",
                "--poll-secs", "0.05", "-epoch", "20", "-lr", "1e-3"]
#: (b)'s captured days: a request a day whose newest frame is the day
CAPTURE_DAYS = range(48, 55)
#: launches a train step (M x L of each LSTM training entry, M x 3 of each
#: BDGCN entry) and an eval step or rollout forward (lstm_infer_last,
#: bdgcn_pair_fwd), at the reference widths (M=2, L=1, 3 graph layers)
DAEMON_TRAIN = {"lstm_train_fwd_f32": 2, "lstm_train_bwd_f32": 2,
                "bdgcn_pair_fwd_f32": 6, "bdgcn_pair_bwd_f32": 6}
DAEMON_INFER = {"lstm_infer_last_f32": 2, "bdgcn_pair_fwd_f32": 6}


def _snap(snap: dict, name: str, **labels) -> float:
    """One series of a metrics snapshot, 0 where it was never written."""
    want = [f'{k}="{v}"' for k, v in labels.items()]
    for key, v in snap.items():
        if key.startswith("mpgcn_" + name) and all(w in key for w in want):
            return v
    return 0.0


def _attempt_launches(label, done):
    """One retrain_done's kernel launches by kernel name, checked against
    its steps: exactly DAEMON_TRAIN a train step and DAEMON_INFER an eval
    step or rollout forward, no other kernel."""
    m = done["metrics"]
    steps = {k: int(_snap(m, "daemon_retrain_steps", kind=k))
             for k in ("train", "eval", "rollout")}
    require(min(steps.values()) > 0, f"{label}: steps {steps}")
    symbols = {k.symbol: n for n, k in kernels().items()}
    got = {s: int(_snap(m, "daemon_retrain_launches", kernel=s))
           for s in symbols}
    want = {s: 0 for s in symbols}
    for s, n in DAEMON_TRAIN.items():
        want[s] += n * steps["train"]
    for s, n in DAEMON_INFER.items():
        want[s] += n * (steps["eval"] + steps["rollout"])
    require(got == want, f"{label}: launches {_nz(got)} for steps {steps}, "
                         f"expected {_nz(want)}")
    return {symbols[s]: n for s, n in got.items()}, steps


def _daemon_env():
    env = dict(os.environ, PYTHONPATH=HERE)
    env.pop("MPGCN_FAULTS", None)
    return env


class _SlotWatch:
    """A thread that integrity-loads the promoted slot every 30 ms (a load
    that fails is a torn promotion) and stamps, on this process's clock,
    the first sighting of the n-th line holding a text in a file, for
    each of ``marks``."""

    def __init__(self, slot, marks):
        self.slot, self.marks = slot, marks  # name -> (path, text, n)
        self.seen, self.loads, self.failures = {}, 0, []
        self._stop = threading.Event()
        self._t = threading.Thread(target=self._run, daemon=True)
        self._t.start()

    def _run(self):
        from mpgcn_tpu_torch.train.checkpoint import load_checkpoint

        while not self._stop.is_set():
            if os.path.exists(self.slot):
                try:
                    load_checkpoint(self.slot)
                    self.loads += 1
                except Exception as e:
                    self.failures.append(repr(e))
            for name, (path, text, n) in self.marks.items():
                if name in self.seen:
                    continue
                try:
                    with open(path) as f:
                        if f.read().count(text) >= n:
                            self.seen[name] = time.time()
                except OSError:
                    pass
            time.sleep(0.03)

    def stop(self):
        self._stop.set()
        self._t.join(timeout=10)


def _retrain_report(events):
    """Per retrain_done, in order: (attempt, process, seconds, graph
    captures, reserved bytes); the process counted from daemon_start, the
    graph captures from the process-cumulative counter."""
    rows, proc, start, graphs = [], -1, {}, 0.0
    for e in events:
        if e["event"] == "daemon_start":
            proc, graphs = proc + 1, 0.0
        elif e["event"] == "retrain_start":
            start[e["attempt"]] = e["t"]
        elif e["event"] == "retrain_done":
            m = e["metrics"]
            g = _snap(m, "cuda_program_builds", kind="cuda_graph")
            rows.append((e["attempt"], proc, e["t"] - start[e["attempt"]],
                         g - graphs,
                         _snap(m, "daemon_device_bytes_reserved"),
                         _snap(m, "cuda_program_builds",
                               kind="kernel_library"), e))
            graphs = g
    return rows


def daemon_supervised(out_dir, card, device):
    """(a): the supervised daemon killed mid-retrain. Returns its launches
    and the output root."""
    from mpgcn_tpu_torch.data.loader import synthetic_od
    from mpgcn_tpu_torch.scenarios.dynamics import write_od_spool
    from mpgcn_tpu_torch.service.daemon import daemon_log_path
    from mpgcn_tpu_torch.service.promote import ledger_path, promoted_path
    from mpgcn_tpu_torch.utils.logging import read_events

    spool, out = os.path.join(out_dir, "spool"), os.path.join(out_dir, "svc")
    od = synthetic_od(DAEMON_DAYS, 47, seed=0)
    od[DAEMON_CORRUPT, 0] = np.nan
    write_od_spool(od, spool)
    sup_log = os.path.join(out, "supervisor", "supervisor_log.jsonl")
    dlog = daemon_log_path(out)
    watch = _SlotWatch(promoted_path(out), {
        "killed": (sup_log, '"generation_end"', 1),
        "relaunched": (dlog, '"daemon_start"', 2),
        "first_cycle": (dlog, '"retrain_done"', 2)})
    used0 = _device_used()
    argv = [sys.executable, "-m", "mpgcn_tpu_torch.cli", "supervise",
            "--procs", "1", "--max-restarts", "3", "--", "daemon", "-spool",
            spool, "-out", out, "--device", device, "--idle-exits", "2",
            *DAEMON_FLAGS, "-faults", "kill_retrain=2"]
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(argv, cwd=HERE, env=_daemon_env(),
                              capture_output=True, text=True, timeout=600)
    finally:
        watch.stop()
    secs = time.perf_counter() - t0
    with open(os.path.join(out_dir, "supervise.stdout"), "w") as f:
        f.write(proc.stdout + proc.stderr)
    require(proc.returncode == 0, f"supervise exited {proc.returncode}: "
                                  f"{(proc.stdout + proc.stderr)[-3000:]}")
    require(not watch.failures, f"the promoted slot failed to load "
                                f"{len(watch.failures)} times: "
                                f"{watch.failures[:2]}")
    require(watch.loads > 0, "the promoted slot never appeared")
    gens = read_events(sup_log, "generation_end")
    require([g["rcs"] for g in gens] == [[-9], [0]],
            f"supervisor generations {[g['rcs'] for g in gens]}")
    verdicts = read_events(os.path.join(out, "quarantine", "verdicts.jsonl"))
    require([v["day"] for v in verdicts] == [DAEMON_CORRUPT],
            f"quarantined {[v['day'] for v in verdicts]}")
    events = read_events(dlog)
    starts = [e["attempt"] for e in events if e["event"] == "retrain_start"]
    gates = read_events(ledger_path(out), "gate")
    require(starts[:2] == [1, 2] and 2 not in [g["attempt"] for g in gates],
            f"retrains {starts}, gate rows {[g['attempt'] for g in gates]}")
    require([g["attempt"] for g in gates] == [a for a in starts if a != 2],
            "a retrain other than the killed one left no gate row")
    for g in gates:
        if g["promoted"] and g["inc_loss"] is not None:
            require(g["cand_loss"] <= g["inc_loss"] * (1 + g["tolerance"]),
                    f"attempt {g['attempt']} promoted past the gate")
    rows = _retrain_report(events)
    total = {n: 0 for n in KERNEL_META}
    for attempt, p, s, g, reserved, libs, e in rows:
        launches, _ = _attempt_launches(f"[daemon] attempt {attempt}", e)
        total = _add(total, launches)
        require(libs == 0, f"attempt {attempt} built {libs} kernel "
                           f"libraries")
    relaunched = [r for r in rows if r[1] == 1]
    reserved = [r[4] for r in relaunched]
    require(len(relaunched) >= 3 and max(reserved) <= reserved[0] + 2 ** 21,
            f"reserved bytes after the relaunched daemon's retrains: "
            f"{reserved}")
    promoted = sum(g["promoted"] for g in gates)
    print(f"[daemon] (a) supervise --procs 1 -- daemon -faults "
          f"kill_retrain=2 on {DAEMON_DAYS} days (N=47, hidden 32, batch 4, "
          f"obs 7, M=2, K=3 supports; day {DAEMON_CORRUPT} corrupt): "
          f"{secs:.1f}s, generations [-9] then [0], day {DAEMON_CORRUPT} "
          f"quarantined, retrains {starts} (2 killed after its first "
          f"epoch, no gate row), {promoted} of {len(gates)} gated attempts "
          f"promoted, the promoted slot loaded {watch.loads} times "
          f"without a failure, 0 kernel libraries built ({card})",
          flush=True)
    for attempt, p, s, g, reserved, _, e in rows:
        steps = {k: int(_snap(e["metrics"], "daemon_retrain_steps", kind=k))
                 for k in ("train", "eval", "rollout")}
        print(f"[daemon] (a) attempt {attempt} (process {p}): {s:.3f}s "
              f"retrain + gate, {g:.0f} graph captures, steps {steps} with "
              f"exact launches, memory_reserved after it "
              f"{reserved / 2 ** 20:.1f} MiB ({card})", flush=True)
    k = watch.seen
    require({"killed", "relaunched", "first_cycle"} <= set(k),
            f"marks seen: {sorted(k)}")
    kill_t = gens[0]["t"]  # the supervisor's clock: its wait saw the exit
    print(f"[daemon] (a) kill -> relaunch -> first cycle: the relaunched "
          f"daemon's loop started {k['relaunched'] - kill_t:.2f}s after "
          f"the kill was reaped, its first retrain (attempt 3) done "
          f"{k['first_cycle'] - k['relaunched']:.2f}s later; the card's "
          f"used bytes {(_device_used() - used0) / 2 ** 20:+.1f} MiB against "
          f"before the run ({card})", flush=True)
    return total, out


def _serve_argv(out, device):
    return ["serve", "--device", device, "-out", out, "--capture-flows",
            "--buckets", "1", "--deadline-ms", "0", "--max-queue", "256",
            "--reload-poll-secs", "0.1", "--canary-fraction", "1.0",
            "--canary-requests", "4", "--window-days", "30",
            "--holdout-days", "2", "--val-days", "2"]


def daemon_serve_capture(out, card, device):
    """(b): a serve process with flow capture on (a)'s root; a daemon with
    --capture-ledger stitches captured days, retrains and promotes; the
    server's canary takes the new weights. Returns both processes'
    launches."""
    from mpgcn_tpu_torch.config import MPGCNConfig, ServeConfig
    from mpgcn_tpu_torch.data.loader import synthetic_od
    from mpgcn_tpu_torch.data.pipeline import DataPipeline
    from mpgcn_tpu_torch.service import serve
    from mpgcn_tpu_torch.service.daemon import daemon_log_path
    from mpgcn_tpu_torch.service.promote import ledger_path, promoted_path
    from mpgcn_tpu_torch.service.serve import ServeEngine
    from mpgcn_tpu_torch.utils.logging import read_events

    argv = _serve_argv(out, device)
    ns = serve.build_parser().parse_args(argv[1:])
    tcfg = MPGCNConfig(mode="test", data="synthetic", input_dir=out,
                       output_dir=serve.serve_dir(out), obs_len=ns.obs_len,
                       pred_len=ns.pred_len, batch_size=ns.batch_size,
                       hidden_dim=ns.hidden_dim, kernel_type=ns.kernel_type,
                       cheby_order=ns.cheby_order,
                       num_branches=ns.num_branches, seed=ns.seed)
    info = serve.http_info_path(out)
    if os.path.exists(info):
        os.remove(info)
    log_s = open(os.path.join(os.path.dirname(out), "serve.log"), "w")
    t0 = time.perf_counter()
    srv = subprocess.Popen([sys.executable, "-m", "mpgcn_tpu_torch.cli",
                            *argv], cwd=HERE, env=_daemon_env(),
                           stdout=log_s, stderr=subprocess.STDOUT)
    daemon_proc = ref = log_d = None
    try:
        while not os.path.exists(info):
            require(srv.poll() is None, f"serve exited {srv.returncode}")
            require(time.perf_counter() - t0 < 300, "serve never came up")
            time.sleep(0.1)
        up_s = time.perf_counter() - t0
        with open(info) as f:
            base = f"http://127.0.0.1:{json.load(f)['port']}"
        # the banks the server built at startup, from the same accepted days
        cfg_ref, data_ref = serve._build_data(ns, tcfg)
        # (b1) capture: one request a new day, its newest frame the day
        od = synthetic_od(max(CAPTURE_DAYS) + 1, 47, seed=0).astype(
            np.float32)
        sent = {}
        for day in CAPTURE_DAYS:
            x = od[day - ns.obs_len + 1: day + 1]
            sent[day] = x[-1]
            code, doc = _post(base, {"x": x.tolist(), "key": day % 7,
                                     "day_slot": day, "deadline_ms": 0})
            require(code == 200 and doc["ok"], f"capture request {day}: "
                                               f"{code} {doc}")
        n_gates = len(read_events(ledger_path(out), "gate"))
        _wait_for(lambda: len([r for r in read_events(
            serve.requests_ledger_path(out), "request")
            if "day_slot" in r]) == len(sent), 60,
            "the captured rows in the request ledger")
        # (b2) the daemon on the capture ledger, traffic running meanwhile
        log_d = open(os.path.join(os.path.dirname(out), "daemon_b.log"), "w")
        spool = os.path.join(os.path.dirname(out), "spool")
        daemon_proc = subprocess.Popen(
            [sys.executable, "-m", "mpgcn_tpu_torch.cli", "daemon", "-spool",
             spool, "-out", out, "--device", device, "--idle-exits", "4",
             *DAEMON_FLAGS,
             "--promote-tolerance", "0.25", "--capture-ledger",
             serve.requests_ledger_path(out)], cwd=HERE, env=_daemon_env(),
            stdout=log_d, stderr=subprocess.STDOUT)
        md = DataPipeline(cfg_ref, data_ref, "cpu").modes["train"]
        stop = threading.Event()

        def traffic():  # the canary's requests
            i = 0
            while not stop.is_set():
                w = i % len(md)
                try:
                    _post(base, {"x": md.x[w, ..., 0].tolist(),
                                 "key": int(md.keys[w]), "deadline_ms": 0})
                except OSError:
                    time.sleep(0.05)
                i += 1

        th = threading.Thread(target=traffic, daemon=True)
        th.start()
        try:
            t1 = time.perf_counter()
            while True:
                gates = read_events(ledger_path(out), "gate")
                if len(gates) > n_gates:
                    t_gate = time.perf_counter()
                    break
                require(daemon_proc.poll() is None or len(gates) > n_gates,
                        f"the daemon exited {daemon_proc.returncode} "
                        f"without a gate row")
                require(time.perf_counter() - t1 < 300, "no retrain gated")
                time.sleep(0.02)
            row = gates[-1]
            require(row["promoted"], f"the captured-day retrain was not "
                                     f"promoted: {row['verdict']}")
            while True:
                st = json.loads(_get(base, "/v1/stats"))
                if st["incumbent"]["hash"] == row["candidate_hash"]:
                    t_reload = time.perf_counter()
                    break
                require(time.perf_counter() - t_gate < 120,
                        f"the server never promoted the new slot: "
                        f"{st['incumbent']} {st['canary']}")
                time.sleep(0.02)
        finally:
            stop.set()
            th.join(timeout=60)
        rc = daemon_proc.wait(timeout=300)
        require(rc == 0, f"the capture daemon exited {rc}")
        # (b3) the captured days: bit-equal to the frames sent
        dlog = read_events(daemon_log_path(out), "capture")
        emitted = sorted(d for e in dlog for d in e["days"])
        require(emitted == list(CAPTURE_DAYS)[:-1],
                f"captured days {emitted}")
        for day in emitted:
            got = np.load(os.path.join(out, "accepted", f"day_{day:05d}.npy"))
            require(got.dtype == np.float32
                    and np.array_equal(got, sent[day]),
                    f"captured day {day} differs from the frame sent")
        # (b4) the server answers as a ServeEngine on the promoted slot
        ref = ServeEngine(cfg_ref, data_ref, ServeConfig(
            output_dir=os.path.join(os.path.dirname(out), "serve_ref"),
            buckets=(1,), reload_poll_secs=0), device=device,
            init_ckpt=promoted_path(out))
        bad = []
        for w in range(min(16, len(md))):
            t = ref.submit(md.x[w, ..., 0], int(md.keys[w]), deadline_ms=0)
            require(t.wait(60) and t.ok, f"reference window {w}: {t.error}")
            code, doc = _post(base, {"x": md.x[w, ..., 0].tolist(),
                                     "key": int(md.keys[w]),
                                     "deadline_ms": 0})
            if code != 200 or not np.array_equal(
                    np.asarray(doc["pred"], np.float32), t.pred):
                bad.append(w)
        require(not bad, f"windows {bad} differ from the promoted slot's "
                         f"ServeEngine")
        st = json.loads(_get(base, "/v1/stats"))
        launches = {n: st["kernel_launches"].get(n, 0) for n in KERNEL_META}
        srv.send_signal(15)
        rc = srv.wait(timeout=120)
        require(rc == 0, f"serve exited {rc} on SIGTERM")
    finally:
        for p in (srv, daemon_proc):
            if p is not None and p.poll() is None:
                p.kill()
                p.wait()
        log_s.close()
        if log_d is not None:
            log_d.close()
        if ref is not None:
            ref.close()
    done = read_events(daemon_log_path(out), "retrain_done")
    d_launches, _ = _attempt_launches("[daemon] (b) retrain", done[-1])
    print(f"[daemon] (b) serve --capture-flows up in {up_s:.1f}s; "
          f"{len(emitted)} captured days stitched by the daemon's "
          f"--capture-ledger, bit-equal to the frames sent; attempt "
          f"{row['attempt']} gated ({row['verdict']}), the server's canary "
          f"promoted it {t_reload - t_gate:.2f}s after its gate row "
          f"(promotion -> serve reload; reload poll 0.1 s, 4 canary "
          f"requests); {min(16, len(md))} answers bit-equal to a "
          f"ServeEngine on "
          f"the promoted checkpoint ({card})", flush=True)
    return _add(d_launches, launches)


def phase_daemon(out_dir, card, device="cuda"):
    """Phase 19 (module docstring). Returns the launches of the daemon and
    serve processes."""
    t0 = time.perf_counter()
    total, out = daemon_supervised(out_dir, card, device)
    total = _add(total, daemon_serve_capture(out, card, device))
    print(f"[daemon] phase 19 took {time.perf_counter() - t0:.1f}s; "
          f"launches {_nz(total)}", flush=True)
    return total



# --- phase 20: the operator surface and the scenario engine -----------------

#: the train command run in a child interpreter through the CLI's entry
#: point (cli.main, what ``python -m mpgcn_tpu_torch.cli`` calls), then the
#: process's kernel launches printed last (the wrappers' counters)
OPS_CLI = (
    "import json, sys\n"
    "from mpgcn_tpu_torch import cli\n"
    "from mpgcn_tpu_torch.service.daemon import kernel_launches\n"
    "try:\n"
    "    cli.main(sys.argv[1:])\n"
    "finally:\n"
    "    print('[launches] ' + json.dumps(kernel_launches()), flush=True)\n")
#: the kernel libraries phase 20's cache directory starts with: all of
#: the train path's but bdgcn_pair_fwd, which its first process builds
OPS_PRIMED = ("lstm_infer", "lstm_train", "bdgcn_pair_bwd")
#: the federation's tenants (N=20, obs 5: shape-compatible) and its width
OPS_PROFILES = ("taxi-midtown", "bike-harbor", "metro-loop")
OPS_HIDDEN = "32"


def _ops_log_url(log):
    """The /metrics URL a process printed on its "[obs] /metrics on" line
    (None before it has)."""
    try:
        with open(log) as f:
            for line in f:
                if line.startswith("[obs] /metrics on "):
                    return line.split()[-1]
    except OSError:
        pass
    return None


def _ops_child(argv, log, scrape=False, timeout=600):
    """Run ``argv`` (a list after ``python``) from the checkout with the
    repo on PYTHONPATH, output into ``log``; with ``scrape``, GET its
    /metrics every 50 ms while it runs and keep the last page whose
    ``mpgcn_train_steps_per_sec`` is above 0. Returns (seconds, output,
    kept page or None)."""
    import urllib.request

    t0 = time.perf_counter()
    page = None
    with open(log, "w") as f:
        p = subprocess.Popen([sys.executable, *argv], stdout=f,
                             stderr=subprocess.STDOUT, env=_daemon_env(),
                             cwd=HERE)
        try:
            while p.poll() is None:
                if time.perf_counter() - t0 > timeout:
                    raise RuntimeError(f"{argv[:3]} ran past {timeout}s")
                url = _ops_log_url(log) if scrape else None
                if url:
                    try:
                        with urllib.request.urlopen(url, timeout=5) as r:
                            text = r.read().decode()
                        if _metric(text, "mpgcn_train_steps_per_sec") > 0:
                            page = text
                    except (OSError, RuntimeError):
                        pass
                time.sleep(0.05)
        finally:
            if p.poll() is None:
                p.kill()
            rc = p.wait()
    with open(log) as f:
        out = f.read()
    require(rc == 0, f"{argv[:4]} exited {rc}: {out[-3000:]}")
    return time.perf_counter() - t0, out, page


def _ops_train(tag, argv, out_dir, scrape=False):
    """One train command in its own process: (launches by kernel name,
    seconds, its epoch events, the kept /metrics page)."""
    run_out = os.path.join(out_dir, tag)
    secs, out, page = _ops_child(
        ["-c", OPS_CLI, *argv, "-out", run_out],
        os.path.join(out_dir, f"{tag}.log"), scrape=scrape)
    line = [x for x in out.splitlines() if x.startswith("[launches] ")][-1]
    by_symbol = json.loads(line[len("[launches] "):])
    launches = {n: by_symbol[k.symbol] for n, k in kernels().items()}
    from mpgcn_tpu_torch.utils.logging import read_events

    epochs = read_events(os.path.join(run_out, "MPGCN_train_log.jsonl"),
                         "epoch")
    require(len(epochs) == 2, f"{tag}: {len(epochs)} epoch events")
    return launches, secs, epochs, page


def _hand_kernel_names():
    """The __global__ functions of csrc/: the names the hand kernels
    carry in a device trace."""
    import re

    names = set()
    csrc = os.path.join(HERE, "mpgcn_tpu_torch", "csrc")
    for f in os.listdir(csrc):
        with open(os.path.join(csrc, f)) as fh:
            names.update(re.findall(r"__global__[\s\S]{0,200}?(\w+_kernel)"
                                    r"\s*\(", fh.read()))
    return names


def _ops_trace(tdir, label, cuda=True):
    """The trace file trace_if wrote into ``tdir``: (device kernel events
    by hand-kernel name, every device kernel event, annotation names)."""
    import collections
    import glob

    files = glob.glob(os.path.join(tdir, "*.pt.trace.json"))
    require(len(files) == 1, f"{label}: trace files {files}")
    with open(files[0]) as f:
        events = json.load(f).get("traceEvents", [])
    kern = [e for e in events if e.get("cat") == "kernel"]
    require(kern or not cuda,
            f"{label}: the profiler recorded no CUDA kernel")
    hand = collections.Counter()
    graphed = 0
    names = _hand_kernel_names()
    for e in kern:
        for name in names:
            if name in e.get("name", ""):
                hand[name] += 1
                graphed += any("graph" in k for k in e.get("args", {}))
                break
    notes = collections.Counter(
        e.get("name", "") for e in events
        if e.get("cat") == "user_annotation")
    print(f"[ops] {label}: {os.path.basename(files[0])} "
          f"{os.path.getsize(files[0]) / 2 ** 20:.1f} MiB, "
          f"{len(kern)} device kernels, hand kernels {dict(hand)} "
          f"({graphed} with a graph id)", flush=True)
    return hand, kern, notes


def ops_train(tree, out_dir, card, device="cuda"):
    """(a): the train command traced, with the sidecar and a fresh
    kernel-library directory, against the same command untraced and with
    -no-obs. Returns the launches of the three runs. (``device="cpu"``
    rehearses the plumbing off the card: no kernel, no device trace.)"""
    from mpgcn_tpu_torch.obs.perf.compile_cache import ENV_VAR

    cuda = device == "cuda"
    os.environ.pop(ENV_VAR, None)
    os.makedirs(out_dir)
    cache = os.path.join(out_dir, "kernel_cache")
    os.makedirs(cache)
    if cuda:
        # the directory starts with three of the path's four libraries,
        # as phase 1 built them (a cold process builds one source after
        # another: ~2 minutes of the smoke's limit for all four): the
        # first process builds bdgcn_pair_fwd and the host library into it
        from mpgcn_tpu_torch.native import build

        for name in OPS_PRIMED:
            shutil.copy(build._lib_path(name), cache)
    tdir = os.path.join(out_dir, "trace")
    base = ["-GPU", "0" if cuda else "cpu", "-in", tree, "-data", "npz",
            "-epoch", "2", "-compile-cache", cache]
    # 1: cold directory, untraced, the sidecar scraped
    cold, cold_s, cold_ep, cold_page = _ops_train(
        "cold", base + ["-metrics-port", "0"], out_dir, scrape=True)
    # 2: the traced command, the second process on the directory
    traced, traced_s, traced_ep, page = _ops_train(
        "traced", base + ["-trace", tdir, "-metrics-port", "0"], out_dir,
        scrape=True)
    # 3: without telemetry, in this process (warm: its kernels loaded,
    # its context up), on the default library directory
    from mpgcn_tpu_torch.utils.logging import read_events

    bare_out = os.path.join(out_dir, "no_obs")
    _, bare, bare_s, _ = _cli(base[:-2] + ["-no-obs", "-out", bare_out])
    bare_ep = read_events(os.path.join(bare_out, "MPGCN_train_log.jsonl"),
                          "epoch")
    require(_nz(cold) == _nz(traced) == _nz(bare)
            and (_nz(cold) or not cuda),
            f"launches untraced {_nz(cold)}, traced {_nz(traced)}, "
            f"-no-obs {_nz(bare)}")
    for label, p in (("cold", cold_page), ("traced", page)):
        require(p is not None, f"{label}: no /metrics page with steps/s > 0")
        for fam in ("mpgcn_train_steps_per_sec", "mpgcn_train_epoch_seconds",
                    "mpgcn_graph_support_density", "mpgcn_train_loss_scale",
                    "mpgcn_cuda_program_builds",
                    "mpgcn_kernel_cache_hits", "mpgcn_slo_state"):
            require(f"# TYPE {fam}" in p, f"{label}: /metrics lacks {fam}")
    for label, eps in (("cold", cold_ep), ("traced", traced_ep)):
        require(all("metrics" in e for e in eps),
                f"{label}: an epoch event without metrics")
    require(not any("metrics" in e for e in bare_ep),
            "-no-obs: an epoch event carries metrics")
    for key in ("train_loss", "validate_loss"):
        a = [e[key] for e in cold_ep]
        require(a == [e[key] for e in bare_ep]
                == [e[key] for e in traced_ep],
                f"{key}: telemetry {a}, -no-obs {[e[key] for e in bare_ep]}"
                f", traced {[e[key] for e in traced_ep]}")
    m_cold, m_warm = cold_ep[-1]["metrics"], traced_ep[-1]["metrics"]
    built = _snap(m_cold, "cuda_program_builds", kind="kernel_library")
    missed = _snap(m_cold, "kernel_cache_misses")
    hit = _snap(m_cold, "kernel_cache_hits")
    require(built == (1 if cuda else 0) and missed == built + 1
            and hit == (len(OPS_PRIMED) if cuda else 0),
            f"cold directory: {built} libraries built, {missed} misses, "
            f"{hit} hits")
    require(_snap(m_warm, "cuda_program_builds", kind="kernel_library") == 0
            and _snap(m_warm, "kernel_cache_misses") == 0
            and _snap(m_warm, "kernel_cache_hits") == missed + hit,
            f"second process: builds "
            f"{_snap(m_warm, 'cuda_program_builds', kind='kernel_library')}"
            f", misses {_snap(m_warm, 'kernel_cache_misses')}, hits "
            f"{_snap(m_warm, 'kernel_cache_hits')} (first: {missed} misses)")
    hand, kern, notes = _ops_trace(tdir, "train trace", cuda)
    for name, n in _nz(traced).items():
        require(notes.get(kernels()[name].symbol, 0) > 0,
                f"the trace names no eager launch of {name}")
    for name in ("lstm_fwd_kernel", "lstm_train_bwd_kernel"):
        require(hand.get(name) or not cuda, f"the trace holds no {name}")
    require(any(n.startswith("tf32_") for n in hand) or not cuda,
            "the trace holds no K-BDGCN product kernel")
    require(sum(hand.values()) >= sum(traced.values()),
            f"{sum(hand.values())} hand kernels in the trace for "
            f"{sum(traced.values())} counted launches (graph replays "
            f"missing)")
    require(any(k.startswith("train_step#") for k in notes),
            "the trace has no step annotation")
    sps = {k: e[-1]["steps_per_sec"] for k, e in
           (("untraced", cold_ep), ("traced", traced_ep),
            ("no-obs", bare_ep))}
    print(f"[ops] (a) train -epoch 2 at N=47: launches equal traced, "
          f"untraced and -no-obs {_nz(traced)}; steps/s {sps} (step "
          f"{1e3 / sps['no-obs']:.3f} ms warm without the profiler, "
          f"{1e3 / sps['traced']:.3f} ms under it); process "
          f"{cold_s:.1f} s cold ({built:.0f} kernel library built, "
          f"{missed:.0f} misses with the host library, {hit:.0f} hits), "
          f"{traced_s:.1f} s traced warm (0 built, "
          f"{_snap(m_warm, 'kernel_cache_hits'):.0f} hits); -no-obs in "
          f"this process {bare_s:.1f} s; losses bit-equal with and without "
          f"telemetry ({card})", flush=True)
    return [cold, traced, bare]


def _ops_request(base, body, trace):
    import urllib.request

    req = urllib.request.Request(
        base + "/v1/predict", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json",
                 "X-MPGCN-Trace": trace})
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.load(r)


def _ops_cmd(args, log, timeout=120):
    """``python -m mpgcn_tpu_torch.cli <args>``: (rc, output)."""
    with open(log, "w") as f:
        rc = subprocess.run([sys.executable, "-m", "mpgcn_tpu_torch.cli",
                             *args], stdout=f, stderr=subprocess.STDOUT,
                            env=_daemon_env(), cwd=HERE,
                            timeout=timeout).returncode
    with open(log) as f:
        return rc, f.read()


def _json_tail(out):
    """The JSON document a command printed last (from its first line that
    opens one)."""
    lines = out.splitlines()
    start = max(i for i, x in enumerate(lines) if x.startswith(("{", "[")))
    return json.loads("\n".join(lines[start:]))


def ops_serve(out_dir, cache, card, device="cuda"):
    """(b): serve --profile taxi-midtown -trace, then stats and slo live
    and offline and one request's stitched trace. Returns its launches."""
    from mpgcn_tpu_torch.obs.trace import TRACE_HEADER
    from mpgcn_tpu_torch.scenarios.profiles import generate, get_profile

    require(TRACE_HEADER == "X-MPGCN-Trace", TRACE_HEADER)
    svc, tdir = os.path.join(out_dir, "svc"), os.path.join(out_dir, "trace")
    prof = get_profile("taxi-midtown")
    od = generate(prof, days=prof.obs_len + 1)["od"]
    log = open(os.path.join(out_dir, "serve.log"), "w")
    p = subprocess.Popen(
        [sys.executable, "-m", "mpgcn_tpu_torch.cli", "serve", "--device",
         device, "-out", svc, "--profile", prof.name, "-trace", tdir, "--allow-fresh-init",
         "-hidden", OPS_HIDDEN, "--buckets", "1,2", "--compile-cache",
         cache], stdout=log, stderr=subprocess.STDOUT, env=_daemon_env(),
        cwd=HERE)
    try:
        info = os.path.join(svc, "serve", "http.json")
        _wait_for(lambda: os.path.exists(info) or p.poll() is not None,
                  180, "serve's http.json")
        require(p.poll() is None, "serve exited at startup")
        with open(info) as f:
            addr = json.load(f)
        base = f"http://{addr['host']}:{addr['port']}"
        x = np.log1p(od[:prof.obs_len])
        for i in range(6):
            ans = _ops_request(base, {"x": x.tolist(), "key": i % 7},
                               f"ops{i}")
            require(ans.get("outcome") == "ok", f"request {i}: {ans}")
        st = json.loads(_get(base, "/v1/stats"))
        launches = dict(st["kernel_launches"])
        rc, out = _ops_cmd(["stats", "-out", svc, "--json"],
                           os.path.join(out_dir, "stats_live.log"))
        live = _json_tail(out)
        require(rc == 0 and "live" in live
                and live["requests"]["n"] >= 6, f"stats live: {out[-2000:]}")
        rc, out = _ops_cmd(["slo", "-out", svc, "--json"],
                           os.path.join(out_dir, "slo_live.log"))
        slo_live = _json_tail(out)
        require(rc == 0 and slo_live["source"] == "live"
                and slo_live["slos"], f"slo live: {out[-2000:]}")
    finally:
        if p.poll() is None:
            p.send_signal(signal.SIGTERM)
        rc = p.wait(timeout=180)
        log.close()
    require(rc == 0, f"serve exited {rc}")
    rc, out = _ops_cmd(["stats", "-out", svc, "--json"],
                       os.path.join(out_dir, "stats_offline.log"))
    off = _json_tail(out)
    require(rc == 0 and "live" not in off and off["spans"]["traces"] >= 6,
            f"stats offline: {out[-2000:]}")
    rc, out = _ops_cmd(["slo", "-out", svc, "--json"],
                       os.path.join(out_dir, "slo_offline.log"))
    slo_off = _json_tail(out)
    require(rc == 0 and slo_off["source"] == "ledger"
            and slo_off["rows"] >= 6, f"slo offline: {out[-2000:]}")
    rc, out = _ops_cmd(["stats", "-out", svc, "--trace", "ops3", "--json"],
                       os.path.join(out_dir, "stats_trace.log"))
    roots = _json_tail(out)
    chain = []
    node = roots[0] if len(roots) == 1 else None
    while node is not None:
        chain.append(node["name"])
        node = node["children"][0] if len(node["children"]) == 1 else None
    require(rc == 0 and chain == ["serve.request", "serve.batcher",
                                  "serve.model"], f"stats --trace: {out}")
    hand, _, notes = _ops_trace(tdir, "serve trace", device == "cuda")
    require((hand.get("lstm_fwd_kernel") or device != "cuda") and any(
        k.startswith("serve_batch#") for k in notes),
        f"serve trace: hand kernels {dict(hand)}")
    print(f"[ops] (b) serve --profile {prof.name} (N={prof.num_nodes}, "
          f"obs {prof.obs_len}, hidden {OPS_HIDDEN}): 6 requests; stats "
          f"live and offline, slo live ({[s['state'] for s in slo_live['slos']]}"
          f") and offline ({slo_off['rows']} rows), --trace ops3 -> "
          f"{' -> '.join(chain)} ({card})", flush=True)
    return {n: launches.get(n, 0) for n in KERNEL_META}


def ops_federation(out_dir, cache, card, device="cuda"):
    """(c): scenario run over three profiles on the card, stats on the
    root, then transfer_ab from taxi-midtown's promoted checkpoint.
    Returns the launches of the retrains and of the A/B."""
    from mpgcn_tpu_torch.scenarios.transfer import transfer_ab
    from mpgcn_tpu_torch.utils.logging import read_events

    root = os.path.join(out_dir, "fleet")
    env_cache = dict(os.environ)
    os.environ["MPGCN_COMPILE_CACHE"] = cache  # the run's libraries
    try:
        rc, out = _ops_cmd(["scenario", "run", "-out", root, "--profiles",
                            ",".join(OPS_PROFILES), "-hidden", OPS_HIDDEN,
                            "--device", device, "--json"],
                           os.path.join(out_dir, "scenario_run.log"),
                           timeout=600)
    finally:
        os.environ.clear()
        os.environ.update(env_cache)
    require(rc == 0, f"scenario run exited {rc}: {out[-3000:]}")
    report = _json_tail(out)
    total = {n: 0 for n in KERNEL_META}
    symbols = {k.symbol: n for n, k in kernels().items()}
    rows = []
    for tid in OPS_PROFILES:
        sec = report["tenants"][tid]
        require(sec["promoted"] >= 1, f"{tid}: {sec}")
        events = read_events(os.path.join(root, "tenants", tid,
                                          "daemon_log.jsonl"))
        for attempt, _, secs, graphs, reserved, libs, e in \
                _retrain_report(events):
            require(libs == 0, f"{tid}: {libs} kernel libraries built")
            rows.append((tid, attempt, secs, graphs, reserved))
            for s, name in symbols.items():
                total[name] += int(_snap(e["metrics"],
                                         "daemon_retrain_launches",
                                         kernel=s))
    reserved = [r[4] for r in rows]
    require(max(reserved) <= reserved[0] + 2 ** 21,
            f"memory_reserved after each tenant's retrains: {reserved}")
    rc, out = _ops_cmd(["stats", "-out", root, "--json"],
                       os.path.join(out_dir, "stats_fleet.log"))
    fed = _json_tail(out).get("federation")
    require(rc == 0 and fed and fed["cross_tenant"]["tenants_total"] == 3,
            f"stats federation: {out[-2000:]}")
    for tid, attempt, secs, graphs, res in rows:
        print(f"[ops] (c) {tid} retrain {attempt}: {secs:.2f} s, "
              f"{graphs:.0f} graph captures, memory_reserved after it "
              f"{res / 2 ** 20:.1f} MiB ({card})", flush=True)
    donor = os.path.join(root, "tenants", "taxi-midtown", "promoted",
                         "MPGCN_od.pkl")
    reset_counts()
    t0 = time.perf_counter()
    ab = transfer_ab("taxi-riverside", donor, os.path.join(out_dir, "ab"),
                     hidden_dim=int(OPS_HIDDEN), device=device)
    ab_s = time.perf_counter() - t0
    if device == "cuda":
        total = _add(total, read_counts())
    require(ab["scratch_steps_to_promote"], f"transfer_ab: {ab}")
    print(f"[ops] (c) federation cross-tenant {json.dumps(fed['cross_tenant'])}"
          f"; transfer_ab taxi-riverside <- taxi-midtown: steps to promote "
          f"warm {ab['warm_steps_to_promote']} scratch "
          f"{ab['scratch_steps_to_promote']} ({ab['steps_per_epoch']} a "
          f"epoch, bar {ab['bar_val_loss']}), {ab_s:.1f} s ({card})",
          flush=True)
    return total


def ops_daemon(out_dir, cache, card, device="cuda"):
    """(d): scenario gen, then daemon --profile metro-loop --metrics-port
    0, scraped once while it runs. Returns its retrains' launches."""
    from mpgcn_tpu_torch.service.daemon import daemon_log_path
    from mpgcn_tpu_torch.utils.logging import read_events

    spool, svc = os.path.join(out_dir, "spool"), os.path.join(out_dir, "svc")
    rc, out = _ops_cmd(["scenario", "gen", "-profile", "metro-loop", "-out",
                        spool, "--days", "34"],
                       os.path.join(out_dir, "gen.log"))
    require(rc == 0 and "wrote 34 day file(s)" in out, f"gen: {out}")
    log = os.path.join(out_dir, "daemon.log")
    page = []

    def scrape():
        # the sidecar is up before the daemon registers its series: the
        # page kept is the first that holds them
        url = _ops_log_url(log)
        if url and not page:
            try:
                text = _get(url.rsplit("/metrics", 1)[0], "/metrics",
                            timeout=5)
            except OSError:
                return
            if "# TYPE mpgcn_daemon_days_total counter" in text:
                page.append(text)

    with open(log, "w") as f:
        p = subprocess.Popen(
            [sys.executable, "-m", "mpgcn_tpu_torch.cli", "daemon",
             "--device", device, "--profile", "metro-loop", "-spool", spool, "-out", svc,
             "--metrics-port", "0", "--compile-cache", cache, "-hidden",
             OPS_HIDDEN, "-epoch", "3", "--window-days", "34",
             "--val-days", "3", "--holdout-days", "4",
             "--retrain-cadence", "4", "--idle-exits", "2",
             "--poll-secs", "0.2"], stdout=f, stderr=subprocess.STDOUT,
            env=_daemon_env(), cwd=HERE)
        t0 = time.perf_counter()
        while p.poll() is None and time.perf_counter() - t0 < 300:
            scrape()
            time.sleep(0.05)
        if p.poll() is None:
            p.kill()
        rc = p.wait()
    with open(log) as f:
        text = f.read()
    require(rc == 0, f"daemon exited {rc}: {text[-3000:]}")
    require(page, "daemon /metrics: no page with the daemon's series "
                  "while it ran")
    require("scenario profile 'metro-loop'" in text, text[-2000:])
    total = {n: 0 for n in KERNEL_META}
    symbols = {k.symbol: n for n, k in kernels().items()}
    done = read_events(daemon_log_path(svc), "retrain_done")
    require(done and done[-1]["promoted"], f"daemon retrains: {done}")
    for e in done:
        for s, name in symbols.items():
            total[name] += int(_snap(e["metrics"], "daemon_retrain_launches",
                                     kernel=s))
    print(f"[ops] (d) daemon --profile metro-loop --metrics-port 0: scraped "
          f"{len(page[0].splitlines())} lines, {len(done)} retrain(s), "
          f"promoted ({card})", flush=True)
    return total


def phase_ops(out_dir, card, device="cuda"):
    """Phase 20, [ops]: the operator surface and the scenario engine.
    Returns the launches of its processes and of transfer_ab."""
    t0 = time.perf_counter()
    tree = os.path.join(out_dir, "data")
    os.makedirs(tree)
    write_reference_tree(tree)
    total = {n: 0 for n in KERNEL_META}
    for counts in ops_train(tree, os.path.join(out_dir, "train"), card,
                            device):
        total = _add(total, counts)
    cache = os.path.join(out_dir, "train", "kernel_cache")
    print(f"[ops] (a) took {time.perf_counter() - t0:.1f}s", flush=True)
    for sub, fn in (("serve", ops_serve), ("federation", ops_federation),
                    ("daemon", ops_daemon)):
        t1 = time.perf_counter()
        d = os.path.join(out_dir, sub)
        os.makedirs(d)
        total = _add(total, fn(d, cache, card, device))
        print(f"[ops] {sub} took {time.perf_counter() - t1:.1f}s",
              flush=True)
    print(f"[ops] phase 20 took {time.perf_counter() - t0:.1f}s ({card})",
          flush=True)
    return total


# --- phase 21: self-tuning dispatch ------------------------------------------

#: phase 21 (b): the train CLI's flags over phase 15's banded N=500 series
#: at hidden 32, batch 4, one epoch, both arms left to `auto`
TUNE_CITY_ARGV = ["-GPU", "0", "-data", "synthetic", "-sN", "500", "-sT",
                  "60", "-hidden", "32", "-batch", "4", "-epoch", "1",
                  "-bdgcn", "auto", "-od-storage", "auto"]
#: the hand kernels phase 21 (a)'s harnesses run: the epoch harnesses
#: (f32, dense kernel arm) and the sparse crossover's two bf16 + remat arms
TUNE_KERNELS = ("lstm_train_fwd", "lstm_train_bwd", "bdgcn_pair_fwd",
                "bdgcn_pair_bwd", "ell_fwd", "ell_bwd_dx",
                "lstm_train_fwd_bf16", "lstm_train_bwd_bf16",
                "bdgcn_pair_fwd_bf16", "bdgcn_pair_bwd_bf16")


def _child_launches(out):
    """A child's launches by kernel name, from the [launches] line that
    OPS_CLI prints."""
    line = [x for x in out.splitlines() if x.startswith("[launches] ")][-1]
    by_symbol = json.loads(line[len("[launches] "):])
    return {n: by_symbol[k.symbol] for n, k in kernels().items()}


def tune_run(tuned, out_dir, card):
    """(a): `tune run` with every harness meaningful on the card at its
    JAX shape. Returns (launches, the profile's constants)."""
    from mpgcn_tpu_torch.tune.registry import profile_path

    secs, out, _ = _ops_child(
        ["-c", OPS_CLI, "tune", "run", "--tuned-dir", tuned],
        os.path.join(out_dir, "tune_run.log"), timeout=600)
    path = profile_path("cuda", tuned)
    require(f"[tune] wrote {path}" in out, f"tune run: {out[-3000:]}")
    with open(path) as f:
        prof = json.load(f)
    consts, prov = prof["constants"], prof["provenance"]
    require(prof["platform"] == "torch-cuda", f"platform {prof['platform']}")
    require(sorted(consts) == ["epoch_scan_max_mb", "sparse_density_threshold",
                               "stream_chunk_mb"], f"constants {consts}")
    require(prov.get("nvidia_smi") == card and prov.get("cuda"),
            f"provenance {prov}")
    for name, e in sorted(consts.items()):
        require(e["curve"], f"{name}: no curve")
        print(f"[tune] (a) {name} = {e['value']} ({e['harness']}); curve "
              f"{json.dumps(e['curve'])} ({card})", flush=True)
    launches = _child_launches(out)
    idle = [n for n in TUNE_KERNELS if not launches[n]]
    require(not idle, f"tune run launched no {idle}: {_nz(launches)}")
    print(f"[tune] (a) tune run: {secs:.1f}s, launches {_nz(launches)}; "
          f"provenance {json.dumps(prov, sort_keys=True)}", flush=True)
    return launches, {n: e["value"] for n, e in consts.items()}


def tune_city(dev, data_l, out_dir, tuned_values, card):
    """(b): -bdgcn auto -od-storage auto on phase 15's banded N=500 series
    through the train CLI's config, once on the profile and once with
    -sparse-threshold 0.25: the [dispatch] line's arm and the [tune]
    line's source. Returns the launches."""
    import io

    from mpgcn_tpu_torch import cli
    from mpgcn_tpu_torch.train.trainer import ModelTrainer
    from mpgcn_tpu_torch.tune import registry

    threshold = tuned_values["sparse_density_threshold"]
    total = {n: 0 for n in KERNEL_META}
    for tag, extra, source, t in (
            ("tuned", [], "(tuned profile ", threshold),
            ("explicit", ["-sparse-threshold", "0.25"], "(explicit knob)",
             0.25)):
        args = cli.build_parser().parse_args(
            TUNE_CITY_ARGV + extra + ["-out", os.path.join(out_dir, tag)]
        ).__dict__
        bdgcn = args["bdgcn_impl"]
        cfg = cli.config_from_args(args).replace(num_nodes=500)
        registry._reset_cache()  # this run's one-time [tune] lines
        buf = io.StringIO()
        t0 = time.perf_counter()
        reset_counts()
        with contextlib.redirect_stdout(buf):
            tr = ModelTrainer(cfg, data_l, device=dev, bdgcn_impl=bdgcn)
            hist = tr.train()
        counts = read_counts()
        secs = time.perf_counter() - t0
        out = buf.getvalue()
        density = tr.pipeline.support_density
        want = "ell" if density <= t else "kernel"
        line = next(x for x in out.splitlines()
                    if x.startswith("[dispatch] bdgcn_impl="))
        exec_line = next(x for x in out.splitlines()
                         if x.startswith("[dispatch] epoch_exec:"))
        tune_lines = [x for x in out.splitlines() if x.startswith("[tune]")]
        require(line.startswith(f"[dispatch] bdgcn_impl={want} "
                                f"(requested 'auto')"), f"{tag}: {line}")
        require(any(x.startswith(f"[tune] sparse_density_threshold = {t} "
                                 + source) for x in tune_lines),
                f"{tag}: {tune_lines}")
        arm = (("ell_fwd", "ell_bwd_dx") if want == "ell"
               else ("bdgcn_pair_fwd", "bdgcn_pair_bwd"))
        require(all(counts[n] > 0 for n in arm)
                and np.isfinite(hist["train"]).all(),
                f"{tag}: {_nz(counts)}, losses {hist['train']}")
        print(f"[tune] (b) {tag}: {line}; {exec_line}; "
              f"{' | '.join(tune_lines)}; 1 epoch {secs:.1f}s, launches "
              f"{_nz(counts)} ({card})", flush=True)
        tr.close()
        del tr
        total = _add(total, counts)
    return total


def tune_serve(tuned, ledger, out_dir, card):
    """(c): `tune buckets --platform cuda --write` on a request ledger of
    phase 16, then `serve` on the card on that profile: serve_start and
    /v1/stats list the planned buckets, slots x buckets x horizons
    graphs, requests answered. Returns its launches."""
    from mpgcn_tpu_torch.data.loader import synthetic_od
    from mpgcn_tpu_torch.tune.registry import profile_path

    rc, out = _ops_cmd(["tune", "buckets", "--trace", ledger, "--platform",
                        "cuda", "--write", "--tuned-dir", tuned],
                       os.path.join(out_dir, "buckets.log"))
    require(rc == 0, f"tune buckets: {out[-2000:]}")
    cmp = json.loads(out.split("\n[tune] wrote")[0])
    with open(profile_path("cuda", tuned)) as f:
        consts = json.load(f)["constants"]
    buckets = consts["serve_buckets"]["value"]
    horizons = consts.get("serve_horizons", {}).get("value", [])
    require(buckets == cmp["planned_buckets"], f"{buckets} {cmp}")
    print(f"[tune] (c) tune buckets on {cmp['requests']} requests of "
          f"{os.path.relpath(ledger, HERE)}: planned {buckets} x horizons {horizons} against "
          f"{cmp['default_buckets']} (pad waste {cmp['pad_waste_planned']} "
          f"against {cmp['pad_waste_default']}, {cmp['planned_compiles']} "
          f"against {cmp['default_compiles']} captures a slot)", flush=True)
    svc = os.path.join(out_dir, "svc")
    log = open(os.path.join(out_dir, "serve.log"), "w")
    t0 = time.perf_counter()
    p = subprocess.Popen(
        [sys.executable, "-m", "mpgcn_tpu_torch.cli", "serve", "--device",
         "cuda", "-out", svc, "--allow-fresh-init"], stdout=log,
        stderr=subprocess.STDOUT, env=_daemon_env(), cwd=HERE)
    try:
        info = os.path.join(svc, "serve", "http.json")
        _wait_for(lambda: os.path.exists(info) or p.poll() is not None,
                  180, "serve's http.json")
        require(p.poll() is None, "serve exited at startup")
        up_s = time.perf_counter() - t0
        with open(info) as f:
            port = json.load(f)["port"]
        base = f"http://127.0.0.1:{port}"
        st = json.loads(_get(base, "/v1/stats"))
        want_h = horizons or [1]
        require(st["buckets"] == buckets and st["horizons"] == want_h
                and st["traces"] == 2 * len(buckets) * len(want_h),
                f"/v1/stats buckets {st['buckets']} horizons "
                f"{st['horizons']} graphs {st['traces']}")
        od = synthetic_od(8, 47, 0)
        x = np.log1p(od[:7])
        bodies = [json.dumps({"x": (x * (1 + 0.01 * i)).tolist(),
                              "key": i % 7}).encode() for i in range(8)]
        res, wall = _http_load(port, bodies, 4, 8)
        bad = [(w, s_, a.get("outcome")) for w, s_, a, _ in res
               if s_ != 200 or a.get("outcome") != "ok"
               or not np.isfinite(np.asarray(a["pred"], np.float32)).all()]
        require(not bad, f"answers on the planned buckets: {bad[:4]}")
        st = json.loads(_get(base, "/v1/stats"))
        used = sorted(int(b) for b in st["pad_waste"]["by_bucket"])
        require(set(used) <= set(buckets), f"batches in buckets {used}")
        launches = dict(st["kernel_launches"])
    finally:
        if p.poll() is None:
            p.send_signal(signal.SIGTERM)
        rc = p.wait(timeout=180)
        log.close()
    require(rc == 0, f"serve exited {rc}")
    with open(os.path.join(out_dir, "serve.log")) as f:
        out = f.read()
    require(f"[tune] serve_buckets = {tuple(buckets)} (tuned profile " in out,
            f"serve's [tune] line: {out[-2000:]}")
    from mpgcn_tpu_torch.utils.logging import read_events

    start = next(r for r in read_events(os.path.join(
        svc, "serve", "requests.jsonl")) if r["event"] == "serve_start")
    require(start["buckets"] == buckets, f"serve_start {start}")
    print(f"[tune] (c) serve on the profile: up in {up_s:.1f}s, "
          f"serve_start and /v1/stats buckets {buckets}, horizons {want_h}, "
          f"{2 * len(buckets) * len(want_h)} graphs (2 slots x "
          f"{len(buckets)} x {len(want_h)}); 32 requests from 4 clients in "
          f"{wall:.2f}s, all ok and finite, batches in buckets {used}; "
          f"launches {_nz(launches)} ({card})", flush=True)
    return {n: launches.get(n, 0) for n in KERNEL_META}


def phase_tune(dev, data_l, ledger, out_dir, card):
    """Phase 21, [tune]: (a) `tune run`, (b) the city's `auto` on the
    profile and with an explicit flag, (c) `tune buckets` then `serve`;
    all on a profile directory under ``out_dir``. Returns the launches."""
    t0 = time.perf_counter()
    tuned = os.path.join(out_dir, "tuned")
    old = os.environ.get("MPGCN_TUNED_DIR")
    os.environ["MPGCN_TUNED_DIR"] = tuned
    try:
        total, values = tune_run(tuned, out_dir, card)
        t1 = time.perf_counter()
        total = _add(total, tune_city(dev, data_l, out_dir, values, card))
        print(f"[tune] (b) took {time.perf_counter() - t1:.1f}s", flush=True)
        t1 = time.perf_counter()
        total = _add(total, tune_serve(tuned, ledger, out_dir, card))
        print(f"[tune] (c) took {time.perf_counter() - t1:.1f}s", flush=True)
    finally:
        if old is None:
            os.environ.pop("MPGCN_TUNED_DIR", None)
        else:
            os.environ["MPGCN_TUNED_DIR"] = old
    print(f"[tune] phase 21 took {time.perf_counter() - t0:.1f}s ({card}); "
          f"launches {_nz(total)}", flush=True)
    return total


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
    from mpgcn_tpu_torch.data.pipeline import DataPipeline

    # full f32 on the plain paths: no TF32 in matmuls or cuDNN
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()
    # every phase before 21 (and its children) on the guessed defaults,
    # whatever tuned/ holds: a profile directory that does not exist
    os.environ["MPGCN_TUNED_DIR"] = os.path.join(HERE, "smoke_out",
                                                 "no_profile")
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


    # the sparse path: N=500, banded density 0.05, batch 2, reference widths
    t0 = time.perf_counter()
    cfg_l = MPGCNConfig(**LARGE_N)
    data_l = large_n_data(cfg_l)
    pipe = DataPipeline(cfg_l.replace(pred_len=1), data_l, dev)
    print(f"[large-N] data and banks in {time.perf_counter() - t0:.1f}s: "
          f"{pipe.dispatch_line('kernel')}", flush=True)
    require(pipe.bdgcn_impl == "ell", f"auto resolved to {pipe.bdgcn_impl}")
    ell_errors, dblk_launches, ell_inputs = phase_ell_kernels(
        dev, pipe.banks, rng)
    errors.update(ell_errors)
    del pipe
    cfg_l = cfg_l.replace(seed=live_init_seed(cfg_l, data_l, dev))
    out_l = os.path.join(HERE, "smoke_out", "large_n")
    shutil.rmtree(out_l, ignore_errors=True)
    os.makedirs(out_l)
    large = phase_large_n_train(dev, cfg_l, data_l, out_l)
    spmm = 7 * cfg_l.num_branches * cfg_l.gcn_num_layers * (1 + cfg_l.support_K)
    eng_l, launches_l = serve_phase(
        "large-N", cfg_l, data_l, dev, groups=(1, 2),
        expect_per_batch={"lstm_infer_last": 14, "ell_fwd": spmm},
        expect_buckets=(1, 2), buckets=(1, 2))
    print(f"[large-N] resident supports, f32 tiles: "
          f"{json.dumps(eng_l.stats()['support'])}", flush=True)
    eng_q, launches_q = serve_phase(
        "large-N int8", cfg_l.replace(support_payload="int8"), data_l, dev,
        groups=(1, 2),
        expect_per_batch={"lstm_infer_last": 14, "ell_fwd_q": spmm},
        expect_buckets=(1, 2), buckets=(1, 2))
    support_q = eng_q.stats()["support"]
    print(f"[large-N] resident supports, int8 tiles: {json.dumps(support_q)}",
          flush=True)
    require(support_q["reduction"] >= 3,
            f"int8 resident-support reduction {support_q['reduction']} < 3")
    eng_q.drain()
    eng_q.close()
    int8_counts = phase_int8_train(dev, cfg_l, data_l, large["batches"])
    for counts in (large["train_counts"], large["test_counts"], launches_l,
                   launches_q, int8_counts, {"ell_bwd_dblk": dblk_launches}):
        total = _add(total, counts)

    times = phase_times(dev, eng, kernel_inputs)
    times.update(phase_train_times(dev, train_inputs, train))
    eng.drain()
    eng.close()
    times.update(phase_ell_times(dev, ell_inputs))
    phase_large_n_times(dev, large, eng_l, data_l)
    eng_l.drain()
    eng_l.close()

    # the wide widths last, so every phase before them (and its times)
    # runs as it did without them; their own seeded inputs
    wide_errors, wide_inputs = phase_wide_kernels(dev,
                                                  np.random.default_rng(7))
    for name, e in wide_errors.items():
        errors[name] = max(errors[name], e)
    out_w = os.path.join(HERE, "smoke_out", "wide")
    shutil.rmtree(out_w, ignore_errors=True)
    os.makedirs(out_w)
    wide = phase_wide_model(dev, data, out_w)
    for counts in wide["counts"]:
        total = _add(total, counts)
    phase_wide_times(dev, wide_inputs, wide)
    wide_seed = wide["trainer"].cfg.seed
    wide["eng"].drain()
    wide["eng"].close()
    # after every phase above, so each runs as it did without them
    phase_large_n_int8_times(dev, large, data_l)
    del large, eng_l, ell_inputs, wide, wide_inputs
    torch.cuda.empty_cache()
    phase_large_n_lstm_times(dev)

    # the reference command on a dataset file, after every phase above
    out_r = os.path.join(HERE, "smoke_out", "reference_cli")
    shutil.rmtree(out_r, ignore_errors=True)
    os.makedirs(out_r)
    for counts in phase_reference_cli(dev, out_r):
        total = _add(total, counts)

    # the epoch executor and the graphs, after every phase above
    card = card_name_and_limit()
    out_g = os.path.join(HERE, "smoke_out", "graphs")
    shutil.rmtree(out_g, ignore_errors=True)
    os.makedirs(out_g)
    total = _add(total, phase_executor(dev, cfg, data, out_g, card))
    total = _add(total, phase_graph_rollouts(dev, eng, card))
    total = _add(total, phase_graph_wide(dev, data, wide_seed, card))
    torch.cuda.empty_cache()
    total = _add(total, phase_graph_large_n(
        dev, cfg_l, data_l, os.path.join(out_g, "large_n")))

    # the self-healing trainer, after every phase above
    out_h = os.path.join(HERE, "smoke_out", "heal")
    shutil.rmtree(out_h, ignore_errors=True)
    os.makedirs(out_h)
    total = _add(total, phase_self_healing(dev, cfg, data, cfg_l, data_l,
                                           out_h, card))

    # the precision plane, after every phase above
    out_p = os.path.join(HERE, "smoke_out", "precision")
    shutil.rmtree(out_p, ignore_errors=True)
    os.makedirs(out_p)
    p_errors, p_times, p_total = phase_precision(
        dev, cfg, data, cfg_l, data_l, out_p, out_r, card)
    errors.update(p_errors)
    times.update(p_times)
    total = _add(total, p_total)

    # the city-scale feed, after every phase above
    out_c = os.path.join(HERE, "smoke_out", "city_feed")
    shutil.rmtree(out_c, ignore_errors=True)
    os.makedirs(out_c)
    total = _add(total, phase_city_feed(dev, cfg, data, cfg_l, data_l,
                                        out_c, card))

    # the serving plane over HTTP, after every phase above
    out_s = os.path.join(HERE, "smoke_out", "serve_http")
    shutil.rmtree(out_s, ignore_errors=True)
    os.makedirs(out_s)
    total = _add(total, phase_serve_http(dev, cfg, data, out_dir, out_s,
                                         card))

    # the multi-tenant fleet, after every phase above
    out_f = os.path.join(HERE, "smoke_out", "fleet")
    shutil.rmtree(out_f, ignore_errors=True)
    os.makedirs(out_f)
    fleet_total, fleet = phase_fleet(
        dev, cfg, data, out_dir,
        os.path.join(out_s, "candidate", "MPGCN_od_last.pkl"), out_f, card)
    total = _add(total, fleet_total)

    # the router tier over serve --fleet replicas, after every phase above
    out_t = os.path.join(HERE, "smoke_out", "router")
    shutil.rmtree(out_t, ignore_errors=True)
    os.makedirs(out_t)
    total = _add(total, phase_router(cfg, fleet, out_t, card))

    # the continual-learning daemon and its supervisor, after every phase
    out_d = os.path.join(HERE, "smoke_out", "daemon")
    shutil.rmtree(out_d, ignore_errors=True)
    os.makedirs(out_d)
    total = _add(total, phase_daemon(out_d, card))

    # the operator surface and the scenario engine, after every phase
    out_o = os.path.join(HERE, "smoke_out", "ops")
    shutil.rmtree(out_o, ignore_errors=True)
    os.makedirs(out_o)
    total = _add(total, phase_ops(out_o, card))

    # self-tuning dispatch, after every phase (its own profile directory)
    out_u = os.path.join(HERE, "smoke_out", "tune")
    shutil.rmtree(out_u, ignore_errors=True)
    os.makedirs(out_u)
    total = _add(total, phase_tune(
        dev, data_l, os.path.join(out_s, "command", "serve",
                                  "requests.jsonl"), out_u, card))

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
