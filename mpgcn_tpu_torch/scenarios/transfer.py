"""Cross-city transfer: warm-start a new city from a donor checkpoint
(counterpart of mpgcn_tpu/scenarios/transfer.py).

When a tenant joins the fleet, its first model can start from the most
similar trained city's checkpoint (``ModelTrainer.warm_start``) instead
of from scratch. Two pieces:

  * donor selection: ``profile_similarity`` scores two profiles on
    modality (the weekly signature is what transfers), declared graph
    statistics, flow scale, horizon and zone count; ``rank_donors`` and
    ``select_donor`` rank a candidate pool (numpy only);
  * the steps-to-promote A/B: ``transfer_ab`` trains the target city from
    scratch and warm-started from the donor, with the same knobs, and
    reports the steps each needs to first reach the promote bar (the
    scratch arm's best validation loss inside the epoch budget, times
    ``bar_factor``).

``transfer_ab`` trains on the card unless ``device="cpu"`` asks for the
plain PyTorch versions of the kernels; each arm's trainer is closed after
its run.
"""

from __future__ import annotations

import math
from typing import Optional

from mpgcn_tpu_torch.scenarios.profiles import ScenarioProfile, get_profile

#: weight of each similarity term; modality dominates: a same-modality
#: donor shares the weekly signature its LSTM learned, which transfers
#: even where the graph differs
_WEIGHTS = {"modality": 3.0, "density": 1.0, "degree_skew": 1.0,
            "peak_sharpness": 1.0, "scale": 0.5, "horizon": 0.5,
            "nodes": 2.0}


def profile_similarity(a: ScenarioProfile, b: ScenarioProfile) -> float:
    """Similarity in (0, 1]: 1 / (1 + weighted distance) over modality,
    the declared graph statistics, flow scale, horizon and zone count.
    Symmetric; identical profiles score 1.0."""
    d = 0.0
    d += _WEIGHTS["modality"] * (a.modality != b.modality)
    for key in ("density", "degree_skew", "peak_sharpness"):
        va, vb = getattr(a, key), getattr(b, key)
        d += _WEIGHTS[key] * abs(va - vb) / max(va, vb)
    d += _WEIGHTS["scale"] * abs(math.log(a.flow_scale / b.flow_scale))
    d += _WEIGHTS["horizon"] * abs(a.horizon - b.horizon) / max(
        a.horizon, b.horizon)
    # a donor of another N still loads (its weights do not depend on N),
    # but they stop being zone-aligned: penalized, not excluded
    d += _WEIGHTS["nodes"] * (a.num_nodes != b.num_nodes)
    return 1.0 / (1.0 + d)


def rank_donors(target: ScenarioProfile,
                candidates: list[str | ScenarioProfile]) -> list[tuple]:
    """[(similarity, profile), ...] best first; names resolve through the
    profile registry; the target itself is left out."""
    pool = [c if isinstance(c, ScenarioProfile) else get_profile(c)
            for c in candidates]
    scored = [(profile_similarity(target, p), p) for p in pool
              if p.name != target.name]
    return sorted(scored, key=lambda sp: -sp[0])


def select_donor(target: ScenarioProfile,
                 candidates: list[str | ScenarioProfile]
                 ) -> Optional[ScenarioProfile]:
    """The most similar candidate profile, or None on an empty pool."""
    ranked = rank_donors(target, candidates)
    return ranked[0][1] if ranked else None


# --- the steps-to-promote A/B -------------------------------------------------


def build_target_trainer(profile: ScenarioProfile, out_dir: str,
                         days: int, epochs: int, lr: float,
                         hidden_dim: int, val_days: int,
                         holdout_days: int, device="cuda"):
    """A ModelTrainer over the target city's generated window, split as a
    daemon retrain window is (``window_split_ratio``), so the A/B runs
    the path a federated tenant's bootstrap runs."""
    from mpgcn_tpu_torch.config import MPGCNConfig
    from mpgcn_tpu_torch.data.loader import preprocess_od
    from mpgcn_tpu_torch.scenarios.profiles import generate
    from mpgcn_tpu_torch.service.daemon import window_split_ratio
    from mpgcn_tpu_torch.train.trainer import ModelTrainer

    data = generate(profile, days=days)
    cfg = MPGCNConfig(
        mode="train", data="synthetic", output_dir=out_dir,
        obs_len=profile.obs_len, pred_len=profile.horizon,
        batch_size=4, hidden_dim=hidden_dim, learn_rate=lr,
        num_epochs=epochs, seed=profile.folded_seed,
        num_nodes=profile.num_nodes,
        split_ratio=window_split_ratio(days, profile.obs_len,
                                       profile.horizon, val_days,
                                       holdout_days))
    return ModelTrainer(cfg, preprocess_od(data["od"], data["adj"], cfg),
                        device=device)


def transfer_ab(target: ScenarioProfile | str, donor_ckpt: str,
                out_root: str, days: int = 34, epochs: int = 10,
                lr: float = 3e-3, hidden_dim: int = 8,
                val_days: int = 3, holdout_days: int = 4,
                bar_factor: float = 1.05, device="cuda") -> dict:
    """Steps-to-promote A/B on the target city: scratch against warm from
    ``donor_ckpt``. The bar is the best validation loss the scratch arm
    reaches inside its ``epochs`` budget, times ``bar_factor``; both arms
    train with the same knobs, and the metric is the steps each needs to
    first cross the bar (None: never)."""
    import contextlib
    import os
    import sys

    from mpgcn_tpu_torch.device import resolve_device

    device = resolve_device(device)  # no card, nothing trained
    if isinstance(target, str):
        target = get_profile(target)

    def run(tag: str, warm_from: Optional[str]):
        t = build_target_trainer(target, os.path.join(out_root, tag),
                                 days, epochs, lr, hidden_dim,
                                 val_days, holdout_days, device=device)
        try:
            if warm_from:
                t.warm_start(warm_from)
            hist = t.train()
            return ([float(v) for v in hist["validate"]],
                    t.pipeline.num_batches("train"))
        finally:
            t.close()

    with contextlib.redirect_stdout(sys.stderr):
        scratch_val, _ = run("scratch", None)
        bar = min(scratch_val) * bar_factor
        warm_val, spe = run("warm", donor_ckpt)

    def steps_to(hist: list) -> Optional[int]:
        for i, v in enumerate(hist):
            if v <= bar:
                return (i + 1) * spe
        return None

    warm_steps = steps_to(warm_val)
    scratch_steps = steps_to(scratch_val)
    return {
        "target": target.name, "donor_ckpt": donor_ckpt,
        "bar_val_loss": round(bar, 6),
        "warm_steps_to_promote": warm_steps,
        "scratch_steps_to_promote": scratch_steps,
        "warm_final_val": round(warm_val[-1], 6),
        "scratch_final_val": round(scratch_val[-1], 6),
        "steps_per_epoch": spe,
        "warm_vs_scratch": (round(scratch_steps / warm_steps, 2)
                            if warm_steps and scratch_steps else None),
        "note": "steps to first cross the promote bar (converged-"
                "scratch best val x bar_factor); lower = better, warm "
                "should win on a similar donor",
    }
