"""The dispatch-constants registry and the tuned-profile resolver
(counterpart of mpgcn_tpu/tune/registry.py).

One declarative table (`CONSTANTS`) holds every hand-set dispatch
threshold: name, guessed default, owning module, search space, and the
``tune run`` harness that measures it. Call sites read through
`resolve_knob(cfg, name, platform=...)` (config-backed knobs) or
`tuned_or_default(name)` (serve's buckets and horizons) instead of the
raw values, so a profile measured on one platform can replace the guess
without touching the call site.

Resolution order, the JAX package's:

  1. **explicit knob** -- the knob's name is in ``cfg.explicit_knobs``
     (the CLI records every tunable flag the user passed), or the config
     value differs from the guessed default (a caller that built the
     config by hand), or the caller passes ``explicit=``. A profile never
     overrides it.
  2. **tuned profile** -- ``tuned/<platform>.json`` (the directory is
     ``$MPGCN_TUNED_DIR`` where set), written by ``tune`` with its
     provenance. A corrupt file, a file whose recorded platform is not
     its name's, or a bad value is skipped with a one-time warning:
     never a crash, never applied across platforms.
  3. **guessed default** -- with no profile on disk every decision is
     what it was before the registry.

The first resolution of each (name, source) pair prints one line,
``[tune] <name> = <value> (<source>)``.

**Platforms.** The port's keys are ``torch-cuda`` and ``torch-cpu``
(files ``tuned/torch-cuda.json`` and ``tuned/torch-cpu.json``); a
caller may name them ``cuda`` / ``cpu`` and the prefix is added. The
JAX package's ``cpu.json`` measures its own arms in its own program, so
neither program reads the other's profiles. Three of the nine constants
are the JAX package's TPU-only switches (``platforms=("tpu",)``); they
are registered so that ``tune show`` lists the whole table, and no port
code reads them: a CUDA tensor always launches its kernel.

Standard library only: the router's front tier and ``tune show`` /
``tune buckets`` import it with neither torch nor JAX. The default
platform consults torch only where something already imported it.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
from typing import Any, Optional

#: file-format version of tuned/<platform>.json
PROFILE_VERSION = 1

#: the port's profile platforms; ``cuda`` / ``cpu`` name them too
PLATFORMS = ("torch-cpu", "torch-cuda")
PREFIX = "torch-"


@dataclasses.dataclass(frozen=True)
class TunedConstant:
    """One registered dispatch constant."""

    name: str          #: registry key (and profile key)
    default: Any       #: the guessed default shipped before tuning
    kind: str          #: "float" | "int" | "int_tuple"
    owner: str         #: module whose dispatch reads it
    space: str         #: search space the tune harness sweeps
    harness: str       #: `tune run` measurement hook
    platforms: tuple   #: platforms where measuring it is meaningful
    doc: str           #: what the constant gates

    def coerce(self, value: Any) -> Any:
        """Validate and normalise a profile value; raises ValueError."""
        if self.kind == "float":
            v = float(value)
            if not (v == v and abs(v) != float("inf")):
                raise ValueError(f"{self.name}: non-finite {value!r}")
            return v
        if self.kind == "int":
            if isinstance(value, bool) or int(value) != value:
                raise ValueError(f"{self.name}: not an int: {value!r}")
            return int(value)
        if self.kind == "int_tuple":
            vals = tuple(int(v) for v in value)
            if not vals or any(v < 1 for v in vals) \
                    or list(vals) != sorted(set(vals)):
                raise ValueError(
                    f"{self.name}: need sorted unique ints >= 1, "
                    f"got {value!r}")
            return vals
        raise ValueError(f"{self.name}: unknown kind {self.kind!r}")


#: every dispatch threshold, in one place: the JAX table's nine names,
#: defaults and kinds. The defaults equal the owning config fields'
#: (tests/test_torch_tune.py holds them).
CONSTANTS: tuple = (
    TunedConstant(
        name="sparse_density_threshold", default=0.25, kind="float",
        owner="data/pipeline.py (MPGCNConfig field)",
        space="support density grid 0.02..0.3 at N=300",
        harness="sparse_crossover", platforms=("cpu", "cuda"),
        doc="support-bank density at or below which -bdgcn auto takes "
            "'ell' and -od-storage auto sparse host storage"),
    TunedConstant(
        name="sparse_min_nodes", default=256, kind="int",
        owner="data/pipeline.py (MPGCNConfig field)",
        space="node-count grid 64..1024",
        harness="sparse_crossover", platforms=("cpu", "cuda"),
        doc="'auto' never picks a sparse arm below this node count"),
    TunedConstant(
        name="bdgcn_bwd_min_pairs", default=32768, kind="int",
        owner="mpgcn_tpu nn/pallas_bdgcn.py (no port switch)",
        space="OD pair counts 2^12..2^20 (geometric)",
        harness="bdgcn_bwd_crossover", platforms=("tpu",),
        doc="B*N^2 pairs below which the JAX package's XLA einsum-loop "
            "backward beats its Pallas grid; the port always launches "
            "its kernel"),
    TunedConstant(
        name="lstm_bwd_min_rows", default=32768, kind="int",
        owner="mpgcn_tpu nn/pallas_lstm.py (no port switch)",
        space="per-device sequence rows 2^12..2^20 (geometric)",
        harness="lstm_bwd_crossover", platforms=("tpu",),
        doc="sequence rows below which the JAX package's XLA-scan BPTT "
            "beats its Pallas kernel; the port always launches its "
            "kernel"),
    TunedConstant(
        name="pallas_vmem_tile_budget", default=8 * 1024 * 1024,
        kind="int", owner="mpgcn_tpu nn/pallas_bdgcn.py (no port switch)",
        space="VMEM budget {2,4,8,16,32} MiB",
        harness="pallas_tile_grid", platforms=("tpu",),
        doc="the TPU's double-buffered VMEM block budget; no CUDA "
            "counterpart"),
    TunedConstant(
        name="epoch_scan_max_mb", default=512.0, kind="float",
        owner="train/trainer.py (MPGCNConfig field)",
        space="epoch MB: the scan executor against the stream at one "
              "shape",
        harness="scan_stream_crossover", platforms=("cpu", "cuda"),
        doc="a mode's epoch tensors at or below this budget run on the "
            "scan executor (device-resident, one host read an epoch); "
            "above it the chunked-stream executor takes over"),
    TunedConstant(
        name="stream_chunk_mb", default=0.0, kind="float",
        owner="train/trainer.py (MPGCNConfig field)",
        space="chunk MB {0.05, 0.1, 0.25, 0.5, 1}",
        harness="stream_chunk", platforms=("cpu", "cuda"),
        doc="device budget per stream chunk; the guessed 0 couples it "
            "to epoch_scan_max_mb, which degenerates into 1-step "
            "chunks when the scan budget is forced small"),
    TunedConstant(
        name="serve_buckets", default=(1, 2, 4, 8), kind="int_tuple",
        owner="service/serve.py (ServeConfig field)",
        space="subsets of observed batch sizes, |B| <= max-compiles",
        harness="bucket_planner", platforms=("cpu", "cuda"),
        doc="captured batch buckets; the planner derives the set "
            "minimizing expected pad waste over the request ledger's "
            "observed batch-size distribution"),
    TunedConstant(
        name="serve_horizons", default=(), kind="int_tuple",
        owner="service/serve.py (ServeConfig field)",
        space="observed horizon set from the request ledger",
        harness="bucket_planner", platforms=("cpu", "cuda"),
        doc="captured forecast horizons; () prepares only the model's "
            "pred_len"),
)

REGISTRY: dict = {c.name: c for c in CONSTANTS}

#: knobs that are MPGCNConfig fields (resolve_knob targets)
CONFIG_KNOBS = ("sparse_density_threshold", "sparse_min_nodes",
                "epoch_scan_max_mb", "stream_chunk_mb")

# one-time log / warning state (process-wide: the point is to not repeat)
_logged: set = set()
_warned: set = set()
# profile cache keyed on (path, platform) and checked against the file's
# mtime: a test that moves $MPGCN_TUNED_DIR or rewrites the file gets a
# fresh load without a reset
_cache: dict = {}


def _log_once(key: tuple, msg: str) -> None:
    if key not in _logged:
        _logged.add(key)
        print(msg, flush=True)


def _warn_once(key: tuple, msg: str) -> None:
    if key not in _warned:
        _warned.add(key)
        print(msg, file=sys.stderr, flush=True)


def _reset_cache() -> None:
    """Test hook: forget cached profiles and the one-time log state."""
    _cache.clear()
    _logged.clear()
    _warned.clear()


def guessed_default(name: str) -> Any:
    return REGISTRY[name].default


def current_platform(platform: Optional[str] = None) -> str:
    """'torch-cuda' or 'torch-cpu'. A given ``platform`` may be 'cuda' /
    'cpu' (the prefix is added) or carry it. Without one: 'torch-cuda'
    when torch is already imported and sees a card, else 'torch-cpu'
    (torch is never imported here)."""
    if platform:
        p = str(platform).lower()
        if not p.startswith(PREFIX):
            p = PREFIX + p
        if p not in PLATFORMS:
            raise ValueError(f"platform {platform!r} is not one of "
                             f"{PLATFORMS} (or 'cuda' / 'cpu')")
        return p
    torch = sys.modules.get("torch")
    if torch is not None:
        try:
            if torch.cuda.is_available():
                return "torch-cuda"
        except Exception:  # a broken CUDA runtime: never crash resolution
            pass
    return "torch-cpu"


def device_platform(device) -> str:
    """The profile platform of a torch device (or its name)."""
    kind = getattr(device, "type", None) or str(device).split(":")[0]
    return "torch-cuda" if kind == "cuda" else "torch-cpu"


def short_platform(platform: str) -> str:
    """'cuda' / 'cpu': the name `TunedConstant.platforms` uses."""
    return current_platform(platform)[len(PREFIX):]


def repo_root(start: Optional[str] = None) -> str:
    """The checkout's root: walk up from ``start`` (default: this
    package's parent) to the first directory holding ``.git`` or
    ``BENCH_r*.json`` (the JAX package's ``repo_root`` rule)."""
    import glob

    d = os.path.abspath(start or os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "..", ".."))
    while True:
        if (glob.glob(os.path.join(d, "BENCH_r*.json"))
                or os.path.isdir(os.path.join(d, ".git"))):
            return d
        parent = os.path.dirname(d)
        if parent == d:
            return os.path.abspath(start or ".")
        d = parent


def tuned_dir() -> str:
    """Profile directory: $MPGCN_TUNED_DIR, else tuned/ at the repo's
    root."""
    env = os.environ.get("MPGCN_TUNED_DIR", "")
    if env:
        return env
    return os.path.join(repo_root(), "tuned")


def profile_path(platform: Optional[str] = None,
                 directory: Optional[str] = None) -> str:
    return os.path.join(directory or tuned_dir(),
                        f"{current_platform(platform)}.json")


def load_profile(platform: Optional[str] = None,
                 directory: Optional[str] = None) -> Optional[dict]:
    """The validated tuned profile for ``platform``, or None.

    A missing file is silent; a corrupt file, a recorded ``platform``
    other than the file's, or a constants table that is not one warns
    once and resolves as if no profile existed. A bad value is dropped
    (warn once) and the valid ones kept."""
    plat = current_platform(platform)
    path = profile_path(plat, directory)
    try:
        mtime = os.stat(path).st_mtime_ns
    except OSError:
        return None  # no profile: the guessed defaults are the contract
    key = (os.path.abspath(path), plat)
    cached = _cache.get(key)
    if cached is not None and cached[0] == mtime:
        return cached[1]
    prof = _load_profile_uncached(path, plat)
    _cache[key] = (mtime, prof)
    return prof


def _load_profile_uncached(path: str, plat: str) -> Optional[dict]:
    try:
        with open(path) as f:
            raw = json.load(f)
    except (OSError, json.JSONDecodeError, UnicodeDecodeError) as e:
        _warn_once(("corrupt", path),
                   f"[tune] WARNING: ignoring corrupt tuned profile "
                   f"{path}: {e}")
        return None
    if not isinstance(raw, dict) \
            or not isinstance(raw.get("constants"), dict):
        _warn_once(("malformed", path),
                   f"[tune] WARNING: ignoring malformed tuned profile "
                   f"{path}: no constants table")
        return None
    # the recorded platform must be this one as written: a JAX profile
    # ('cpu', 'tpu') copied under a port name is another program's
    rec_plat = str(raw.get("platform", "")).lower()
    if rec_plat != plat:
        _warn_once(("platform", path),
                   f"[tune] WARNING: ignoring tuned profile {path}: "
                   f"recorded platform {rec_plat!r} != {plat!r} "
                   f"(profiles never cross-apply)")
        return None
    constants: dict = {}
    for name, entry in raw["constants"].items():
        spec = REGISTRY.get(name)
        if spec is None:
            _warn_once(("unknown", path, name),
                       f"[tune] WARNING: tuned profile {path} has "
                       f"unknown constant {name!r}; skipped")
            continue
        value = entry.get("value") if isinstance(entry, dict) else entry
        try:
            constants[name] = spec.coerce(value)
        except (TypeError, ValueError) as e:
            _warn_once(("badvalue", path, name),
                       f"[tune] WARNING: tuned profile {path}: bad "
                       f"value for {name}: {e}; skipped")
    prof = dict(raw)
    prof["constants"] = constants
    return prof


def save_profile(values: dict, platform: Optional[str] = None,
                 directory: Optional[str] = None,
                 provenance: Optional[dict] = None,
                 curves: Optional[dict] = None) -> str:
    """Write or merge ``tuned/<platform>.json``: ``values`` maps constant
    name -> measured value; ``curves`` maps name -> the measured points
    behind it (provenance, never read at resolve time). Unknown names or
    invalid values raise: the writer is strict, only the reader
    forgives."""
    plat = current_platform(platform)
    coerced = {}
    for name, v in values.items():
        spec = REGISTRY.get(name)
        if spec is None:
            raise KeyError(f"unknown tuned constant {name!r}")
        c = spec.coerce(v)
        coerced[name] = list(c) if isinstance(c, tuple) else c
    path = profile_path(plat, directory)
    existing = load_profile(plat, directory) or {}
    constants = {
        n: {"value": (list(v) if isinstance(v, tuple) else v),
            "harness": REGISTRY[n].harness}
        for n, v in (existing.get("constants") or {}).items()}
    for name, v in coerced.items():
        entry = {"value": v, "harness": REGISTRY[name].harness}
        if curves and name in curves:
            entry["curve"] = curves[name]
        constants[name] = entry
    out = {"version": PROFILE_VERSION, "platform": plat,
           "constants": constants,
           "provenance": {**(existing.get("provenance") or {}),
                          **(provenance or {})}}
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(out, f, indent=2, sort_keys=True)
        f.write("\n")
    os.replace(tmp, path)
    _cache.pop((os.path.abspath(path), plat), None)
    return path


def resolve(name: str, explicit: Any = None,
            platform: Optional[str] = None) -> tuple:
    """(value, source) for one registered constant.

    ``explicit`` is the caller's deliberate value (a CLI flag, a config
    field set on purpose); None means "not set". Source is one of
    ``explicit`` / ``tuned`` / ``default``; the first hit of each
    (name, source) prints one line naming it."""
    spec = REGISTRY[name]
    if explicit is not None:
        value, source = spec.coerce(explicit), "explicit"
    else:
        prof = load_profile(platform)
        if prof is not None and name in prof["constants"]:
            value, source = prof["constants"][name], "tuned"
        else:
            value, source = spec.default, "default"
    detail = {"explicit": "explicit knob",
              "tuned": f"tuned profile {profile_path(platform)}",
              "default": "guessed default"}[source]
    _log_once((name, source), f"[tune] {name} = {value} ({detail})")
    return value, source


def tuned_or_default(name: str, explicit: Any = None,
                     platform: Optional[str] = None) -> Any:
    """`resolve` without the source: the call-site one-liner."""
    return resolve(name, explicit=explicit, platform=platform)[0]


def resolve_knob(cfg, name: str, platform: Optional[str] = None) -> Any:
    """A config-backed knob (`CONFIG_KNOBS`) for one trainer or
    pipeline: explicit when the knob is named in ``cfg.explicit_knobs``
    or the config value differs from the guessed default; otherwise the
    tuned profile, then the config value (the guessed default)."""
    spec = REGISTRY[name]
    value = getattr(cfg, name)
    if name in getattr(cfg, "explicit_knobs", ()) \
            or spec.coerce(value) != spec.coerce(spec.default):
        return resolve(name, explicit=value, platform=platform)[0]
    return resolve(name, platform=platform)[0]
