"""Self-tuning dispatch (counterpart of mpgcn_tpu/tune/): the constants
registry, the per-platform tuned-profile store, the traffic-driven
serving-shape planner and the crossover harnesses.

Every ``auto`` decision -- the BDGCN arm and the OD storage by measured
density, the scan or stream epoch executor, the stream chunk, serve's
buckets and horizons -- resolves through one order, explicit knob >
tuned profile > guessed default (`registry.resolve`,
`registry.resolve_knob`). ``python -m mpgcn_tpu_torch.cli tune``
measures the crossovers on the card (``tune run``), plans the buckets
from observed traffic (``tune buckets``) and prints the table (``tune
show``); profiles live in ``tuned/torch-<platform>.json``.

Torch-free except `measure`, which imports torch inside its harnesses.
"""

from mpgcn_tpu_torch.tune.registry import (  # noqa: F401
    CONFIG_KNOBS,
    CONSTANTS,
    REGISTRY,
    current_platform,
    device_platform,
    guessed_default,
    load_profile,
    profile_path,
    resolve,
    resolve_knob,
    save_profile,
    tuned_dir,
    tuned_or_default,
)
