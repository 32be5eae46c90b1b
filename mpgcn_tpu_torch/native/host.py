"""The host kernels of the data feed (C++/OpenMP, ``mpgcn_host.cpp``),
built and loaded with ctypes, each with its numpy version (the role of
mpgcn_tpu/native/__init__.py for the JAX package).

    from mpgcn_tpu_torch.native import host
    if host.available():
        out = host.gather_windows(base, starts, steps)

The library is built on first use with ``g++ -O3 -std=c++17 -fPIC -shared
-fopenmp`` into the kernel-library directory beside the CUDA kernels'
libraries of native/build.py (``native/_build/`` unless
``-compile-cache`` picks another; obs/perf/compile_cache.py, which counts
it found or built), named by a hash of the source: by
the compiler ``CXX`` names when it is set, else, or when that one cannot
build it (a compiler without OpenMP's runtime, say), by ``g++``. This is
host code, not a device kernel. Where it does not build,
``available()`` is False, ``unavailable_reason()`` says why, and every
entry runs its numpy version.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Optional

import numpy as np

from mpgcn_tpu_torch.obs.perf import compile_cache

#: where the library lives; None: the kernel-library directory
#: (``compile_cache.library_dir()``)
BUILD_DIR: Optional[str] = None
SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "mpgcn_host.cpp")
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared", "-fopenmp")

_lock = threading.Lock()
#: None: not tried yet; a CDLL once loaded; a str: why it is unavailable
_state = None

_i64 = ctypes.c_int64
_f32_p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
_f64_p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
_i64_p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")


def lib_path() -> str:
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:12]
    return os.path.join(BUILD_DIR or compile_cache.library_dir(),
                        f"libmpgcn_host-{digest}.so")


def compilers() -> list:
    """The compilers to try, in order: ``CXX`` when it is set, then
    ``g++``."""
    found = [os.environ.get("CXX"), "g++"]
    return [c for i, c in enumerate(found) if c and c not in found[:i]]


def _build(out: str) -> None:
    """Build the library into ``out`` with the first compiler that can;
    raises RuntimeError naming each failure when none can."""
    os.makedirs(os.path.dirname(out), exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"  # concurrent builds never interleave
    failures = []
    for cxx in compilers():
        try:
            subprocess.run([cxx, *CXX_FLAGS, SOURCE, "-o", tmp],
                           check=True, capture_output=True, text=True)
            os.replace(tmp, out)  # importers never see a partial library
            compile_cache.note_miss()
            return
        except (OSError, subprocess.CalledProcessError) as e:
            detail = (getattr(e, "stderr", "") or "").strip()
            failures.append(f"{cxx}: {type(e).__name__}: {e} {detail}"
                            .strip())
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
    raise RuntimeError("; ".join(failures))


def load():
    """The loaded library, building it first if needed; None when it
    cannot be built or loaded (``unavailable_reason`` says why)."""
    global _state
    with _lock:
        if _state is None:
            try:
                path = lib_path()
                if os.path.exists(path):
                    compile_cache.note_hit()
                else:
                    _build(path)
                lib = ctypes.CDLL(path)
                lib.gather_windows_f32.argtypes = [_f32_p, _i64_p, _i64,
                                                   _i64, _i64, _f32_p]
                lib.gather_windows_f32.restype = None
                lib.dow_mean_f64.argtypes = [_f64_p, _i64, _i64, _i64,
                                             _f64_p]
                lib.dow_mean_f64.restype = None
                _state = lib
            except (OSError, RuntimeError) as e:
                _state = f"{type(e).__name__}: {e}"
        return _state if isinstance(_state, ctypes.CDLL) else None


def available() -> bool:
    return load() is not None


def unavailable_reason() -> Optional[str]:
    """Why the library is not available (None when it is)."""
    load()
    return None if isinstance(_state, ctypes.CDLL) else _state


def gather_windows(base: np.ndarray, starts, steps: int,
                   out: Optional[np.ndarray] = None) -> np.ndarray:
    """out[b] = base[starts[b] : starts[b] + steps] for each b.

    base: (T, ...) float32 C-contiguous; out (len(starts), steps, ...)
    float32 C-contiguous, made when not given. The library's gather when
    it is available, else numpy's."""
    starts = np.ascontiguousarray(starts, dtype=np.int64)
    shape = (starts.shape[0], steps) + base.shape[1:]
    if out is None:
        out = np.empty(shape, np.float32)
    if out.shape != shape or out.dtype != np.float32 \
            or not out.flags.c_contiguous:
        raise ValueError(f"out must be a C-contiguous float32 {shape}, got "
                         f"{out.dtype} {out.shape}")
    if starts.size and (int(starts.min()) < 0
                        or int(starts.max()) + steps > base.shape[0]):
        raise IndexError(f"a window of {steps} steps from starts "
                         f"[{starts.min()}, {starts.max()}] leaves a series "
                         f"of {base.shape[0]}")
    lib = load()
    if lib is not None and base.dtype == np.float32 \
            and base.flags.c_contiguous:
        feat = int(np.prod(base.shape[1:], dtype=np.int64))
        lib.gather_windows_f32(base, starts, starts.shape[0], steps, feat,
                               out)
    else:
        for b, s in enumerate(starts):
            out[b] = base[s: s + steps]
    return out


def dow_mean(history: np.ndarray, period: int) -> np.ndarray:
    """out[p] = history[p::period].mean(axis=0) in float64.

    history: (Th, ...) with Th a multiple of period. Returns (period,
    ...) float64: the library's loop when it is available, else numpy's
    mean of the float64 history."""
    Th = history.shape[0]
    if Th % period:
        raise ValueError(f"history of {Th} steps is not a multiple of the "
                         f"period {period}")
    history = np.ascontiguousarray(history, dtype=np.float64)
    lib = load()
    if lib is None:
        return np.stack([history[p::period].mean(axis=0)
                         for p in range(period)])
    out = np.empty((period,) + history.shape[1:], np.float64)
    feat = int(np.prod(history.shape[1:], dtype=np.int64))
    lib.dow_mean_f64(history, Th, period, feat, out)
    return out
