"""The kernel-library cache behind ``-compile-cache`` (counterpart of
mpgcn_tpu/obs/perf/compile_cache.py).

The JAX package's flag points XLA's persistent compilation cache at a
directory. The port's programs are the hand kernels' shared libraries
(native/build.py, one ``nvcc`` build per source, named by a hash of the
sources) and the host library (native/host.py): ``-compile-cache DIR``
(``--compile-cache`` on ``serve`` and ``daemon``,
``cfg.compile_cache_dir``, ``$MPGCN_COMPILE_CACHE``) is the directory
they are built into and looked up in, so a second process on the same
directory loads them and builds none. Without either, the libraries live
in ``native/_build/`` (native/build.py ``BUILD_DIR``).

``resolve_dir``: an explicit value wins, then the env hook, then the
default. The first directory ``enable`` is given wins for the process,
as in the JAX package. With a directory chosen by flag or env, ``enable``
puts the cache's series in the default registry:

    mpgcn_kernel_cache_hits_total     libraries found built and loaded
    mpgcn_kernel_cache_misses_total   libraries built by this process
    mpgcn_kernel_cache_dir_bytes      bytes in the directory (at scrape)
    mpgcn_kernel_cache_entries        libraries in the directory

Unlike the JAX ``enable``, nothing degrades: a directory that cannot be
created or written raises, and so does a failed build (native/build.py).
A CUDA context and cuBLAS still start in every process; the cache saves
the builds only.
"""

from __future__ import annotations

import os
import threading
from typing import Optional

from mpgcn_tpu_torch.obs.metrics import default_registry

ENV_VAR = "MPGCN_COMPILE_CACHE"

#: native/_build/ beside native/build.py (its ``BUILD_DIR``)
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "native", "_build")

_LOCK = threading.Lock()
#: the directory enable() chose for the process (None: never enabled)
_ENABLED_DIR: Optional[str] = None
#: the hit and miss counters, made by enable() with a chosen directory
_COUNTERS: Optional[tuple] = None


def resolve_dir(explicit: Optional[str] = None) -> str:
    """The library directory: ``explicit`` wins, then
    ``$MPGCN_COMPILE_CACHE``, then ``DEFAULT_DIR``."""
    return os.path.abspath(explicit or os.environ.get(ENV_VAR)
                           or DEFAULT_DIR)


def enabled_dir() -> Optional[str]:
    with _LOCK:
        return _ENABLED_DIR


def library_dir() -> str:
    """Where the libraries are built and looked up: the directory enabled
    for the process, else what ``resolve_dir`` gives now."""
    return enabled_dir() or resolve_dir()


def _dir_stats(path: str) -> tuple[int, int]:
    """(bytes, libraries) in the directory."""
    total = entries = 0
    try:
        with os.scandir(path) as it:
            for e in it:
                if e.is_file(follow_symlinks=False) \
                        and e.name.endswith(".so"):
                    entries += 1
                    total += e.stat(follow_symlinks=False).st_size
    except FileNotFoundError:
        pass
    return total, entries


def _check_writable(path: str) -> None:
    """Create ``path`` and write a file into it, or raise."""
    try:
        os.makedirs(path, exist_ok=True)
        probe = os.path.join(path, f".write-probe-{os.getpid()}")
        with open(probe, "wb") as f:
            f.write(b"ok")
        os.unlink(probe)
    except OSError as e:
        raise RuntimeError(f"the kernel-library cache directory {path} "
                           f"cannot be used: {type(e).__name__}: {e}") from e


def enable(cache_dir: Optional[str] = None) -> str:
    """Choose the process's library directory (``resolve_dir``) and
    return the one in effect: the first one enabled wins. A directory
    chosen by flag or env must be writable (else this raises) and gets
    the hit, miss and size series in the default registry; the default
    directory is used without them, as the JAX package keeps its series
    off without a cache directory."""
    global _ENABLED_DIR, _COUNTERS
    chosen = bool(cache_dir or os.environ.get(ENV_VAR))
    path = resolve_dir(cache_dir)
    with _LOCK:
        if _ENABLED_DIR is not None:
            return _ENABLED_DIR
    if not chosen:
        with _LOCK:
            _ENABLED_DIR = _ENABLED_DIR or path
            return _ENABLED_DIR
    _check_writable(path)
    reg = default_registry()
    counters = (
        reg.counter("kernel_cache_hits", "kernel libraries found built in "
                    "the cache directory and loaded (builds skipped)"),
        reg.counter("kernel_cache_misses", "kernel libraries this process "
                    "built into the cache directory"))
    reg.gauge("kernel_cache_dir_bytes", "bytes of the kernel libraries in "
              "the cache directory").set_fn(
        lambda: float(_dir_stats(path)[0]))
    reg.gauge("kernel_cache_entries", "kernel libraries in the cache "
              "directory").set_fn(lambda: float(_dir_stats(path)[1]))
    with _LOCK:
        if _ENABLED_DIR is not None:  # another thread was first
            return _ENABLED_DIR
        _ENABLED_DIR, _COUNTERS = path, counters
    print(f"[compile-cache] kernel libraries at {path}", flush=True)
    return path


def note_hit() -> None:
    """A library found built and loaded."""
    if _COUNTERS is not None:
        _COUNTERS[0].inc()


def note_miss() -> None:
    """A library built."""
    if _COUNTERS is not None:
        _COUNTERS[1].inc()


def cache_stats() -> dict:
    """The process's hit and miss counts and its directory."""
    hits, misses = ((int(c.value) for c in _COUNTERS)
                    if _COUNTERS is not None else (0, 0))
    return {"hits": hits, "misses": misses, "dir": library_dir()}
