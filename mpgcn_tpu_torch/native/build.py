"""Build and load the port's CUDA kernels (the role that
mpgcn_tpu/native/__init__.py plays for the JAX package's host library).

Each source under ``mpgcn_tpu_torch/csrc/`` is compiled on first use by
``nvcc`` into its own shared library with a plain C interface, and loaded
with ``ctypes``: seconds per source, where a build that includes PyTorch's
headers takes minutes. Libraries are named by a hash of their source and
of the headers under ``csrc/``, and land in the kernel-library directory
(obs/perf/compile_cache.py: ``-compile-cache DIR``, else
``$MPGCN_COMPILE_CACHE``, else ``native/_build/``, listed in .gitignore),
so an edited source is rebuilt and an unchanged one is reused: a library
found built counts as a cache hit, one built as a miss. ``build_all``
starts one ``nvcc`` per source at once. Nothing but the sources in this
package is built.

Every C entry point launches on the stream it is given and returns
``cudaGetLastError()``; :class:`CudaKernel` raises when that is not 0 and
counts the launches that went through, eager or replayed from a CUDA
graph (``capture_launches``, ``add_replayed``). A few entries launch
nothing and report one number about the device (``query_int``). Each
library built counts into the default metrics registry's
``cuda_program_builds`` (obs/metrics.py). While a ``torch.profiler``
window records (utils/profiling.py ``trace_if``), each eager launch is
named in the trace by its C entry.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

from mpgcn_tpu_torch.obs.metrics import count_program_build
from mpgcn_tpu_torch.obs.perf import compile_cache
from mpgcn_tpu_torch.utils.profiling import kernel_annotation

CSRC_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "csrc")
#: the default library directory (``-compile-cache`` picks another)
BUILD_DIR = compile_cache.DEFAULT_DIR
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
#: the library paths this process built (a later load of one is no hit)
_built: set = set()
#: the launches of the CUDA graph being captured, by kernel (None: none is);
#: one for the process, not one for a thread: a captured backward launches
#: from autograd's device thread, not from the thread that captures
_captured: dict | None = None
_captured_lock = threading.Lock()
#: per-source ptxas report (registers, shared memory, spills) of the build
ptxas_reports: dict[str, str] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found on PATH or under /usr/local/cuda: "
                       "the CUDA kernels cannot be built")


def _source(name: str) -> str:
    path = os.path.join(CSRC_DIR, f"{name}.cu")
    if not os.path.exists(path):
        raise FileNotFoundError(f"no kernel source {path}")
    return path


def _lib_path(name: str) -> str:
    """The library's path, named by a hash of its source and of every
    header under csrc/ (a source may include any of them)."""
    h = hashlib.sha256()
    headers = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh"))
    for path in [_source(name)] + [os.path.join(CSRC_DIR, f)
                                   for f in headers]:
        with open(path, "rb") as f:
            h.update(f.read())
    return os.path.join(compile_cache.library_dir(),
                        f"lib{name}-{h.hexdigest()[:12]}.so")


def _start(name: str):
    """Start one nvcc build into a temporary name; None when the library
    for the current source is already built."""
    out = _lib_path(name)
    if os.path.exists(out):
        return None
    os.makedirs(os.path.dirname(out), exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, _source(name)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, started) -> None:
    proc, tmp, out = started
    log, _ = proc.communicate()
    ptxas_reports[name] = log
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise RuntimeError(f"nvcc failed to build {name}.cu "
                           f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)
    _built.add(out)
    count_program_build("kernel_library")
    compile_cache.note_miss()


def kernel_sources() -> list[str]:
    return sorted(f[:-3] for f in os.listdir(CSRC_DIR) if f.endswith(".cu"))


def build_all() -> None:
    """Build every source under csrc/ that is not built yet, one nvcc
    each, all started together."""
    with _lock:
        started = {n: _start(n) for n in kernel_sources()}
        errors = []
        for name, st in started.items():
            if st is None:
                continue
            try:
                _finish(name, st)
            except RuntimeError as e:
                errors.append(str(e))
        if errors:
            raise RuntimeError("\n".join(errors))


def load(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = _lib_path(name)
            started = _start(name)
            if started is not None:
                _finish(name, started)
            elif path not in _built:
                compile_cache.note_hit()
            lib = _libs[name] = ctypes.CDLL(path)
        return lib


class capture_launches:
    """Context of one CUDA graph capture: the launches made on a capturing
    stream inside it are tallied here, {CudaKernel: calls}, and not in
    ``launches``, since a capture runs nothing. Each replay of the graph
    then adds the tally (``add_replayed``), so ``launches`` counts kernel
    executions whichever way they ran. A launch on a capturing stream
    outside this context raises: it would go uncounted."""

    def __enter__(self) -> dict:
        global _captured
        with _captured_lock:
            if _captured is not None:
                raise RuntimeError("a CUDA graph capture is already being "
                                   "tallied")
            _captured = self.tally = {}
        return self.tally

    def __exit__(self, *exc) -> None:
        global _captured
        with _captured_lock:
            _captured = None


def add_replayed(tally: dict, times: int = 1) -> None:
    """Count ``times`` replays of a graph whose capture tallied ``tally``."""
    for kernel, n in tally.items():
        with kernel._count_lock:
            kernel.launches += n * times


class CudaKernel:
    """One C entry point of a kernel library. ``launch`` passes tensors'
    data pointers and PyTorch's current stream, raises when the launch
    reports an error, and counts the launch. ``launches`` is the count of
    kernel executions since it was last set to 0: a launch made eagerly
    counts when it is made; one made while a CUDA graph is captured counts
    at each replay of that graph (``capture_launches``), never at the
    capture."""

    def __init__(self, source: str, symbol: str, n_ptrs: int, n_ints: int):
        self.source, self.symbol = source, symbol
        self.n_ptrs, self.n_ints = n_ptrs, n_ints
        self.launches = 0
        self._fn = None
        self._count_lock = threading.Lock()

    def _entry(self):
        if self._fn is None:
            fn = getattr(load(self.source), self.symbol)
            fn.argtypes = ([ctypes.c_void_p] * self.n_ptrs
                           + [ctypes.c_int] * self.n_ints
                           + [ctypes.c_void_p])
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn

    def launch(self, tensors, ints) -> None:
        """``tensors`` may hold None where the entry takes a null pointer
        (the first tensor that is not None names the device)."""
        import torch

        if len(tensors) != self.n_ptrs or len(ints) != self.n_ints:
            raise ValueError(f"{self.symbol}: expected {self.n_ptrs} "
                             f"tensors and {self.n_ints} ints")
        fn = self._entry()
        dev = next(t for t in tensors if t is not None).device
        stream = torch.cuda.current_stream(dev).cuda_stream
        with torch.cuda.device(dev), kernel_annotation(self.symbol):
            err = fn(*[None if t is None else t.data_ptr()
                       for t in tensors],
                     *[int(i) for i in ints], stream)
            capturing = torch.cuda.is_current_stream_capturing()
        if err != 0:
            raise RuntimeError(f"CUDA kernel {self.symbol} failed to "
                               f"launch: cudaError {err}")
        if capturing:
            with _captured_lock:
                if _captured is None:
                    raise RuntimeError(
                        f"{self.symbol} was captured into a CUDA graph "
                        f"outside build.capture_launches: its replays "
                        f"would go uncounted")
                _captured[self] = _captured.get(self, 0) + 1
            return
        with self._count_lock:
            self.launches += 1


def query_int(source: str, symbol: str, ints, device) -> int:
    """Call the C entry ``symbol(int..., int* out)`` of csrc/<source>.cu
    with ``device`` current and return ``out``; raises when it reports an
    error. Launches nothing (an occupancy bound, say)."""
    import torch

    fn = getattr(load(source), symbol)
    fn.argtypes = [ctypes.c_int] * len(ints) + [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    out = ctypes.c_int(0)
    with torch.cuda.device(device):
        err = fn(*[int(i) for i in ints], ctypes.byref(out))
    if err != 0:
        raise RuntimeError(f"CUDA query {symbol} failed: cudaError {err}")
    return out.value
