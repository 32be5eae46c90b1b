"""Build and load the port's CUDA kernels (the role that
mpgcn_tpu/native/__init__.py plays for the JAX package's host library).

Each source under ``mpgcn_tpu_torch/csrc/`` is compiled on first use by
``nvcc`` into its own shared library with a plain C interface, and loaded
with ``ctypes``: seconds per source, where a build that includes PyTorch's
headers takes minutes. Libraries are named by a hash of their source and
of the headers under ``csrc/``, and land in ``native/_build/`` (listed in
.gitignore), so an edited source is rebuilt and an unchanged one is
reused. ``build_all`` starts one ``nvcc`` per source at once. Nothing but
the sources in this package is built.

Every C entry point launches on the stream it is given and returns
``cudaGetLastError()``; :class:`CudaKernel` raises when that is not 0 and
counts the launches that went through. A few entries launch nothing and
report one number about the device (``query_int``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

CSRC_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
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
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:12]}.so")


def _start(name: str):
    """Start one nvcc build into a temporary name; None when the library
    for the current source is already built."""
    out = _lib_path(name)
    if os.path.exists(out):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
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
            started = _start(name)
            if started is not None:
                _finish(name, started)
            lib = _libs[name] = ctypes.CDLL(_lib_path(name))
        return lib


class CudaKernel:
    """One C entry point of a kernel library. ``launch`` passes tensors'
    data pointers and PyTorch's current stream, raises when the launch
    reports an error, and counts the launch. ``launches`` is the count
    since it was last set to 0."""

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
        (the first must be a tensor: it names the device)."""
        import torch

        if len(tensors) != self.n_ptrs or len(ints) != self.n_ints:
            raise ValueError(f"{self.symbol}: expected {self.n_ptrs} "
                             f"tensors and {self.n_ints} ints")
        fn = self._entry()
        dev = tensors[0].device
        stream = torch.cuda.current_stream(dev).cuda_stream
        with torch.cuda.device(dev):
            err = fn(*[None if t is None else t.data_ptr()
                       for t in tensors],
                     *[int(i) for i in ints], stream)
        if err != 0:
            raise RuntimeError(f"CUDA kernel {self.symbol} failed to "
                               f"launch: cudaError {err}")
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
