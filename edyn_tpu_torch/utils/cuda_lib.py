"""Building, loading and calling the port's CUDA C++ kernels.

Each source ``edyn_tpu_torch/csrc/<name>.cu`` has a plain C interface and is
compiled by ``nvcc`` for ``sm_90a`` into its own shared library under
``build/edyn_tpu_torch/`` at first use (named by a hash of the source and the
flags, so an edited source rebuilds), then loaded with ``ctypes``. Nothing
here runs when a module is imported: the CPU tests import every module on a
machine without ``nvcc``.

The wrappers around the kernels share the helpers below: ``on_cpu`` decides
by the tensors' device (the CPU takes the plain version; CUDA launches the
kernel or raises, never falls back), ``check`` validates a kernel argument,
``stream`` gives PyTorch's current stream, and ``launched`` raises on a
failed launch and counts a good one, in the wrapper's own counts and in
``DEVICE_LAUNCHES`` under the launch's device and shard (``shard_scope``).
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "edyn_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC",
              # no contraction into FMAs: each kernel rounds op by op as its
              # plain version does (parity first)
              "-fmad=false"]
_libs: dict = {}
# one build and load at a time: a client's extrapolation thread or an
# AsyncSimulation can make the first launch of a library
_load_lock = threading.Lock()
_count_lock = threading.Lock()  # launch counts from several threads
# compiler output of each source built by this process ({name: log})
BUILD_LOGS: dict = {}
# every launch by where it ran: {(device, shard): {kernel step: launches}};
# shard is the index set by ``shard_scope`` (None outside a sharded step)
DEVICE_LAUNCHES: dict = {}
_scope = threading.local()


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")


def library_path(name: str, src_dir: Path = CSRC) -> Path:
    """Where ``<src_dir>/<name>.cu`` is built to: named by a hash of the
    source, the headers beside it and the flags."""
    src_dir = Path(src_dir)
    h = hashlib.sha256((src_dir / f"{name}.cu").read_bytes())
    for hdr in sorted(src_dir.glob("*.cuh")):
        h.update(hdr.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}_{h.hexdigest()[:16]}.so"


def build_libraries(names, verbose: bool = False,
                    src_dir: Path = CSRC) -> dict:
    """Compile the sources ``<src_dir>/<name>.cu`` that are not built yet,
    one ``nvcc`` process per source, all started together. Returns
    {name: library path}; with ``verbose`` the compiler's output
    (``-Xptxas -v``: registers, stack, spills) is printed."""
    out = {n: library_path(n, src_dir) for n in names}
    todo = [n for n, p in out.items() if not p.exists()]
    if not todo:
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for n in todo:
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
               str(Path(src_dir) / f"{n}.cu")]
        if verbose:
            cmd.insert(1, "-Xptxas=-v")
        procs[n] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT,
                                          text=True))
    failed = []
    for n, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"nvcc {n}.cu failed ({proc.returncode}):\n{log}")
            continue
        BUILD_LOGS[n] = log
        if verbose:
            print(f"[nvcc {n}.cu]\n{log}", flush=True)
        os.replace(tmp, out[n])
    if failed:
        raise RuntimeError("\n".join(failed))
    return out


def load(name: str, signatures: dict):
    """The ctypes library of ``csrc/<name>.cu``, built if needed, with each
    entry point's argument types set (pointers and the stream as
    ``c_void_p``; every entry point returns a ``cudaError_t`` as int)."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _load_lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build_libraries([name])[name]))
            for fn_name, args in signatures.items():
                fn = getattr(lib, fn_name)
                fn.argtypes = args
                fn.restype = ctypes.c_int
            _libs[name] = lib
    return lib


def on_cpu(*ts) -> bool:
    """True when every tensor lies on the CPU, False when all lie on one
    CUDA device; raises otherwise."""
    devs = {t.device.type for t in ts}
    if devs == {"cpu"}:
        return True
    if devs != {"cuda"} or len({t.device for t in ts}) != 1:
        raise ValueError(f"tensors on {sorted({str(t.device) for t in ts})}:"
                         " all on the CPU or all on one CUDA device")
    return False


def check(t, name, shape, dtype=torch.float32):
    if t.dtype != dtype:
        raise TypeError(f"{name}: {dtype} expected, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(shape)} expected, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: contiguous tensor expected")


def stream(t):
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


@contextlib.contextmanager
def shard_scope(index: int, device):
    """Launches inside count under shard ``index``; on a CUDA ``device``
    it is also the current device, which a launch through ctypes runs on."""
    prev = getattr(_scope, "shard", None)
    _scope.shard = index
    try:
        if torch.device(device).type == "cuda":
            with torch.cuda.device(device):
                yield
        else:
            yield
    finally:
        _scope.shard = prev


def reset_device_launches():
    with _count_lock:
        DEVICE_LAUNCHES.clear()


def launched(counts: dict, name: str, rc: int, device=None):
    """Raise if the launch failed; else count it in ``counts[name]`` and
    under ``device`` (the launch's tensors') and the current shard in
    ``DEVICE_LAUNCHES``."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {rc}")
    key = (None if device is None else str(device),
           getattr(_scope, "shard", None))
    with _count_lock:
        counts[name] += 1
        per = DEVICE_LAUNCHES.setdefault(key, {})
        per[name] = per.get(name, 0) + 1
