"""Build and load the port's CUDA kernels.

Every kernel source under ``qaig_tpu_torch/csrc/`` is compiled by ``nvcc``
for Hopper (``sm_90a``) into a shared library with a plain C interface and
loaded with ``ctypes``; tensors are passed as ``data_ptr()`` integers and
the launch goes on PyTorch's current stream of the tensors' card, with that
card made the current device around the call (every wrapper does this, so a
launch works on any card of the process; the sources set their kernels'
attributes once per device).  The sources include no
PyTorch header, so a build takes seconds, where a
``torch.utils.cpp_extension`` build that compiles PyTorch's headers takes
minutes.

Libraries go to ``build/qaig_tpu_torch_kernels/`` at the repository root
(listed in ``.gitignore``), named by a hash of the sources and flags, so a
checkout builds them at first use and reuses them afterwards.  Nothing here
runs at import time: the first CUDA call builds every source at once, one
``nvcc`` process per source, all started together.
"""

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = (Path(__file__).resolve().parents[2] / "build"
             / "qaig_tpu_torch_kernels")
SOURCES = ("flash_attention", "flash_attention_bwd", "decode_attention",
           "decode_attention_flat", "bmu", "mlp2_fused", "linear_f32")
NVCC_FLAGS = ["-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v", "-lineinfo"]

_lock = threading.Lock()
_libraries = {}
_functions = {}


def _nvcc():
    home = (os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
            or "/usr/local/cuda")
    candidate = Path(home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found: the CUDA kernels are compiled from "
            f"{CSRC} at first use and need the CUDA toolkit "
            "(set CUDA_HOME).")
    return found


def _library_path(name):
    digest = hashlib.sha256()
    for path in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        digest.update(path.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(names=SOURCES):
    """Compile every source in ``names`` that has no library yet, in
    parallel.  Raises with nvcc's output if one fails.  The compiler's
    report (registers, shared memory, spills per kernel) is kept next to
    each library as ``<name>.log``."""
    with _lock:
        jobs = []
        for name in names:
            target = _library_path(name)
            if target.exists():
                continue
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                   str(CSRC / f"{name}.cu")]
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
            jobs.append((name, target, tmp, proc))
        failures = []
        for name, target, tmp, proc in jobs:
            output, _ = proc.communicate()
            (BUILD_DIR / f"{name}.log").write_text(output)
            if proc.returncode != 0:
                failures.append(f"nvcc failed for {name}.cu:\n{output}")
                continue
            os.replace(tmp, target)
        if failures:
            raise RuntimeError("\n".join(failures))


def function(library, symbol, argtypes, restype=ctypes.c_int):
    """The C entry point ``symbol`` of ``library`` (built on first use)
    with its ctypes signature set."""
    key = (library, symbol)
    fn = _functions.get(key)
    if fn is not None:
        return fn
    if library not in _libraries:
        build()
        with _lock:
            if library not in _libraries:
                _libraries[library] = ctypes.CDLL(
                    str(_library_path(library)))
    fn = getattr(_libraries[library], symbol)
    fn.argtypes = argtypes
    fn.restype = restype
    _functions[key] = fn
    return fn


def check(library, err):
    """Raise if a launch returned a CUDA error (``cudaGetLastError()``
    after the launch, as the C entry points return it)."""
    if err:
        message = function(library, f"qaig_{library}_error_string",
                           [ctypes.c_int], ctypes.c_char_p)(err)
        raise RuntimeError(
            f"{library} kernel launch failed: CUDA error {err} "
            f"({message.decode()})")


def stream_handle(tensor):
    import torch
    return torch.cuda.current_stream(tensor.device).cuda_stream


@functools.lru_cache(maxsize=None)
def sm_count(device):
    """Streaming multiprocessors of a CUDA device (the launch plans size
    their grids by it)."""
    import torch
    return torch.cuda.get_device_properties(device).multi_processor_count
