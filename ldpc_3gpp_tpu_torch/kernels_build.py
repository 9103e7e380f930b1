"""Builds the port's CUDA kernels at first use and loads them with ctypes.

Every ``csrc/*.cu`` has a plain C interface and is compiled by ``nvcc`` for
``sm_90a`` into its own shared library under ``build/ldpc_3gpp_tpu_torch/``
beside the package (a directory the repository ignores), named by a hash of
the source, the shared headers (``csrc/*.cuh``) and the flags, so an
unchanged source is not rebuilt.  One
``nvcc`` process per source, all started together.  Nothing but the sources
in this package and the installed CUDA toolkit is used.

``nvcc`` and ``ctypes`` loading are touched only inside functions: importing
this module needs neither a compiler nor a GPU.
"""
from __future__ import annotations

import ctypes
import functools
import glob
import hashlib
import os
import shutil
import subprocess
from typing import Dict, List

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "ldpc_3gpp_tpu_torch")

# -fmad=false: the decoder is held bit-exact against separate f32 roundings,
# so no multiply-add may be contracted.  No --use_fast_math, no -ftz.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def kernel_names() -> List[str]:
    """Names (source stems) of every kernel source in ``csrc/``."""
    return sorted(
        os.path.splitext(os.path.basename(p))[0]
        for p in glob.glob(os.path.join(CSRC_DIR, "*.cu"))
    )


def _nvcc() -> str:
    for var in ("CUDA_HOME", "CUDA_PATH"):
        root = os.environ.get(var)
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _source(name: str) -> str:
    path = os.path.join(CSRC_DIR, name + ".cu")
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    return path


def library_path(name: str) -> str:
    """Where the shared library of kernel ``name`` is (to be) built."""
    h = hashlib.sha256()
    headers = sorted(glob.glob(os.path.join(CSRC_DIR, "*.cuh")))
    for path in [_source(name), *headers]:
        with open(path, "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"{name}-{h.hexdigest()[:16]}.so")


def build_log(name: str) -> str:
    """The compiler's output of the last build of ``name`` (ptxas -v)."""
    with open(library_path(name) + ".log") as f:
        return f.read()


def build(names=None) -> Dict[str, str]:
    """Compile the named kernels (default: all) that are not built yet.

    Starts one ``nvcc`` per source, all together, waits for all of them and
    raises ``RuntimeError`` with the compiler's output if any fails.
    Returns {name: library path}.
    """
    names = kernel_names() if names is None else list(names)
    os.makedirs(BUILD_DIR, exist_ok=True)
    out = {n: library_path(n) for n in names}
    procs = []
    for n in names:
        if os.path.exists(out[n]):
            continue
        tmp = f"{out[n]}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, _source(n)]
        procs.append((n, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failures = []
    for n, tmp, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"nvcc failed for {n}.cu (exit {proc.returncode}):\n{log}")
            if os.path.exists(tmp):
                os.remove(tmp)
            continue
        with open(out[n] + ".log", "w") as f:
            f.write(log)
        os.replace(tmp, out[n])  # atomic: a reader never sees a partial file
    if failures:
        raise RuntimeError("\n".join(failures))
    return out


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The shared library of kernel ``name``, built first if need be."""
    return ctypes.CDLL(build([name])[name])
