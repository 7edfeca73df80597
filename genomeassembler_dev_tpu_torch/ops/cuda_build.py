"""Build and load the port's CUDA kernels (csrc/<name>.cu).

Each source is compiled by nvcc for sm_90a into a shared library with a
plain C interface, build/torch_kernels/lib<name>_<hash of source, shared
headers and flags>.so, and loaded with ctypes. The compiler's register and
shared memory report (-Xptxas -v) is kept beside it as <library>.log.
Nothing is built when a module is imported: a wrapper loads its library at
its first launch, and `build` compiles several sources at once. An entry
point makes the tensors' device current for its call only
(csrc/device_guard.cuh).
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading

import torch

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "torch_kernels")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# every kernel of csrc/, by source name: `build(*KERNELS)` compiles them all
KERNELS = ("myers", "histogram", "prefix_min", "ks")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def library_path(name: str) -> str:
    """Where csrc/<name>.cu builds to under the current source, the shared
    headers (csrc/*.cuh) and the flags."""
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for path in [os.path.join(_SRC_DIR, f"{name}.cu"),
                 *sorted(glob.glob(os.path.join(_SRC_DIR, "*.cuh")))]:
        with open(path, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{name}_{h.hexdigest()[:12]}.so")


def build(*names: str) -> list[str]:
    """Compile csrc/<name>.cu for every name whose library is missing, all
    nvcc processes at once; returns the library paths in order. Raises if
    any build fails."""
    paths = [library_path(n) for n in names]
    nvcc = shutil.which("nvcc") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    os.makedirs(BUILD_DIR, exist_ok=True)
    jobs = []
    for name, so in zip(names, paths):
        if os.path.exists(so):
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(_SRC_DIR, f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                text=True)
        jobs.append((so, tmp, cmd, proc))
    failed = []
    for so, tmp, cmd, proc in jobs:
        out, err = proc.communicate()
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"nvcc failed ({' '.join(cmd)}):\n{err}")
            continue
        with open(so + ".log", "w") as f:
            f.write(out + err)
        os.replace(tmp, so)  # atomic: another process never loads a partial file
    if failed:
        raise RuntimeError("\n".join(failed))
    return paths


def load(name: str, declare) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built on first use;
    `declare(lib)` sets the entry points' argtypes and restype once."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(build(name)[0])
            declare(lib)
            _libs[name] = lib
        return lib


def launch_args(t: torch.Tensor) -> tuple[int, int]:
    """(device index, raw CUDA stream) for a launch on tensor t's device."""
    device = t.device.index
    if device is None:
        device = torch.cuda.current_device()
    return device, torch.cuda.current_stream(t.device).cuda_stream
