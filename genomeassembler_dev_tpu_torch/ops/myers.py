"""The Myers bit-vector Levenshtein kernel (csrc/myers.cu) and its wrapper.

Replaces the TPU kernel genomeassembler_dev_tpu/ops/pallas/myers_kernel.py
(`_kernel`, wrapper `batched_levenshtein_myers`). The kernel is CUDA C++ for
Hopper (sm_90a), built with nvcc at first use into build/torch_kernels/ and
bound with ctypes. For CUDA tensors the wrapper launches it on the current
stream or raises; for CPU tensors it runs the plain prefix-min DP
(ops/edit_distance.py), which is also the kernel's oracle. What bounds the
kernel on the card is described at the top of csrc/myers.cu.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading

import torch

from genomeassembler_dev_tpu_torch.ops.edit_distance import batched_levenshtein

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_PKG_DIR, "csrc", "myers.cu")
_BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "torch_kernels")
_NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
               "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_lib = None


def build() -> str:
    """Compile csrc/myers.cu for sm_90a unless a library built from the same
    source and flags exists; returns its path. The compiler's register and
    shared memory report (-Xptxas -v) is kept beside it as <library>.log."""
    with open(_SRC, "rb") as f:
        tag = hashlib.sha1(f.read() + " ".join(_NVCC_FLAGS).encode()).hexdigest()[:12]
    so = os.path.join(_BUILD_DIR, f"libmyers_{tag}.so")
    if os.path.exists(so):
        return so
    os.makedirs(_BUILD_DIR, exist_ok=True)
    nvcc = shutil.which("nvcc") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
    os.close(fd)
    cmd = [nvcc, *_NVCC_FLAGS, "-o", tmp, _SRC]
    r = subprocess.run(cmd, capture_output=True, text=True)
    if r.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({' '.join(cmd)}):\n{r.stderr}")
    with open(so + ".log", "w") as f:
        f.write(r.stdout + r.stderr)
    os.replace(tmp, so)  # atomic: another process never loads a partial file
    return so


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            lib.gadev_myers_launch.restype = ctypes.c_int
            lib.gadev_myers_launch.argtypes = (
                [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [ctypes.c_void_p])
            _lib = lib
        return _lib


def batched_levenshtein_myers(queries: torch.Tensor, query_lens: torch.Tensor,
                              target: torch.Tensor, mode: str = "NW") -> torch.Tensor:
    """Edit distance of each query [B, M] (uint8 codes, its first
    query_lens[b] positions count) vs one exact-length target [N] (uint8).
    NW: global; HW: infix. An empty query gives N in NW and 0 in HW.
    Returns [B] int32."""
    if mode not in ("NW", "HW"):
        raise ValueError(mode)
    devices = {queries.device, query_lens.device, target.device}
    if len(devices) != 1:
        raise ValueError(f"inputs on several devices: {devices}")
    if queries.device.type == "cpu":
        return batched_levenshtein(queries, query_lens, target, mode=mode)
    if queries.device.type != "cuda":
        raise ValueError(f"no Myers kernel for device {queries.device}")
    if queries.dim() != 2 or queries.dtype != torch.uint8:
        raise ValueError(f"queries must be [B, M] uint8, got {tuple(queries.shape)} "
                         f"{queries.dtype}")
    B, M = queries.shape
    if query_lens.shape != (B,) or query_lens.dtype != torch.int32:
        raise ValueError(f"query_lens must be [{B}] int32, got "
                         f"{tuple(query_lens.shape)} {query_lens.dtype}")
    if target.dim() != 1 or target.dtype != torch.uint8:
        raise ValueError(f"target must be [N] uint8, got {tuple(target.shape)} "
                         f"{target.dtype}")
    if not (queries.is_contiguous() and query_lens.is_contiguous()
            and target.is_contiguous()):
        raise ValueError("queries, query_lens and target must be contiguous")
    if B and int(query_lens.max()) > M:
        raise ValueError(f"a query length exceeds the query width {M}")
    N = target.shape[0]
    W = max(1, -(-M // 32))
    out = torch.empty(B, dtype=torch.int32, device=queries.device)
    peq = torch.empty((4, W, B), dtype=torch.int32, device=queries.device)
    vp = torch.empty((W, B), dtype=torch.int32, device=queries.device)
    vn = torch.empty((W, B), dtype=torch.int32, device=queries.device)
    device = queries.device.index
    if device is None:
        device = torch.cuda.current_device()
    lib = _load()
    err = lib.gadev_myers_launch(
        queries.data_ptr(), query_lens.data_ptr(), target.data_ptr(),
        out.data_ptr(), peq.data_ptr(), vp.data_ptr(), vn.data_ptr(),
        B, M, N, W, int(mode == "HW"), device,
        torch.cuda.current_stream(queries.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"Myers kernel launch failed: CUDA error {err}")
    batched_levenshtein_myers.launches += 1
    return out


# kernel launches since the last reset; CPU calls do not count
batched_levenshtein_myers.launches = 0
