"""Build the CUDA kernels with nvcc and bind them with ctypes.

The sources under raytracer_tpu_torch/csrc/ compile into ONE shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds), at first use, into raytracer_tpu_torch/_build/.  The library's
name carries a hash of the sources and flags, so an edit rebuilds it and
an unchanged tree reuses it.  Each C entry launches on the stream it is
given and returns cudaGetLastError(); `launch` raises if that is not 0.

Built for sm_90a (Hopper) only, and without --use_fast_math: fast math
flushes subnormals, which breaks the is_normal photon filter, and
approximates division and sqrt.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
import time

import torch

PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(PKG, "csrc")
BUILD = os.path.join(PKG, "_build")
SOURCES = ("level_kernel.cu", "mc_kernel.cu")
HEADERS = ("common.cuh",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

# C signatures: p = pointer (tensor), i = int, f = float; every entry also
# takes the CUDA stream last.
_TABLES = "p" + "ip" * 3 + "i"  # tri, n_tri, sph, n_sph, mat, n_obj, lights, n_light
SIGNATURES = {
    # ray_o, ray_d, unifs, tables, photon, casts, n, depth, max_distance,
    # max_retries
    "rt_mc_trace": "ppp" + _TABLES + "pp" + "ii" + "fi",
    # pf, pi, tables, contrib, rf, ri, ff, fi, casts, k, last, direct,
    # threshold, max_distance, max_retries
    "rt_level": "pp" + _TABLES + "pppppp" + "iii" + "ffi",
}
ATTRS = {"level": "rt_level_attrs", "mc": "rt_mc_attrs"}
_CTYPES = {"p": ctypes.c_void_p, "i": ctypes.c_int, "f": ctypes.c_float}


@dataclasses.dataclass
class LaunchCounts:
    """Per wrapper: `launches` of its kernel, and `plain` calls that took
    the plain version (CPU tensors)."""

    launches: int = 0
    plain: int = 0


def check(name: str, t: torch.Tensor, dtype, shape, device) -> None:
    """Raise unless `t` has this dtype, shape and device and is contiguous."""
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) or t.device != device:
        raise ValueError(f"{name}: expected {dtype} {tuple(shape)} on {device}, "
                         f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def nvcc_path() -> str:
    for cand in (os.environ.get("CUDA_HOME") and os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in HEADERS + SOURCES:
        with open(os.path.join(CSRC, name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read())
    return h.hexdigest()[:16]


def build(verbose: bool = False) -> tuple[str, float]:
    """Compile the library if it is not built yet -> (path, seconds spent
    compiling, 0.0 when it was already there)."""
    out = os.path.join(BUILD, f"libraytracer_kernels_{_digest()}.so")
    if os.path.exists(out):
        return out, 0.0
    os.makedirs(BUILD, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp,
           *(os.path.join(CSRC, s) for s in SOURCES)]
    if verbose:
        cmd[1:1] = ["-Xptxas", "-v"]
    t0 = time.time()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    if verbose and proc.stderr:
        print(proc.stderr, end="")
    os.replace(tmp, out)
    return out, time.time() - t0


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    path, _ = build()
    lib = ctypes.CDLL(path)
    for name, sig in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = [_CTYPES[c] for c in sig] + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    for name in ATTRS.values():
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.POINTER(ctypes.c_int)]
        fn.restype = ctypes.c_int
    return lib


def launch(name: str, *args) -> None:
    """Call C entry `name` with tensors passed as device pointers, on the
    current CUDA stream; raise if the launch reported an error."""
    sig = SIGNATURES[name]
    if len(args) != len(sig):
        raise TypeError(f"{name} takes {len(sig)} arguments, got {len(args)}")
    conv = []
    for c, a in zip(sig, args):
        if c == "p":
            if not isinstance(a, torch.Tensor) or a.device.type != "cuda":
                raise TypeError(f"{name}: pointer arguments must be CUDA tensors")
            conv.append(a.data_ptr())
        else:
            conv.append(a)
    stream = torch.cuda.current_stream().cuda_stream
    err = getattr(library(), name)(*conv, stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


def kernel_attrs(which: str) -> dict:
    """Compiled attributes of kernel `which` ("level" or "mc")."""
    out = (ctypes.c_int * 4)()
    err = getattr(library(), ATTRS[which])(out)
    if err != 0:
        raise RuntimeError(f"cudaFuncGetAttributes failed: {err}")
    return {"registers": out[0], "local_bytes": out[1], "shared_bytes": out[2],
            "max_threads": out[3]}
