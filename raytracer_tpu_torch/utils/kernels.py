"""Build the CUDA kernels with nvcc and bind them with ctypes.

The sources under raytracer_tpu_torch/csrc/ compile (one nvcc per source,
in parallel) and link into ONE shared library with a plain C interface
(no PyTorch headers, so a build takes seconds), at first use, into
raytracer_tpu_torch/_build/.  The library's
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
SOURCES = ("level_kernel.cu", "mc_kernel.cu", "mc_binned.cu", "intersect_kernels.cu",
           "march_kernel.cu", "deliver.cu")
HEADERS = ("common.cuh", "mc_walk.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

# C signatures: p = pointer (a CUDA tensor), o = optional pointer (a CUDA
# tensor or None), i = int, f = float; every entry also takes the CUDA
# stream last.  The optional pointer `work`: given a tensor, the entry runs
# the instantiation that counts each lane's tests into it (WORK_ROWS); None
# runs the main path's, which counts nothing.  The MC entries' second
# optional pointer, `sph_tests` (int64 [n]): given a tensor, the main path's
# walk counting its sphere tests alone fills it with each lane's.  The dense
# MC entries' third, `sph_box_tests` (int64 [n]), receives the gate's box
# tests of the same walk; they take the sphere chunk table as optional
# pointers too (None and a count of 0: a scene without one).
_TABLES = "p" + "ip" * 3 + "i"  # tri, n_tri, sph, n_sph, mat, n_obj, lights, n_light
_BLK = "pppi"  # blocked tri rows, chunk boxes, supergroup boxes, n_chunks
# what the warp-cooperative walks read besides: hot rows, their ids, the
# chunks' live row counts, the triangles' blocked rows (a dense scene's
# staged walks read its hot rows only, after _TABLES: "p")
_HOT = "pppp"
_SPH = "oooi"  # sphere chunk rows, chunk boxes, supergroup boxes, n_sph_chunks
_GEO = "pipi"  # tri, n_tri, sph, n_sph
_RAYS = "pppppp"  # ray_o, ray_d, face, excl_prim, excl_face, active
SIGNATURES = {
    # ray_o, ray_d, unifs, tables, photon, casts, work, sph_tests,
    # (sph_box_tests,) n, depth, max_distance, max_retries
    "rt_mc_trace": "ppp" + _TABLES + "p" + _SPH + "ppooo" + "ii" + "fi",
    "rt_mc_trace_thread": "ppp" + _TABLES + _SPH + "ppooo" + "ii" + "fi",
    "rt_mc_trace_blk": "ppp" + _TABLES + _BLK + _HOT + "ppoo" + "ii" + "fi",
    "rt_mc_trace_blk_thread": "ppp" + _TABLES + _BLK + "ppoo" + "ii" + "fi",
    # pf, pi, tables, contrib, rf, ri, ff, fi, casts, work, k, last, direct,
    # threshold, max_distance, max_retries
    "rt_level": "pp" + _TABLES + "p" + "ppppppo" + "iii" + "ffi",
    "rt_level_thread": "pp" + _TABLES + "ppppppo" + "iii" + "ffi",
    "rt_level_blk": "pp" + _TABLES + _BLK + _HOT + "ppppppo" + "iii" + "ffi",
    "rt_level_blk_thread": "pp" + _TABLES + _BLK + "ppppppo" + "iii" + "ffi",
    # ray_o, ray_d, tables, st_f, st_i, casts, work, n
    "rt_binned_primary": "pp" + _TABLES + _BLK + _HOT + "pppo" + "i",
    "rt_binned_primary_thread": "pp" + _TABLES + _BLK + "pppo" + "i",
    # st_f, st_i, unifs, tables, out_f, out_i, casts, work, n, first,
    # max_distance, max_retries
    "rt_binned_bounce": "ppp" + _TABLES + _BLK + _HOT + "pppo" + "ii" + "fi",
    "rt_binned_bounce_thread": "ppp" + _TABLES + _BLK + "pppo" + "ii" + "fi",
    # st_f, st_i, tables, photon, casts, work, n, first
    "rt_binned_terminal": "pp" + _TABLES + _BLK + _HOT + "ppo" + "ii",
    "rt_binned_terminal_thread": "pp" + _TABLES + _BLK + "ppo" + "ii",
    # rays, geometry, hot rows, lanes (scratch), t, idx, bf, valid, work, n
    "rt_nearest_hit": _RAYS + _GEO + "p" + "p" + "pppp" + "o" + "i",
    "rt_nearest_hit_thread": _RAYS + _GEO + "pppp" + "o" + "i",
    # rays, limit, geometry, hot rows, lanes (scratch), blocked, work, n
    "rt_any_hit": _RAYS + "p" + _GEO + "p" + "p" + "p" + "o" + "i",
    "rt_any_hit_thread": _RAYS + "p" + _GEO + "p" + "o" + "i",
    # pos, dirs, excl_prim, limits, actives, geometry, hot rows, lights,
    # n_light, lanes (scratch), blocked, work, n
    "rt_shadow_any_hit": "ppppp" + _GEO + "p" + "pi" + "p" + "p" + "o" + "i",
    "rt_shadow_any_hit_thread": "ppppp" + _GEO + "pi" + "p" + "o" + "i",
    # pos, nrm, dir, k, want, geometry, hot rows, lanes (scratch), esc_o,
    # esc_d, prim, escaped, travel, iters, work, n, max_distance, max_retries
    "rt_march": "ppppp" + _GEO + "p" + "p" + "pppppp" + "o" + "i" + "fi",
    "rt_march_thread": "ppppp" + _GEO + "pppppp" + "o" + "i" + "fi",
    # img (in place), sorted slots, their lanes, contrib [3, k], n, k
    "rt_deliver": "pppp" + "ii",
}
# Rows of a `work` output (csrc/common.cuh Work), per lane: triangle tests
# begun, those that went on to the plane's t, edge tests, sphere tests,
# box (slab) tests; the chunks of a blocked mesh whose rows one of the
# lane's rays tested, and the chunks its warp staged in shared memory
# (counted on the warp's first lane; 0 in the per-thread walks); the low 32
# bits of the card's nanosecond clock when the lane's thread began and when
# it wrote its counts; the SM cycles the thread spent in a cooperative
# walk's box tests and votes, in waiting for staged chunks, in testing
# staged rows (0 in the per-thread walks), and from its start to its end;
# then the thread's cycles by phase of the walk, in every geometry: in
# nearest-hit sweeps, in shadow tests and in interior marches.
WORK_ROWS = ("tri", "plane", "edge", "sph", "box", "chunk", "wchunk", "t_in", "t_out",
             "cyc_box", "cyc_stage", "cyc_rows", "cyc_all", "cyc_near", "cyc_shadow",
             "cyc_march")
# kernel name -> (C entry that reports its attributes, instantiation index).
# "level", "mc", "nearest_hit", "any_hit", "shadow_any_hit" and "march" are
# the dense walks out of shared memory, "level_blk", "mc_blk" and the binned
# primary, bounce and terminal kernels the warp-cooperative walks of the
# main path; the "*_thread" ones are their per-thread yardsticks;
# "mc_gated" is the dense MC walk with its sphere sweeps gated by the
# sphere chunk table.
ATTRS = {
    "level": ("rt_level_attrs", 0), "level_thread": ("rt_level_attrs", 3),
    "level_blk": ("rt_level_attrs", 1), "level_blk_thread": ("rt_level_attrs", 2),
    "mc": ("rt_mc_attrs", 0), "mc_thread": ("rt_mc_attrs", 3),
    "mc_blk": ("rt_mc_attrs", 1), "mc_blk_thread": ("rt_mc_attrs", 2),
    "mc_gated": ("rt_mc_attrs", 4), "mc_gated_thread": ("rt_mc_attrs", 5),
    "binned_primary": ("rt_binned_attrs", 0),
    "binned_bounce_first": ("rt_binned_attrs", 1),
    "binned_bounce": ("rt_binned_attrs", 2),
    "binned_terminal_first": ("rt_binned_attrs", 3),
    "binned_terminal": ("rt_binned_attrs", 4),
    "binned_bounce_thread": ("rt_binned_attrs", 5),
    "binned_terminal_thread": ("rt_binned_attrs", 6),
    "binned_primary_thread": ("rt_binned_attrs", 7),
    "nearest_hit": ("rt_intersect_attrs", 0), "any_hit": ("rt_intersect_attrs", 1),
    "shadow_any_hit": ("rt_intersect_attrs", 2),
    "shadow_any_hit_thread": ("rt_intersect_attrs", 3),
    "nearest_hit_thread": ("rt_intersect_attrs", 4), "any_hit_thread": ("rt_intersect_attrs", 5),
    "march": ("rt_march_attrs", 0), "march_thread": ("rt_march_attrs", 1),
}
# The attribute entries that also take a dense scene's triangle count: the
# staged walks' shared bytes, and so their blocks per SM, depend on it.
ATTRS_N_TRI = ("rt_level_attrs", "rt_mc_attrs", "rt_intersect_attrs", "rt_march_attrs")
_CTYPES = {"p": ctypes.c_void_p, "o": ctypes.c_void_p, "i": ctypes.c_int,
           "f": ctypes.c_float}


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


def check_work(work: torch.Tensor | None, n: int, device) -> None:
    """Raise unless `work` is None or an int32 [len(WORK_ROWS), n] output."""
    if work is not None:
        check("work", work, torch.int32, (len(WORK_ROWS), n), device)


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
    compiling, 0.0 when it was already there).  One nvcc per source, all
    started together, then one link."""
    out = os.path.join(BUILD, f"libraytracer_kernels_{_digest()}.so")
    if os.path.exists(out):
        return out, 0.0
    os.makedirs(BUILD, exist_ok=True)
    tag = f"{os.getpid()}"
    nvcc = nvcc_path()
    compile_flags = [f for f in NVCC_FLAGS if f != "-shared"]
    if verbose:
        compile_flags += ["-Xptxas", "-v"]
    t0 = time.time()
    objs, procs = [], []
    for src in SOURCES:
        obj = os.path.join(BUILD, f"{os.path.splitext(src)[0]}.{tag}.o")
        objs.append(obj)
        procs.append(subprocess.Popen(
            [nvcc, *compile_flags, "-c", os.path.join(CSRC, src), "-o", obj],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    failed = []
    for src, proc in zip(SOURCES, procs):
        _, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{src} ({proc.returncode}):\n{err}")
        elif verbose and err:
            print(f"--- {src}\n{err}", end="")
    if failed:
        raise RuntimeError("nvcc failed: " + "\n".join(failed))
    tmp = f"{out}.{tag}.tmp"
    proc = subprocess.run([nvcc, *NVCC_FLAGS, "-o", tmp, *objs],
                          capture_output=True, text=True)
    for obj in objs:
        os.remove(obj)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{proc.stderr}")
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
    for name, _ in ATTRS.values():
        fn = getattr(lib, name)
        fn.argtypes = ([ctypes.c_int] * (2 if name in ATTRS_N_TRI else 1)
                       + [ctypes.POINTER(ctypes.c_int)])
        fn.restype = ctypes.c_int
    return lib


def launch(name: str, *args) -> None:
    """Call C entry `name` with tensors passed as device pointers, on the
    current CUDA stream; raise if the launch reported an error.

    The kernel runs on the current device, so every pointer tensor must lie
    on it: a tensor of another card raises (on a host whose cards reach
    each other's memory it would otherwise be read there, unreported)."""
    sig = SIGNATURES[name]
    if len(args) != len(sig):
        raise TypeError(f"{name} takes {len(sig)} arguments, got {len(args)}")
    conv, current = [], None
    for c, a in zip(sig, args):
        if c == "o" and a is None:  # an optional output the caller does not want
            conv.append(None)
        elif c in "po":
            dev = a.device if isinstance(a, torch.Tensor) else None
            if dev is None or dev.type != "cuda":
                raise TypeError(f"{name}: pointer arguments must be CUDA tensors")
            if current is None:  # read once a launch
                current = torch.cuda.current_device()
            if dev.index != current:
                raise RuntimeError(f"{name}: a pointer argument lies on {dev}, but the "
                                   f"current device is cuda:{current}")
            conv.append(a.data_ptr())
        else:
            conv.append(a)
    stream = torch.cuda.current_stream().cuda_stream
    err = getattr(library(), name)(*conv, stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


def kernel_attrs(which: str, n_tri: int = 0) -> dict:
    """Compiled attributes of kernel instantiation `which` (a key of
    ATTRS); the staged dense walks ("level", "mc", "nearest_hit",
    "any_hit", "shadow_any_hit", "march") at the shared bytes of a scene of
    `n_tri` triangles."""
    out = (ctypes.c_int * 6)()
    entry, index = ATTRS[which]
    args = (index, n_tri, out) if entry in ATTRS_N_TRI else (index, out)
    err = getattr(library(), entry)(*args)
    if err != 0:
        raise RuntimeError(f"cudaFuncGetAttributes failed: {err}")
    return {"registers": out[0], "local_bytes": out[1], "shared_bytes": out[2],
            "max_threads": out[3], "dynamic_shared_bytes": out[4], "blocks_per_sm": out[5]}
