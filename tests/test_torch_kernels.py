"""The ctypes binding of the CUDA kernels (raytracer_tpu_torch/utils/kernels.py),
checked without nvcc or a card: the C entries in csrc/ against SIGNATURES,
and the argument checks that run before any library is loaded."""

from __future__ import annotations

import os
import re

import pytest
import torch

from raytracer_tpu_torch.utils import kernels

torch.set_num_threads(1)

_ENTRY = re.compile(r"^int (rt_\w+)\(([^)]*)\)\s*\{", re.M)


def _c_entries() -> dict[str, list[str]]:
    out = {}
    for src in kernels.SOURCES:
        with open(os.path.join(kernels.CSRC, src)) as f:
            text = f.read()
        for name, params in _ENTRY.findall(text):
            out[name] = [" ".join(p.split()) for p in params.split(",")]
    return out


def _code(param: str) -> str:
    if "*" in param:
        return "o" if param.split("*")[-1].strip() == "work" else "p"
    return {"int": "i", "float": "f"}[param.split()[0]]


def test_c_entries_match_signatures():
    """Every bound entry exists with SIGNATURES' types in order, the stream
    last, and `work` is its one optional pointer."""
    entries = _c_entries()
    assert {"rt_nearest_hit", "rt_any_hit", "rt_shadow_any_hit", "rt_march"} <= set(entries)
    assert {"intersect_kernels.cu", "march_kernel.cu"} <= set(kernels.SOURCES)
    # every C entry in the sources is bound, and nothing else
    assert set(entries) == set(kernels.SIGNATURES) | {e for e, _ in kernels.ATTRS.values()}
    for name, sig in kernels.SIGNATURES.items():
        params = entries[name]
        assert params[-1] == "void* stream", (name, params[-1])
        assert "".join(_code(p) for p in params[:-1]) == sig, name
        assert sig.count("o") == 1, name
    for entry, _ in kernels.ATTRS.values():
        assert entries[entry] == ["int which", "int* out"], entry


@pytest.mark.parametrize("entry", sorted(kernels.SIGNATURES))
def test_launch_refuses_missing_or_host_pointers(entry):
    """None passes only for the optional `work`; a required pointer that is
    None or a CPU tensor raises before any library is built or loaded."""
    sig = kernels.SIGNATURES[entry]
    host = torch.zeros(4)
    args = [None if c in "po" else (0.0 if c == "f" else 0) for c in sig]
    with pytest.raises(TypeError, match="CUDA tensors"):
        kernels.launch(entry, *args)
    args = [host if c == "p" else (0.0 if c == "f" else 0) for c in sig]
    args[sig.index("o")] = host
    with pytest.raises(TypeError, match="CUDA tensors"):
        kernels.launch(entry, *args)
    with pytest.raises(TypeError, match="takes"):
        kernels.launch(entry, *args[:-1])


def test_check_work_shape():
    cpu = torch.device("cpu")
    kernels.check_work(None, 8, cpu)
    kernels.check_work(torch.zeros((len(kernels.WORK_ROWS), 8), dtype=torch.int32), 8, cpu)
    with pytest.raises(ValueError):
        kernels.check_work(torch.zeros((2, 8), dtype=torch.int32), 8, cpu)
    with pytest.raises(ValueError):
        kernels.check_work(torch.zeros((len(kernels.WORK_ROWS), 8)), 8, cpu)
