"""The ctypes binding of the CUDA kernels (raytracer_tpu_torch/utils/kernels.py),
checked without nvcc or a card: the C entries in csrc/ against SIGNATURES,
and the argument checks that run before any library is loaded."""

from __future__ import annotations

import os
import re
import types

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


# the optional pointers: the counters' outputs, the sphere chunk table and
# the cone rows
OPTIONAL = ("work", "sph_tests", "sph_box_tests", "sph_rows", "sph_box", "sph_sup", "cone",
            "cone_tests")


def _code(param: str) -> str:
    if "*" in param:
        return "o" if param.split("*")[-1].strip() in OPTIONAL else "p"
    return {"int": "i", "float": "f"}[param.split()[0]]


def test_c_entries_match_signatures():
    """Every bound entry exists with SIGNATURES' types in order, the stream
    last, and `work` is its one optional pointer (the ordered delivery,
    which runs no tests, has none; the MC walks have `sph_tests` too, and
    the dense ones `sph_box_tests` and the sphere chunk table's three; the
    staged dense entries the cone rows, and the MC one `cone_tests`)."""
    entries = _c_entries()
    assert {"rt_nearest_hit", "rt_any_hit", "rt_shadow_any_hit", "rt_march"} <= set(entries)
    assert {"intersect_kernels.cu", "march_kernel.cu"} <= set(kernels.SOURCES)
    # every C entry in the sources is bound, and nothing else
    assert set(entries) == set(kernels.SIGNATURES) | {e for e, _ in kernels.ATTRS.values()}
    for name, sig in kernels.SIGNATURES.items():
        params = entries[name]
        assert params[-1] == "void* stream", (name, params[-1])
        assert "".join(_code(p) for p in params[:-1]) == sig, name
        want = (0 if name == "rt_deliver" else 2 if name.startswith("rt_mc_trace_blk")
                else 8 if name == "rt_mc_trace" else 6 if name.startswith("rt_mc_trace")
                else 2 if name == "rt_level" else 1)
        assert sig.count("o") == want, name
    for entry, _ in kernels.ATTRS.values():
        n_tri = ["int n_tri"] if entry in kernels.ATTRS_N_TRI else []
        assert entries[entry] == ["int which", *n_tri, "int* out"], entry


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
    if "o" in sig:
        args[sig.index("o")] = host
    with pytest.raises(TypeError, match="CUDA tensors"):
        kernels.launch(entry, *args)
    with pytest.raises(TypeError, match="takes"):
        kernels.launch(entry, *args[:-1])


class _OnCard(torch.Tensor):
    """A CPU tensor that says it lies on cuda:<card>: the launch guard's
    stand-in for a tensor of one of several cards."""

    @property
    def device(self):
        return torch.device("cuda", self.card)


def _on_card(card):
    t = torch.zeros(4).as_subclass(_OnCard)
    t.card = card
    return t


@pytest.mark.parametrize("entry", ["rt_mc_trace", "rt_level_blk", "rt_binned_bounce",
                                   "rt_deliver"])
@pytest.mark.parametrize("current, stray", [(0, 1), (1, 0), (3, 2)])
def test_launch_refuses_a_tensor_of_another_card(monkeypatch, entry, current, stray):
    """Every pointer tensor must lie on the current device, read once a
    launch: all on it, the entry is called; one on another card (first,
    last or `work`), RuntimeError naming the entry and both devices, and
    nothing is called."""
    sig = kernels.SIGNATURES[entry]
    reads, called = [], []
    monkeypatch.setattr(torch.cuda, "current_device", lambda: reads.append(1) or current)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda: types.SimpleNamespace(cuda_stream=0))
    lib = types.SimpleNamespace(**{entry: lambda *a: called.append(a) or 0})
    monkeypatch.setattr(kernels, "library", lambda: lib)
    args = [_on_card(current) if c in "po" else (0.0 if c == "f" else 0) for c in sig]
    kernels.launch(entry, *args)
    assert len(called) == 1 and len(reads) == 1
    assert called[0][-1] == 0 and called[0][0] == args[0].data_ptr()
    pointers = [i for i, c in enumerate(sig) if c in "po"]
    for k in {pointers[0], pointers[-1], *(i for i, c in enumerate(sig) if c == "o")}:
        bad = list(args)
        bad[k] = _on_card(stray)
        with pytest.raises(RuntimeError,
                           match=f"{entry}: a pointer argument lies on cuda:{stray}, but the "
                                 f"current device is cuda:{current}"):
            kernels.launch(entry, *bad)
    assert len(called) == 1


def test_check_work_shape():
    cpu = torch.device("cpu")
    kernels.check_work(None, 8, cpu)
    kernels.check_work(torch.zeros((len(kernels.WORK_ROWS), 8), dtype=torch.int32), 8, cpu)
    with pytest.raises(ValueError):
        kernels.check_work(torch.zeros((2, 8), dtype=torch.int32), 8, cpu)
    with pytest.raises(ValueError):
        kernels.check_work(torch.zeros((len(kernels.WORK_ROWS), 8)), 8, cpu)


def _header() -> str:
    with open(os.path.join(kernels.CSRC, "common.cuh")) as f:
        return f.read()


def test_work_rows_follow_the_header():
    """WORK_ROWS names the rows Work::put writes, in its order."""
    text = _header()
    assert int(re.search(r"constexpr int WORK_ROWS = (\d+);", text).group(1)) == len(kernels.WORK_ROWS)
    put = text[text.index("void put(int* __restrict__ out"):text.index("void put_helped")]
    written = re.findall(r"out\[(.*?)lane\] = (\w+)", put)
    row = lambda prefix: 0 if not prefix else int(prefix.split("*")[0]) if "*" in prefix else 1
    assert [row(pre) for pre, _ in written] == list(range(len(kernels.WORK_ROWS)))
    names = {"chunks": "chunk", "staged": "wchunk", "timer_ns": "t_out", "cycles": "cyc_all"}
    assert tuple(names.get(v, v) for _, v in written) == kernels.WORK_ROWS


@pytest.mark.parametrize("entry,thread", [("rt_mc_trace_blk", "rt_mc_trace_blk_thread"),
                                          ("rt_binned_bounce", "rt_binned_bounce_thread"),
                                          ("rt_level_blk", "rt_level_blk_thread"),
                                          ("rt_binned_terminal", "rt_binned_terminal_thread"),
                                          ("rt_binned_primary", "rt_binned_primary_thread")])
def test_cooperative_entries_take_the_hot_tables(entry, thread):
    """The cooperative walk's entry is its per-thread yardstick's plus the
    four hot tables right after the blocked ones, in kernel_geometry's order."""
    entries = _c_entries()
    coop, ref = entries[entry], entries[thread]
    at = coop.index("int n_chunks") + 1
    assert coop[at:at + 4] == ["const float* hot", "const int* ids", "const int* live",
                               "const int* row_of_tri"]
    assert coop[:at] + coop[at + 4:] == ref
    sig, ref_sig = kernels.SIGNATURES[entry], kernels.SIGNATURES[thread]
    assert sig.replace(kernels._BLK + kernels._HOT, kernels._BLK, 1) == ref_sig


@pytest.mark.parametrize("entry,thread", [("rt_mc_trace", "rt_mc_trace_thread"),
                                          ("rt_level", "rt_level_thread")])
def test_staged_dense_entries_take_the_hot_rows(entry, thread):
    """The staged dense walk's entry is its per-thread yardstick's plus the
    dense hot rows right after the tables, in kernel_geometry's order, and
    the cone rows and their count after the scene's last table (the MC
    walk's also a last output, `cone_tests`): only the staged walks cast
    cones."""
    entries = _c_entries()
    staged, ref = list(entries[entry]), entries[thread]
    at = staged.index("int n_light") + 1
    assert staged.pop(at) == "const float* hot"
    at = staged.index("const float* cone")
    assert staged[at - 1] in ("int n_sph_chunks", "int n_light")
    assert staged[at:at + 2] == ["const float* cone", "int n_cone"]
    del staged[at:at + 2]
    if entry == "rt_mc_trace":
        at = staged.index("long long* sph_box_tests") + 1
        assert staged.pop(at) == "long long* cone_tests"
    assert staged == ref
    sig, ref_sig = kernels.SIGNATURES[entry], kernels.SIGNATURES[thread]
    sig = sig.replace(kernels._TABLES + "p", kernels._TABLES, 1).replace(kernels._CONE, "", 1)
    if entry == "rt_mc_trace":
        sig = sig.replace("ppooo" + "o", "ppooo", 1)
    assert sig == ref_sig


@pytest.mark.parametrize("entry,thread,after", [("rt_march", "rt_march_thread", "int n_sph"),
                                                ("rt_shadow_any_hit", "rt_shadow_any_hit_thread",
                                                 "int n_light"),
                                                ("rt_nearest_hit", "rt_nearest_hit_thread",
                                                 "int n_sph"),
                                                ("rt_any_hit", "rt_any_hit_thread", "int n_sph")])
def test_listed_unfused_entries_take_the_hot_rows_and_a_lane_list(entry, thread, after):
    """The unfused path's listed kernels' entries (march, shadow, nearest
    hit, any hit) are their per-thread yardsticks' plus the dense hot rows
    right after the sphere table and the lane list (scratch) before the
    first output."""
    entries = _c_entries()
    staged, ref = list(entries[entry]), entries[thread]
    assert staged.pop(staged.index("int n_sph") + 1) == "const float* hot"
    assert staged.pop(staged.index(after) + 1) == "int* lanes"
    assert staged == ref
    sig, ref_sig = kernels.SIGNATURES[entry], kernels.SIGNATURES[thread]
    assert len(sig) == len(ref_sig) + 2 and sig.count("o") == ref_sig.count("o") == 1


def test_dense_hot_rows_are_what_the_staged_walks_read():
    from raytracer_tpu_torch.ops import kernel_common as kc
    from raytracer_tpu_torch.scene.presets import demo_scene

    scene = demo_scene(device="cpu")
    tb = scene.tables
    assert torch.equal(tb.hot, tb.tri[:, :kc.HOT_COLS]) and tb.hot.is_contiguous()
    assert tb.hot.data_ptr() % 16 == 0
    kc.check_tables(tb, scene.device)
    geo = kc.kernel_geometry(tb, None, hot=True)
    assert geo[-1] is tb.hot and len(geo) == len(kernels._TABLES) + 1
    assert len(kc.kernel_geometry(tb)) == len(kernels._TABLES)
    with pytest.raises(ValueError):  # rows cut out of the wider table: not contiguous
        kc.check_tables(tb._replace(hot=tb.tri[:, :kc.HOT_COLS]), scene.device)
    with pytest.raises(ValueError):
        kc.kernel_geometry(tb._replace(hot=None), None, hot=True)


def test_attrs_name_both_walks_of_the_redesigned_kernels():
    for coop in ("level", "mc", "mc_gated", "level_blk", "mc_blk", "binned_bounce",
                 "binned_terminal", "binned_primary", "march", "shadow_any_hit", "nearest_hit",
                 "any_hit"):
        assert kernels.ATTRS[coop] != kernels.ATTRS[coop + "_thread"]
        assert kernels.ATTRS[coop][0] == kernels.ATTRS[coop + "_thread"][0]
    assert len(set(kernels.ATTRS.values())) == len(kernels.ATTRS)
