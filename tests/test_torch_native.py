"""raytracer_tpu_torch/utils/native.py: the C++ host runtime (native/src/
host.cpp) against the port's pure-Python paths, as tests/test_native.py
holds it against the JAX package's.  The library is compiled from the
committed source into the test's own directory (the Makefile's flags), so
no other test's build of native/ can be half-written when this one loads."""

import os
import subprocess

import numpy as np
import pytest
import torch

from raytracer_tpu_torch.ops.tonemap import luma_percentile_scale
from raytracer_tpu_torch.utils import color, native, png

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    so = str(tmp_path_factory.mktemp("native") / "libraytpu_host.so")
    subprocess.run(["g++", "-O3", "-std=c++17", "-fPIC", "-shared", "-o", so,
                    os.path.join(REPO, "native", "src", "host.cpp"), "-lz"], check=True)
    saved = native.CANDIDATES
    native.CANDIDATES = (so,)
    native.library.cache_clear()
    assert native.available(), "native host runtime failed to load"
    yield so
    native.CANDIDATES = saved
    native.library.cache_clear()


def test_loader_looks_in_native_first():
    assert os.path.abspath(native.CANDIDATES[0]) == os.path.join(
        REPO, "native", "libraytpu_host.so")


def test_a_library_without_the_entries_is_passed_over(tmp_path):
    """A file that loads but lacks an entry (a build half written, or
    another library) is skipped for the next candidate, then the Python
    path."""
    src = tmp_path / "other.cpp"
    src.write_text('extern "C" int rt_other(void) { return 0; }\n')
    so = str(tmp_path / "libother.so")
    subprocess.run(["g++", "-fPIC", "-shared", "-o", so, str(src)], check=True)
    saved = native.CANDIDATES
    native.CANDIDATES = (so, str(tmp_path / "missing.so"))
    native.library.cache_clear()
    try:
        assert native.library() is None
    finally:
        native.CANDIDATES = saved
        native.library.cache_clear()


def test_native_srgb_matches_python(lib):
    rng = np.random.default_rng(0)
    lin = rng.uniform(-0.1, 1.2, size=(64, 3)).astype(np.float32)
    got = native.srgb_encode_u8(lin)
    want = color.linear_to_u8(torch.as_tensor(lin)).numpy()
    # rounding at an exact .5 may differ by one step
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    assert native.srgb_encode_u8(np.asarray([[np.nan, -np.inf, np.inf]], np.float32)).tolist() \
        == [[0, 0, 255]]


def test_native_png_roundtrip(lib, tmp_path):
    rng = np.random.default_rng(1)
    rgb = rng.integers(0, 256, size=(21, 13, 3), dtype=np.uint8)
    path = str(tmp_path / "native.png")
    native.write_png_atomic(path, rgb)
    np.testing.assert_array_equal(png.read_png_rgb8(path), rgb)
    assert not any(f.endswith(".tmp") for f in os.listdir(tmp_path))


def test_native_percentile_matches_the_tone_map(lib):
    rng = np.random.default_rng(2)
    rgb = rng.gamma(2.0, 0.5, size=(4096, 3)).astype(np.float32)
    rgb[7] = [np.nan, 1.0, 1.0]
    rgb[9] = [0.0, 0.0, 0.0]
    got = native.luma_percentile(rgb, 0.99)
    want, _ = luma_percentile_scale(torch.as_tensor(rgb), 0.99)
    assert got == pytest.approx(float(want), rel=1e-5)


def test_png_writer_takes_native_when_it_loads(lib, tmp_path, monkeypatch):
    rgb = np.zeros((4, 4, 3), np.uint8)
    rgb[..., 0] = 200
    calls = []
    monkeypatch.setattr(native, "write_png_atomic",
                        lambda p, x, w=native.write_png_atomic: (calls.append(p), w(p, x)))
    path = str(tmp_path / "via_native.png")
    png.write_png_atomic(path, rgb)
    assert calls == [path]
    np.testing.assert_array_equal(png.read_png_rgb8(path), rgb)


def test_no_native_switch_takes_the_python_writer(lib, tmp_path, monkeypatch):
    monkeypatch.setenv("RAYTPU_NO_NATIVE", "1")
    native.library.cache_clear()
    try:
        assert not native.available()
        rgb = np.arange(4 * 5 * 3, dtype=np.uint8).reshape(4, 5, 3)
        path = str(tmp_path / "python.png")
        png.write_png_atomic(path, rgb)
        with open(path, "rb") as f:
            assert f.read() == png.encode_png_rgb8(rgb)  # the Python encoder's bytes
    finally:
        monkeypatch.delenv("RAYTPU_NO_NATIVE")
        native.library.cache_clear()
    assert native.available()
