"""The port's progressive schedule, tone map, sRGB/u8, PNG and CLI on the CPU
(plain versions), held against raytracer_tpu where it has a counterpart."""

import contextlib
import functools
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from raytracer_tpu.ops.tonemap import post_process as jax_post_process
from raytracer_tpu.utils import color as jax_color
from raytracer_tpu.utils.color import linear_to_u8 as jax_linear_to_u8
from raytracer_tpu_torch import render
from raytracer_tpu_torch.config import RenderConfig
from raytracer_tpu_torch.ops.distributed import MCResult
from raytracer_tpu_torch.ops.tonemap import luma_percentile_scale, post_process
from raytracer_tpu_torch.parallel import mesh as tmesh
from raytracer_tpu_torch.parallel.progressive import load_checkpoint, render_progressive
from raytracer_tpu_torch.scene.presets import demo_camera, demo_scene
from raytracer_tpu_torch.utils import color, vec
from raytracer_tpu_torch.utils.color import linear_to_u8
from raytracer_tpu_torch.utils.png import decode_png_rgb8, encode_png_rgb8, read_png_rgb8

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = RenderConfig(width=32, height=24, depth=2, epochs=2, tile_rays=512)


def _image(seed=0):
    rng = np.random.default_rng(seed)
    img = rng.exponential(0.4, size=(24, 32, 3)).astype(np.float32)
    img[0, :4] = 0.0  # black pixels are excluded from the statistic
    img[1, 0, 1] = 1e-40  # subnormal luma too
    return img


def test_post_process_and_u8_match_jax():
    img = _image()
    got = post_process(torch.as_tensor(img)).numpy()
    ref = np.asarray(jax_post_process(jnp.asarray(img)))
    # atol: XLA's CPU runtime flushes the subnormal pixel's product to 0
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-37)
    lin = np.linspace(-0.1, 1.2, 4096, dtype=np.float32).reshape(-1, 1) * np.ones(3, np.float32)
    np.testing.assert_array_equal(linear_to_u8(torch.as_tensor(lin)).numpy(),
                                  np.asarray(jax_linear_to_u8(jnp.asarray(lin))))


def _host_read_scale(img_flat, percentile=0.99):
    """luma_percentile_scale as written with the weights copied from the
    host on every call and the index read on the host: the formula the
    card-resident one must give bit for bit."""
    w = torch.tensor(color.LUMA_WEIGHTS, dtype=img_flat.dtype, device=img_flat.device)
    lum = torch.sum(img_flat * w, dim=-1)
    valid = vec.is_normal_f32(lum)
    count = valid.to(torch.int32).sum()
    sorted_l = torch.sort(torch.where(valid, lum, torch.inf)).values
    idx = (count.to(torch.float32) * percentile).to(torch.int64).clamp(0, lum.shape[0] - 1)
    return sorted_l[int(idx)], count


def _host_read_post_process(img, percentile=0.99):
    p98, count = _host_read_scale(img.reshape(-1, 3), percentile)
    do = (p98 > vec.F32_EPS) & (count > 0)
    return img * torch.where(do, 1.0 / p98, 1.0)


def _odd_image(kind):
    """Images whose luma is not always normal: NaN, +-inf, subnormal and
    zero pixels among random ones; no valid pixel at all; one pixel."""
    rng = np.random.default_rng(5)
    if kind == "one_pixel":
        return rng.exponential(0.4, size=(1, 1, 3)).astype(np.float32)
    img = rng.exponential(0.4, size=(24, 32, 3)).astype(np.float32)
    if kind == "no_valid_pixel":
        img[:] = 0.0
        img[0, :3] = [np.nan, np.inf, 1e-41]
        return img
    flat = img.reshape(-1, 3)
    picks = rng.choice(len(flat), size=(6, 40), replace=False)
    flat[picks[0]] = np.nan
    flat[picks[1]] = np.inf
    flat[picks[2]] = -np.inf
    flat[picks[3]] = 1e-40  # subnormal
    flat[picks[4]] = 0.0
    flat[picks[5], 1] = -flat[picks[5], 1]  # negative luma on some
    return img


def _bits(t):
    return t.contiguous().view(torch.int32)


@pytest.mark.parametrize("kind", ["specials", "no_valid_pixel", "one_pixel"])
@pytest.mark.parametrize("percentile", [0.99, 0.5])
def test_percentile_on_the_device_is_the_host_read_formula_bit_for_bit(kind, percentile):
    img = torch.as_tensor(_odd_image(kind))
    value, count = luma_percentile_scale(img.reshape(-1, 3), percentile)
    want_value, want_count = _host_read_scale(img.reshape(-1, 3), percentile)
    assert value.shape == () == count.shape and count.dtype == want_count.dtype
    assert torch.equal(_bits(value), _bits(want_value)) and torch.equal(count, want_count)
    if kind == "no_valid_pixel":
        assert int(count) == 0
    got = post_process(img, percentile)
    assert torch.equal(_bits(got), _bits(_host_read_post_process(img, percentile)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_luma_makes_its_weights_once(monkeypatch, dtype):
    """The second call of color.luma on a device and dtype makes no
    weights tensor: on a card that copy would wait for the card's queue."""
    rgb = torch.rand((7, 3), dtype=dtype)
    first = color.luma(rgb)
    made = []
    real = torch.tensor
    monkeypatch.setattr(torch, "tensor", lambda *a, **k: made.append(a) or real(*a, **k))
    second = color.luma(rgb)
    assert made == [] and torch.equal(first, second) and second.dtype == dtype
    assert torch.equal(second, torch.sum(rgb * real(color.LUMA_WEIGHTS, dtype=dtype), dim=-1))


HOST_READS = ("item", "tolist", "__int__", "__index__", "__float__", "__bool__")


class _NoHostData(TorchDispatchMode):
    """Fails on a tensor made from host data (torch.tensor, an index given
    as a Python list): on a card that is a copy which waits for the card's
    queue."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        assert func is not torch.ops.aten.lift_fresh.default, "a tensor made from host data"
        return func(*args, **(kwargs or {}))


@contextlib.contextmanager
def no_host_reads():
    """Every read of a tensor's value on the host raises inside, and so
    does a tensor made from host data."""
    def spy(self, *args, _name, **kwargs):
        raise AssertionError(f"Tensor.{_name} read a value on the host")

    with pytest.MonkeyPatch.context() as mp, _NoHostData():
        for name in HOST_READS:
            mp.setattr(torch.Tensor, name, functools.partialmethod(spy, _name=name))
        yield


def _lane_photons(scene, ray_o, ray_d, unifs, cfg):
    """A walk that gives each lane its direction and its first draw as the
    photon: the plain walk reads on the host where the card's does not."""
    photon = ray_d.abs() + unifs[0, 0][:, None]
    zero = torch.zeros((), dtype=torch.int64)
    return MCResult(photon=photon, casts=zero + ray_o.shape[0], filtered=zero)


@pytest.mark.parametrize("what", ["post_process", "dp_parts"])
def test_no_value_is_read_on_the_host(monkeypatch, what):
    """post_process, and render._epoch tracing and assembling each part of
    a dp mesh (five tiles over two ranks: three and two), read nothing on
    the host and make no tensor from host data; the parts sum to the whole
    frame's epoch."""
    if what == "post_process":
        img = torch.as_tensor(_odd_image("specials"))
        want = _host_read_post_process(img)
        with no_host_reads():
            got = post_process(img)
        assert torch.equal(_bits(got), _bits(want))
        return
    monkeypatch.setattr(render, "trace_distributed", _lane_photons)
    scene, cam = demo_scene(device="cpu"), demo_camera(device="cpu")
    cfg = RenderConfig(width=32, height=20, depth=3, tile_rays=128)
    whole = render._epoch(scene, cam, cfg, 3, 2, None)[0]
    ranks = [tmesh.RenderMesh(dp=2, sp=1, rank=r) for r in range(2)]
    assert [len(tmesh._my_tiles(cfg, "cpu", 2, r)) for r in range(2)] == [3, 2]
    with no_host_reads():
        parts = [tmesh.epoch_body(scene, cam, cfg, m, 3, 2) for m in ranks]
    assert torch.equal(parts[0][0] + parts[1][0], whole)
    assert all(torch.count_nonzero(p[0]) for p in parts)
    assert (parts[0][1] + parts[1][1]).tolist() == [640, 0]


def test_srgb_decode_and_u8_to_linear_match_jax():
    """The inverse transfer function on [-0.5, 1.5] (clamped) and on every
    u8 value, against the JAX package's, within an ulp (XLA's pow and
    torch's round apart on a few inputs); u8 -> linear -> u8 is the
    identity (tests/test_tonemap_io.py:62)."""
    x = np.linspace(-0.5, 1.5, 4001, dtype=np.float32)
    np.testing.assert_allclose(color.srgb_decode(torch.as_tensor(x)).numpy(),
                               np.asarray(jax_color.srgb_decode(jnp.asarray(x))),
                               rtol=2e-7, atol=0)
    u8 = np.arange(256, dtype=np.uint8)
    lin = color.srgb_u8_to_linear(torch.as_tensor(u8))
    assert lin.dtype == torch.float32
    np.testing.assert_allclose(lin.numpy(), np.asarray(jax_color.srgb_u8_to_linear(
        jnp.asarray(u8))), rtol=2e-7, atol=0)
    np.testing.assert_array_equal(linear_to_u8(lin).numpy(), u8)


def test_png_round_trip():
    rgb = np.random.default_rng(1).integers(0, 256, size=(7, 5, 3), dtype=np.uint8)
    np.testing.assert_array_equal(decode_png_rgb8(encode_png_rgb8(rgb)), rgb)
    with pytest.raises(ValueError):
        encode_png_rgb8(rgb[..., :2])


def test_render_progressive_writes_png(tmp_path):
    out = str(tmp_path / "out.png")
    seen = []
    state = render_progressive(demo_scene(device="cpu"), demo_camera(device="cpu"), CFG, out_path=out,
                               on_epoch=lambda e, s: seen.append((e, s)), log=lambda m: None)
    assert state.epoch == 2 and [e for e, _ in seen] == [1, 2]
    assert seen[0][1]["casts"] > CFG.width * CFG.height
    png = read_png_rgb8(out)
    assert png.shape == (24, 32, 3) and png.max() > 0
    np.testing.assert_array_equal(png, linear_to_u8(state.img).numpy())


def test_checkpoint_resume_matches_uninterrupted(tmp_path):
    scene, cam = demo_scene(device="cpu"), demo_camera(device="cpu")
    ref = render_progressive(scene, cam, CFG, out_path=str(tmp_path / "a.png"), seed=3,
                             log=lambda m: None)
    ckpt = str(tmp_path / "ck.npz")
    first = RenderConfig(**{**CFG.__dict__, "epochs": 1})
    render_progressive(scene, cam, first, out_path=str(tmp_path / "b.png"), seed=3,
                       checkpoint_path=ckpt, log=lambda m: None)
    assert load_checkpoint(ckpt, "cpu").epoch == 1
    lines = []
    got = render_progressive(scene, cam, CFG, out_path=str(tmp_path / "b.png"), seed=3,
                             checkpoint_path=ckpt, log=lines.append)
    assert lines[0] == "resumed at epoch 1"
    assert got.epoch == 2 and load_checkpoint(ckpt, "cpu").epoch == 2
    torch.testing.assert_close(got.img, ref.img, rtol=0, atol=0)


def test_png_every_groups_give_the_same_image(tmp_path):
    scene, cam = demo_scene(device="cpu"), demo_camera(device="cpu")
    a = render_progressive(scene, cam, CFG, out_path=str(tmp_path / "a.png"),
                           log=lambda m: None)
    written = []
    b = render_progressive(scene, cam, CFG, out_path=str(tmp_path / "b.png"),
                           on_epoch=lambda e, s: written.append(e), log=lambda m: None,
                           png_every=2)
    assert written == [2]
    torch.testing.assert_close(a.img, b.img, rtol=0, atol=0)


@pytest.mark.parametrize("one_rank", [False, True])
def test_debug_nans_checks_each_epochs_photons(tmp_path, monkeypatch, one_rank):
    """In a group of epochs (png_every=2) debug_nans checks each epoch's
    photons before they are accumulated and names that epoch, on one card
    and on a mesh alike; nothing is written after the Whitted frame."""
    from raytracer_tpu_torch.parallel import mesh as tmesh

    run = tmesh._mc_epoch

    def poisoned(scene, camera, cfg, mesh, seed, epoch):
        photons, counters = run(scene, camera, cfg, mesh, seed, epoch)
        if epoch == 0:
            photons[0, 0, 0] = float("nan")
        return photons, counters

    monkeypatch.setattr(tmesh, "_mc_epoch", poisoned)
    written = []
    with pytest.raises(FloatingPointError, match=r"the photons \(epoch 0\)"):
        render_progressive(demo_scene(device="cpu"), demo_camera(device="cpu"), CFG,
                           out_path=str(tmp_path / "o.png"), log=lambda m: None,
                           on_epoch=lambda e, s: written.append(e), png_every=2,
                           debug_nans=True,
                           mesh=tmesh.RenderMesh(dp=1, sp=1) if one_rank else None)
    assert written == []


def test_cli_runs_on_cpu(tmp_path):
    out = str(tmp_path / "cli.png")
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=ROOT)
    proc = subprocess.run(
        [sys.executable, "-m", "raytracer_tpu_torch", "--device", "cpu", "--width", "32",
         "--height", "24", "--epochs", "1", "--depth", "2", "--out", out],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "rays in" in proc.stdout
    assert read_png_rgb8(out).shape == (24, 32, 3)
