"""The port's tools for the full reference schedule on the CPU:
scripts/psnr_torch_vs_reference.py against scripts/psnr_vs_reference.py
and the JAX package's recorded noise floor, the draws' seeds over the
schedule's epochs and tiles, the tone normaliser's percentile at the
schedule's 1,228,800 pixels against the JAX package's, the roofline cost
model against the JAX package's, chip_smoke.schedule_profile (phase 8's
profile of the epoch loop from its own spans) at 64x48, and
chip_smoke.py's phase 8 at 64x48 against the port's own renders, with a
planted golden and a planted floor that its gates must refuse."""

import json
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from raytracer_tpu.ops.tonemap import luma_percentile_scale as jax_luma_percentile_scale
from raytracer_tpu.utils import roofline as jax_roofline
from raytracer_tpu_torch.config import RenderConfig
from raytracer_tpu_torch.ops.tonemap import luma_percentile_scale
from raytracer_tpu_torch.render import _clips, _seed, tile_draws
from raytracer_tpu_torch.scene.presets import demo_camera, demo_scene
from raytracer_tpu_torch.utils import native, roofline
from raytracer_tpu_torch.utils.png import read_png_rgb8, write_png_atomic

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "scripts"))
import psnr_torch_vs_reference as port_psnr  # noqa: E402
import psnr_vs_reference as jax_psnr  # noqa: E402

ARTIFACTS = os.path.join(ROOT, "artifacts")
# the reference schedule: 1280x960 in tiles of 65536 rays, 100 epochs
FULL = RenderConfig(depth=5)
# chip_smoke.py's phase 8 on the CPU: 64x48 (one tile), two epochs, the
# profile at one group size
SMALL_SCHEDULE = dict(width=64, height=48, epochs=2, profile_epochs=2, png_every=(1,),
                      device="cpu")


@pytest.mark.parametrize("shape, same", [((48, 64, 3), False), ((37, 53, 3), False),
                                         ((48, 64, 3), True), ((17, 13, 3), False)])
def test_psnr_functions_match_the_jax_tool(tmp_path, shape, same):
    """psnr_u8, box_down, psnr_down, score and self_noise equal
    scripts/psnr_vs_reference.py's on seeded u8 images: identical images
    score inf, and box_down crops sizes that are not multiples of k."""
    rng = np.random.default_rng(sum(shape) + same)
    a = rng.integers(0, 256, size=shape, dtype=np.uint8)
    b = a.copy() if same else rng.integers(0, 256, size=shape, dtype=np.uint8)
    assert port_psnr.psnr_u8(a, b) == jax_psnr.psnr_u8(a, b)
    assert (port_psnr.psnr_u8(a, b) == float("inf")) == same
    for k in (4, 8):
        got = port_psnr.box_down(a, k)
        np.testing.assert_array_equal(got, jax_psnr.box_down(a, k))
        assert got.shape == (shape[0] // k, shape[1] // k, 3)
        assert port_psnr.psnr_down(a, b, k) == jax_psnr.psnr_down(a, b, k)
    pa, pb = str(tmp_path / "a.png"), str(tmp_path / "b.png")
    write_png_atomic(pa, a)
    write_png_atomic(pb, b)
    assert port_psnr.score(pa, pb) == jax_psnr.score(pa, pb)
    assert port_psnr.self_noise(pa, pb) == jax_psnr.self_noise(pa, pb)


def test_committed_renders_reproduce_the_recorded_floor():
    """The JAX package's two full-schedule renders, scored by the port's
    tool, give artifacts/PSNR.json's self_psnr_* (the floor phase 8 of
    chip_smoke.py gates on) to 0.01 dB."""
    with open(os.path.join(ARTIFACTS, "PSNR.json")) as f:
        recorded = json.load(f)
    a, b = (os.path.join(ARTIFACTS, n) for n in ("out.png", "out_seed1.png"))
    got = port_psnr.score(a, b)
    floor = port_psnr.self_noise(a, b)
    assert got["shape"] == [960, 1280, 3]
    for k in ("raw", "down4", "down8"):
        assert abs(got[f"psnr_{k}_db"] - recorded[f"self_psnr_{k}_db"]) <= 0.01, (k, got)
        assert floor[f"self_psnr_{k}_db"] == got[f"psnr_{k}_db"]


def test_draws_are_distinct_streams_over_the_schedule():
    """_seed gives every (seed, epoch, tile) of two seeds' 100-epoch,
    19-tile schedules (and the sample-parallel ranks' further samples)
    its own generator seed, distinct also in the low 32 bits that seed
    the CPU's generator, and the streams' first draws differ."""
    tiles = len(_clips(FULL, "cpu")[0])
    assert tiles == 19
    keys = [(s, e, t, sm) for s in (0, 1) for e in range(100) for t in range(tiles)
            for sm in (0, 1)]
    seeds = [_seed(*k) for k in keys]
    assert len(set(seeds)) == len(keys)
    assert len({x & 0xFFFFFFFF for x in seeds}) == len(keys)
    assert all(0 <= x < 1 << 63 for x in seeds)
    cfg = RenderConfig(width=8, height=8, depth=2, tile_rays=64)
    first = {tuple(u[:, :, 0].flatten().tolist()) + tuple(n[0].tolist())
             for s, e, t, sm in keys
             for n, u in [tile_draws(cfg, s, e, t, 4, "cpu", sm)]}
    assert len(first) == len(keys)


@pytest.mark.parametrize("invalid", [0, 37_411])
def test_luma_percentile_matches_jax_at_the_schedules_size(invalid):
    """At 1280x960 pixels the index trunc(f32(count) * 0.99) rounds in
    f32; the port's (int64) and the JAX package's (int32) pick the same
    luma, with every pixel valid and with black and subnormal pixels left
    out of the count."""
    rng = np.random.default_rng(invalid)
    img = rng.exponential(0.4, size=(960 * 1280, 3)).astype(np.float32)
    drop = rng.choice(img.shape[0], size=invalid, replace=False)
    img[drop[::2]] = 0.0
    img[drop[1::2]] = np.float32(1e-40)
    value, count = luma_percentile_scale(torch.as_tensor(img))
    want_value, want_count = jax_luma_percentile_scale(jnp.asarray(img))
    assert int(count) == int(want_count) == img.shape[0] - invalid
    assert float(value) == float(want_value)


def test_roofline_cost_model_matches_jax():
    """dense_cast_ops and the blocked costs are the JAX model's; on a Chip
    of the TPU v5e's rates the attainable casts are the JAX package's; the
    H100 instance takes the module's rates, an FMA as one operation."""
    for n_tri, n_sph in ((64, 4), (11_262, 0), (0, 1), (204_812, 3)):
        assert roofline.dense_cast_ops(n_tri, n_sph) == jax_roofline.dense_cast_ops(n_tri, n_sph)
    v5e = jax_roofline.V5E
    chip = roofline.Chip(name=v5e.name, vpu_ops=v5e.vpu_ops, hbm_bytes=v5e.hbm_bytes)
    assert (roofline.dense_attainable_casts(64, 4, chip)
            == jax_roofline.dense_attainable_casts(64, 4, v5e))
    assert (roofline.blocked_chunk_body_seconds(65536, chip=chip)
            == jax_roofline.blocked_chunk_body_seconds(65536, chip=v5e))
    assert roofline.blocked_stream_seconds(chip) == jax_roofline.blocked_stream_seconds(v5e)
    h100 = roofline.H100
    assert h100.vpu_ops == roofline.PEAK_FP32 / 2 and h100.hbm_bytes == roofline.PEAK_BYTES
    assert roofline.dense_attainable_casts(64, 4) == h100.vpu_ops / roofline.dense_cast_ops(64, 4)
    assert roofline.blocked_stream_seconds() == 128 * 128 * 4 / roofline.PEAK_BYTES


@pytest.mark.parametrize("route", ["python", "native"])
def test_schedule_profile_reads_the_spans(tmp_path, monkeypatch, route):
    """chip_smoke.schedule_profile at 64x48, 3 epochs, a PNG every epoch,
    on the CPU: three groups, two timed, every figure present and >= 0 in
    each, each group's main-thread units within its wall, and the route it
    took (the native route faked: its writer is one call, one
    rt.png.write span and no rt.png.encode)."""
    written = []
    monkeypatch.setattr(native, "available", lambda: route == "native")
    if route == "native":
        monkeypatch.setattr(native, "write_png_atomic",
                            lambda path, rgb: written.append(rgb.shape))
    cfg = RenderConfig(width=64, height=48, depth=5, epochs=3)
    out = chip_smoke.schedule_profile(demo_scene(device="cpu"), demo_camera(device="cpu"), cfg,
                                      1, str(tmp_path))
    assert out["writer_route"] == route and out["device"] == "cpu"
    assert (out["width"], out["height"], out["epochs"], out["png_every"]) == (64, 48, 3, 1)
    assert len(out["groups"]) == 3 and out["groups_timed"] == 2
    assert out["render_progressive_s"] > 0
    for g in out["groups"]:
        assert g["epochs"] == 1
        assert all(g[k] >= 0 for k in chip_smoke.GROUP_FIGURES), g
        units = g["epoch_host_ms"] + g["wait_ms"] + g["encode_u8_ms"]
        assert units <= g["wall_ms"] and g["read_ms"] == pytest.approx(g["wall_ms"] - units), g
        assert g["png_job_ms"] >= g["png_encode_ms"] + g["png_write_ms"] > 0, g
        assert (g["png_encode_ms"] > 0) == (route == "python"), g
    assert all(out[k] >= 0 for k in chip_smoke.GROUP_FIGURES)
    # the Whitted frame's PNG, then one an epoch
    assert written == ([(48, 64, 3)] * 4 if route == "native" else [])
    json.dumps(out)


def test_psnr_tool_renders_and_scores_on_the_cpu(tmp_path, capsys):
    """psnr_torch_vs_reference.main renders the schedule (here 64x48, two
    epochs, on the CPU only because asked) and scores it: one PNG at the
    end gives the image of a PNG every epoch, bit for bit."""
    a, b = str(tmp_path / "a.png"), str(tmp_path / "b.png")
    ran = port_psnr.render(a, 0, 2, 1, "cpu", 64, 48)
    assert ran["dropped"] == 0 and ran["device_name"] == "cpu"
    argv = ["--device", "cpu", "--width", "64", "--height", "48", "--epochs", "2",
            "--png-every", "2", "--out", b, "--golden", a, "--self-b", a]
    assert port_psnr.main(argv) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["dropped"] == 0 and out["shape"] == [48, 64, 3] and out["epochs"] == 2
    assert out["psnr_raw_db"] == out["self_psnr_down8_db"] == float("inf")


@pytest.fixture(scope="module")
def port_goldens(tmp_path_factory):
    """The port's own renders of the small schedule at seeds 0 and 1 and a
    floor JSON of their self_noise: phase 8's goldens and floor here."""
    d = tmp_path_factory.mktemp("schedule_goldens")
    paths = tuple(str(d / f"seed{seed}.png") for seed in (0, 1))
    for seed, path in enumerate(paths):
        port_psnr.render(path, seed, SMALL_SCHEDULE["epochs"], 1, "cpu", 64, 48)
    floor = str(d / "PSNR.json")
    with open(floor, "w") as f:
        json.dump(port_psnr.self_noise(*paths), f)
    return paths, floor


@pytest.mark.parametrize("planted", [None, "golden", "floor"])
def test_schedule_phase_gates_on_the_cpu(port_goldens, tmp_path, capsys, planted):
    """chip_smoke.py's phase 8 at 64x48, two epochs, on the CPU against the
    port's own renders passes: seed 1's render made the main path's plain
    calls (the level six times, MC once an epoch, the delivery once, for
    the one tile) and nothing else, both renders' pixels are the goldens',
    and the profile timed five groups past the first.  A planted golden
    (seed 0's inverted) fails the port-vs-golden gate; a planted floor
    (1 dB over the port's) fails the port-floor gate."""
    goldens, floor = port_goldens
    if planted == "golden":
        bad = str(tmp_path / "inverted.png")
        write_png_atomic(bad, 255 - read_png_rgb8(goldens[0]))
        goldens = (bad, goldens[1])
    elif planted == "floor":
        with open(floor) as f:
            recorded = json.load(f)
        floor = str(tmp_path / "PSNR.json")
        with open(floor, "w") as f:
            json.dump({f"self_psnr_{k}_db": recorded[f"self_psnr_{k}_db"] + 1.0
                       for k in chip_smoke.SCALES}, f)
    spec = chip_smoke.ScheduleSpec(**SMALL_SCHEDULE, goldens=goldens, floor_json=floor)
    if planted:
        gate = "vs_jax_seed0" if planted == "golden" else "port floor"
        with pytest.raises(AssertionError, match=gate):
            chip_smoke.schedule_phase(spec, ["cpu"])
        return
    out = chip_smoke.schedule_phase(spec, ["cpu"])
    assert {k: n for k, n in out["launches_seed1"].items() if n} == {
        "level": 6, "mc": 2, "deliver": 1}
    assert out["pixels_sha256"] == {"seed0": chip_smoke.pixels_sha256(goldens[0]),
                                    "seed1": chip_smoke.pixels_sha256(goldens[1])}
    with open(floor) as f:
        recorded = json.load(f)
    for k in chip_smoke.SCALES:
        assert out["vs_jax_seed0"][f"psnr_{k}_db"] == out["vs_jax_seed1"][f"psnr_{k}_db"] \
            == float("inf")
        assert out["port_floor"][f"self_psnr_{k}_db"] == recorded[f"self_psnr_{k}_db"]
    prof = out["profile"][1]
    assert prof["epochs"] == 6 and prof["groups_timed"] == 5
    assert out["cli"]["epoch_lines"] == 2 and out["render_seed1"]["dropped"] == 0
    printed = capsys.readouterr().out
    assert "seed 1's launches (plain calls): level 6, mc 2, deliver 1" in printed
    assert "phase 8 took" in printed
