"""The port's command line (``cli.py``, ``bench.py``) against the JAX
package's ``cli.py`` on the CPU, after tests/test_io_checkpoint.py:102-139
and :239-272. Both CLIs are called in-process through ``main(argv)``; one
test runs ``python -m cpu_raytracing_experiments_tpu_torch.cli`` in a
subprocess.

Tolerances: the hero's .hdr against the JAX CLI's at the bar of
tests/test_goldens.py::_check (more than 99.5% of values within rtol 1e-3 /
atol 1e-4, the mean within 1e-3: XLA's CPU rsqrt, sin and cos are not
correctly rounded, the port's are); the white furnace within 0.01 of 1, as
the JAX CLI test holds it; a resumed render bit for bit.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from cpu_raytracing_experiments_tpu import cli as jcli
from cpu_raytracing_experiments_tpu.utils import image as jimage
from cpu_raytracing_experiments_tpu_torch import Renderer, cli
from cpu_raytracing_experiments_tpu_torch.scene import builders
from cpu_raytracing_experiments_tpu_torch.utils import image
from cpu_raytracing_experiments_tpu_torch.utils.config import RendererPolicy

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
SMALL = ["--width", "32", "--height", "32", "--spp", "5", "--bounces", "4",
         "--chunk", "1024", "--quiet"]


def _check(img, want):
    """tests/test_goldens.py::_check's bar."""
    close = np.isclose(img, want, rtol=1e-3, atol=1e-4).mean()
    assert close > 0.995, close
    assert abs(img.mean() - want.mean()) <= 1e-3 * abs(want.mean())


def test_cli_render_furnace_subprocess(tmp_path):
    """``python -m cpu_raytracing_experiments_tpu_torch.cli render --cpu`` of
    the white furnace at 32x32 writes a PNG and an .hdr whose radiance is 1
    within 0.01 (tests/test_io_checkpoint.py::test_cli_render_end_to_end)."""
    out, hdr = tmp_path / "out.png", tmp_path / "out.hdr"
    res = subprocess.run(
        [sys.executable, "-m", "cpu_raytracing_experiments_tpu_torch.cli",
         "render", "--scene", "white_furnace", *SMALL, "--cpu", "--out",
         str(out), "--hdr-out", str(hdr)],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert res.returncode == 0, res.stderr[-2000:]
    np.testing.assert_allclose(image.read_hdr(hdr), 1.0, atol=0.01)
    png = np.asarray(Image.open(out))
    assert png.shape == (32, 32, 3)


def test_cli_render_hero_matches_jax_cli(tmp_path):
    """``render --cpu`` of the hero at 32x32, 5 spp, 4 bounces, with
    ``--hdr-out`` and ``--out``: the .hdr read back is the JAX CLI's at
    _check's bar, and equals the RGBE encoding of the port's in-process
    Renderer at the same settings byte for byte; the PNG is that render's
    tonemapped resolve."""
    args = ["render", "--scene", "default", *SMALL, "--cpu"]
    cli.main(args + ["--hdr-out", str(tmp_path / "port.hdr"),
                     "--out", str(tmp_path / "port.png")])
    jcli.main(args + ["--hdr-out", str(tmp_path / "jax.hdr")])
    _check(image.read_hdr(tmp_path / "port.hdr"),
           jimage.read_hdr(tmp_path / "jax.hdr"))
    r = Renderer(builders.default_scene(32, 32),
                 RendererPolicy(max_bounces=4, rays_per_chunk=1024), 32, 32,
                 device="cpu")
    r.accumulate(5)
    assert (tmp_path / "port.hdr").read_bytes() == \
        image.encode_hdr(r.render(tonemap=False))
    want = (np.clip(r.render(tonemap=True), 0, 1) * 255 + 0.5).astype(
        np.uint8)
    assert np.array_equal(np.asarray(Image.open(tmp_path / "port.png")),
                          want)


def test_cli_scenes_matches_jax(capsys):
    """``scenes`` lists the JAX CLI's scenes, in its order."""
    cli.main(["scenes"])
    got = capsys.readouterr().out
    jcli.main(["scenes"])
    assert got == capsys.readouterr().out
    assert "brdf_test" in got.split()


def test_cli_aov_and_ao(tmp_path, capsys):
    """``aov --cpu`` (with ``--exr-out``) writes the depth / normal / albedo
    PNGs, the prim ids (equal to the JAX CLI's) and one EXR holding every
    AOV; ``ao --cpu`` writes an AO image in [0, 1]."""
    args = ["aov", "--scene", "default", "--width", "24", "--height", "24",
            "--cpu"]
    cli.main(args + ["--out-prefix", str(tmp_path / "a"),
                     "--exr-out", str(tmp_path / "a.exr")])
    jcli.main(args + ["--out-prefix", str(tmp_path / "j")])
    for k in ("depth", "normal", "albedo"):
        assert np.asarray(Image.open(tmp_path / f"a_{k}.png")).shape == \
            (24, 24, 3)
    ids = np.load(tmp_path / "a_prim_id.npy")
    np.testing.assert_array_equal(ids, np.load(tmp_path / "j_prim_id.npy"))
    ch = image.read_exr_channels(tmp_path / "a.exr")
    assert sorted(ch) == ["N.X", "N.Y", "N.Z", "albedo.B", "albedo.G",
                          "albedo.R", "depth.Z", "id"]
    np.testing.assert_array_equal(ch["id"], ids.astype(np.float32))
    cli.main(["ao", "--scene", "default", "--width", "16", "--height", "16",
              "--ao-samples", "4", "--cpu", "--out", str(tmp_path / "ao.png")])
    ao = np.asarray(Image.open(tmp_path / "ao.png"))
    assert ao.shape == (16, 16, 3) and ao.min() < 255
    assert "wrote" in capsys.readouterr().out


def test_cli_checkpoint_resume_bit_exact(tmp_path):
    """Two ``render --checkpoint`` calls (5 spp, then on to 10, with
    ``--checkpoint-every 5``) give the linear frame of one uninterrupted
    10-pass render, bit for bit (tests/test_io_checkpoint.py::
    test_cli_checkpoint_resume), and the ``--metrics`` JSONL carries the JAX
    CLI's records: a step per checkpoint interval, resume, wrote."""
    ck, met = tmp_path / "s.npz", tmp_path / "m.jsonl"
    base = ["render", "--scene", "default", "--width", "16", "--height",
            "16", "--bounces", "3", "--chunk", "256", "--cpu", "--quiet",
            "--checkpoint", str(ck), "--checkpoint-every", "5", "--metrics",
            str(met)]
    cli.main(base + ["--spp", "5"])
    cli.main(base + ["--spp", "10", "--hdr-out", str(tmp_path / "r.npy")])
    r = Renderer(builders.default_scene(16, 16),
                 RendererPolicy(max_bounces=3, rays_per_chunk=256), 16, 16,
                 device="cpu")
    r.accumulate(10)
    want = r.render(tonemap=False)
    got = np.load(tmp_path / "r.npy")
    assert np.array_equal(got.view(np.int32), want.view(np.int32))
    recs = [json.loads(x) for x in met.read_text().splitlines()]
    assert [x["event"] for x in recs] == ["step", "done", "resume", "step",
                                          "wrote"]
    assert set(recs[0]) == {"event", "spp", "wall_s", "total_wall_s",
                            "wall_ewma_s", "Msamples_per_s",
                            "variance_estimate"}
    assert [recs[k]["spp"] for k in range(4)] == [5, 5, 5, 10]


def test_cli_adaptive_denoise_and_hdri(tmp_path):
    """``--adaptive-tol`` logs the adaptive stats (the keys of
    ``render_adaptive``), ``--denoise`` writes the denoised PNG and
    ``--hdri`` lights the hero from an .hdr read with the port's reader."""
    met = tmp_path / "m.jsonl"
    base = ["render", "--scene", "default", "--width", "16", "--height",
            "16", "--bounces", "3", "--chunk", "256", "--cpu", "--quiet"]
    cli.main(base + ["--spp", "20", "--adaptive-tol", "0.05", "--metrics",
                     str(met), "--out", str(tmp_path / "ad.png")])
    rec = json.loads(met.read_text().splitlines()[0])
    assert rec["event"] == "adaptive"
    assert {"samples_traced", "uniform_equivalent", "saved_fraction",
            "max_spp_pixel"} <= set(rec)
    cli.main(base + ["--spp", "5", "--denoise", "--out",
                     str(tmp_path / "dn.png")])
    assert np.asarray(Image.open(tmp_path / "dn.png")).shape == (16, 16, 3)
    sky = np.full((8, 16, 3), 0.5, np.float32)
    image.write_hdr(tmp_path / "sky.hdr", sky)
    cli.main(base + ["--spp", "5", "--hdri", str(tmp_path / "sky.hdr"),
                     "--hdr-out", str(tmp_path / "lit.npy")])
    cli.main(base + ["--spp", "5", "--hdr-out", str(tmp_path / "dark.npy")])
    assert np.load(tmp_path / "lit.npy").mean() > \
        np.load(tmp_path / "dark.npy").mean()


def test_cli_without_card_names_it(capsys):
    """Without ``--cpu`` the CLI renders on the card: on a machine without
    one, ``render`` and ``bench`` exit non-zero with a message naming the
    missing CUDA device, and nothing falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    for argv in (["render", "--scene", "white_furnace", *SMALL],
                 ["bench"]):
        with pytest.raises(SystemExit) as exc:
            cli.main(argv)
        assert exc.value.code != 0
        assert "no CUDA device" in str(exc.value.code)


@pytest.mark.cuda
def test_cli_default_device_is_the_card(tmp_path):
    """On the card: ``render`` without ``--cpu`` renders there, and its
    linear frame equals the ``--cpu`` render's bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    args = ["render", "--scene", "default", *SMALL]
    cli.main(args + ["--hdr-out", str(tmp_path / "card.npy")])
    cli.main(args + ["--cpu", "--hdr-out", str(tmp_path / "cpu.npy")])
    a, b = (np.load(tmp_path / f"{k}.npy") for k in ("card", "cpu"))
    assert np.array_equal(a.view(np.int32), b.view(np.int32))
