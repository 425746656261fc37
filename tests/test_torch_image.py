"""The port's shell utilities against the JAX package's on the CPU: image IO
(``utils/image.py``: .hdr with the RGBE codec of ``utils/native.py``, PNG,
npy, EXR), the metrics logger (``utils/metrics.py``) and the profiling hooks
(``utils/profiling.py``).

Tolerances: none. File bytes, decoded pixels, codec outputs and metric
records are equal to the JAX package's (the wall-clock fields of a record
aside). The native codec needs a C++ compiler, as the port's tree builder
does; without one those tests skip.
"""
import json
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from cpu_raytracing_experiments_tpu.utils import image as jimage
from cpu_raytracing_experiments_tpu.utils import metrics as jmetrics
from cpu_raytracing_experiments_tpu_torch.scene import builders
from cpu_raytracing_experiments_tpu_torch.utils import image, metrics, native
from cpu_raytracing_experiments_tpu_torch.utils import profiling
from cpu_raytracing_experiments_tpu_torch.utils.config import RendererPolicy

REPO = Path(__file__).resolve().parents[1]


def _need_compiler():
    if shutil.which("g++") is None:
        pytest.skip("no C++ compiler: the RGBE codec is built from csrc/")


def _radiance(h=13, w=17, seed=0):
    """Seeded linear radiance with the codec's edge cases: black, a value
    below 1e-32, a negative, huge and tiny values."""
    g = np.random.default_rng(seed)
    rgb = (g.random((h, w, 3)) * 4).astype(np.float32)
    specials = [0.0, 1e-40, -1.0, (3e4, 1e-3, 7.0), (1e-20, 0.0, 2e-20)]
    for k, v in enumerate(specials[:min(h, w)]):
        rgb[k, k] = v
    return rgb


def _bytes(path):
    return Path(path).read_bytes()


def test_native_rgbe_matches_numpy():
    """utils/native.py::rgbe_encode / rgbe_decode (csrc/rgbe.cpp, JAX
    ``native.rgbe_*``) equal the numpy codec of utils/image.py and the JAX
    package's numpy codec, byte for byte and bit for bit."""
    _need_compiler()
    rgb = _radiance(64, 48)
    enc = native.rgbe_encode(rgb)
    assert np.array_equal(enc, image.rgbe_encode_np(rgb))
    assert np.array_equal(enc, jimage._rgbe_encode_np(rgb))
    dec = native.rgbe_decode(enc)
    for want in (image.rgbe_decode_np(enc), jimage._rgbe_decode_np(enc)):
        assert np.array_equal(dec.view(np.int32), want.view(np.int32))


def test_hdr_bytes_and_read_match_jax(tmp_path):
    """write_hdr writes JAX ``write_hdr``'s bytes; read_hdr of the JAX
    package's file equals JAX ``read_hdr``."""
    _need_compiler()
    rgb = _radiance()
    image.write_hdr(tmp_path / "port.hdr", rgb)
    jimage.write_hdr(tmp_path / "jax.hdr", rgb)
    assert _bytes(tmp_path / "port.hdr") == _bytes(tmp_path / "jax.hdr")
    got = image.read_hdr(tmp_path / "jax.hdr")
    want = jimage.read_hdr(tmp_path / "jax.hdr")
    assert got.dtype == np.float32 and got.shape == rgb.shape
    assert np.array_equal(got.view(np.int32), want.view(np.int32))


def _rle_scanline(row, w):
    """tests/test_io_checkpoint.py::test_hdr_rle_decode's encoder: runs of
    two or more as (128 + n, value), else literals."""
    out = bytearray([2, 2, w >> 8, w & 0xFF])
    for c in range(4):
        vals = row[:, c]
        i = 0
        while i < len(vals):
            run = 1
            while i + run < len(vals) and vals[i + run] == vals[i] \
                    and run < 127:
                run += 1
            if run >= 2:
                out += bytes([128 + run, int(vals[i])])
                i += run
            else:
                j = i + 1
                while (j < len(vals)
                       and (j + 1 >= len(vals) or vals[j + 1] != vals[j])
                       and j - i < 128):
                    j += 1
                out += bytes([j - i]) + bytes(int(v) for v in vals[i:j])
                i = j
    return bytes(out)


def test_read_hdr_rle(tmp_path):
    """The RLE scanlines of tests/test_io_checkpoint.py::test_hdr_rle_decode
    (a constant red row, a varying green row) and a flat scanline after
    them: read_hdr equals JAX ``read_hdr`` bit for bit, within the RGBE
    step of the radiance."""
    _need_compiler()
    h, w = 3, 8
    rgb = np.zeros((h, w, 3), np.float32)
    rgb[0, :, 0] = 1.0
    rgb[1, :, 1] = np.arange(w) / 8.0 + 0.25
    rgb[2] = 0.5
    rgbe = jimage._rgbe_encode_np(rgb)
    payload = (b"".join(_rle_scanline(rgbe[y], w) for y in range(2))
               + rgbe[2].tobytes())
    path = tmp_path / "rle.hdr"
    path.write_bytes(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n"
                     + f"-Y {h} +X {w}\n".encode() + payload)
    got, want = image.read_hdr(path), jimage.read_hdr(path)
    assert np.array_equal(got.view(np.int32), want.view(np.int32))
    bound = rgb.max(axis=-1, keepdims=True) / 256 + 1e-6
    assert (np.abs(got - rgb) <= bound * 1.01 + 1e-6).all()
    with pytest.raises(ValueError, match="not a Radiance HDR"):
        (tmp_path / "bad.hdr").write_bytes(b"P6\n")
        image.read_hdr(tmp_path / "bad.hdr")


@pytest.mark.parametrize("h,w", [(13, 17), (1, 1), (64, 96)])
def test_png_pixels_equal_jax(tmp_path, h, w):
    """write_png (zlib and struct, no imaging package) against JAX
    ``write_png`` (PIL): the decoded 8-bit RGB pixels are equal, row 0 at
    the top; encode_png of uint8 pixels decodes to the same pixels."""
    rgb = np.clip(_radiance(h, w, seed=h) / 4, -0.5, 1.5)
    image.write_png(tmp_path / "port.png", rgb)
    jimage.write_png(tmp_path / "jax.png", rgb)
    got, want = (Image.open(tmp_path / f"{k}.png") for k in ("port", "jax"))
    assert got.mode == want.mode == "RGB" and got.size == (w, h)
    assert np.array_equal(np.asarray(got), np.asarray(want))
    arr = (np.arange(h * w * 3) % 256).astype(np.uint8).reshape(h, w, 3)
    png = image.encode_png(arr)
    assert png[:8] == b"\x89PNG\r\n\x1a\n"
    (tmp_path / "raw.png").write_bytes(png)
    assert np.array_equal(np.asarray(Image.open(tmp_path / "raw.png")), arr)


def test_the_port_needs_no_pil(tmp_path):
    """utils/image.py, the viewer and the CLI import no PIL: a process that
    imports them and writes a PNG and a viewer delta has no PIL module."""
    code = (
        "import sys, numpy as np\n"
        "from cpu_raytracing_experiments_tpu_torch import cli, viewer\n"
        "from cpu_raytracing_experiments_tpu_torch.utils import image\n"
        f"image.write_png({str(tmp_path / 'a.png')!r}, np.ones((4, 5, 3)))\n"
        "viewer._frame_delta({}, np.zeros((40, 40, 3), np.uint8), -1)\n"
        "assert not any(m == 'PIL' or m.startswith('PIL.') "
        "for m in sys.modules), 'PIL imported'\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
    assert "PIL" not in (REPO / "cpu_raytracing_experiments_tpu_torch/utils/"
                         "image.py").read_text()


def test_exr_bytes_and_channels_match_jax(tmp_path):
    """write_exr (RGB and named AOV channels in one file) writes JAX
    ``write_exr``'s bytes; read_exr_channels / read_exr of either file
    return the planes bit for bit."""
    rgb = _radiance(9, 11)
    aov = {"N.X": rgb[..., 1] * 2, "depth.Z": rgb[..., 2] + 1,
           "id": np.arange(99, dtype=np.float32).reshape(9, 11)}
    image.write_exr(tmp_path / "port.exr", rgb, channels=aov)
    jimage.write_exr(tmp_path / "jax.exr", rgb, channels=aov)
    assert _bytes(tmp_path / "port.exr") == _bytes(tmp_path / "jax.exr")
    got = image.read_exr_channels(tmp_path / "jax.exr")
    want = jimage.read_exr_channels(tmp_path / "jax.exr")
    assert sorted(got) == sorted(want) == ["B", "G", "N.X", "R", "depth.Z",
                                           "id"]
    for k in want:
        assert np.array_equal(got[k].view(np.int32), want[k].view(np.int32))
    back = image.read_exr(tmp_path / "port.exr")
    assert np.array_equal(back.view(np.int32), rgb.view(np.int32))
    image.write_exr(tmp_path / "aov.exr", channels=aov)
    assert sorted(image.read_exr_channels(tmp_path / "aov.exr")) == \
        ["N.X", "depth.Z", "id"]


def test_store_dispatches_like_jax(tmp_path):
    """store by extension (.hdr / .exr / .png / .npy, the Image::Store
    slot): the files equal JAX ``store``'s (the PNG decoded); another
    extension is refused."""
    _need_compiler()
    rgb = _radiance(8, 8) / 4
    for ext in ("hdr", "exr", "npy", "png"):
        image.store(tmp_path / f"port.{ext}", rgb)
        jimage.store(tmp_path / f"jax.{ext}", rgb)
        if ext == "png":
            assert np.array_equal(
                np.asarray(Image.open(tmp_path / "port.png")),
                np.asarray(Image.open(tmp_path / "jax.png")))
        else:
            assert _bytes(tmp_path / f"port.{ext}") == \
                _bytes(tmp_path / f"jax.{ext}"), ext
    with pytest.raises(ValueError, match="unsupported image extension"):
        image.store(tmp_path / "x.bmp", rgb)


def test_ewma_matches_jax():
    """Ewma (JAX ``metrics.Ewma``, after tests/test_metrics.py:10-16): alpha
    = 2 / (N + 1) and the same values on a seeded sequence."""
    e, je = metrics.Ewma(64), jmetrics.Ewma(64)
    assert e.alpha == je.alpha == 2.0 / 65.0
    for x in np.random.default_rng(3).random(50) * 10:
        assert e.update(float(x)) == je.update(float(x))
    assert metrics.Ewma(8).update(3.0) == 3.0


def test_metrics_logger_records_match_jax(tmp_path, capsys):
    """MetricsLogger (JAX ``MetricsLogger``, after
    tests/test_metrics.py:30-44): the same JSONL records and keys from the
    same calls, the total wall time aside; quiet writes nothing to stdout,
    not quiet prints each record."""
    g = np.random.default_rng(4)
    buckets = g.random((5, 3, 64)).astype(np.float32)
    records = []
    for mod, name in ((metrics, "port"), (jmetrics, "jax")):
        log = mod.MetricsLogger(tmp_path / f"{name}.jsonl", quiet=True)
        log.log_step(spp=5, step_wall=0.5, width=64, height=64, rays=100000)
        log.log_step(spp=10, step_wall=0.25, width=64, height=64,
                     buckets=buckets, extra={"tag": "b"})
        log.log(event="done", foo=1)
        records.append([json.loads(x) for x in
                        (tmp_path / f"{name}.jsonl").read_text().splitlines()])
    got, want = records
    assert len(got) == len(want) == 3
    for g_rec, w_rec in zip(got, want):
        assert list(g_rec) == list(w_rec)
        g_rec.pop("total_wall_s", None)
        w_rec.pop("total_wall_s", None)
        assert g_rec == w_rec
    assert got[0]["Mrays_per_s"] == 0.2
    assert got[2] == {"event": "done", "foo": 1}
    assert capsys.readouterr().out == ""
    metrics.MetricsLogger(quiet=False).log(event="x", n=2)
    assert json.loads(capsys.readouterr().out) == {"event": "x", "n": 2}


def test_stage_shares_and_trace(tmp_path):
    """trace() writes a Chrome trace and, beside it, the spans recorded in
    its block (``spans.json``): an update's port.* stages, each span's id
    and parent counted from the block's first span, and the port.update
    spans in the Chrome trace too."""
    from cpu_raytracing_experiments_tpu_torch.render.api import Renderer

    scene = builders.default_scene(16, 16)
    pol = RendererPolicy(max_bounces=3, rays_per_chunk=256)
    r = Renderer(scene, pol, 16, 16, device="cpu")
    with profiling.trace(str(tmp_path / "first")):
        r.accumulate(1)
    with profiling.trace(str(tmp_path / "trace")) as logdir:
        image.encode_png(np.zeros((2, 2, 3), np.uint8))
        r.accumulate(1)
    assert logdir == str(tmp_path / "trace")
    events = json.loads((tmp_path / "trace" / "trace.json").read_text())
    assert "traceEvents" in events
    assert any(e.get("name") == "port.update"
               for e in events["traceEvents"])
    recs = json.loads((tmp_path / "trace" / "spans.json").read_text())
    assert recs[0]["name"] == "port.update" and recs[0]["id"] == 0
    assert recs[0]["parent"] is None and recs[0]["update_id"] == 2
    assert {x["name"] for x in recs} >= {"port.wavefront", "port.bounce",
                                         "port.sync", "port.buckets"}
    assert all(x["parent"] < x["id"] for x in recs[1:])
    assert sum(x["counts"].get("host_syncs", 0) for x in recs) > 0
