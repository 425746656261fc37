"""The port's live viewer (``viewer.py``) against the JAX package's
``viewer.py`` (the viewer replaces the reference's GLFW/ImGui shell, App.cpp
/ Application.cpp:361-421).

* tests/test_viewer.py's nine endpoint tests, each against
  ``make_server(..., device="cpu")``: the protocol;
* against the JAX package on the same inputs: ``_frame_delta`` (JAX
  ``viewer._frame_delta``) on the same uint8 frames; and the two viewers
  side by side on the hero, their render threads stopped and the passes
  accumulated by the test, with JAX's rsqrt, sin and cos correctly rounded
  (``test_torch_knobs.py::jax_exact_math``): ``/materials``, the frames
  (``/frame.png``, ``/frame.hdr``, ``/delta``) and the scene after the same
  ``/edit`` and ``/camera`` queries.

Tolerances: none but the focus probe's (rtol 1e-4, the bar of
test_torch_probes.py, whose docstring says why). Everything else is equal:
bytes, decoded pixels, JSON, scene arrays and buckets bit for bit. The PNGs
are the port's own encoder's (zlib); they are decoded here with PIL, which
only the tests import."""
import base64
import io
import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch
from PIL import Image

from cpu_raytracing_experiments_tpu import viewer as jviewer
from cpu_raytracing_experiments_tpu.scene import builders as jbuilders
from cpu_raytracing_experiments_tpu.utils.config import RendererPolicy as JPolicy
from cpu_raytracing_experiments_tpu_torch import viewer
from cpu_raytracing_experiments_tpu_torch.scene import builders
from cpu_raytracing_experiments_tpu_torch.utils.config import RendererPolicy

from test_torch_knobs import jax_exact_math  # noqa: F401  (a fixture)
from test_torch_scene import _assert_same_arrays, jax_scene_to_numpy

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def live():
    scene = builders.white_furnace_scene(16, 16)
    pol = RendererPolicy(max_bounces=3, rays_per_chunk=1024)
    server, renderer, stop, worker = viewer.make_server(scene, pol, 16, 16,
                                                        port=0, device="cpu")
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    yield base, renderer
    stop.set()
    server.shutdown()
    server.server_close()
    worker.join(timeout=60)
    t.join(timeout=60)
    assert not worker.is_alive() and not t.is_alive()


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=30) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def test_index_and_stats(live):
    base, _ = live
    code, body = _get(base + "/")
    assert code == 200 and b"<html" in body.lower()
    # wait for the background worker to complete at least one pass
    deadline = time.time() + 60
    spp = 0
    while time.time() < deadline:
        code, body = _get(base + "/stats")
        assert code == 200
        s = json.loads(body)
        spp = s["spp"]
        if spp > 0:
            break
        time.sleep(0.2)
    assert spp > 0
    assert s["width"] == 16 and s["height"] == 16
    assert s["ms_per_pass"] > 0 and s["msamples_per_s"] > 0
    assert len(s["history_ms"]) == 64  # reference HUD's 64-slot CyclicBuffer


def test_frame_png(live):
    """/frame.png: an 8-bit RGB PNG of the frame's size."""
    import io

    import numpy as np
    from PIL import Image

    base, _ = live
    code, body = _get(base + "/frame.png")
    assert code == 200
    assert body[:8] == b"\x89PNG\r\n\x1a\n"
    arr = np.asarray(Image.open(io.BytesIO(body)))
    assert arr.shape == (16, 16, 3) and arr.dtype == np.uint8


def test_edit_and_camera(live):
    base, renderer = live
    code, body = _get(base + "/edit?material=0&albedo=0.5,0.5,0.5")
    assert (code, body) == (200, b"ok")
    # edit committed: material 0 albedo now 0.5 and accumulator reset
    import numpy as np

    assert np.isclose(float(renderer.scene.materials.albedo.x[0]), 0.5)
    code, body = _get(base + "/camera?translate=0,0,-0.25")
    assert (code, body) == (200, b"ok")
    code, body = _get(base + "/camera?exposure=0.5&fnumber=2.8")
    assert (code, body) == (200, b"ok")
    assert np.isclose(float(renderer.scene.camera.exposure), 0.5)
    assert float(renderer.scene.camera.aperture_radius) > 0
    code, body = _get(base + "/reset")
    assert (code, body) == (200, b"ok")


def test_materials_endpoint(live):
    base, renderer = live
    code, body = _get(base + "/materials")
    assert code == 200
    mats = json.loads(body)
    assert len(mats) == int(renderer.scene.materials.count)
    assert {"albedo", "emission", "roughness"} <= set(mats[0])
    assert all(len(m["albedo"]) == 3 for m in mats)


def test_frame_hdr_export(live):
    base, _ = live
    code, body = _get(base + "/frame.hdr")
    assert code == 200
    assert body.startswith(b"#?")  # Radiance header


def test_focus_probe_endpoint(live):
    base, renderer = live
    code, body = _get(base + "/camera?focus=8,8")
    assert (code, body) == (200, b"ok")
    # white furnace: center pixel hits the unit sphere -> finite focus
    import numpy as np

    assert np.isfinite(float(renderer.scene.camera.focus_distance))


def test_interactive_page_controls(live):
    """The served page carries the fly-cam / focus / slider wiring."""
    base, _ = live
    _, body = _get(base + "/")
    page = body.decode()
    for needle in ("KeyW", "contextmenu", "rotate=", "translate=",
                   "/materials", "roughness", "frame.hdr"):
        assert needle in page, needle


def test_bad_requests(live):
    base, _ = live
    code, body = _get(base + "/edit?material=0&albedo=not,a,vec")
    assert code == 400 and body.startswith(b"error:")
    code, _ = _get(base + "/nonexistent")
    assert code == 404


def test_delta_streaming(live):
    """Dirty-tile protocol: first request (gen mismatch) returns a full
    frame; a gen-matched request on the converged white furnace returns no
    tiles (every pixel is byte-stable); a stale gen forces a full refresh."""
    base, _ = live
    # wait until the worker has at least one pass in (frame non-black)
    deadline = time.time() + 60
    while time.time() < deadline:
        if json.loads(_get(base + "/stats")[1])["spp"] > 0:
            break
        time.sleep(0.2)
    code, body = _get(base + "/delta?gen=-1")
    assert code == 200
    d = json.loads(body)
    assert d["full"] is True and len(d["png_b64"]) > 0
    gen = d["gen"]

    # matched gen -> partial update (tile list may be empty or not: earlier
    # tests in this module edited the scene, so pixels can still be moving)
    code, body = _get(base + f"/delta?gen={gen}")
    d2 = json.loads(body)
    assert code == 200 and d2["gen"] == gen + 1 and d2["full"] is False
    if d2["tiles"]:
        assert d2["tile"] == 32
        assert all(x % 32 == 0 and y % 32 == 0 for x, y in d2["tiles"])

    # stale generation -> full frame again
    code, body = _get(base + "/delta?gen=0")
    d3 = json.loads(body)
    assert d3["full"] is True

    # unit check of the diff core: a one-pixel change ships exactly one tile
    import numpy as np
    from cpu_raytracing_experiments_tpu_torch.viewer import _frame_delta

    st = {}
    a = np.zeros((48, 80, 3), np.uint8)
    full = _frame_delta(st, a, client_gen=-1)
    assert full["full"] is True
    b = a.copy()
    b[40, 70] = 255  # tile (y=32..47, x=64..79) — a padded edge tile
    part = _frame_delta(st, b, client_gen=full["gen"])
    assert part["full"] is False and part["tiles"] == [[64, 32]]
    assert part["tile"] == 32
    # the shipped tile is folded into the reference: next delta is empty
    again = _frame_delta(st, b, client_gen=part["gen"])
    assert again["tiles"] == []


def test_make_server_needs_a_card_by_default():
    """Without ``device`` the viewer renders on the card: on a machine
    without one, make_server raises before it starts a thread."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    before = set(threading.enumerate())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        viewer.make_server(builders.white_furnace_scene(8, 8),
                           RendererPolicy(max_bounces=2), 8, 8, port=0)
    assert not set(threading.enumerate()) - before


# --- against the JAX package's viewer, on the same inputs -----------------

KNOBS = dict(max_bounces=3, rays_per_chunk=1024)
# /edit and /camera queries sent to both viewers in order (material 0 is
# the hero's floor; the lens query turns the thin lens on)
QUERIES = [
    "/edit?material=0&albedo=0.2,0.3,0.4&roughness=0.35",
    "/edit?material=1&emission=2,1,0.5&ior_minus_one=0.45",
    "/edit?sphere=3&pos=0.25,0.5,-1&radius=0.3",
    "/edit?ambient=0.1,0.2,0.3",
    "/camera?translate=0.3,-0.2,0.7",
    "/camera?rotate=0.05,0.1,-0.02",
    "/camera?focal=85&fnumber=2.8&exposure=0.5",
]


def _png(body: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(body)))


@pytest.fixture(scope="module")
def pair():
    """[port, JAX]: each package's viewer on the hero at 16x16, 3 bounces,
    serving on its own ephemeral port, its render thread stopped (the tests
    accumulate the passes themselves); (base url, renderer) each."""
    made = [viewer.make_server(builders.default_scene(16, 16),
                               RendererPolicy(**KNOBS), 16, 16, port=0,
                               device="cpu"),
            jviewer.make_server(jbuilders.default_scene(16, 16),
                                JPolicy(**KNOBS), 16, 16, port=0)]
    threads = []
    for server, _, stop, worker in made:
        stop.set()
        worker.join(timeout=300)
        assert not worker.is_alive()
        threads.append(threading.Thread(target=server.serve_forever,
                                        daemon=True))
        threads[-1].start()
    yield [(f"http://127.0.0.1:{m[0].server_address[1]}", m[1])
           for m in made]
    for (server, *_), t in zip(made, threads):
        server.shutdown()
        server.server_close()
        t.join(timeout=60)


def _accumulate(pair, n: int):
    """/reset on both viewers, then n passes in each renderer; their
    buckets equal bit for bit."""
    (pbase, pr), (jbase, jr) = pair
    for base in (pbase, jbase):
        assert _get(base + "/reset") == (200, b"ok")
    pr.accumulate(n)
    jr.accumulate(n)
    assert np.array_equal(pr.state.buckets.numpy(),
                          np.asarray(jr.state.buckets))


@pytest.mark.parametrize("shape", [(48, 80), (64, 64), (20, 33)])
def test_frame_delta_matches_jax(shape):
    """``_frame_delta`` (JAX ``viewer._frame_delta``) on the same seeded
    uint8 frames, one client: a first request, a few changed pixels, an
    unchanged frame, a frame changed everywhere and a stale generation.
    Each answer's gen, full, tile and tile list are equal, the PNGs decode
    to equal pixels (the full frame or the atlas of shipped tiles), and the
    server's reference frames stay equal."""
    rng = np.random.default_rng(sum(shape))
    h, w = shape
    frames = [rng.integers(0, 256, (h, w, 3), dtype=np.uint8)]
    b = frames[0].copy()
    for y, x in zip(rng.integers(0, h, 5), rng.integers(0, w, 5)):
        b[y, x] = 255 - b[y, x]
    frames += [b, b.copy(), rng.integers(0, 256, (h, w, 3), dtype=np.uint8)]
    pstate, jstate = {}, {}
    gen = -1
    for i, frame in enumerate(frames + [frames[-1]]):
        cgen = 0 if i == len(frames) else gen  # the last: a stale client
        got = viewer._frame_delta(pstate, frame, cgen)
        want = jviewer._frame_delta(jstate, frame, cgen)
        gpng, wpng = got.pop("png"), want.pop("png")
        assert got == want, i
        if wpng:
            assert np.array_equal(_png(gpng), _png(wpng)), i
        else:
            assert gpng == b"", i
        assert np.array_equal(pstate["frame"], jstate["frame"])
        assert pstate["gen"] == jstate["gen"]
        gen = got["gen"]
    assert got["full"]  # the stale client gets the whole frame


def test_materials_match_jax(pair):
    """``/materials`` of the two viewers on the same scene: the same
    JSON."""
    (pbase, _), (jbase, _) = pair
    pcode, pbody = _get(pbase + "/materials")
    jcode, jbody = _get(jbase + "/materials")
    assert pcode == jcode == 200
    assert json.loads(pbody) == json.loads(jbody)


def test_frames_match_jax(pair, jax_exact_math):
    """After /reset and the same 5 passes in both viewers (buckets bit for
    bit): the JAX viewer's /frame.png is the port's ``_quantize`` of the JAX
    renderer's tonemapped frame (no +0.5 rounding, unlike write_png), the
    port's is ``_quantize`` of its own, and the two decode to equal pixels;
    /frame.hdr are the same bytes; /delta?gen=-1 gives the same JSON and
    the same frame."""
    (pbase, pr), (jbase, jr) = pair
    _accumulate(pair, 5)
    pimg = pr.render(tonemap=True)
    jimg = np.asarray(jr.render(tonemap=True))
    pframe = _png(_get(pbase + "/frame.png")[1])
    jframe = _png(_get(jbase + "/frame.png")[1])
    assert np.array_equal(jframe, viewer._quantize(jimg))
    assert np.array_equal(pframe, viewer._quantize(pimg))
    assert np.array_equal(pframe, jframe)
    assert _get(pbase + "/frame.hdr") == _get(jbase + "/frame.hdr")
    pd = json.loads(_get(pbase + "/delta?gen=-1")[1])
    jd = json.loads(_get(jbase + "/delta?gen=-1")[1])
    pngs = [_png(base64.b64decode(d.pop("png_b64"))) for d in (pd, jd)]
    assert pd == jd and pd["full"] is True
    assert np.array_equal(pngs[0], pngs[1])
    assert np.array_equal(pngs[0], pframe)


def test_edits_match_jax(pair, jax_exact_math):
    """The same /edit and /camera queries (material, sphere, ambient,
    translate, rotate, lens) sent to both viewers: the same answers, each
    resets the accumulator, and the scenes' arrays stay equal after each;
    then the same 5 passes equal bit for bit and the frames decode to equal
    pixels. The focus probe (/camera?focus=x,y) leaves every other array
    equal and the focus distance within rtol 1e-4 (test_torch_probes.py's
    bar); a bad query and an unknown path get the same codes."""
    (pbase, pr), (jbase, jr) = pair
    for q in QUERIES:
        pr.accumulate(1)
        jr.accumulate(1)
        assert _get(pbase + q) == _get(jbase + q) == (200, b"ok"), q
        assert pr.state.accumulations == int(jr.state.accumulations) == 0
        _assert_same_arrays(pr.scene.to_numpy(), jax_scene_to_numpy(jr.scene))
    _accumulate(pair, 5)
    assert np.array_equal(_png(_get(pbase + "/frame.png")[1]),
                          _png(_get(jbase + "/frame.png")[1]))
    assert _get(pbase + "/camera?focus=8,8") == \
        _get(jbase + "/camera?focus=8,8") == (200, b"ok")
    got, want = pr.scene.to_numpy(), jax_scene_to_numpy(jr.scene)
    np.testing.assert_allclose(got.pop("camera_focus_distance"),
                               want.pop("camera_focus_distance"), rtol=1e-4)
    _assert_same_arrays(got, want)
    for q in ("/edit?material=0&albedo=not,a,vec", "/edit?sphere=0&pos=1,2",
              "/nonexistent"):
        (pcode, pbody), (jcode, jbody) = _get(pbase + q), _get(jbase + q)
        assert pcode == jcode and pcode in (400, 404), q
        assert pbody.startswith(b"error:") == jbody.startswith(b"error:"), q
