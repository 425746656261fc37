"""Live progressive viewer, the port of the JAX package's ``viewer.py``: a
lightweight replacement for the reference's GLFW/Vulkan/ImGui shell
(App.cpp, Application.cpp:361-421).

A background thread accumulates samples continuously on the render device
(the progressive refinement loop); an HTTP server serves the current
median-of-means resolve as PNG plus a stats endpoint mirroring the reference
HUD (spp, ms/frame, Msamples/s). Scene and camera edits arrive as query
parameters and go through scene/edit.py, preserving the reference's edit ->
invalidate -> re-render semantics (UpdateTracker, Application.cpp:335-358):

  /edit?material=2&albedo=0.8,0.2,0.2&roughness=0.5
  /edit?material=1&emission=50,50,50
  /edit?sphere=0&pos=0,1,0&radius=0.5
  /edit?ambient=1,1,1
  /camera?translate=0,0,-0.5      (local frame, like WASD flight)
  /camera?rotate=0.05,0.1,0       (pitch, yaw, roll radians)
  /camera?focus=128,96            (depth-probe autofocus at pixel x,y)
  /camera?focal=85&fnumber=2.8&exposure=0.5   (lens sliders)

Frames stream incrementally: /delta?gen=N diffs the current tonemapped
frame against the last one sent and returns only the changed 32-px tiles
as a packed PNG atlas (tiles quiesce byte-exactly as pixels converge, so
late-render traffic collapses; a gen mismatch or first request returns the
full frame). /frame.png remains for single-shot fetches. PNGs are encoded
by ``utils/image.py::encode_png`` (zlib, no imaging package).

The renderer runs on the card unless ``make_server`` is given another
device (``device="cpu"``); the render thread and the HTTP threads share it
under one lock.
"""
from __future__ import annotations

import base64
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch

from .utils.image import encode_hdr, encode_png

_TILE = 32  # dirty-tile edge for /delta streaming


def _frame_delta(state: dict, arr: np.ndarray, client_gen: int) -> dict:
    """Diff `arr` (uint8 [H,W,3]) against the last frame sent to the (single)
    streaming client. Returns {'gen', 'full', 'png' (bytes)} plus
    {'tiles', 'tile'} for partial updates. Only the tiles actually shipped
    are folded into the server's reference frame, so a tile that drifts
    below next tick's diff keeps its pending difference until sent: no
    accumulation drift."""
    prev = state.get("frame")
    if (client_gen != state.get("gen", 0) or prev is None
            or prev.shape != arr.shape):
        state["frame"] = arr.copy()
        state["gen"] = state.get("gen", 0) + 1
        return {"gen": state["gen"], "full": True, "png": encode_png(arr)}
    h, w = arr.shape[:2]
    t = _TILE
    ph, pw = -(-h // t) * t, -(-w // t) * t

    def pad(a):
        return np.pad(a, ((0, ph - h), (0, pw - w), (0, 0)))

    a4 = pad(arr).reshape(ph // t, t, pw // t, t, 3)
    p4 = pad(prev).reshape(ph // t, t, pw // t, t, 3)
    dirty = (a4 != p4).any(axis=(1, 3, 4))  # [th, tw]
    ys, xs = np.nonzero(dirty)
    state["gen"] += 1
    if ys.size == 0:
        return {"gen": state["gen"], "full": False, "tiles": [], "png": b""}
    atlas = np.concatenate([a4[y, :, x, :, :] for y, x in zip(ys, xs)],
                           axis=1)  # [t, n*t, 3]
    for y, x in zip(ys, xs):
        y0, x0 = y * t, x * t
        state["frame"][y0:min(y0 + t, h), x0:min(x0 + t, w)] = arr[
            y0:min(y0 + t, h), x0:min(x0 + t, w)]
    return {
        "gen": state["gen"],
        "full": False,
        "tile": t,
        "tiles": [[int(x) * t, int(y) * t] for y, x in zip(ys, xs)],
        "png": encode_png(atlas),
    }


_PAGE = """<!doctype html>
<html><head><title>path tracer</title><style>
body { background:#111; color:#ccc; font-family:monospace; text-align:center }
#frame { image-rendering:pixelated; margin-top:0.5em; max-width:95vw; cursor:crosshair }
#panel { display:inline-block; text-align:left; margin:0.5em; font-size:12px }
#panel label { display:inline-block; width:7em }
input[type=range] { width:10em; vertical-align:middle }
#help { color:#777; font-size:11px }
</style></head><body>
<div id="stats">...</div>
<canvas id="plot" width="320" height="48" style="display:block;margin:0.3em auto;background:#181818"></canvas>
<div id="help">drag = look &nbsp; WASD/QE = fly (shift = fast) &nbsp;
right-click = focus &nbsp; <a href="/frame.hdr" download style="color:#6cf">save .hdr</a></div>
<canvas id="frame"></canvas>
<div id="panel">
 <div>
  <label>material</label><select id="mat"></select>
  <label style="width:5em">roughness</label>
  <input type="range" id="rough" min="0" max="1" step="0.01">
  <span id="roughv"></span>
 </div>
 <div>
  <label>albedo</label><input type="color" id="albedo">
  <label style="width:5em">emission</label>
  <input type="range" id="emit" min="0" max="2.5" step="0.01">
  <span id="emitv"></span>
 </div>
 <div>
  <label>fly speed</label><input type="range" id="speed" min="-2" max="2" step="0.1" value="0">
 </div>
</div>
<script>
const img = document.getElementById('frame');  // canvas: dirty tiles blit here
const fctx = img.getContext('2d');
let gen = -1, mats = [], cur = 0;
async function pullDelta() {  // /delta dirty-tile stream
  const d = await (await fetch('/delta?gen=' + gen)).json();
  gen = d.gen;
  if (!d.full && !d.tiles.length) return;
  const bm = await createImageBitmap(
    await (await fetch('data:image/png;base64,' + d.png_b64)).blob());
  if (d.full) {
    img.width = bm.width; img.height = bm.height;
    fctx.drawImage(bm, 0, 0);
  } else {
    d.tiles.forEach(([x, y], i) =>
      fctx.drawImage(bm, i * d.tile, 0, d.tile, d.tile, x, y, d.tile, d.tile));
  }
}
const hex = v => Math.round(Math.pow(Math.min(Math.max(v,0),1), 1/2.2)*255)
  .toString(16).padStart(2,'0');
const unhex = s => [1,3,5].map(i => Math.pow(parseInt(s.substr(i,2),16)/255, 2.2));
function showMat() {
  const m = mats[cur]; if (!m) return;
  document.getElementById('rough').value = m.roughness;
  document.getElementById('roughv').textContent = m.roughness.toFixed(2);
  document.getElementById('albedo').value = '#'+m.albedo.map(hex).join('');
  const e = Math.max(...m.emission);
  document.getElementById('emit').value = Math.log10(Math.max(e,1e-3)+1);
  document.getElementById('emitv').textContent = e.toFixed(1);
}
async function loadMats() {
  mats = await (await fetch('/materials')).json();
  const sel = document.getElementById('mat');
  sel.innerHTML = mats.map((m,i) => `<option value="${i}">#${i}</option>`).join('');
  sel.onchange = () => { cur = +sel.value; showMat(); };
  showMat();
}
document.getElementById('rough').oninput = ev => {
  mats[cur].roughness = +ev.target.value; showMat();
  fetch(`/edit?material=${cur}&roughness=${ev.target.value}`);
};
document.getElementById('albedo').oninput = ev => {
  mats[cur].albedo = unhex(ev.target.value);
  fetch(`/edit?material=${cur}&albedo=${mats[cur].albedo.map(v=>v.toFixed(4))}`);
};
document.getElementById('emit').oninput = ev => {
  const e = Math.pow(10, +ev.target.value) - 1;
  mats[cur].emission = [e, e, e]; showMat();
  fetch(`/edit?material=${cur}&emission=${e.toFixed(3)},${e.toFixed(3)},${e.toFixed(3)}`);
};
// --- fly camera: drag to look, WASD/QE to move (Application.cpp:309-333) ---
const held = new Set();
let dragging = false, dp = 0, dy = 0;
window.addEventListener('keydown', ev => {
  if (['KeyW','KeyA','KeyS','KeyD','KeyQ','KeyE','ShiftLeft','ShiftRight']
      .includes(ev.code)) {
    held.add(ev.code); ev.preventDefault();
  }
});
window.addEventListener('keyup', ev => held.delete(ev.code));
img.addEventListener('mousedown', ev => { if (ev.button === 0) dragging = true; });
window.addEventListener('mouseup', () => dragging = false);
window.addEventListener('mousemove', ev => {
  if (!dragging) return;
  dy -= ev.movementX * 0.003;  // yaw
  dp -= ev.movementY * 0.003;  // pitch
});
img.addEventListener('contextmenu', ev => {  // right-click depth-probe focus
  ev.preventDefault();
  const r = img.getBoundingClientRect();
  const px = Math.floor((ev.clientX - r.left) / r.width * img.width);
  const py = Math.floor((ev.clientY - r.top) / r.height * img.height);
  fetch(`/camera?focus=${px},${img.height - 1 - py}`);  // y-up flip
});
setInterval(() => {  // 20 Hz control loop
  const q = [];
  if (dp || dy) { q.push(`rotate=${dp.toFixed(4)},${dy.toFixed(4)},0`); dp = dy = 0; }
  let v = Math.pow(10, +document.getElementById('speed').value) * 0.05;
  if (held.has('ShiftLeft') || held.has('ShiftRight')) v *= 5;
  if (held.size) {
    const t = [0, 0, 0];
    if (held.has('KeyW')) t[2] -= v;   if (held.has('KeyS')) t[2] += v;
    if (held.has('KeyA')) t[0] -= v;   if (held.has('KeyD')) t[0] += v;
    if (held.has('KeyQ')) t[1] -= v;   if (held.has('KeyE')) t[1] += v;
    q.push(`translate=${t.map(x=>x.toFixed(4))}`);
  }
  if (q.length) fetch('/camera?' + q.join('&'));
}, 50);
async function tick() {
  await pullDelta();
  const s = await (await fetch('/stats')).json();
  document.getElementById('stats').textContent =
    `${s.width}x${s.height}  ${s.spp} spp  ${s.ms_per_pass.toFixed(1)} ms/pass  ` +
    `${s.msamples_per_s.toFixed(1)} Msamples/s`;
  const c = document.getElementById('plot').getContext('2d');
  const h = s.history_ms, peak = Math.max(...h, 1e-3);
  c.clearRect(0, 0, 320, 48);
  c.strokeStyle = '#6cf'; c.beginPath();
  h.forEach((v, i) => { const x = i * 5, y = 48 - 46 * v / peak;
    i ? c.lineTo(x, y) : c.moveTo(x, y); });
  c.stroke();
}
setInterval(tick, 1000);
loadMats();
</script></body></html>"""


def _quantize(img: np.ndarray) -> np.ndarray:
    """A tonemapped frame as the uint8 pixels the JAX viewer sends."""
    return (np.clip(img, 0, 1) * 255).astype(np.uint8)


def make_server(scene, policy, width: int, height: int, port: int = 8000,
                device=None):
    """Build the viewer server without blocking: the renderer on `device`
    (the card unless another is named; it raises without one) and its
    render thread, started.

    Returns (server, renderer, stop_event, worker_thread); the caller runs
    server.serve_forever() (see serve()) or drives it from a test, and sets
    stop_event to end the render thread. Pass port=0 for an ephemeral port
    (server.server_address[1] reports it).
    """
    from .render.api import Renderer

    renderer = Renderer(scene, policy, width, height, device=device)
    lock = threading.Lock()
    delta_lock = threading.Lock()
    delta_state: dict = {}
    # 64-sample frame-time history, like the reference HUD's CyclicBuffer
    # plot (Application.cpp:391-404)
    stats = {"ms_per_pass": 0.0, "spp": 0, "history": [0.0] * 64}
    stop = threading.Event()
    on_card = renderer.device.type == "cuda"
    # the current device is a thread's own: the render thread takes the
    # caller's where the renderer names no index
    card = (renderer.device.index if renderer.device.index is not None
            else torch.cuda.current_device()) if on_card else None

    def worker():
        if on_card:
            torch.cuda.set_device(card)
        while not stop.is_set():
            t0 = time.perf_counter()
            with lock:
                renderer.accumulate(policy.accumulation_buckets)
                if on_card:
                    torch.cuda.synchronize(renderer.device)
            dt = time.perf_counter() - t0
            stats["ms_per_pass"] = dt * 1e3 / policy.accumulation_buckets
            stats["spp"] = int(renderer.state.accumulations)
            stats["history"] = stats["history"][1:] + [stats["ms_per_pass"]]

    thread = threading.Thread(target=worker, daemon=True)
    thread.start()

    def edit(q: dict):
        """Apply the /edit and /camera query `q` through scene/edit.py."""
        from .scene import edit as edit_mod

        def vec(key):
            return tuple(float(t) for t in q[key].split(","))

        editor = edit_mod.SceneEditor(renderer)
        if "material" in q:
            fields = {f: vec(f) for f in ("albedo", "emission", "f0", "f80",
                                          "transmission") if f in q}
            fields.update({f: float(q[f]) for f in ("roughness",
                                                    "ior_minus_one")
                           if f in q})
            editor.edit(edit_mod.set_material, int(q["material"]), **fields)
        if "sphere" in q:
            editor.edit(
                edit_mod.set_sphere, int(q["sphere"]),
                position=vec("pos") if "pos" in q else None,
                radius=float(q["radius"]) if "radius" in q else None)
        if "ambient" in q:
            editor.edit(edit_mod.set_ambient, vec("ambient"))
        if "translate" in q:
            editor.edit(edit_mod.translate_camera_local, vec("translate"))
        if "rotate" in q:
            editor.edit(edit_mod.rotate_camera_local, vec("rotate"))
        if any(k in q for k in ("focal", "fnumber", "exposure")):
            editor.edit(
                edit_mod.set_camera_lens, width, height,
                focal_length=float(q["focal"]) if "focal" in q else None,
                f_number=float(q["fnumber"]) if "fnumber" in q else None,
                exposure=float(q["exposure"]) if "exposure" in q else None)
        if "focus" in q:
            from .render import probes

            fx, fy = (int(t) for t in q["focus"].split(","))
            renderer.scene = probes.autofocus(renderer.scene, fx, fy, width,
                                              height)
            editor.flags |= edit_mod.SceneUpdate.CAMERA
        editor.commit()

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def _send(self, code, ctype, body):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            path = self.path.split("?")[0]
            if path == "/":
                self._send(200, "text/html", _PAGE.encode())
            elif path == "/frame.png":
                with lock:
                    img = renderer.render(tonemap=True)
                self._send(200, "image/png", encode_png(_quantize(img)))
            elif path == "/delta":
                q = parse_qs(urlparse(self.path).query)
                cgen = int(q.get("gen", ["-1"])[0])
                with lock:
                    img = renderer.render(tonemap=True)
                with delta_lock:
                    d = _frame_delta(delta_state, _quantize(img), cgen)
                png = d.pop("png")
                d["png_b64"] = base64.b64encode(png).decode()
                self._send(200, "application/json", json.dumps(d).encode())
            elif path == "/stats":
                ms = stats["ms_per_pass"]
                body = json.dumps({
                    "width": width,
                    "height": height,
                    "spp": stats["spp"],
                    "ms_per_pass": ms,
                    "msamples_per_s": (width * height / (ms * 1e-3) / 1e6
                                       if ms > 0 else 0.0),
                    "history_ms": [round(v, 2) for v in stats["history"]],
                }).encode()
                self._send(200, "application/json", body)
            elif path == "/reset":
                with lock:
                    renderer.reset_accumulator()
                self._send(200, "text/plain", b"ok")
            elif path == "/materials":
                with lock:
                    m = renderer.scene.materials.to("cpu")
                body = json.dumps([
                    {"albedo": [float(c[i]) for c in m.albedo],
                     "emission": [float(c[i]) for c in m.emission],
                     "roughness": float(m.roughness[i])}
                    for i in range(m.count)]).encode()
                self._send(200, "application/json", body)
            elif path == "/frame.hdr":
                # F5-screenshot parity: HDR export of the current resolve
                # (Application.cpp:254-257 -> Image::Store, Image.cpp:71-74)
                with lock:
                    hdr = renderer.render(tonemap=False)
                self._send(200, "image/vnd.radiance", encode_hdr(hdr))
            elif path in ("/edit", "/camera"):
                q = {k: v[0]
                     for k, v in parse_qs(urlparse(self.path).query).items()}
                try:
                    with lock:
                        edit(q)
                    self._send(200, "text/plain", b"ok")
                except Exception as e:  # a bad query: 400 with the reason
                    self._send(400, "text/plain", f"error: {e}".encode())
            else:
                self._send(404, "text/plain", b"not found")

    server = ThreadingHTTPServer(("0.0.0.0", port), Handler)
    return server, renderer, stop, thread


def serve(scene, policy, width: int, height: int, port: int = 8000,
          device=None):
    server, _, stop, thread = make_server(scene, policy, width, height, port,
                                          device)
    print(f"live viewer on http://localhost:{port}  (ctrl-c to stop)")
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        stop.set()
        server.shutdown()
        thread.join()
