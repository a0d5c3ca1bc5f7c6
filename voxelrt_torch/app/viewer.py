"""Browser-based interactive viewer — the GGUI window replacement (the
PyTorch port of voxelrt/app/viewer.py).

The reference opens a Vulkan GGUI window with WASDQE + mouse-drag orbit and
an FOV slider (scene.py:171-297). A render host is headless, so the
equivalent is a tiny HTTP viewer: the render loop runs server-side, frames
stream as PNG, and the page forwards keyboard/mouse input back. Start with:

    scene = Scene(...); ...build voxels...
    from voxelrt_torch.app.viewer import serve
    serve(scene, port=8000)

Implements the reference's motion policy: moving -> render_scale 0.5 +
50-frame accumulation cap; still -> full res, unbounded accumulation;
framebuffer reset on transitions (scene.py:206-256). 'p' saves a screenshot
(scene.py:264-272): on the native runtime's writer thread when it is built
(utils/native.py), with utils/image.write_png in the render loop otherwise.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import threading
from datetime import datetime
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np

_PAGE = """<!doctype html><html><head><title>voxelrt viewer</title><style>
body{margin:0;background:#111;color:#ccc;font:13px monospace}
#hud{position:fixed;top:8px;left:8px;background:#0008;padding:6px}
img{display:block;margin:auto;image-rendering:pixelated}
</style></head><body>
<div id="hud">WASDQE move &middot; drag to orbit &middot; P screenshot<br>
FOV <input id="fov" type="range" min="1" max="90" value="50" style="width:90px">
<span id="stat"></span></div>
<img id="view" width="%W%" height="%H%">
<script>
const keys = new Set(); let drag=null, acc={dx:0,dy:0};
onkeydown = e=>keys.add(e.key.toLowerCase());
onkeyup = e=>keys.delete(e.key.toLowerCase());
const img = document.getElementById('view');
img.onmousedown = e=>drag=[e.clientX,e.clientY];
onmouseup = ()=>drag=null;
onmousemove = e=>{ if(drag){acc.dx+=(e.clientX-drag[0])/%W%; acc.dy+=(e.clientY-drag[1])/%H%; drag=[e.clientX,e.clientY];} };
async function loop(){
  const q = new URLSearchParams({keys:[...keys].join(''), dx:acc.dx, dy:acc.dy,
    fov:document.getElementById('fov').value});
  acc={dx:0,dy:0};
  await fetch('/input?'+q);
  img.src = '/frame.png?t='+Date.now();
  const s = await (await fetch('/stat')).json();
  document.getElementById('stat').textContent =
    `spp ${s.spp}  ${s.ms.toFixed(0)} ms per frame  ${s.moving?'moving':'accumulating'}`;
  setTimeout(loop, 30);
}
loop();
</script></body></html>"""


class ViewerState:
    def __init__(self):
        self.keys = ""
        self.dx = 0.0
        self.dy = 0.0
        self.fov_deg = None
        self.lock = threading.Lock()
        self.frame_png = b""
        self.stat = dict(spp=0, ms=0.0, moving=False)
        self.running = True


def serve(scene, port=8000, host="127.0.0.1", spp_per_frame=1,
          stats_csv=None, max_frames=None, ready_cb=None, res=None):
    """Serve the browser viewer. ``port=0`` binds an ephemeral port;
    ``ready_cb(port)`` fires once the server is listening; ``max_frames``
    bounds the render loop (None = run until interrupted) — both exist so
    tests (and scripted demos) can drive a real server lifecycle.
    ``res``: serve at this resolution instead of the scene's (e.g.
    ``(1920, 1080)``, the reference's native window size, scene.py:12)."""
    from voxelrt_torch.utils.image import encode_png, to_uint8_rows, write_png
    from voxelrt_torch.utils.native import frame_writer
    from voxelrt_torch.utils.profiling import FrameStats

    if res is not None and tuple(res) != tuple(scene.config.image_res):
        scene.config = dataclasses.replace(scene.config,
                                           image_res=tuple(res))
        scene._renderer = None  # rebuild under the new resolution
    r = scene.renderer
    r.prepare_data()
    vs = ViewerState()
    w, h = scene.config.image_res
    writer = frame_writer()

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
            u = urlparse(self.path)
            if u.path == "/":
                page = _PAGE.replace("%W%", str(w)).replace("%H%", str(h))
                self._send(200, "text/html", page.encode())
            elif u.path == "/frame.png":
                self._send(200, "image/png", vs.frame_png or b"")
            elif u.path == "/stat":
                self._send(200, "application/json", json.dumps(vs.stat).encode())
            elif u.path == "/input":
                q = parse_qs(u.query)
                try:
                    dx = float(q.get("dx", ["0"])[0])
                    dy = float(q.get("dy", ["0"])[0])
                    fov = float(q["fov"][0]) if "fov" in q else None
                except ValueError:
                    self._send(400, "text/plain", b"bad number")
                    return
                with vs.lock:
                    vs.keys = q.get("keys", [""])[0]
                    vs.dx += dx
                    vs.dy += dy
                    if fov is not None:  # FOV slider (scene.py:284-291)
                        vs.fov_deg = fov
                self._send(200, "text/plain", b"ok")
            else:
                self._send(404, "text/plain", b"not found")

    server = ThreadingHTTPServer((host, port), Handler)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    bound_port = server.server_address[1]
    print(f"voxelrt viewer at http://{host}:{bound_port}/")
    if ready_cb is not None:
        ready_cb(bound_port)

    def frames():
        n_served = 0
        while vs.running and (max_frames is None or n_served < max_frames):
            n_served += 1
            with vs.lock:
                keys, dx, dy = vs.keys, vs.dx, vs.dy
                vs.dx = vs.dy = 0.0
                if vs.fov_deg is not None:
                    scene._fov = math.radians(vs.fov_deg)
            f = {"move_keys": [k for k in keys if k in "wasdqe"]}
            if dx or dy:
                f["orbit"] = (dx, dy)
            if "p" in keys:
                stamp = datetime.today().strftime("%Y-%m-%d-%H%M%S")
                path = os.path.join("screenshot", f"viewer-{stamp}.png")
                if writer is None:
                    write_png(path, r.fetch_image())
                else:
                    # encoded and written on the native worker thread
                    os.makedirs("screenshot", exist_ok=True)
                    rows = np.ascontiguousarray(to_uint8_rows(r.fetch_image()))
                    writer.submit(path, rows.tobytes(), w, h)
            yield f

    stats = FrameStats(csv_path=stats_csv)

    def on_frame(i, img):
        # HUD timing comes from FrameStats' synced render wall (the row
        # run_frames just recorded), not the server loop cadence.
        row = stats.rows[-1]
        rows = np.ascontiguousarray(to_uint8_rows(img))
        vs.frame_png = encode_png(rows, w, h, 3)
        vs.stat = dict(spp=int(r.state.spp), ms=row["wall_ms"],
                       moving=row["moving"])

    try:
        r.quiet = True  # FrameStats rows go to the CSV, not the console
        r.run_frames(frames(), spp_per_frame=spp_per_frame,
                     on_frame=on_frame, stats=stats)
    except KeyboardInterrupt:
        pass
    finally:
        vs.running = False
        server.shutdown()
        server.server_close()
        if writer is not None:
            writer.drain()
