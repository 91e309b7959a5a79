"""Live render preview: an in-process HTTP viewer fed by render events
(a copy of the JAX package's utils/preview.py, which imports nothing of
JAX).

The counterpart of Mitsuba's interactive viewer (mtsgui, a Qt window
repainted per finished block).  The preview is a small stdlib HTTP
server on 127.0.0.1: it serves a page whose <img> polls the latest
developed image (a tonemapped PNG, encoded on the host), the render's
status and pause/stop/exposure controls.  Attach ``PreviewServer`` to a
``RenderQueue`` (utils/logger.py) and every progression shows up in the
browser.  The server's threads see only the host numpy images the queue
hands over, never a device tensor.

Usage:
    srv = PreviewServer(port=8750)
    cfg.queue = RenderQueue(listeners=[srv])
    render_progressive(scene, cfg)
    srv.close()
or via the CLI: ``python -m mitsuba_path_guiding_torch.render scene.xml
--preview 8750``.
"""
from __future__ import annotations

import io
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from mitsuba_path_guiding_torch.utils.logger import RenderEvent, RenderListener

_PAGE = """<!doctype html>
<html><head><title>render preview</title><style>
body { background: #181818; color: #ddd; font: 14px sans-serif;
       text-align: center; }
img { image-rendering: pixelated; max-width: 95vw; max-height: 85vh;
      border: 1px solid #444; }
</style></head><body>
<h3 id="s">waiting for first progression&hellip;</h3>
<div>
  <button onclick="ctl('pause=1')">pause</button>
  <button onclick="ctl('pause=0')">resume</button>
  <button onclick="ctl('stop=1')">stop</button>
  exposure <input id="ev" type="range" min="-6" max="6" step="0.5"
    value="0" onchange="ctl('exposure='+this.value)">
  <span id="evv">0</span> EV
</div>
<img id="im" src="/image.png">
<script>
const im = document.getElementById('im'), s = document.getElementById('s');
async function ctl(q) {
  await fetch('/control?' + q);
  document.getElementById('evv').textContent =
    document.getElementById('ev').value;
  im.src = '/image.png?v=' + Date.now();
}
setInterval(async () => {
  const r = await fetch('/status');
  const j = await r.json();
  if (j.version > (im.dataset.v|0)) {
    im.dataset.v = j.version;
    im.src = '/image.png?v=' + j.version;
    s.textContent = (j.finished
      ? `finished: ${j.spp} spp in ${j.elapsed.toFixed(1)} s`
      : `progression ${j.progression}/${j.total} — ${j.spp} spp, ` +
        `${j.elapsed.toFixed(1)} s`) + (j.paused ? ' [paused]' : '');
  }
}, 500);
</script></body></html>
""".encode("utf-8")


def encode_png(img: np.ndarray) -> bytes:
    """sRGB-tonemapped PNG bytes for a linear (H, W, 3) image."""
    from mitsuba_path_guiding_torch.core.spectrum import srgb_encode_np

    arr = (np.clip(srgb_encode_np(np.clip(img, 0.0, 1.0)), 0, 1) * 255
           + 0.5).astype(np.uint8)
    # reuse the film PNG writer's chunk logic via an in-memory path
    import struct
    import zlib

    h, w, _ = arr.shape
    raw = b"".join(b"\x00" + arr[i].tobytes() for i in range(h))

    def chunk(tag, data):
        c = struct.pack(">I", len(data)) + tag + data
        return c + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))


class PreviewServer(RenderListener):
    """HTTP preview server + render listener; thread-safe snapshot swap."""

    def __init__(self, port: int = 8750, host: str = "127.0.0.1"):
        self._lock = threading.Lock()
        self._png: bytes = b""
        self._img = None      # last linear image (re-encode on EV change)
        self._state = {"version": 0, "progression": 0, "total": 0,
                       "spp": 0, "elapsed": 0.0, "finished": False,
                       "paused": False}
        # interactive render controls (reference mtsgui job control /
        # render-settings leg): polled by the progressive loop between
        # progressions via RenderListener.control_state
        self._controls = {"pause": False, "stop": False, "exposure": 0.0}

        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # silence per-request stderr spam
                pass

            def do_GET(self):
                if self.path.startswith("/image.png"):
                    with outer._lock:
                        body = outer._png
                    ctype = "image/png"
                elif self.path.startswith("/status"):
                    import json

                    with outer._lock:
                        st = dict(outer._state)
                        st["paused"] = outer._controls["pause"]
                        body = json.dumps(st).encode()
                    ctype = "application/json"
                elif self.path.startswith("/control"):
                    from urllib.parse import parse_qs, urlparse

                    q = parse_qs(urlparse(self.path).query)
                    with outer._lock:
                        if "pause" in q:
                            outer._controls["pause"] = q["pause"][0] == "1"
                        if "stop" in q:
                            outer._controls["stop"] = q["stop"][0] == "1"
                        if "exposure" in q:
                            outer._controls["exposure"] = float(
                                q["exposure"][0])
                            if outer._img is not None:
                                outer._png = encode_png(
                                    outer._img
                                    * 2.0 ** outer._controls["exposure"])
                    import json

                    body = json.dumps(outer._controls).encode()
                    ctype = "application/json"
                else:
                    body, ctype = _PAGE, "text/html"
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.send_header("Cache-Control", "no-store")
                self.end_headers()
                self.wfile.write(body)

        self.server = ThreadingHTTPServer((host, port), Handler)
        self.port = self.server.server_address[1]
        self._thread = threading.Thread(target=self.server.serve_forever,
                                        daemon=True)
        self._thread.start()

    # -- RenderListener ----------------------------------------------------
    def control_state(self) -> dict:
        with self._lock:
            return dict(self._controls)

    def _update(self, ev: RenderEvent, finished: bool) -> None:
        if ev.image is None:
            return
        img = np.asarray(ev.image)
        with self._lock:
            expo = self._controls["exposure"]
        png = encode_png(img * 2.0 ** expo if expo else img)
        with self._lock:
            self._img = img
            self._png = png
            self._state = {
                "version": self._state["version"] + 1,
                "progression": ev.progression + 1,
                "total": ev.n_progressions,
                "spp": ev.spp_done,
                "elapsed": ev.elapsed_s,
                "finished": finished,
            }

    def on_progression(self, ev: RenderEvent) -> None:
        self._update(ev, finished=False)

    def on_finish(self, ev: RenderEvent) -> None:
        self._update(ev, finished=True)

    def close(self) -> None:
        self.server.shutdown()
        self.server.server_close()
