"""Interactive web viewer of the port: stdlib HTTP server + HTML/JS orbit
frontend, the port of the JAX package's `viewer/server.py`. The page, the
event protocol (rotate, pan, zoom, roll, sensitivity, release, resize,
preset, tick, init) and the RGBA post-processed PNG frames are the same;
frames are rendered by the port's `render` + `post_process` on the device
the app was built for.
"""

from __future__ import annotations

import json
import os
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np
import torch

from ..config import RenderConfig
from ..core.types import GaussianCloud
from ..io.cameras import load_cameras_json
from ..io.ply import read_ply
from ..ops.composite import post_process
from ..ops.rasterize import render
from ..utils.image import encode_png
from . import orbit

_PAGE = """<!DOCTYPE html>
<html><head><title>gaussian_splatting_web_tpu_torch viewer</title>
<style>
 body { margin:0; background:#111; color:#ddd; font:13px sans-serif; display:flex; }
 #side { width:230px; padding:10px; flex:none; }
 #view { flex:1; display:flex; align-items:center; justify-content:center; }
 img { max-width:100%; touch-action:none; }
 li { cursor:pointer; padding:2px; } li:hover { color:#fff; }
 #fps { color:#8f8; }
 input[type=file] { width:100%; font-size:11px; margin:2px 0; }
 #popup { position:fixed; inset:0; background:rgba(0,0,0,.7); display:none;
   align-items:center; justify-content:center; flex-direction:column; }
 #bar { width:260px; height:10px; background:#333; margin-top:8px; }
 #barfill { height:100%; width:0; background:#8f8; }
</style></head>
<body>
<div id="popup"><div>Loading .ply, this may take from seconds to a couple
 of minutes…</div><div id="bar"><div id="barfill"></div></div></div>
<div id="side">
 <h3>splat viewer</h3>
 <div id="fps">fps: –</div>
 <div id="stats"></div>
 <label>.ply scene <input type="file" id="plyPick" accept=".ply"></label>
 <label>cameras.json <input type="file" id="camPick" accept=".json"></label>
 <label>rotate speed
   <input type="range" id="speed" min="10" max="1000" value="100"></label>
 <p>drag: rotate · right-drag: pan · wheel: zoom · touch: 1-finger rotate,
    2-finger pan<br>
    keys: q/e zoom, j/l yaw, i/k pitch, u/o roll</p>
 <ul id="cams"></ul>
</div>
<div id="view"><img id="frame" draggable="false"></div>
<script>
const img = document.getElementById('frame');
let busy=false, queued=null, frames=0, t0=performance.now(), dirty=false;
async function send(ev) {
  if (busy) { queued = ev; return; }
  busy = true;
  try {
    const r = await fetch('/event', {method:'POST', body:JSON.stringify(ev)});
    dirty = r.headers.get('X-Dirty') === '1';
    const b = await r.blob();
    img.src = URL.createObjectURL(b);
    frames++;
    const now = performance.now();
    if (now - t0 > 1000) {
      document.getElementById('fps').textContent = 'fps: ' + (frames*1000/(now-t0)).toFixed(1);
      frames=0; t0=now;
    }
  } finally {
    busy = false;
    if (queued) { const q = queued; queued = null; send(q); }
    // continuous frame loop with dirty gating (renderer.ts:332-387):
    // while inertia keeps the camera dirty, keep ticking frames
    else if (dirty) requestAnimationFrame(()=>send({kind:'tick'}));
  }
}
let drag=false, mode=0, ox=0, oy=0;
img.addEventListener('contextmenu', e=>e.preventDefault());
img.addEventListener('pointerdown', e=>{
  if(e.pointerType==='touch') return;  // touch handled below
  drag=true;mode=e.button;ox=e.clientX;oy=e.clientY;e.preventDefault();});
window.addEventListener('pointerup', e=>{if(drag){drag=false;send({kind:'release'});}});
window.addEventListener('pointermove', e=>{
  if(!drag) return;
  const dx=(e.clientX-ox)/img.clientWidth, dy=(e.clientY-oy)/img.clientHeight;
  ox=e.clientX; oy=e.clientY;
  if(mode===0) send({kind:'rotate', dx:dx*2*Math.PI, dy:-dy*2*Math.PI});
  else send({kind:'pan', dx:dx*2, dy:-dy*2});
});
// one-finger rotate / two-finger pan (camera.ts:282-326)
let tmode=-1;
img.addEventListener('touchstart', e=>{
  tmode = e.touches.length===1 ? 2 : 0;
  ox=e.touches[0].clientX; oy=e.touches[0].clientY;
  e.preventDefault();
});
img.addEventListener('touchmove', e=>{
  if(tmode<0) return;
  const dx=(e.touches[0].clientX-ox), dy=(e.touches[0].clientY-oy);
  ox=e.touches[0].clientX; oy=e.touches[0].clientY;
  if(tmode===2) send({kind:'rotate', dx:dx*2*Math.PI/img.clientWidth,
                      dy:-dy*2*Math.PI/img.clientHeight});
  else send({kind:'pan', dx:dx*2/img.clientWidth, dy:-dy*2/img.clientHeight});
  e.preventDefault();
});
img.addEventListener('touchend', e=>{ tmode=-1; send({kind:'release'}); });
img.addEventListener('wheel', e=>{send({kind:'zoom', d:e.deltaY}); e.preventDefault();});
window.addEventListener('keydown', e=>{
  const m={'q':{kind:'zoom',d:-100},'e':{kind:'zoom',d:100},
           'j':{kind:'rotate',dx:0.1,dy:0},'l':{kind:'rotate',dx:-0.1,dy:0},
           'i':{kind:'rotate',dx:0,dy:0.1},'k':{kind:'rotate',dx:0,dy:-0.1},
           'u':{kind:'roll',d:0.1},'o':{kind:'roll',d:-0.1}};
  if(m[e.key]) { send(m[e.key]); e.preventDefault(); }
});
document.getElementById('speed').addEventListener('input', e=>{
  send({kind:'sensitivity', value: e.target.value/1000});  // camera.ts:74-76
});
function refreshInfo(info){
  document.getElementById('stats').textContent =
    info.num_gaussians + ' gaussians, SH deg ' + info.sh_degree;
  const ul = document.getElementById('cams');
  ul.innerHTML = '';
  (info.cameras||[]).forEach((name,i)=>{
    const li=document.createElement('li'); li.textContent=name;
    li.onclick=()=>send({kind:'preset', index:i});
    ul.appendChild(li);
  });
}
// scene upload with a loading popup + progress bar (the reference's
// fetchWithProgress + loading popup, index.ts:55-84 / index.html)
document.getElementById('plyPick').addEventListener('change', async e=>{
  const f=e.target.files[0]; if(!f) return;
  const popup=document.getElementById('popup'),
        fill=document.getElementById('barfill');
  popup.style.display='flex'; fill.style.width='0';
  const xhr=new XMLHttpRequest();
  xhr.open('POST','/scene');
  xhr.upload.onprogress=ev=>{
    if(ev.lengthComputable) fill.style.width=(ev.loaded/ev.total*100)+'%';
  };
  xhr.onload=()=>{ popup.style.display='none';
    refreshInfo(JSON.parse(xhr.responseText)); send({kind:'init'}); };
  xhr.onerror=()=>{ popup.style.display='none'; };
  xhr.send(await f.arrayBuffer());
});
document.getElementById('camPick').addEventListener('change', async e=>{
  const f=e.target.files[0]; if(!f) return;
  const r=await fetch('/cameras',{method:'POST', body:await f.text()});
  refreshInfo(await r.json()); send({kind:'init'});
});
// window-resize re-render (index.ts:146-152), debounced
let rt=null;
window.addEventListener('resize', ()=>{
  clearTimeout(rt);
  rt=setTimeout(()=>{
    const v=document.getElementById('view');
    send({kind:'resize', width:v.clientWidth, height:v.clientHeight});
  }, 250);
});
fetch('/info').then(r=>r.json()).then(refreshInfo);
send({kind:'init'});
</script></body></html>
"""

MAX_DIM = 4096


class ViewerApp:
    def __init__(self, cloud: GaussianCloud, width: int, height: int,
                 config: RenderConfig, cameras_json: Optional[str] = None,
                 device="cuda"):
        self.device = torch.device(device)
        self.width, self.height = width, height
        self.config = config
        self.preset = None  # overrides orbit when set
        self.presets = []
        self.lock = threading.Lock()
        self._set_cloud(cloud)
        if cameras_json:
            with open(cameras_json) as f:
                self._set_cameras(f.read())

    def _set_cloud(self, cloud: GaussianCloud):
        """Install a scene on the app's device and re-center the orbit
        camera on its bbox (index.ts:115-119)."""
        self.cloud = cloud.to(self.device)
        lo, hi = self.cloud.bbox()
        center = tuple(float(x) for x in ((lo + hi) / 2).cpu())
        eye = (center[0], center[1], center[2] - 5.0)
        sens = getattr(self, "state", None)
        self.state = orbit.OrbitState(
            eye=eye, center=center, radius=5.0, previous_eye=eye,
            sensitivity=sens.sensitivity if sens else 0.1,
        )
        self.preset = None

    def _set_cameras(self, json_text: str):
        self.presets = load_cameras_json(
            json_text, target_size=(self.width, self.height))

    def load_scene(self, ply_bytes: bytes) -> dict:
        """Hot-swap the scene (the reference's handlePlyChange,
        index.ts:29-54)."""
        cloud = read_ply(ply_bytes)
        with self.lock:
            self._set_cloud(cloud)
        return self.info()

    def load_cameras(self, json_text: str) -> dict:
        with self.lock:
            self._set_cameras(json_text)
        return self.info()

    def load_scene_model(self, scene_dir: str, name: str) -> dict:
        """`?model=<name>` scene selection (index.ts:89-95): load
        `<scene_dir>/<name>.ply`, the name sanitized to a basename."""
        base = os.path.basename(name)
        if not base.endswith(".ply"):
            base += ".ply"
        path = os.path.join(scene_dir, base)
        if not os.path.isfile(path):
            raise FileNotFoundError(base)
        cloud = read_ply(path)
        with self.lock:
            self._set_cloud(cloud)
        return self.info()

    def _frame(self) -> np.ndarray:
        """Render the current camera → straight-alpha RGBA float array
        with the post-process alpha shaping applied
        (post_process_render.ts:63-76)."""
        camera = (self.preset if self.preset is not None
                  else orbit.to_camera(self.state, self.width, self.height))
        with torch.no_grad():
            img, aux = render(self.cloud, camera, self.width, self.height,
                              self.config)
            rgba = post_process(img, aux["alpha"], self.config)
            a = torch.clamp(rgba[..., 3:4], min=1.0 / 255.0)
            straight = torch.clamp(rgba[..., :3] / a, 0.0, 1.0)
            frame = torch.cat([straight, rgba[..., 3:4]], dim=-1)
        return frame.cpu().numpy()

    def handle_event(self, ev: dict):
        """Apply one interaction event → (frame array, dirty flag). The
        frame is returned un-encoded so PNG compression happens outside
        the state lock."""
        with self.lock:
            kind = ev.get("kind")
            if kind == "rotate":
                self.preset = None
                self.state = orbit.rotate(self.state, ev["dx"], ev["dy"])
            elif kind == "pan":
                self.preset = None
                self.state = orbit.translate(self.state, ev["dx"], ev["dy"])
            elif kind == "zoom":
                self.preset = None
                self.state = orbit.zoom(self.state, ev["d"])
            elif kind == "roll":
                self.preset = None
                self.state = orbit.roll(self.state, ev["d"])
            elif kind == "sensitivity":
                self.state = orbit.set_sensitivity(self.state, ev["value"])
            elif kind == "release":
                self.state = orbit.release(self.state)
            elif kind == "resize":
                w = int(min(max(ev["width"], 16), MAX_DIM))
                h = int(min(max(ev["height"], 16), MAX_DIM))
                ts = self.config.tile_size
                self.width = max(ts, (w // ts) * ts)
                self.height = max(ts, (h // ts) * ts)
            elif kind == "preset" and self.presets:
                self.preset = self.presets[int(ev["index"]) % len(self.presets)][0]
            # 'tick' and 'init' fall through: advance inertia + render
            self.state = orbit.update(self.state)
            frame = self._frame()
            dirty = orbit.is_dirty(self.state)
        return frame, dirty

    def info(self) -> dict:
        return {
            "num_gaussians": self.cloud.num_gaussians,
            "sh_degree": self.cloud.sh_degree,
            "width": self.width,
            "height": self.height,
            "cameras": [name for (_, _, name) in self.presets],
        }


def serve(cloud: GaussianCloud, host="127.0.0.1", port=8090,
          width=1280, height=720, config: RenderConfig = RenderConfig(),
          cameras_json: Optional[str] = None, block: bool = True,
          scene_dir: Optional[str] = None, device="cuda"):
    """Start the viewer's HTTP server; with block=False return
    (httpd, app) for the caller to run and shut down."""
    app = ViewerApp(cloud, width, height, config, cameras_json, device)

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _send(self, code, body, ctype, headers=()):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            for k, v in headers:
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def _send_frame(self, frame, dirty):
            png = encode_png(frame)
            self._send(200, png, "image/png",
                       headers=(("X-Dirty", "1" if dirty else "0"),))

        def _body(self) -> bytes:
            n = int(self.headers.get("Content-Length", 0))
            return self.rfile.read(n)

        def do_GET(self):
            from urllib.parse import parse_qs, urlparse

            url = urlparse(self.path)
            if url.path == "/" or url.path.startswith("/index"):
                # `?model=<name>` scene selection (index.ts:89-95): load
                # <scene_dir>/<name>.ply before serving the page
                q = parse_qs(url.query)
                model = (q.get("model") or [None])[0]
                if model and scene_dir:
                    try:
                        app.load_scene_model(scene_dir, model)
                        app.handle_event({"kind": "init"})
                    except FileNotFoundError as e:
                        self._send(404, f"model not found: {e}".encode(),
                                   "text/plain")
                        return
                    except Exception as e:  # noqa: BLE001 — a corrupt or
                        # unparseable .ply must yield an error response,
                        # not a connection reset mid-handler (and must not
                        # leave the previous scene half-replaced — the app
                        # swaps its scene only after a successful parse)
                        self._send(
                            400,
                            f"failed to load model {model!r}: "
                            f"{type(e).__name__}: {e}".encode(),
                            "text/plain")
                        return
                self._send(200, _PAGE.encode(), "text/html")
            elif self.path.startswith("/info"):
                self._send(200, json.dumps(app.info()).encode(),
                           "application/json")
            elif self.path.startswith("/frame"):
                self._send_frame(*app.handle_event({"kind": "init"}))
            else:
                self._send(404, b"not found", "text/plain")

        def do_POST(self):
            try:
                if self.path.startswith("/event"):
                    ev = json.loads(self._body() or b"{}")
                    if not isinstance(ev, dict):
                        raise ValueError("event must be a JSON object")
                    self._send_frame(*app.handle_event(ev))
                elif self.path.startswith("/scene"):
                    info = app.load_scene(self._body())
                    self._send(200, json.dumps(info).encode(),
                               "application/json")
                elif self.path.startswith("/cameras"):
                    info = app.load_cameras(self._body().decode())
                    self._send(200, json.dumps(info).encode(),
                               "application/json")
                else:
                    self._send(404, b"not found", "text/plain")
            except Exception as e:
                self._send(400, f"bad request: {e}".encode(), "text/plain")

    httpd = ThreadingHTTPServer((host, port), Handler)
    print(f"viewer at http://{host}:{httpd.server_address[1]}/")
    if block:
        httpd.serve_forever()
    return httpd, app
