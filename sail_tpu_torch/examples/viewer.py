"""Interactive progressive viewer (the counterpart of the repo's
`examples/viewer.py`) over the port's `Renderer`, `Control` and
`utils/imageio.png_bytes` (the native codec where it builds).

It serves a browser page with mouse orbit, wheel zoom, click picking and
object dragging (`Control`), the selected object's box drawn over the
frame, and a scene-script editor whose RUN executes the Python script and
rebuilds the renderer, while a render thread accumulates progressive
samples (motion restarts the accumulation).

    python -m sail_tpu_torch.examples.viewer --scene cornell_mirror --size 256
    # open http://localhost:8000
"""
import argparse
import json
import threading
import traceback
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import sail_tpu_torch as sail
from sail_tpu_torch import scenes
from sail_tpu_torch.render.control import Control
from sail_tpu_torch.render.renderer import Renderer
from sail_tpu_torch.utils.imageio import png_bytes

DEFAULT_SCRIPT = '''\
# Live scene script: build a `scene` (Python analog of the reference's
# editor script, ui/ui.js:9-42). RUN recompiles + restarts accumulation.
scene = sail.Scene()
scene.add(sail.Camera((0.0, 0.0, -2.95), (0.0, 0.0, 0.0)))
scene.add(sail.Cornellbox((-1.0, -1.0, -1.0), (1.0, 1.0, 1.0)))
scene.add(sail.Sphere((-0.45, -0.6, 0.2), 0.4, sail.Mirror()))
scene.add(sail.Sphere((0.45, -0.7, -0.3), 0.3, sail.Glass(eta=1.5)))
scene.add(sail.AreaLight(
    sail.Rectangle((-0.3, 0.98, -0.3), (0.3, 0.98, 0.3), sail.Matte()),
    (8.0, 8.0, 8.0)))
scene.filter = "gamma"
'''

PAGE = """<!doctype html><html><head><title>sail_tpu_torch viewer</title><style>
body{background:#111;color:#ddd;font-family:monospace;text-align:center}
#wrap{display:flex;justify-content:center;gap:16px;align-items:flex-start}
img{image-rendering:pixelated;width:512px;height:512px;cursor:grab}
textarea{width:480px;height:420px;background:#181818;color:#cde;
  border:1px solid #333;font-family:monospace;font-size:12px;padding:8px}
button{background:#2a6;border:0;color:#fff;padding:6px 24px;cursor:pointer}
#err{color:#f66;white-space:pre-wrap;text-align:left;width:480px}
</style></head><body>
<h3>sail_tpu_torch — progressive path tracer</h3>
<div id=wrap>
<div>
<img id=v src=/frame.png draggable=false>
<div id=s></div>
</div>
<div>
<textarea id=code spellcheck=false>%SCRIPT%</textarea><br>
<button onclick=run()>RUN</button>
<div id=err></div>
</div>
</div>
<script>
const img=document.getElementById('v'), stat=document.getElementById('s');
const scale=e=>{const r=img.getBoundingClientRect();
  return [(e.clientX-r.left)*%SIZE%/r.width,(e.clientY-r.top)*%SIZE%/r.height];};
let down=false;
img.onmousedown=e=>{down=true;const[x,y]=scale(e);
  fetch(`/mouse?type=down&x=${x}&y=${y}`);e.preventDefault()};
window.onmouseup=e=>{if(down){down=false;fetch('/mouse?type=up')}};
window.onmousemove=e=>{if(!down)return;const[x,y]=scale(e);
  fetch(`/mouse?type=move&x=${x}&y=${y}`);};
img.onwheel=e=>{fetch(`/zoom?d=${e.deltaY>0?-1:1}`);e.preventDefault()};
async function run(){
  const r=await fetch('/run',{method:'POST',
    body:document.getElementById('code').value});
  document.getElementById('err').textContent=await r.text();}
setInterval(async()=>{
  img.src='/frame.png?t='+Date.now();
  const j=await (await fetch('/status')).json();
  stat.textContent=`samples: ${j.samples}`+
    (j.selected==null?'':`  selected: object ${j.selected}`);
},500);
</script></body></html>"""


class ViewerState:
    def __init__(self, scene, size, device=None):
        self.size = size
        self.device = device
        self.lock = threading.Lock()
        self.dirty = False
        self.png = None
        self.pending_scene = None
        self.script = ""
        self._install(scene)

    def _install(self, scene):
        self.scene = scene
        self.renderer = Renderer(self.size, self.size, device=self.device)
        self.renderer.update(scene)
        self.control = Control(scene, self.size, self.size,
                               device=self.device)

    def run_script(self, src: str):
        """RUN: exec the script and adopt its `scene`."""
        ns = {"sail": sail, "Sail": sail, "scenes": scenes}
        exec(compile(src, "<scene-script>", "exec"), ns)
        scene = ns.get("scene")
        if scene is None or not isinstance(scene, sail.Scene):
            raise ValueError("script must build a sail.Scene named `scene`")
        scene.pack()  # validate before swapping it in
        with self.lock:
            self.pending_scene = scene

    def step(self):
        """One frame of the render loop: a pending scene or motion taken
        in, one sample added, and the PNG refreshed at the first samples
        and every fourth after."""
        with self.lock:
            if self.pending_scene is not None:
                self._install(self.pending_scene)
                self.pending_scene = None
            if self.dirty:
                self.scene.moving = True
                self.dirty = False
        self.renderer.render(self.scene)
        self.scene.moving = False
        if (self.renderer.sample_count % 4 == 1
                or self.renderer.sample_count < 4):
            self.png = png_bytes(self.renderer.output(self.scene))

    def render_loop(self):
        while True:
            self.step()


def make_handler(state: ViewerState):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def _send(self, code, ctype, body):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_POST(self):
            if urlparse(self.path).path != "/run":
                return self._send(404, "text/plain", b"not found")
            n = int(self.headers.get("Content-Length", 0))
            src = self.rfile.read(n).decode()
            try:
                state.run_script(src)
                self._send(200, "text/plain", b"ok")
            except Exception:
                self._send(200, "text/plain", traceback.format_exc().encode())

        def do_GET(self):
            url = urlparse(self.path)
            q = {k: v[0] for k, v in parse_qs(url.query).items()}
            if url.path == "/":
                page = (PAGE.replace("%SCRIPT%", state.script)
                        .replace("%SIZE%", str(state.size)))
                self._send(200, "text/html", page.encode())
            elif url.path == "/frame.png":
                body = state.png or b""
                self._send(200, "image/png", body)
            elif url.path == "/status":
                self._send(200, "application/json", json.dumps(
                    {"samples": state.renderer.sample_count,
                     "selected": state.scene.select}).encode())
            elif url.path == "/mouse":
                x = float(q.get("x", 0))
                y = float(q.get("y", 0))
                with state.lock:
                    kind = q.get("type")
                    if kind == "down":
                        state.control.mouse_down(x, y)
                    elif kind == "move":
                        state.control.mouse_move(x, y)
                        state.dirty = True
                    elif kind == "up":
                        state.control.mouse_up()
                        state.dirty = True
                self._send(200, "text/plain", b"ok")
            elif url.path == "/zoom":
                with state.lock:
                    state.control.zoom(float(q.get("d", 0)))
                    state.dirty = True
                self._send(200, "text/plain", b"ok")
            else:
                self._send(404, "text/plain", b"not found")
    return Handler


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scene", default=None,
                    help="named scene from sail_tpu_torch.scenes; default: "
                         "the editable DEFAULT_SCRIPT scene")
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--host", default="127.0.0.1",
                    help="bind address. POST /run execs the scene script "
                         "on the server, so binding beyond loopback is "
                         "remote code execution: an explicit opt-in.")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    if args.scene:
        scene = getattr(scenes, args.scene)()
        scene.filter = "gamma"
        script = (f"# showing prebuilt scene {args.scene!r}; edit + RUN "
                  f"to replace it\nscene = scenes.{args.scene}()\n"
                  f'scene.filter = "gamma"\n')
    else:
        ns = {"sail": sail, "Sail": sail, "scenes": scenes}
        exec(compile(DEFAULT_SCRIPT, "<default>", "exec"), ns)
        scene = ns["scene"]
        script = DEFAULT_SCRIPT

    state = ViewerState(scene, args.size, args.device)
    state.script = script
    threading.Thread(target=state.render_loop, daemon=True).start()
    server = ThreadingHTTPServer((args.host, args.port), make_handler(state))
    print(f"viewer on http://localhost:{args.port} "
          f"({args.scene or 'editor scene'}, {args.size}x{args.size})")
    server.serve_forever()


if __name__ == "__main__":
    main()
