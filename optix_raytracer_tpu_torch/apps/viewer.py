"""The interactive progressive renderer (counterpart of `apps/viewer.py`,
the reference's `SDK/imgui_test/` playground): a movable depth-of-field
camera (WASDQE moves, arrow orbit, mouse orbit / pan / zoom through
`core/camera.Trackball`), settings (samples per frame 2^n, FOV, aperture),
a launch per frame and save on space (`tracer_window.cpp:64-183`,
`camera.h:17-172`, `main.cpp:41-303`).

    python -m optix_raytracer_tpu_torch.apps.viewer --frames 8 --file v.ppm
    python -m optix_raytracer_tpu_torch.apps.viewer --model model.glb \
        --frames 4 --file v.ppm
    python -m optix_raytracer_tpu_torch.apps.viewer --checkpoint v.npz ...
    python -m optix_raytracer_tpu_torch.apps.viewer --resume v.npz ...

Headless by default: N progressive frames, then the image and the stage
times (`api/context.StageTimers`, the displayStats overlay). The Cornell box
is path-traced by `render_accumulate` (the fused kernel 3 on a CUDA
device), and so is `--scene spd-tetra`, the SPD `tetra` pyramid (the
cluster path, kernels 4-6), the Whitted scene and a `--model` (`Scene.load`) by the Whitted
integrator (kernels 1-2, or 4-6 past 512 triangles). `--checkpoint` /
`--resume` write and read the film and camera as one .npz
(`core/checkpoint.py`). The live loops are host code: `--ansi` draws
truecolor half-blocks in the terminal, `--serve PORT` serves a browser view
over HTTP (PNG frames through PIL) and `--interactive` opens a matplotlib
window; matplotlib and PIL are imported only there.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..api.context import StageTimers
from ..core import checkpoint as ckpt
from ..core import film as film_mod
from ..core.camera import Camera, Trackball
from ..io.image import save_image
from ..scene.builtins import (cornell_box, cornell_camera, spd_tetra_camera,
                              spd_tetra_scene, whitted_camera, whitted_scene)
from ..wavefront.engine import render_accumulate
from ..wavefront.whitted import render_whitted_sample
from ._cli import parse_dim


class TracerViewer:
    """The TracerWindow role: owns scene, camera, film and the frame loop,
    on the scene's device."""

    def __init__(self, scene, camera: Camera, width: int, height: int,
                 integrator: str = "pathtrace", spf_log2: int = 2,
                 max_depth: int = 4):
        self.scene = scene
        self.device = scene.device
        self.camera = camera
        self.width = width
        self.height = height
        self.integrator = integrator
        self.spf_log2 = spf_log2          # samples per frame = 2^n
        self.max_depth = max_depth
        self.film = film_mod.Film.create(height, width, self.device)
        self.trackball = Trackball(camera, move_speed=50.0)
        self.timers = StageTimers()
        self.dirty = False                # camera/settings changed → reset

    @property
    def spf(self):
        return 1 << self.spf_log2

    def stats_line(self) -> str:
        """The displayStats/displayFPS overlay text
        (`sutil/sutil.h:117-121`): accumulated spp, settings, live FPS +
        per-stage frame times. Shared by all three display paths."""
        return (f"{int(self.film.subframe)} spp | spf {self.spf} | "
                f"fov {self.camera.fov_y:.0f} | {self.timers.overlay()}")

    def reset(self):
        self.film = self.film.reset()

    def step(self):
        """One frame: (maybe) reset, render spf samples, return uint8 RGBA."""
        with self.timers.stage("state_update"):
            if self.dirty:
                self.reset()
                self.dirty = False
            cam = self.camera.params(self.device)
        with self.timers.stage("render"):
            if self.integrator == "whitted":
                radiance, _ = render_whitted_sample(
                    self.scene, cam, self.width, self.height,
                    self.film.subframe, max_depth=self.max_depth)
                self.film = self.film.accumulate(radiance)
            else:
                self.film, _ = render_accumulate(
                    self.scene, cam, self.film, self.width, self.height,
                    samples_per_launch=self.spf, max_depth=self.max_depth)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        with self.timers.stage("display"):
            img = film_mod.make_color(self.film.accum).cpu().numpy()
        self.timers.frame_done()
        return img

    # --- input handling (tracer_window.cpp update_camera / imgui panel) ---
    def key(self, k: str):
        if k in "wasdqe":
            self.trackball.move(k, dt=0.1)
            self.dirty = True
        elif k in ("up", "down", "left", "right"):
            dx = {"left": 40, "right": -40}.get(k, 0)
            dy = {"up": 25, "down": -25}.get(k, 0)
            self.trackball.orbit(dx, dy)
            self.dirty = True
        elif k == "+":
            self.spf_log2 = min(self.spf_log2 + 1, 8)
        elif k == "-":
            self.spf_log2 = max(self.spf_log2 - 1, 0)
        elif k == "[":
            self.camera.fov_y = max(self.camera.fov_y - 5, 5)
            self.dirty = True
        elif k == "]":
            self.camera.fov_y = min(self.camera.fov_y + 5, 120)
            self.dirty = True
        elif k == "9":
            self.camera.aperture = max(self.camera.aperture - 2.0, 0.0)
            self.dirty = True
        elif k == "0":
            self.camera.aperture += 2.0
            self.dirty = True
        elif k == "r":
            self.dirty = True

    def mouse(self, kind: str, dx: float = 0.0, dy: float = 0.0):
        """Mouse routes (the Trackball mouse bindings, `Trackball.h:54-66` /
        `tracer_window.cpp` GLFW cursor callbacks): left-drag orbits,
        right-drag pans, wheel zooms toward the lookat."""
        if kind == "drag_left":
            self.trackball.orbit(dx, dy)
        elif kind == "drag_right":
            self.trackball.pan(dx * 0.01, dy * 0.01)
        elif kind == "scroll":
            self.trackball.zoom(1 if dy > 0 else -1)
        else:
            return
        self.dirty = True


def model_lights():
    """The lights of a --model scene (apps/viewer.py:150-152): a fixed
    directional 0.9 and an ambient 0.25."""
    from ..shade.lights import AMBIENT, DIRECTIONAL
    return [{"kind": DIRECTIONAL, "direction": (-0.4, -0.7, -0.6),
             "color": (0.9, 0.9, 0.9)},
            {"kind": AMBIENT, "color": (0.25, 0.25, 0.25)}]


def build(model, scene_name, width, height, device):
    """→ (DeviceScene, Camera, integrator): the model through the Whitted
    integrator, or the Whitted scene, or the path-traced Cornell box or
    SPD `tetra` pyramid (`spd-tetra`: the cluster path)."""
    if model:
        from ..scene.scene import Scene
        host = Scene.load(model)
        cam = host.default_camera(width, height)
        return host.finalize(device, lights=model_lights()), cam, "whitted"
    if scene_name == "whitted":
        return (whitted_scene(device), whitted_camera(width, height),
                "whitted")
    if scene_name == "spd-tetra":
        return (spd_tetra_scene(device), spd_tetra_camera(width, height),
                "pathtrace")
    return cornell_box(device), cornell_camera(width, height), "pathtrace"


def run_headless(viewer: TracerViewer, frames: int, out: str):
    img = None
    for f in range(frames):
        img = viewer.step()
        print(f"frame {f + 1}/{frames}  spp={int(viewer.film.subframe)}  "
              f"| {viewer.timers.report()}")
    if out:
        save_image(out, img)
        print(f"wrote {out}")
    return img


def interactive_on_key(viewer: TracerViewer, im, out: str, fig):
    """Key handler for the matplotlib window (tracer_window.cpp:129-183
    imgui panel + update_camera): q quits, space saves the current blit,
    everything else routes to TracerViewer.key. Split out of
    run_interactive so tests can drive it with synthetic KeyEvents."""
    import matplotlib.pyplot as plt

    def on_key(event):
        k = event.key
        if k == "q":
            plt.close(fig)
            return
        if k == " ":
            save_image(out or "render.png", np.asarray(im.get_array()))
            print(f"saved ({int(viewer.film.subframe)} spp)")
            return
        viewer.key(k or "")

    return on_key


def interactive_on_mouse(viewer: TracerViewer):
    """Mouse handlers for the matplotlib window (the GLFW cursor/scroll
    callbacks of `tracer_window.cpp` routed through the Trackball):
    left-drag orbit, right-drag pan, wheel zoom. Returns
    (on_press, on_move, on_scroll); split out so tests can drive them
    with synthetic MouseEvents."""
    last = {"xy": None, "button": None}

    def on_press(event):
        last["xy"] = (event.x, event.y)
        last["button"] = getattr(event.button, "value", event.button)

    def on_move(event):
        if last["xy"] is None or event.button is None:
            return
        x0, y0 = last["xy"]
        if event.x is None or event.y is None:
            return
        dx, dy = event.x - x0, event.y - y0
        last["xy"] = (event.x, event.y)
        kind = "drag_right" if last["button"] == 3 else "drag_left"
        viewer.mouse(kind, dx, dy)

    def on_scroll(event):
        viewer.mouse("scroll", dy=1.0 if event.step > 0 else -1.0)

    return on_press, on_move, on_scroll


def run_interactive(viewer: TracerViewer, out: str, max_frames: int = 0):
    import matplotlib.pyplot as plt
    fig, ax = plt.subplots(figsize=(8, 8))
    if fig.canvas.manager is not None:
        fig.canvas.manager.set_window_title("optix_raytracer_tpu_torch "
                                            "viewer")
    im = ax.imshow(viewer.step())
    ax.axis("off")
    fig.canvas.mpl_connect("key_press_event",
                           interactive_on_key(viewer, im, out, fig))
    on_press, on_move, on_scroll = interactive_on_mouse(viewer)
    fig.canvas.mpl_connect("button_press_event", on_press)
    fig.canvas.mpl_connect("motion_notify_event", on_move)
    fig.canvas.mpl_connect("scroll_event", on_scroll)
    frames = 0
    while plt.fignum_exists(fig.number):
        im.set_data(viewer.step())
        ax.set_title(viewer.stats_line(), fontsize=9)
        frames += 1
        if max_frames and frames >= max_frames:
            break
        plt.pause(0.01)


def ansi_frame(img: np.ndarray, cols: int = 80) -> str:
    """uint8 RGB(A) [H, W, C] → ANSI truecolor half-block string.

    Each character cell shows two vertical pixels (▀ with foreground =
    upper row, background = lower row) — the terminal analogue of the
    GLDisplay fullscreen-quad blit (`sutil/GLDisplay.cpp:93-122`),
    working over any SSH session with a 24-bit-color terminal."""
    h, w = img.shape[:2]
    cols = max(2, min(cols, w))
    rows = max(2, int(round(cols * h / w / 2)) * 2)
    ys = (np.arange(rows) * (h / rows)).astype(np.int64)
    xs = (np.arange(cols) * (w / cols)).astype(np.int64)
    small = img[ys][:, xs, :3].astype(np.int64)
    top, bot = small[0::2], small[1::2]
    lines = []
    for r in range(top.shape[0]):
        parts = []
        for c in range(cols):
            tr, tg, tb = top[r, c]
            br, bg, bb = bot[r, c]
            parts.append(f"\x1b[38;2;{tr};{tg};{tb}m"
                         f"\x1b[48;2;{br};{bg};{bb}m▀")
        lines.append("".join(parts) + "\x1b[0m")
    return "\n".join(lines)


def run_ansi(viewer: TracerViewer, out: str, max_frames: int = 0,
             cols: int = 80, read_keys=None, write=None):
    """Live ANSI-terminal render loop: blit each progressive frame as
    truecolor half-blocks, polling single-key input (WASDQE move, arrows
    orbit via h/j/k/l, +/- spf, space save, q quit). `read_keys`/`write`
    are injectable for tests; the defaults use raw stdin + stdout."""
    import sys

    restore = None
    if read_keys is None:
        import select
        import termios
        import tty
        fd = sys.stdin.fileno()
        old = termios.tcgetattr(fd)
        tty.setcbreak(fd)
        restore = lambda: termios.tcsetattr(fd, termios.TCSADRAIN, old)

        def read_keys():
            keys = []
            while select.select([sys.stdin], [], [], 0)[0]:
                keys.append(sys.stdin.read(1))
            return keys

    if write is None:
        write = sys.stdout.write
    arrows = {"h": "left", "l": "right", "k": "up", "j": "down"}
    frames = 0
    try:
        write("\x1b[2J")                      # clear once
        while max_frames == 0 or frames < max_frames:
            quit_ = False
            for k in read_keys():
                if k == "q":
                    quit_ = True
                elif k == " ":
                    save_image(out or "render.png", viewer.step())
                    continue
                else:
                    viewer.key(arrows.get(k, k))
            if quit_:
                break
            img = viewer.step()
            write("\x1b[H" + ansi_frame(img, cols)
                  + f"\n\x1b[0K{viewer.stats_line()}\n"
                    "\x1b[0KWASDQE move | hjkl orbit | +/- spf | "
                    "space save | q quit\n")
            frames += 1
    except KeyboardInterrupt:
        pass
    finally:
        if restore is not None:
            restore()
    return frames


_SERVE_PAGE = """<!doctype html><html><head><title>optix_raytracer_tpu_torch</title>
<style>body{background:#111;color:#ccc;font-family:monospace;text-align:center}
img{image-rendering:pixelated;margin-top:12px}</style></head><body>
<div id=s>connecting…</div><img id=v>
<div>drag orbit · right-drag pan · wheel zoom · WASDQE move ·
arrows orbit · +/- spf · [ ] fov · 9/0 aperture · r reset</div>
<script>
const v=document.getElementById('v'),s=document.getElementById('s');
async function tick(){
  try{
    const r=await fetch('/frame.png?'+Date.now());
    s.textContent=r.headers.get('x-status')||'';
    const b=await r.blob();
    const u=URL.createObjectURL(b); v.onload=()=>URL.revokeObjectURL(u);
    v.src=u;
  }catch(e){s.textContent='disconnected';}
  setTimeout(tick,100);
}
const KEYS={'ArrowUp':'up','ArrowDown':'down','ArrowLeft':'left',
            'ArrowRight':'right','=':'+'};
document.addEventListener('keydown',e=>{
  const k=KEYS[e.key]||e.key.toLowerCase();
  fetch('/key?k='+encodeURIComponent(k),{method:'POST'});
});
let drag=null;
v.addEventListener('pointerdown',e=>{drag=[e.clientX,e.clientY,e.button];
  v.setPointerCapture(e.pointerId);e.preventDefault();});
v.addEventListener('pointerup',()=>{drag=null;});
v.addEventListener('pointermove',e=>{
  if(!drag)return;
  const kind=drag[2]===2?'drag_right':'drag_left';
  const dx=e.clientX-drag[0],dy=e.clientY-drag[1];
  drag=[e.clientX,e.clientY,drag[2]];
  if(dx||dy)fetch(`/mouse?k=${kind}&dx=${dx}&dy=${dy}`,{method:'POST'});
});
v.addEventListener('wheel',e=>{e.preventDefault();
  fetch('/mouse?k=scroll&dx=0&dy='+(e.deltaY<0?1:-1),{method:'POST'});});
v.addEventListener('contextmenu',e=>e.preventDefault());
tick();
</script></body></html>"""


class ViewerServer:
    """HTTP live view: the GLDisplay-blit role (`sutil/GLDisplay.cpp:93-122`)
    re-expressed for headless hosts — the render loop stays in the main
    thread next to the device; a browser anywhere on the network polls
    /frame.png and posts /key, so the 'window' needs no GL, no X, and no
    display on the host at all."""

    def __init__(self, viewer: TracerViewer, port: int = 0):
        import http.server
        import threading
        self.viewer = viewer
        self._png = b""
        self._status = ""
        self._lock = threading.Lock()
        self._keys = []
        self._mouse = []
        srv = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def _send(self, code, body, ctype, extra=()):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                for k, v in extra:
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path.startswith("/frame.png"):
                    with srv._lock:
                        png, status = srv._png, srv._status
                    self._send(200, png, "image/png",
                               [("X-Status", status),
                                ("Cache-Control", "no-store")])
                else:
                    self._send(200, _SERVE_PAGE.encode(), "text/html")

            def do_POST(self):
                if self.path.startswith("/key?k="):
                    from urllib.parse import unquote
                    with srv._lock:
                        srv._keys.append(unquote(self.path[7:]))
                    self._send(200, b"ok", "text/plain")
                elif self.path.startswith("/mouse?"):
                    from urllib.parse import parse_qs, urlsplit
                    q = parse_qs(urlsplit(self.path).query)
                    try:
                        ev = (q["k"][0], float(q.get("dx", ["0"])[0]),
                              float(q.get("dy", ["0"])[0]))
                    except (KeyError, ValueError):
                        self._send(400, b"bad mouse event", "text/plain")
                        return
                    with srv._lock:
                        srv._mouse.append(ev)
                    self._send(200, b"ok", "text/plain")
                else:
                    self._send(404, b"", "text/plain")

        self.httpd = http.server.ThreadingHTTPServer(("0.0.0.0", port),
                                                     Handler)
        self.port = self.httpd.server_address[1]
        self._thread = threading.Thread(target=self.httpd.serve_forever,
                                        daemon=True)
        self._thread.start()

    def publish(self, rgba: np.ndarray, status: str = ""):
        import io
        from PIL import Image
        buf = io.BytesIO()
        Image.fromarray(rgba[..., :3]).save(buf, format="PNG")
        with self._lock:
            self._png = buf.getvalue()
            self._status = status

    def pending_keys(self):
        with self._lock:
            keys, self._keys = self._keys, []
        return keys

    def pending_mouse(self):
        with self._lock:
            evs, self._mouse = self._mouse, []
        return evs

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()


def run_server(viewer: TracerViewer, port: int, out: str,
               max_frames: int = 0):
    """Serve the progressive render over HTTP until interrupted (or for
    max_frames frames — test hook)."""
    server = ViewerServer(viewer, port)
    print(f"live view: http://localhost:{server.port}/  (ctrl-c to stop)")
    frames = 0
    try:
        while max_frames == 0 or frames < max_frames:
            for k in server.pending_keys():
                if k == " " or k == "space":
                    save_image(out or "render.png", viewer.step())
                    print(f"saved ({int(viewer.film.subframe)} spp)")
                else:
                    viewer.key(k)
            for kind, dx, dy in server.pending_mouse():
                viewer.mouse(kind, dx, dy)
            img = viewer.step()
            server.publish(img, viewer.stats_line())
            frames += 1
    except KeyboardInterrupt:
        pass
    finally:
        server.close()
    return frames


def main(argv=None):
    p = argparse.ArgumentParser(description="interactive viewer (imgui_test)")
    p.add_argument("--model", "-m", default=None,
                   help=".gltf/.glb/.obj/.ply model")
    p.add_argument("--scene", default="cornell",
                   choices=["cornell", "whitted", "spd-tetra"])
    p.add_argument("--file", "-o", default="viewer.png")
    p.add_argument("--dim", default="768x768")
    p.add_argument("--frames", type=int, default=8,
                   help="frames to render in headless mode")
    p.add_argument("--spf", type=int, default=2, help="log2 samples/frame")
    p.add_argument("--depth", type=int, default=4)
    p.add_argument("--interactive", "-w", action="store_true",
                   help="open a live window (needs a display)")
    p.add_argument("--serve", type=int, nargs="?", const=8000, default=None,
                   metavar="PORT",
                   help="serve a live browser view over HTTP (headless "
                        "hosts; default port 8000)")
    p.add_argument("--ansi", type=int, nargs="?", const=100, default=None,
                   metavar="COLS",
                   help="live truecolor render in this terminal (any SSH "
                        "session; default 100 columns)")
    p.add_argument("--checkpoint", default=None,
                   help="write render state here on exit")
    p.add_argument("--resume", default=None, help="resume from a checkpoint")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    w, h = parse_dim(args.dim)
    device = torch.device(args.device)

    scene, camera, integrator = build(args.model, args.scene, w, h, device)
    viewer = TracerViewer(scene, camera, w, h, integrator=integrator,
                          spf_log2=args.spf, max_depth=args.depth)
    if args.resume:
        film, cam2, _cfg = ckpt.load_checkpoint(args.resume, device)
        viewer.film = film
        if cam2 is not None:
            viewer.camera = cam2
            viewer.trackball = Trackball(cam2, move_speed=50.0)
        print(f"resumed at {int(film.subframe)} spp")

    img = None
    if args.interactive:
        run_interactive(viewer, args.file)
    elif args.serve is not None:
        run_server(viewer, args.serve, args.file)
    elif args.ansi is not None:
        run_ansi(viewer, args.file, cols=args.ansi)
    else:
        img = run_headless(viewer, args.frames, args.file)

    if args.checkpoint:
        ckpt.save_checkpoint(args.checkpoint, viewer.film, viewer.camera,
                             {"integrator": integrator})
        print(f"checkpoint → {args.checkpoint}")
    return viewer, img


if __name__ == "__main__":
    main()
