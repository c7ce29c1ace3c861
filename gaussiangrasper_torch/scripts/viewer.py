"""Browser viewer for a trained run, and the trainer's live viewer
(counterpart of the JAX package's scripts/viewer.py; stdlib HTTP server).

A small HTTP server serves a page with mouse orbit / pan / zoom that POSTs
camera poses to /render and shows the JPEG frames it gets back, rendered
through the port's `models.model.render` (K1 on the card) and encoded by
`utils/image_io.write_jpeg` at quality 85. Endpoints, as in the JAX viewer:
  POST /render        {eye, center, up, mode, res, crop_min, crop_max}:
                      mode rgb / depth / normal / feature (the feature
                      map's top three principal components); res the
                      frame width (height by the run's aspect); the crop
                      box hides the Gaussians outside it (`crop_mask`)
  POST /render_path   {keyframes: [{eye, center, up}, ...], n_frames,
                      mode, res}: `core.camera_paths.interpolate_path`
                      through the keyframes, every frame written as
                      path_<i>.jpg under the frames directory; returns
                      {"n", "dir", "frames"}
  GET /frames/<name>  a rendered frame
  GET /export.ply, /export/pointcloud.ply   the alive Gaussians (the
                      export_ply writer), or their means and DC colours
  GET /scene          the training cameras and a subsampled seed cloud,
                      drawn over the frame by the page
When a trainer is live (`serve_in_background`, the trainer's
`viewer_port`), `RenderThrottle` keeps renders to 1 - train_util of the
wall clock. The server reads the state through `state_provider()` once a
frame: `train_step` and `refine_step` return new tensors and write none of
the old state's, so a state taken there stays whole while training goes
on. A render that fails is logged and retried with the current state, up
to three times; then the error goes back to the client.

    python -m gaussiangrasper_torch.scripts.viewer --run-dir RUN [--port 7007] [--device cpu]
"""

from __future__ import annotations

import argparse
import io
import json
import sys
import tempfile
import threading
import time
import traceback
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from typing import Optional

import numpy as np
import torch

PAGE = """<!DOCTYPE html>
<html><head><title>gaussiangrasper_torch viewer</title><style>
body{margin:0;background:#111;color:#eee;font-family:sans-serif;overflow:hidden}
#hud{position:fixed;top:8px;left:8px;background:#0008;padding:8px;border-radius:6px;font-size:13px}
img{width:100vw;height:100vh;object-fit:contain;display:block}
select,input{background:#222;color:#eee;border:1px solid #555;width:4.5em}
select{width:auto}
</style></head><body>
<div id="hud">mode <select id="mode">
<option>rgb</option><option>depth</option><option>normal</option><option>feature</option>
</select>
res <select id="res"><option>160</option><option selected>320</option><option>640</option></select>
<span id="fps"></span><br>
crop min <input id="cx0" value="-99"><input id="cy0" value="-99"><input id="cz0" value="-99"><br>
crop max <input id="cx1" value="99"><input id="cy1" value="99"><input id="cz1" value="99"><br>
<button id="addkf">+ keyframe</button> <button id="clearkf">clear</button>
<span id="nkf">0 kf</span>
frames <input id="nframes" value="30">
<button id="renderpath">render path</button> <span id="job"></span><br>
<a href="/export.ply" download style="color:#8cf">export .ply</a> &middot;
<a href="/export/pointcloud.ply" download style="color:#8cf">point cloud</a><br>
<label><input type="checkbox" id="showrig" checked style="width:auto"> camera rig / seed cloud</label><br>
drag: orbit &middot; shift-drag: pan &middot; wheel: zoom</div>
<img id="view">
<canvas id="rig" style="position:fixed;left:0;top:0;pointer-events:none"></canvas>
<script>
let az=0, el=0.5, dist=3.0, cx=0, cy=0, cz=0, busy=false, t0=0;
const img=document.getElementById('view'), fps=document.getElementById('fps');
const v=id=>parseFloat(document.getElementById(id).value);
function pose(){
  const ce=Math.cos(el), se=Math.sin(el), ca=Math.cos(az), sa=Math.sin(az);
  const eye=[cx+dist*ce*sa, cy+dist*ce*ca, cz+dist*se];
  return {eye:eye, center:[cx,cy,cz], up:[0,0,1]};
}
async function refresh(){
  if(busy) return; busy=true; t0=performance.now();
  const r=await fetch('/render',{method:'POST',body:JSON.stringify(
      {...pose(), mode:document.getElementById('mode').value,
       res:parseInt(document.getElementById('res').value),
       crop_min:[v('cx0'),v('cy0'),v('cz0')],
       crop_max:[v('cx1'),v('cy1'),v('cz1')]})});
  const b=await r.blob();
  img.src=URL.createObjectURL(b);
  fps.textContent=(1000/(performance.now()-t0)).toFixed(1)+' fps';
  busy=false;
}
let drag=null;
window.addEventListener('mousedown',e=>drag=[e.clientX,e.clientY,e.shiftKey]);
window.addEventListener('mouseup',()=>drag=null);
window.addEventListener('mousemove',e=>{
  if(!drag) return;
  const dx=e.clientX-drag[0], dy=e.clientY-drag[1];
  if(drag[2]){cx-=dx*0.002*dist; cz+=dy*0.002*dist;}
  else {az+=dx*0.01; el=Math.min(1.5,Math.max(-1.5,el+dy*0.01));}
  drag=[e.clientX,e.clientY,drag[2]]; refresh();
});
window.addEventListener('wheel',e=>{dist*=Math.exp(e.deltaY*0.001); refresh();});
for (const id of ['mode','res','cx0','cy0','cz0','cx1','cy1','cz1'])
  document.getElementById(id).addEventListener('change',refresh);
// render panel: keyframe the current viewpoint, render the spline offline
let kfs=[];
document.getElementById('addkf').onclick=()=>{
  kfs.push(pose());
  document.getElementById('nkf').textContent=kfs.length+' kf';};
document.getElementById('clearkf').onclick=()=>{
  kfs=[]; document.getElementById('nkf').textContent='0 kf';};
document.getElementById('renderpath').onclick=async()=>{
  if(kfs.length<2){document.getElementById('job').textContent='need 2+ kf';return;}
  document.getElementById('job').textContent='rendering...';
  const r=await fetch('/render_path',{method:'POST',body:JSON.stringify(
    {keyframes:kfs, n_frames:parseInt(document.getElementById('nframes').value),
     mode:document.getElementById('mode').value,
     res:parseInt(document.getElementById('res').value)})});
  const j=await r.json();
  document.getElementById('job').textContent=j.n+' frames -> '+j.dir;};
// init_scene overlay (ref viewer_beta/viewer.py:318-366): training-camera
// frustums + the seed point cloud, projected with the same pinhole math
// the server renders with (f = 0.7 * view width).
let scene=null;
fetch('/scene').then(r=>r.json()).then(j=>{scene=j; drawRig();}).catch(()=>{});
const rigc=document.getElementById('rig');
function drawRig(){
  const W=window.innerWidth, H=window.innerHeight;
  rigc.width=W; rigc.height=H;
  const ctx=rigc.getContext('2d');
  ctx.clearRect(0,0,W,H);
  if(!scene||!document.getElementById('showrig').checked) return;
  // object-fit:contain letterboxing: project into the DISPLAYED frame
  // rect, not the window (the server renders with f = 0.7 * renderW, so
  // the displayed focal is 0.7 * displayed width)
  const aw=img.naturalWidth||W, ah=img.naturalHeight||H;
  const s=Math.min(W/aw, H/ah), dw=aw*s, dh=ah*s;
  const ox=(W-dw)/2, oy=(H-dh)/2;
  const p=pose(), f=0.7*dw;
  const sub=(a,b)=>[a[0]-b[0],a[1]-b[1],a[2]-b[2]];
  const crs=(a,b)=>[a[1]*b[2]-a[2]*b[1],a[2]*b[0]-a[0]*b[2],a[0]*b[1]-a[1]*b[0]];
  const nrm=a=>{const n=Math.hypot(...a);return [a[0]/n,a[1]/n,a[2]/n];};
  const dot=(a,b)=>a[0]*b[0]+a[1]*b[1]+a[2]*b[2];
  const fwd=nrm(sub(p.center,p.eye)), right=nrm(crs(fwd,p.up)),
        tu=crs(right,fwd);
  function proj(q){
    const d=sub(q,p.eye), z=dot(d,fwd);
    if(z<0.05) return null;
    return [ox+dw/2+f*dot(d,right)/z, oy+dh/2-f*dot(d,tu)/z];
  }
  if(scene.points){
    for(let i=0;i<scene.points.length;i++){
      const s=proj(scene.points[i]);
      if(!s) continue;
      const c=scene.rgb?scene.rgb[i]:[200,200,200];
      ctx.fillStyle=`rgba(${c[0]},${c[1]},${c[2]},0.7)`;
      ctx.fillRect(s[0],s[1],2,2);
    }
  }
  ctx.strokeStyle='rgba(120,200,255,0.8)'; ctx.lineWidth=1;
  for(const cam of scene.cameras||[]){
    const m=cam.c2w, o=[m[0][3],m[1][3],m[2][3]], d=0.25;
    const ax=i=>[m[0][i],m[1][i],m[2][i]];
    const r=ax(0), u=ax(1), b=ax(2);  // OpenGL: -z forward
    const hw=d*cam.w/(2*cam.fx), hh=d*cam.h/(2*cam.fx);
    // corners = o + sx*hw*right + sy*hh*up - d*back
    const cs=[[1,1],[1,-1],[-1,-1],[-1,1]].map(([sx,sy])=>[
      o[0]+sx*hw*r[0]+sy*hh*u[0]-d*b[0],
      o[1]+sx*hw*r[1]+sy*hh*u[1]-d*b[1],
      o[2]+sx*hw*r[2]+sy*hh*u[2]-d*b[2]]);
    const so=proj(o), sc=cs.map(proj);
    if(!so||sc.some(s=>!s)) continue;
    ctx.beginPath();
    for(let i=0;i<4;i++){
      ctx.moveTo(so[0],so[1]); ctx.lineTo(sc[i][0],sc[i][1]);
      ctx.moveTo(sc[i][0],sc[i][1]);
      ctx.lineTo(sc[(i+1)%4][0],sc[(i+1)%4][1]);
    }
    ctx.stroke();
  }
}
document.getElementById('showrig').addEventListener('change',drawRig);
window.addEventListener('mousemove',()=>{if(drag) drawRig();});
window.addEventListener('wheel',drawRig);
refresh(); setInterval(()=>{if(!busy) refresh();}, 2000);
</script></body></html>"""


def look_at(eye, center, up) -> np.ndarray:
    """OpenGL camera-to-world (3, 4) from eye / center / up."""
    eye, center, up = (np.asarray(v, np.float32) for v in (eye, center, up))
    z = eye - center
    z = z / (np.linalg.norm(z) + 1e-9)  # the camera looks down -z
    x = np.cross(up, z)
    x = x / (np.linalg.norm(x) + 1e-9)
    y = np.cross(z, x)
    return np.stack([x, y, z, eye], axis=1).astype(np.float32)


class RenderThrottle:
    """Train-vs-render time sharing: `train_util` is the share of wall time
    training keeps. After a render of d seconds the next is admitted no
    sooner than d * train_util / (1 - train_util) later, so renders take
    at most 1 - train_util of the wall clock. Inactive unless a trainer is
    live (`training`). `renders` / `render_s` count the renders and their
    seconds."""

    def __init__(self, train_util: float = 0.85):
        self.train_util = float(train_util)
        self.training = False
        self._next_allowed = 0.0
        self._lock = threading.Lock()
        self.render_s = 0.0
        self.renders = 0

    def delay_for(self, render_duration: float) -> float:
        u = min(max(self.train_util, 0.0), 0.99)
        return render_duration * u / (1.0 - u)

    def admit(self, now: Optional[float] = None) -> None:
        """Block until a render may start."""
        if not self.training:
            return
        now = time.monotonic() if now is None else now
        wait = self._next_allowed - now
        if wait > 0:
            time.sleep(wait)

    def note(self, render_duration: float, now: Optional[float] = None) -> None:
        """Record a finished render; schedules the next admission."""
        now = time.monotonic() if now is None else now
        with self._lock:
            self._next_allowed = now + self.delay_for(render_duration)
            self.render_s += render_duration
            self.renders += 1


def scene_info_from_dm(dm, max_points: int = 4000) -> dict:
    """The /scene payload: the training cameras (c2w and intrinsics a view)
    and up to `max_points` seed points with their colours."""
    cams = []
    for i in range(len(dm)):
        cam = dm.camera(i)
        c2w = torch.as_tensor(cam.camera_to_world).detach().cpu().numpy()
        cams.append({"c2w": np.round(c2w.astype(np.float64), 5).tolist(),
                     "fx": float(cam.fx), "w": int(cam.width), "h": int(cam.height)})
    info = {"cameras": cams}
    seeds = getattr(dm, "seed_points", None)
    if seeds is not None:
        xyz, rgb = seeds
        xyz = np.asarray(xyz)
        take = np.linspace(0, len(xyz) - 1, min(len(xyz), max_points)).astype(int)
        rgb = np.asarray(rgb)[take]
        if rgb.dtype != np.uint8:
            rgb = (np.clip(rgb, 0, 1) * 255).astype(np.uint8)
        info["points"] = np.round(xyz[take], 4).tolist()
        info["rgb"] = rgb.tolist()
    return info


def frame_rgb(outs: dict, mode: str) -> np.ndarray:
    """(H, W, 3) float in [0, 1] on the host for a view mode."""
    from gaussiangrasper_torch.models.model import feature_pca_vis

    if mode == "depth":
        d = outs["depth"][..., 0]
        d = (d - d.min()) / (d.max() - d.min() + 1e-8)
        rgb = torch.stack([d] * 3, -1)
    elif mode == "normal":
        rgb = outs["normal_vis"]
    elif mode == "feature":
        rgb = feature_pca_vis(outs["feature"])
    else:
        rgb = torch.clamp(outs["rgb"], 0, 1)
    return rgb.cpu().numpy()


def make_server(state_provider, model_cfg, port: int, width: int, height: int,
                throttle: Optional[RenderThrottle] = None, out_dir: Optional[Path] = None,
                scene_info: Optional[dict] = None):
    """The HTTP viewer over a live state source: `state_provider()` gives
    the TrainState (or any state with field / alive / step) to render, on
    its own device. The server exposes `.throttle` (the trainer sets
    `.training`) and `.render_pose` (one frame's JPEG bytes)."""
    from gaussiangrasper_torch.core.camera_paths import interpolate_path
    from gaussiangrasper_torch.core.cameras import Camera
    from gaussiangrasper_torch.data.dataparsers.base import ParsedCamera
    from gaussiangrasper_torch.models.model import render as render_fn
    from gaussiangrasper_torch.scripts.export_ply import write_gaussian_ply
    from gaussiangrasper_torch.scripts.export_pointcloud import write_ply_points
    from gaussiangrasper_torch.utils.image_io import write_jpeg

    throttle = throttle or RenderThrottle()
    lock = threading.Lock()

    def render_once(state, cam_args, crop_min, crop_max, mode) -> np.ndarray:
        dev = state.field.means.device
        cam = Camera.create(*cam_args, device=dev)
        cmin = torch.tensor(crop_min if crop_min is not None else [-1e9] * 3, dtype=torch.float32,
                            device=dev)
        cmax = torch.tensor(crop_max if crop_max is not None else [1e9] * 3, dtype=torch.float32,
                            device=dev)
        with lock, torch.no_grad():
            means = state.field.means
            inside = torch.all((means >= cmin) & (means <= cmax), -1)
            outs = render_fn(state.field, state.alive, cam, state.step, model_cfg,
                             crop_mask=inside)
            return frame_rgb(outs, mode)  # the copy to the host waits for the render

    def render_pose(eye, center, up, mode="rgb", res=None, crop_min=None, crop_max=None,
                    c2w=None) -> bytes:
        w = int(res) if res else width
        h = int(round(w * height / width))
        f = 0.7 * w
        pose = c2w if c2w is not None else look_at(eye, center, up)
        throttle.admit()
        t0 = time.monotonic()
        for attempt in range(3):  # each attempt takes the state afresh
            try:
                rgb = render_once(state_provider(), (f, f, w / 2, h / 2, pose, w, h),
                                  crop_min, crop_max, mode)
                break
            except RuntimeError:
                print(f"viewer: render attempt {attempt + 1} of 3 failed:\n"
                      f"{traceback.format_exc()}", file=sys.stderr, flush=True)
                if attempt == 2:
                    raise
        throttle.note(time.monotonic() - t0)
        buf = io.BytesIO()
        write_jpeg(buf, (np.clip(rgb, 0, 1) * 255).astype(np.uint8), quality=85)
        return buf.getvalue()

    frames_dir = Path(out_dir) if out_dir else Path("renders")

    def render_path_job(keyframes, n_frames, mode, res) -> dict:
        """Keyframes -> slerp / lerp path -> one JPEG a frame."""
        w = int(res) if res else width
        h = int(round(w * height / width))
        f = 0.7 * w
        kf_cams = [ParsedCamera(fx=f, fy=f, cx=w / 2, cy=h / 2, width=w, height=h,
                                camera_to_world=look_at(k["eye"], k["center"], k["up"]))
                   for k in keyframes]
        per = max(int(n_frames) // max(len(kf_cams) - 1, 1), 1)
        path = interpolate_path(kf_cams, steps_per_transition=per)
        frames_dir.mkdir(parents=True, exist_ok=True)
        names = []
        for i, pc in enumerate(path):
            jpeg = render_pose(pc.camera_to_world[:, 3], None, None, mode, res=w,
                               c2w=pc.camera_to_world)
            name = f"path_{i:04d}.jpg"
            (frames_dir / name).write_bytes(jpeg)
            names.append(name)
        return {"n": len(names), "dir": str(frames_dir), "frames": names}

    def export_ply_bytes(pointcloud: bool = False) -> bytes:
        state = state_provider()
        keep = state.alive.cpu().numpy()
        with tempfile.TemporaryDirectory() as tmp:
            p = Path(tmp) / "export.ply"
            if pointcloud:
                xyz = state.field.means.detach().cpu().numpy()[keep]
                rgb = torch.sigmoid(state.field.sh_coeffs[:, 0]).detach().cpu().numpy()[keep]
                write_ply_points(p, xyz, (rgb * 255).astype(np.uint8))
            else:
                write_gaussian_ply(p, state.field, keep)
            return p.read_bytes()

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _send(self, body: bytes, ctype: str):
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/scene":
                self._send(json.dumps(scene_info or {}).encode(), "application/json")
            elif self.path == "/export.ply":
                self._send(export_ply_bytes(), "application/octet-stream")
            elif self.path == "/export/pointcloud.ply":
                self._send(export_ply_bytes(pointcloud=True), "application/octet-stream")
            elif self.path.startswith("/frames/"):
                fp = frames_dir / Path(self.path).name  # no traversal
                if fp.exists():
                    self._send(fp.read_bytes(), "image/jpeg")
                else:
                    self.send_response(404)
                    self.end_headers()
            else:
                self._send(PAGE.encode(), "text/html")

        def do_POST(self):
            n = int(self.headers.get("Content-Length", 0))
            req = json.loads(self.rfile.read(n))
            try:
                if self.path == "/render_path":
                    out = render_path_job(req["keyframes"], req.get("n_frames", 30),
                                          req.get("mode", "rgb"), req.get("res"))
                    self._send(json.dumps(out).encode(), "application/json")
                    return
                jpeg = render_pose(req["eye"], req["center"], req["up"], req.get("mode", "rgb"),
                                   req.get("res"), req.get("crop_min"), req.get("crop_max"))
            except RuntimeError as e:
                self.send_error(500, f"render failed: {e}")
                return
            self._send(jpeg, "image/jpeg")

    server = ThreadingHTTPServer(("0.0.0.0", port), Handler)
    server.throttle = throttle
    server.render_pose = render_pose
    return server


def serve_in_background(state_provider, model_cfg, port: int, width: int = 320,
                        height: int = 240, train_util: float = 0.85, scene_info=None,
                        out_dir: Optional[Path] = None):
    """Start the viewer on a daemon thread (the trainer's `viewer_port`).
    The returned server's `.throttle.training` is True, so renders share
    the wall clock with the train loop at `train_util`; `.shutdown()` stops
    it."""
    throttle = RenderThrottle(train_util)
    throttle.training = True
    server = make_server(state_provider, model_cfg, port, width, height, throttle,
                         out_dir=out_dir, scene_info=scene_info)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    print(f"live viewer on http://localhost:{server.server_address[1]}", flush=True)
    return server


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description="Browser viewer for a trained run")
    p.add_argument("--run-dir", type=Path, required=True)
    p.add_argument("--port", type=int, default=7007)
    p.add_argument("--width", type=int, default=640)
    p.add_argument("--height", type=int, default=480)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    from gaussiangrasper_torch._device import resolve_device
    from gaussiangrasper_torch.scripts.common import load_run

    config, trainer, state = load_run(args.run_dir, device=resolve_device(args.device))
    server = make_server(lambda: state, config.model, args.port, args.width, args.height,
                         out_dir=args.run_dir / "renders", scene_info=scene_info_from_dm(trainer.dm))
    print(f"viewer on http://localhost:{server.server_address[1]} "
          f"({int(state.alive.sum())} gaussians)", flush=True)
    server.serve_forever()


if __name__ == "__main__":
    main()
