"""Per-patch visual diagnostics — the offline replacement for the PCL
viewer's debug tooling.

The reference viewer lets you pick a patch and opens OpenCV windows with
the warped patch window in every visible view (Patch::showRefinedResult,
TMVS/mvs/patch.cpp:764-820) and a per-pixel SAD error heat-map
(Patch::showError, patch.cpp:822-910; note that path has a latent bilinear
weight mix-up the survey flags — this implementation uses the correct
weights). Here the same artifacts are SAVED as PNG mosaics, which works
headless and archives with the run.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import jax.numpy as jnp

from pais_mvs_tpu.config import MvsConfig
from pais_mvs_tpu.models.camera import Scene
from pais_mvs_tpu.ops import fitness as F
from pais_mvs_tpu.ops import geometry as geom


def warped_windows(scene: Scene, cfg: MvsConfig, center, normal_sph,
                   ref_cam: int, cam_mask, lod: int):
    """Raw warped (2r+1)^2 windows of ONE patch in every visible view.

    Returns (windows [C, W, W] f32 intensities with NaN outside bounds,
    valid [C] bool). Reference: Patch::getHomographyPatch sampling
    (patch.cpp:332-386) without the L2 normalization.
    """
    r = cfg.patch_radius
    W = 2 * r + 1
    center = jnp.asarray(center, jnp.float32)[None]
    normal = geom.spherical_to_normal(jnp.asarray(normal_sph,
                                                  jnp.float32))[None]
    ref = jnp.asarray([ref_cam], jnp.int32)
    lod_b = jnp.asarray([lod], jnp.int32)
    rig, pyrs = scene.rig, scene.pyramids
    C = rig.num_cameras
    lod_scale = jnp.power(jnp.float32(cfg.lod_ratio),
                          lod_b.astype(jnp.float32))
    H, hok = F._per_camera_homographies(scene, center, normal, ref,
                                        lod_scale)

    pt, _ = geom.project(center[0], rig.R[ref_cam], rig.T[ref_cam],
                         rig.focal[ref_cam], rig.principal[ref_cam],
                         lod_scale[0])
    offs = jnp.asarray(F.window_offsets(r))
    win = pt[None, :] + offs                                  # [W2, 2]
    uv, w = geom.homography_apply(H[0][:, None, :, :], win[None])  # [C,W2,2]
    cam_idx = jnp.broadcast_to(jnp.arange(C, dtype=jnp.int32)[:, None],
                               uv.shape[:2])
    lod_cb = jnp.full(uv.shape[:2], lod, dtype=jnp.int32)
    vals, vok = F.bilinear_gather(pyrs.images, pyrs.yoff, cam_idx, lod_cb, uv,
                                  pyrs.dims, 0.0, 1.0)
    vok = vok & (w != 0)
    # window_offsets is X-MAJOR (offs[i*W+j] = (ax[i], ax[j])), so the
    # raw reshape's first window axis is x; PNG rows are y — transpose so
    # the saved mosaics match the source photo orientation
    out = jnp.where(vok, vals, jnp.nan).reshape(C, W, W).transpose(0, 2, 1)
    valid = jnp.all(vok, axis=-1) & hok[0]
    mask = jnp.asarray(cam_mask, bool)
    return np.asarray(out), np.asarray(valid & mask)


def sad_heatmap(windows: np.ndarray, cam_mask) -> np.ndarray:
    """Per-pixel mean absolute deviation across visible views ([W, W],
    NaN where any view is invalid) — showError's error map
    (patch.cpp:822-910)."""
    m = np.asarray(cam_mask, bool)
    w = windows[m]
    mean = np.nanmean(w, axis=0)
    return np.nanmean(np.abs(w - mean[None]), axis=0)


def _to_u8(img: np.ndarray, lo=None, hi=None) -> np.ndarray:
    ok = np.isfinite(img)
    if not ok.any():
        return np.zeros(img.shape, np.uint8)
    lo = np.nanmin(img) if lo is None else lo
    hi = np.nanmax(img) if hi is None else hi
    scale = 255.0 / (hi - lo) if hi > lo else 1.0
    out = np.clip((img - lo) * scale, 0, 255)
    out[~ok] = 0
    return out.astype(np.uint8)


def save_patch_diagnostics(scene: Scene, cfg: MvsConfig, center, normal_sph,
                           ref_cam: int, cam_mask, lod: int, out_dir: str,
                           patch_id: int,
                           fitness: Optional[float] = None) -> str:
    """Write '<out_dir>/patch<id>_views.png' (warped window per view,
    reference view first) and '..._error.png' (SAD heat-map). Returns the
    views path."""
    try:
        from PIL import Image
    except ImportError:
        raise RuntimeError("--patch-id diagnostics write PNG files and need "
                           "Pillow, which is not installed") from None

    windows, valid = warped_windows(scene, cfg, center, normal_sph,
                                    ref_cam, cam_mask, lod)
    C, W, _ = windows.shape
    pad = 2
    # mosaic: ref view first, then the others, scaled 4x for visibility
    order = [ref_cam] + [c for c in range(C) if c != ref_cam]
    tile = np.zeros((W + 2 * pad, (W + 2 * pad) * C), np.uint8)
    for i, c in enumerate(order):
        img = _to_u8(windows[c], 0.0, 255.0)
        x0 = i * (W + 2 * pad) + pad
        tile[pad:pad + W, x0:x0 + W] = img
    scale = 4
    tile = np.kron(tile, np.ones((scale, scale), np.uint8))
    os.makedirs(out_dir, exist_ok=True)
    views_path = os.path.join(out_dir, f"patch{patch_id}_views.png")
    Image.fromarray(tile).save(views_path)

    err = sad_heatmap(windows, np.asarray(cam_mask) & valid)
    err_img = np.kron(_to_u8(err), np.ones((scale, scale), np.uint8))
    Image.fromarray(err_img).save(
        os.path.join(out_dir, f"patch{patch_id}_error.png"))

    info = [f"patch {patch_id}: refCam {ref_cam} LOD {lod}",
            f"  center {np.asarray(center)}",
            f"  visible {np.nonzero(np.asarray(cam_mask))[0].tolist()}"
            f" valid-warp {np.nonzero(valid)[0].tolist()}"]
    if fitness is not None:
        info.append(f"  fitness {fitness:.6f}")
    print("\n".join(info))
    return views_path


_HTML_TEMPLATE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>pais-mvs-tpu viewer</title>
<style>
 body {{ margin:0; background:#111; color:#ccc; font:13px monospace; }}
 #hud {{ position:fixed; top:8px; left:10px; user-select:none;
        white-space:pre; }}
 #pick {{ position:fixed; bottom:8px; left:10px; user-select:text;
         white-space:pre; color:#8f8; }}
 canvas {{ display:block; }}
</style></head><body>
<div id="hud">{n} patches, {ncam} cameras — drag: orbit, wheel: zoom
c: color mode   o: order replay   n: normals   v: cameras
click: nearest-patch readout</div>
<div id="pick"></div>
<canvas id="cv"></canvas>
<script>
const P = {points};   // [x,y,z, r,g,b, order, nx,ny,nz, id]
const CAMS = {cams};  // [cx,cy,cz, ox,oy,oz, "name"]
const cv = document.getElementById('cv');
const ctx = cv.getContext('2d');
let W, H; function rs() {{ W=cv.width=innerWidth; H=cv.height=innerHeight; }}
rs(); addEventListener('resize', () => {{ rs(); draw(); }});
let cx=0, cy=0, cz=0;
for (const p of P) {{ cx+=p[0]; cy+=p[1]; cz+=p[2]; }}
cx/=P.length; cy/=P.length; cz/=P.length;
let scale0=0;
for (const p of P) scale0=Math.max(scale0, Math.hypot(p[0]-cx,p[1]-cy,p[2]-cz));
scale0=Math.max(scale0, 1e-9);  // all-coincident centers: avoid NaN geometry
let yaw=0.5, pitch=-0.4, zoom=1.0, mode=0, frac=1.0, anim=null;
let showN=false, showC=true;
let proj=[];               // [sx, sy, depth, point] of the last draw
function xform(x, y, z, s) {{
  x-=cx; y-=cy; z-=cz;
  const cyw=Math.cos(yaw), syw=Math.sin(yaw);
  const cp=Math.cos(pitch), sp=Math.sin(pitch);
  let x1=cyw*x+syw*z, z1=-syw*x+cyw*z;
  let y2=cp*y+sp*z1, z2=-sp*y+cp*z1;
  return [x1*s+W/2, y2*s+H/2, z2];
}}
function draw() {{
  ctx.fillStyle='#111'; ctx.fillRect(0,0,W,H);
  const s = 0.45*Math.min(W,H)/scale0*zoom;
  const lim = Math.floor(P.length*frac);
  const pts = [];
  for (let i=0;i<lim;i++) {{
    const p=P[i];
    const q=xform(p[0],p[1],p[2],s);
    pts.push([q[0],q[1],q[2],p]);
  }}
  proj = pts;
  const sorted = pts.slice().sort((a,b)=>a[2]-b[2]);  // back-to-front
  const nlen = 0.03*scale0;
  for (const q of sorted) {{
    const p=q[3];
    if (showN && p[7]!==undefined) {{
      const e=xform(p[0]+p[7]*nlen, p[1]+p[8]*nlen, p[2]+p[9]*nlen, s);
      ctx.strokeStyle='rgba(120,220,120,0.6)';
      ctx.beginPath(); ctx.moveTo(q[0],q[1]); ctx.lineTo(e[0],e[1]);
      ctx.stroke();
    }}
    if (mode===0) ctx.fillStyle=`rgb(${{p[3]}},${{p[4]}},${{p[5]}})`;
    else {{ const t=p[6]; ctx.fillStyle=`hsl(${{240-240*t}},90%,55%)`; }}
    ctx.fillRect(q[0], q[1], 2, 2);
  }}
  if (showC) for (const cam of CAMS) {{
    // red camera glyph + yellow optical axis (mvsviewer.cpp:144-256)
    const q=xform(cam[0],cam[1],cam[2],s);
    const alen=0.18*scale0;
    const e=xform(cam[0]+cam[3]*alen, cam[1]+cam[4]*alen,
                  cam[2]+cam[5]*alen, s);
    ctx.strokeStyle='#dd3'; ctx.beginPath();
    ctx.moveTo(q[0],q[1]); ctx.lineTo(e[0],e[1]); ctx.stroke();
    ctx.fillStyle='#e33'; ctx.fillRect(q[0]-3,q[1]-3,6,6);
    ctx.fillStyle='#e88'; ctx.fillText(cam[6], q[0]+5, q[1]-5);
  }}
}}
let drag=false, moved=false, lx=0, ly=0;
cv.onmousedown=e=>{{drag=true;moved=false;lx=e.clientX;ly=e.clientY;}};
onmouseup=e=>{{
  if (drag && !moved) {{          // click: nearest-patch readout
    let best=1e30, bp=null;
    for (const q of proj) {{
      const d=(q[0]-e.clientX)**2+(q[1]-e.clientY)**2;
      if (d<best) {{ best=d; bp=q[3]; }}
    }}
    if (bp && best < 400) {{
      document.getElementById('pick').textContent =
        `patch id ${{bp[10]}}  pos (${{bp[0]}}, ${{bp[1]}}, ${{bp[2]}})` +
        `  normal (${{bp[7]}}, ${{bp[8]}}, ${{bp[9]}})\\n` +
        `warped windows + SAD heat-map:  ` +
        `python -m pais_mvs_tpu.cli -v <file.mvs> --patch-id ${{bp[10]}}`;
    }}
  }}
  drag=false; }};
onmousemove=e=>{{ if(!drag) return; moved=true;
  yaw+=(e.clientX-lx)*0.008; pitch+=(e.clientY-ly)*0.008;
  lx=e.clientX; ly=e.clientY; draw(); }};
cv.onwheel=e=>{{ zoom*=e.deltaY<0?1.1:0.9; draw(); e.preventDefault(); }};
onkeydown=e=>{{
  if(e.key==='c') {{ mode=1-mode; draw(); }}
  if(e.key==='n') {{ showN=!showN; draw(); }}
  if(e.key==='v') {{ showC=!showC; draw(); }}
  if(e.key==='o') {{
    if (anim) {{ clearInterval(anim); anim=null; frac=1; draw(); return; }}
    frac=0; anim=setInterval(()=>{{ frac=Math.min(1,frac+0.01);
      draw(); if(frac>=1){{clearInterval(anim);anim=null;}} }}, 40);
  }} }};
draw();
</script></body></html>
"""


def write_html_viewer(path: str, centers, colors, normals=None, ids=None,
                      cam_centers=None, cam_axes=None, cam_names=None,
                      max_points: int = 200_000) -> None:
    """Self-contained interactive point-cloud viewer (vanilla JS canvas, no
    network dependencies) — the offline replacement for the PCL window
    (view/mvsviewer.cpp): orbit/zoom, color toggle, insertion-order replay
    (the reference's -a mode), normals toggle, red camera glyphs with
    yellow optical axes (mvsviewer.cpp:144-256), and click-nearest-patch
    readout that names the --patch-id diagnostics command (the offline
    counterpart of pointPickEvent -> printPatchInformation,
    mvsviewer.cpp:441-471)."""
    import json
    n = len(centers)
    if n < 2:
        # a 0/1-point cloud renders as NaN geometry; skip the artifact
        with open(path, "w") as f:
            f.write("<html><body>no patches to view</body></html>")
        return
    step = max(1, -(-n // max_points))   # ceil: never exceed max_points
    rows = []
    for i in range(0, n, step):
        c = centers[i]
        col = np.clip(colors[i], 0, 255).astype(int)
        row = [round(float(c[0]), 5), round(float(c[1]), 5),
               round(float(c[2]), 5), int(col[0]), int(col[1]),
               int(col[2]), round(i / max(n - 1, 1), 4)]
        if normals is not None:
            nm = normals[i]
            row += [round(float(nm[0]), 3), round(float(nm[1]), 3),
                    round(float(nm[2]), 3)]
        else:
            row += [0.0, 0.0, 0.0]
        row.append(int(ids[i]) if ids is not None else i)
        rows.append(row)
    cams = []
    if cam_centers is not None:
        for k in range(len(cam_centers)):
            cc = cam_centers[k]
            ax = (cam_axes[k] if cam_axes is not None else [0, 0, 1])
            nm = (str(cam_names[k]) if cam_names is not None else str(k))
            cams.append([round(float(cc[0]), 5), round(float(cc[1]), 5),
                         round(float(cc[2]), 5), round(float(ax[0]), 4),
                         round(float(ax[1]), 4), round(float(ax[2]), 4),
                         nm])
    html = _HTML_TEMPLATE.format(n=len(rows), ncam=len(cams),
                                 points=json.dumps(rows),
                                 cams=json.dumps(cams))
    with open(path, "w") as f:
        f.write(html)


def write_animate_ply(path: str, centers, normals, colors) -> None:
    """Insertion-order replay artifact: a PLY with an ``order`` scalar per
    point (color-by-order in MeshLab replays the reconstruction the way
    the reference's -a mode animates it, view/mvsviewer.cpp:258-265)."""
    n = len(centers)
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {n}\n")
        for p in ("x", "y", "z", "nx", "ny", "nz"):
            f.write(f"property float {p}\n")
        f.write("property uchar red\nproperty uchar green\n"
                "property uchar blue\nproperty float order\n")
        f.write("end_header\n")
        for i in range(n):
            c = centers[i]
            nm = normals[i]
            col = np.clip(colors[i], 0, 255).astype(int)
            f.write(f"{c[0]:.6f} {c[1]:.6f} {c[2]:.6f} "
                    f"{nm[0]:.6f} {nm[1]:.6f} {nm[2]:.6f} "
                    f"{col[0]} {col[1]} {col[2]} {i / max(n - 1, 1):.6f}\n")
