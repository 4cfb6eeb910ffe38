"""Interactive map viewer: truly self-contained HTML (WebGL2) + CLI.

Port of ``openobj_tpu.viz.viewer`` (host numpy): for the same bundle, title
and colourings ``build_html`` writes the JAX package's HTML, byte for byte.
Only ``make_encoders("hf")`` touches a torch device (the transformers
encoders run on ``device``, the card unless the caller asks for the CPU).

    python -m openobj_torch.viz.viewer map_vis.pkl.gz --out-html map.html \
        [--query "a chair" [--part-query leg] [--top-k K]] \
        [--class-colors replica|<yaml>] [--ply-dir plys/] \
        [--encoders fake|vocab|hf] [--device cuda]

The reference serves its map through an Open3D ``VisualizerWithKeyCallback``
window (visualization/vis_interaction.py) with key-driven modes. Open3D is a
desktop GL dependency that makes no sense for a headless accelerator
workflow, so this package renders the same interactions into a single
self-contained HTML file plus a headless CLI. The HTML embeds its own
minimal WebGL2 renderer (flat shading via fragment derivatives, orbit/pan/
zoom controls) — NO external scripts or CDNs, so it works offline and in
air-gapped environments:

  reference key -> this viewer
    R  vertex RGB                -> mode button / key R
    I  instance colors           -> key I
    S  class (semantic) colors   -> key S (needs a class color YAML or
                                    generated palette, viz.colors)
    O  part-feature PCA RGB      -> key O (per-object PCA, :205-215)
    C  ceiling toggle            -> key C (min-vertex-height > 1 m
                                    heuristic, :150-161)
    A  object bboxes             -> key A
    H  hide all but query hits   -> key H
    F  text query                -> --query "..." bakes a similarity
                                    coloring (0.2 sbert + 0.8 clip,
                                    rainbow or top-k red, :322-376)
    P  object+part query         -> --query + --part-query bakes the
                                    per-vertex part-field similarity
                                    (:378-438)
    viewpoint save/restore       -> keys V / B (browser localStorage)

Queries run at export time (text encoders are injectable; see
``make_encoders``) and are baked into the HTML as extra colorings — the
HTML itself needs no model weights or server.
"""

from __future__ import annotations

import argparse
import base64
import json
import os

import numpy as np

from openobj_torch.viz import colors as C
from openobj_torch.viz import query as Q
from openobj_torch.viz import viewer_math
from openobj_torch.viz.export import load_map_bundle


# --------------------------------------------------------------------------- #
# colorings
# --------------------------------------------------------------------------- #


def bundle_colorings(bundle: dict[int, dict], class_colors=None,
                     class_id_offset: int = 0) -> dict:
    """mode -> {obj_id: [V, 3] uint8} for the static modes (rgb / instance /
    class / part-PCA).

    class_id_offset: 0 for the first-party vocabularies (viz.class_tables /
    ``openobj-class-features --dataset ...``, which include 'unknown' at
    index 0 so semantic ids ARE raw table ids); 1 reproduces the reference
    viewer's mapping[class_id + 1] lookup (vis_interaction.py:284) for
    render_config.yaml vocabularies that omit the void class."""
    modes: dict[str, dict] = {"rgb": {}, "instance": {}, "class": {}, "partpca": {}}
    for oid, e in bundle.items():
        v = e["mesh"]["vertices"].shape[0]
        rgb = e.get("color")
        modes["rgb"][oid] = (
            rgb.astype(np.uint8) if rgb is not None
            else np.full((v, 3), 180, np.uint8)
        )
        modes["instance"][oid] = np.tile(C.instance_color(oid), (v, 1))
        if class_colors is not None and e.get("class_id") is not None:
            col = class_colors.color_of(int(e["class_id"]) + class_id_offset)
        else:
            col = np.array([128, 128, 128], np.uint8)
        modes["class"][oid] = np.tile(col, (v, 1))
        pf = e.get("part_feat")
        if pf is not None and pf.shape[0] == v and pf.shape[0] >= 3:
            modes["partpca"][oid] = (
                Q.part_feature_pca_colors(pf) * 255
            ).astype(np.uint8)
        else:
            modes["partpca"][oid] = modes["rgb"][oid]
    return modes


def bake_object_query(bundle, scores: dict[int, float], top_k: int | None = None):
    """Similarity coloring: rainbow heat over all objects, or top-k red
    (reference :322-376)."""
    out = {}
    norm = C.normalize_scores(scores)
    if top_k is not None:
        top = set(sorted(scores, key=scores.get, reverse=True)[:top_k])
    for oid, e in bundle.items():
        v = e["mesh"]["vertices"].shape[0]
        if top_k is not None:
            col = (np.array([255, 40, 40], np.uint8) if oid in top
                   else np.array([165, 165, 165], np.uint8))
            out[oid] = np.tile(col, (v, 1))
        else:
            out[oid] = np.tile(
                C.rainbow_colormap(np.asarray([norm.get(oid, 0.0)]))[0], (v, 1)
            )
    return out


def bake_part_query(bundle, part_scores: dict[int, np.ndarray]):
    """Per-vertex heat on the picked objects; everything else grey
    (reference :410-438)."""
    out = {}
    for oid, e in bundle.items():
        v = e["mesh"]["vertices"].shape[0]
        if oid in part_scores:
            s = np.asarray(part_scores[oid], np.float64)
            s = (s - s.min()) / max(s.max() - s.min(), 1e-9)
            out[oid] = C.rainbow_colormap(s)
        else:
            out[oid] = np.tile(np.array([165, 165, 165], np.uint8), (v, 1))
    return out


# --------------------------------------------------------------------------- #
# encoders
# --------------------------------------------------------------------------- #


def make_encoders(kind: str, vocab_path: str | None = None, device="cuda"):
    """(clip_text_encoder, sbert_text_encoder).

    kind:
      * "hf"    — live transformers CLIP/SBERT (needs local weights), on
                  ``device``;
      * "vocab" — precomputed vocabulary npz {"terms": [str...],
                  "clip": [N,512], "sbert": [N,384]}; nearest exact-match;
      * "fake"  — deterministic hashing projections (demos/tests).
    """
    if kind == "hf":
        from openobj_torch.perception.encoders import HFClipEncoder, HFSbertEncoder

        clip, sbert = HFClipEncoder(device=device), HFSbertEncoder(device=device)
        return clip.encode_texts, sbert.encode_texts
    if kind == "vocab":
        z = np.load(vocab_path, allow_pickle=True)
        terms = {str(t): i for i, t in enumerate(z["terms"])}

        def enc(mat):
            def f(texts):
                idx = [terms[t] for t in texts]
                return mat[idx]
            return f

        return enc(z["clip"]), enc(z["sbert"])
    if kind == "fake":
        import hashlib

        def hashing_encoder(dim):
            def f(texts):
                out = np.empty((len(texts), dim), np.float32)
                for i, t in enumerate(texts):
                    # hashlib, not hash(): stable across processes
                    # (PYTHONHASHSEED), so fake-encoded artifacts match
                    # fake-encoded queries from any later process
                    digest = hashlib.sha256(
                        f"openobj:{t}".encode()
                    ).digest()
                    rng = np.random.default_rng(
                        int.from_bytes(digest[:8], "little")
                    )
                    v = rng.normal(size=dim)
                    out[i] = v / np.linalg.norm(v)
                return out
            return f

        return hashing_encoder(512), hashing_encoder(384)
    raise ValueError(f"unknown encoder kind {kind!r}")


# --------------------------------------------------------------------------- #
# HTML emission
# --------------------------------------------------------------------------- #


def _b64(a: np.ndarray) -> str:
    return base64.b64encode(np.ascontiguousarray(a).tobytes()).decode()


_HTML = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>{title}</title>
<style>
 body {{ margin:0; background:#101014; color:#ddd; font:13px sans-serif;
        overflow:hidden; }}
 #hud {{ position:fixed; top:8px; left:8px; background:#000a; padding:8px 10px;
        border-radius:6px; max-width:330px; }}
 #hud b {{ color:#8cf; }}
 select, input, button {{ background:#222; color:#ddd; border:1px solid #555; }}
 canvas {{ display:block; }}
</style></head><body>
<div id="hud">
 <div><b>{title}</b></div>
 <div>mode: <select id="mode"></select></div>
 <div>[R]gb [I]nstance [S]emantic part-pca[O] [C]eiling [A]bboxes [H]ide-misses
      [V]save view [B]restore &middot; drag orbit / shift-drag pan / wheel zoom</div>
 <div id="info"></div>{live_block}
</div>
<script>
"use strict";
const CEILING_HEIGHT = {ceiling_height};
const HIDE_THRESH = {hide_thresh};
const DATA = {data_json};
{main_js}{live_js}
</script></body></html>
"""

# Self-contained WebGL2 renderer — NO external scripts (works offline /
# air-gapped; the previous three.js CDN import map did not). Flat shading
# via fragment derivatives, so no normals are stored. Inserted into _HTML
# as a plain value: raw JS braces are safe here.
_MAIN_JS = r"""
const b64f32 = s => new Float32Array(Uint8Array.from(atob(s), c=>c.charCodeAt(0)).buffer);
const b64u32 = s => new Uint32Array(Uint8Array.from(atob(s), c=>c.charCodeAt(0)).buffer);
const b64u8  = s => Uint8Array.from(atob(s), c=>c.charCodeAt(0));

const canvas = document.createElement('canvas');
document.body.appendChild(canvas);
const gl = canvas.getContext('webgl2', {antialias:true});
if (!gl) document.getElementById('info').textContent = 'WebGL2 unavailable';

function sh(type, src) {
  const s = gl.createShader(type); gl.shaderSource(s, src); gl.compileShader(s);
  if (!gl.getShaderParameter(s, gl.COMPILE_STATUS))
    throw new Error(gl.getShaderInfoLog(s));
  return s;
}
const VS = `#version 300 es
layout(location=0) in vec3 pos; layout(location=1) in vec3 col;
uniform mat4 mvp; out vec3 vCol; out vec3 vPos;
void main(){ vCol = col; vPos = pos; gl_Position = mvp * vec4(pos, 1.0); }`;
const FS = `#version 300 es
precision highp float; in vec3 vCol; in vec3 vPos; out vec4 frag;
uniform float flatMode;
void main(){
  vec3 n = normalize(cross(dFdx(vPos), dFdy(vPos)));
  float l = flatMode > 0.5 ? 1.0 : (0.55 + 0.45 * abs(n.y) * 0.5 + 0.35 * abs(dot(n, normalize(vec3(0.5,0.8,0.6)))));
  frag = vec4(vCol * min(l, 1.15), 1.0);
}`;
const prog = gl.createProgram();
gl.attachShader(prog, sh(gl.VERTEX_SHADER, VS));
gl.attachShader(prog, sh(gl.FRAGMENT_SHADER, FS));
gl.linkProgram(prog);
if (!gl.getProgramParameter(prog, gl.LINK_STATUS))
  throw new Error(gl.getProgramInfoLog(prog));
const uMvp = gl.getUniformLocation(prog, 'mvp');
const uFlat = gl.getUniformLocation(prog, 'flatMode');

__JS_MAT4__
// ---- build per-object buffers ----
const meshes = {};
let lo=[1e9,1e9,1e9], hi=[-1e9,-1e9,-1e9];
for (const [oid, o] of Object.entries(DATA.objects)) {
  const v = b64f32(o.v), f = b64u32(o.f);
  for (let i=0;i<v.length;i+=3){
    for (let a=0;a<3;a++){
      if (v[i+a]<lo[a]) lo[a]=v[i+a];
      if (v[i+a]>hi[a]) hi[a]=v[i+a];
    }
  }
  const vao = gl.createVertexArray(); gl.bindVertexArray(vao);
  const vb = gl.createBuffer(); gl.bindBuffer(gl.ARRAY_BUFFER, vb);
  gl.bufferData(gl.ARRAY_BUFFER, v, gl.STATIC_DRAW);
  gl.enableVertexAttribArray(0); gl.vertexAttribPointer(0,3,gl.FLOAT,false,0,0);
  const cb = gl.createBuffer(); gl.bindBuffer(gl.ARRAY_BUFFER, cb);
  gl.bufferData(gl.ARRAY_BUFFER, v.length*4, gl.DYNAMIC_DRAW);
  gl.enableVertexAttribArray(1); gl.vertexAttribPointer(1,3,gl.FLOAT,false,0,0);
  const ib = gl.createBuffer(); gl.bindBuffer(gl.ELEMENT_ARRAY_BUFFER, ib);
  gl.bufferData(gl.ELEMENT_ARRAY_BUFFER, f, gl.STATIC_DRAW);
  // per-object AABB wireframe
  let l=[1e9,1e9,1e9], h=[-1e9,-1e9,-1e9];
  for (let i=0;i<v.length;i+=3) for (let a=0;a<3;a++){
    if (v[i+a]<l[a]) l[a]=v[i+a];
    if (v[i+a]>h[a]) h[a]=v[i+a];
  }
  const cs=[], E=[[0,1],[1,3],[3,2],[2,0],[4,5],[5,7],[7,6],[6,4],[0,4],[1,5],[2,6],[3,7]];
  const corner = k => [k&1?h[0]:l[0], k&2?h[1]:l[1], k&4?h[2]:l[2]];
  for (const [a,b] of E){ cs.push(...corner(a), ...corner(b)); }
  const bvao = gl.createVertexArray(); gl.bindVertexArray(bvao);
  const bvb = gl.createBuffer(); gl.bindBuffer(gl.ARRAY_BUFFER, bvb);
  gl.bufferData(gl.ARRAY_BUFFER, new Float32Array(cs), gl.STATIC_DRAW);
  gl.enableVertexAttribArray(0); gl.vertexAttribPointer(0,3,gl.FLOAT,false,0,0);
  const bcb = gl.createBuffer(); gl.bindBuffer(gl.ARRAY_BUFFER, bcb);
  const bcol = new Float32Array(72); for (let i=0;i<24;i++){ bcol[i*3]=0.27; bcol[i*3+1]=1.0; bcol[i*3+2]=0.53; }
  gl.bufferData(gl.ARRAY_BUFFER, bcol, gl.STATIC_DRAW);
  gl.enableVertexAttribArray(1); gl.vertexAttribPointer(1,3,gl.FLOAT,false,0,0);
  meshes[oid] = { vao, cb, n: f.length, bvao, visible: true,
                  userData: { oid, minUp: o.minUp, score: o.score } };
}
gl.bindVertexArray(null);
const ctr = [(lo[0]+hi[0])/2, (lo[1]+hi[1])/2, (lo[2]+hi[2])/2];
const diag = Math.hypot(hi[0]-lo[0], hi[1]-lo[1], hi[2]-lo[2]) || 1;

// ---- coloring modes ----
function setMode(name) {
  const mode = DATA.colorings[name]; if (!mode) return;
  for (const [oid, m] of Object.entries(meshes)) {
    const c = b64u8(mode[oid]);
    const f = new Float32Array(c.length);
    for (let i=0;i<c.length;i++) f[i]=c[i]/255;
    gl.bindBuffer(gl.ARRAY_BUFFER, m.cb);
    gl.bufferData(gl.ARRAY_BUFFER, f, gl.DYNAMIC_DRAW);
  }
  document.getElementById('mode').value = name;
  document.getElementById('info').textContent = 'mode: ' + name;
}
const sel = document.getElementById('mode');
for (const name of Object.keys(DATA.colorings)) {
  const o = document.createElement('option'); o.value = o.textContent = name;
  sel.appendChild(o);
}
sel.onchange = e => setMode(e.target.value);

// ---- camera / controls ----
let yaw = 0.6, pitch = 0.5, radius = diag * 1.2, target = ctr.slice();
let showBoxes = false, ceilingHidden = false, hideMisses = false;
let dragging = 0, px = 0, py = 0;
canvas.addEventListener('mousedown', e => { dragging = e.shiftKey || e.button===2 ? 2 : 1; px=e.clientX; py=e.clientY; });
addEventListener('mouseup', () => dragging = 0);
addEventListener('mousemove', e => {
  if (!dragging) return;
  const dx = e.clientX-px, dy = e.clientY-py; px=e.clientX; py=e.clientY;
  if (dragging===1){ yaw -= dx*0.005; pitch = Math.min(1.5, Math.max(-1.5, pitch + dy*0.005)); }
  else {
    const s = radius*0.0015;
    const cy=Math.cos(yaw), sy=Math.sin(yaw);
    target[0] -= (cy*dx)*s; target[2] -= (-sy*dx)*s; target[1] += dy*s;
  }
});
canvas.addEventListener('wheel', e => { radius *= Math.exp(e.deltaY*0.001); e.preventDefault(); }, {passive:false});
canvas.addEventListener('contextmenu', e => e.preventDefault());

addEventListener('keydown', e => {
  const k = e.key.toLowerCase();
  if (k==='r') setMode('rgb');
  if (k==='i') setMode('instance');
  if (k==='s') setMode('class');
  if (k==='o') setMode('partpca');
  if (k==='a') showBoxes = !showBoxes;
  if (k==='c') { ceilingHidden = !ceilingHidden;
    for (const m of Object.values(meshes))
      if (m.userData.minUp > CEILING_HEIGHT) m.visible = !ceilingHidden; }
  if (k==='h') { hideMisses = !hideMisses;
    for (const m of Object.values(meshes))
      if (m.userData.score !== null && m.userData.score !== undefined &&
          m.userData.score < HIDE_THRESH) m.visible = !hideMisses; }
  if (k==='v') localStorage.setItem('oo_view', JSON.stringify({yaw, pitch, radius, target}));
  if (k==='b') { const s = JSON.parse(localStorage.getItem('oo_view')||'null');
    if (s) { yaw=s.yaw; pitch=s.pitch; radius=s.radius; target=s.target; } }
});

// ---- render loop ----
gl.enable(gl.DEPTH_TEST);
function draw(){
  const w = innerWidth, h = innerHeight;
  if (canvas.width !== w || canvas.height !== h){ canvas.width=w; canvas.height=h; gl.viewport(0,0,w,h); }
  gl.clearColor(0.063,0.063,0.078,1); gl.clear(gl.COLOR_BUFFER_BIT|gl.DEPTH_BUFFER_BIT);
__JS_ORBIT_EYE__
  const mvp = mul(perspective(1.05, w/h, 0.01*diag, 100*diag), lookAt(eye, target, [0,1,0]));
  gl.useProgram(prog);
  gl.uniformMatrix4fv(uMvp, false, new Float32Array(mvp));
  for (const m of Object.values(meshes)) {
    if (!m.visible) continue;
    gl.uniform1f(uFlat, 0.0);
    gl.bindVertexArray(m.vao);
    gl.drawElements(gl.TRIANGLES, m.n, gl.UNSIGNED_INT, 0);
    if (showBoxes){ gl.uniform1f(uFlat, 1.0); gl.bindVertexArray(m.bvao); gl.drawArrays(gl.LINES, 0, 24); }
  }
  requestAnimationFrame(draw);
}
setMode(DATA.initial);
requestAnimationFrame(draw);
"""

# The mat4/orbit math is NOT inlined above: it is spliced from
# viz.viewer_math — the single blessed source whose Python twins are
# golden-tested against numpy (no JS engine exists here to execute the
# emitted script; see viewer_math docstring for the verification chain).
_MAIN_JS = (
    _MAIN_JS
    .replace("__JS_MAT4__", viewer_math.JS_MAT4)
    .replace("__JS_ORBIT_EYE__", viewer_math.JS_ORBIT_EYE)
)


# substituted into _HTML's {live_js} field (plain value — not re-formatted,
# so raw JS braces are fine here)
_LIVE_JS = """
const qgo = document.getElementById('qgo');
qgo.onclick = async () => {
  const t = document.getElementById('qtext').value;
  if (!t) return;
  const p = document.getElementById('qpart').value;
  const k = document.getElementById('qtopk').value;
  const u = `/query?text=${encodeURIComponent(t)}` +
            (p ? `&part=${encodeURIComponent(p)}` : '') +
            (k ? `&topk=${encodeURIComponent(k)}` : '');
  document.getElementById('info').textContent = 'querying...';
  try {
    const r = await fetch(u);
    if (!r.ok) throw new Error(await r.text());
    const j = await r.json();
    DATA.colorings['live'] = j.colors;
    for (const [oid, m] of Object.entries(meshes))
      if (j.scores && j.scores[oid] !== undefined)
        m.userData.score = j.scores[oid];
    if (![...sel.options].some(o => o.value === 'live')) {
      const o = document.createElement('option');
      o.value = o.textContent = 'live'; sel.appendChild(o);
    }
    setMode('live');
    document.getElementById('info').textContent =
      `live: ${j.query}` + (j.part ? ` / ${j.part}` : '');
  } catch (e) {
    document.getElementById('info').textContent = 'query failed: ' + e.message;
  }
};
"""


def build_html(
    bundle: dict[int, dict],
    out_path: str,
    colorings: dict[str, dict] | None = None,
    class_colors=None,
    class_id_offset: int = 0,
    scores: dict[int, float] | None = None,
    initial: str = "rgb",
    title: str = "openobj-torch map",
    ceiling_height: float = 1.0,
    hide_thresh: float = 0.5,
    live_query: bool = False,
) -> str:
    """Write the self-contained viewer HTML; returns the path.

    live_query=True adds a query box that POSTs to the serving process's
    /query endpoint (viz.server) and installs the returned coloring as a
    'live' mode — interactive re-querying with real encoders, reference
    F/P keys (vis_interaction.py:322-438) without rebaking the HTML."""
    modes = bundle_colorings(bundle, class_colors=class_colors,
                             class_id_offset=class_id_offset)
    if colorings:
        modes.update(colorings)
    norm = C.normalize_scores(scores) if scores else {}
    objects = {}
    for oid, e in bundle.items():
        v = e["mesh"]["vertices"].astype(np.float32)
        objects[str(oid)] = {
            "v": _b64(v),
            "f": _b64(e["mesh"]["faces"].astype(np.uint32)),
            # reference ceiling heuristic: MIN vertex height along world
            # up (z) > threshold -> the whole object sits above the line
            # (vis_interaction.py:152 np.min(vertices[:, 2]))
            "minUp": float(v[:, 2].min()) if len(v) else 0.0,
            "score": norm.get(oid) if scores else None,
        }
    data = {
        "objects": objects,
        "colorings": {
            name: {str(oid): _b64(col.astype(np.uint8))
                   for oid, col in mode.items()}
            for name, mode in modes.items()
        },
        "initial": initial if initial in modes else "rgb",
    }
    live_block = live_js = ""
    if live_query:
        live_block = (
            '\n <div id="livebox">query <input id="qtext" size="16"> '
            'part <input id="qpart" size="10"> '
            'top-k <input id="qtopk" size="3"> '
            '<button id="qgo">go</button></div>'
        )
        live_js = _LIVE_JS
    html = _HTML.format(
        title=title, data_json=json.dumps(data),
        ceiling_height=ceiling_height, hide_thresh=hide_thresh,
        live_block=live_block, live_js=live_js, main_js=_MAIN_JS,
    )
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    with open(out_path, "w") as f:
        f.write(html)
    return out_path


def export_plys(bundle, coloring: dict[int, np.ndarray], out_dir: str):
    """Write one colored PLY per object for external viewers."""
    from openobj_torch.utils.geometry import TriangleMesh

    os.makedirs(out_dir, exist_ok=True)
    for oid, e in bundle.items():
        mesh = TriangleMesh(
            vertices=e["mesh"]["vertices"], faces=e["mesh"]["faces"],
            vertex_colors=coloring[oid],
        )
        mesh.export_ply(os.path.join(out_dir, f"obj_{oid}.ply"))


# --------------------------------------------------------------------------- #
# CLI
# --------------------------------------------------------------------------- #


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Open-vocabulary map viewer/query (reference "
                    "vis_interaction.py, headless + HTML)")
    ap.add_argument("bundle", help="map_vis bundle (.pkl.gz)")
    ap.add_argument("--out-html", default="map_viewer.html")
    ap.add_argument("--ply-dir", default=None)
    ap.add_argument("--query", default=None, help="text -> object retrieval")
    ap.add_argument("--part-query", default=None,
                    help="part text (with --query: object+part mode)")
    ap.add_argument("--top-k", type=int, default=None)
    ap.add_argument("--encoders", default="fake",
                    choices=("fake", "hf", "vocab"))
    ap.add_argument("--vocab", default=None, help="vocabulary npz for "
                    "--encoders vocab")
    ap.add_argument("--class-id-offset", type=int, default=0,
                    help="0: first-party vocabularies (unknown at index "
                         "0); 1: the reference's render_config.yaml "
                         "convention (mapping[class_id + 1])")
    ap.add_argument("--class-colors", default=None,
                    help="reference-format color map YAML, or a shipped "
                         "dataset name ('replica' | 'scannet', "
                         "viz.class_tables)")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the transformers encoders; read only "
                         "with --encoders hf (default: the card)")
    args = ap.parse_args(argv)

    bundle = load_map_bundle(args.bundle)
    print(f"loaded {len(bundle)} objects from {args.bundle}")
    class_colors = None
    if args.class_colors:
        if args.class_colors.lower() in ("replica", "scannet"):
            from openobj_torch.viz import class_tables

            class_colors = class_tables.for_dataset(args.class_colors)
        else:
            class_colors = C.ClassColorMap.from_yaml(args.class_colors)

    colorings, scores, initial = {}, None, "rgb"
    if args.query:
        clip_enc, sbert_enc = make_encoders(args.encoders, args.vocab, device=args.device)
        scores = Q.query_objects(args.query, bundle, clip_enc, sbert_enc)
        ranked = sorted(scores.items(), key=lambda kv: -kv[1])
        print(f"query {args.query!r}:")
        for oid, s in ranked[:10]:
            print(f"  obj {oid:4d}  sim {s:+.4f}")
        if args.part_query:
            part = Q.query_part(
                args.query, args.part_query, bundle, clip_enc, sbert_enc,
                top_k_objects=args.top_k or 1,
            )
            colorings["part_query"] = bake_part_query(bundle, part)
            initial = "part_query"
        else:
            colorings["query"] = bake_object_query(
                bundle, scores, top_k=args.top_k
            )
            initial = "query"

    path = build_html(
        bundle, args.out_html, colorings=colorings, class_colors=class_colors,
        class_id_offset=args.class_id_offset,
        scores=scores, initial=initial,
    )
    print(f"wrote {path}")
    if args.ply_dir:
        modes = bundle_colorings(bundle, class_colors=class_colors)
        modes.update(colorings)
        export_plys(bundle, modes[initial], args.ply_dir)
        print(f"wrote PLYs to {args.ply_dir}")


if __name__ == "__main__":
    main()
