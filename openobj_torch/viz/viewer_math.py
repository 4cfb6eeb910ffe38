"""The viewer's pure-math JS (mat4 + orbit), with Python twins.

A copy of ``openobj_tpu.viz.viewer_math``: ``JS_MAT4`` and ``JS_ORBIT_EYE``
are the same strings, byte for byte, so that the port's viewer HTML is the
JAX package's.

  * ``JS_MAT4`` / ``JS_ORBIT_EYE`` are the ONLY source of the viewer's
    projection/camera code — ``viewer.py`` splices them into the emitted
    HTML verbatim;
  * ``perspective`` / ``look_at`` / ``mat_mul`` / ``orbit_eye`` are
    line-by-line Python transliterations of those JS bodies (kept
    adjacent in this file so a reader can diff them by eye); the tests
    hold them equal to the JAX package's twins, which its own tests check
    against independent numpy constructions.

Matrices are COLUMN-MAJOR flat length-16 lists (WebGL convention:
m[c*4+r]); the reference's interactive viewer uses Open3D's built-in camera
(vis_interaction.py:120,512-525) — these reproduce the standard GL pipeline
it wraps.
"""

from __future__ import annotations

import math

# ---- JS source of truth (spliced verbatim into the viewer HTML) ---- #

JS_MAT4 = """\
// ---- tiny mat4 helpers (column-major) ----
function perspective(fovy, aspect, near, far){
  const f = 1/Math.tan(fovy/2), nf = 1/(near-far);
  return [f/aspect,0,0,0, 0,f,0,0, 0,0,(far+near)*nf,-1, 0,0,2*far*near*nf,0];
}
function lookAt(eye, c, up){
  let zx=eye[0]-c[0], zy=eye[1]-c[1], zz=eye[2]-c[2];
  let zl=Math.hypot(zx,zy,zz); zx/=zl; zy/=zl; zz/=zl;
  let xx=up[1]*zz-up[2]*zy, xy=up[2]*zx-up[0]*zz, xz=up[0]*zy-up[1]*zx;
  let xl=Math.hypot(xx,xy,xz)||1; xx/=xl; xy/=xl; xz/=xl;
  const yx=zy*xz-zz*xy, yy=zz*xx-zx*xz, yz=zx*xy-zy*xx;
  return [xx,yx,zx,0, xy,yy,zy,0, xz,yz,zz,0,
          -(xx*eye[0]+xy*eye[1]+xz*eye[2]),
          -(yx*eye[0]+yy*eye[1]+yz*eye[2]),
          -(zx*eye[0]+zy*eye[1]+zz*eye[2]), 1];
}
function mul(a, b){
  const o = new Array(16);
  for (let c=0;c<4;c++) for (let r=0;r<4;r++){
    o[c*4+r]=0;
    for (let k=0;k<4;k++) o[c*4+r]+=a[k*4+r]*b[c*4+k];
  }
  return o;
}
"""

JS_ORBIT_EYE = """\
  const eye = [
    target[0] + radius*Math.cos(pitch)*Math.sin(yaw),
    target[1] + radius*Math.sin(pitch),
    target[2] + radius*Math.cos(pitch)*Math.cos(yaw)];
"""


# ---- Python twins (line-by-line transliterations of the JS above) ---- #


def perspective(fovy: float, aspect: float, near: float, far: float):
    f = 1 / math.tan(fovy / 2)
    nf = 1 / (near - far)
    return [f / aspect, 0, 0, 0, 0, f, 0, 0,
            0, 0, (far + near) * nf, -1, 0, 0, 2 * far * near * nf, 0]


def look_at(eye, c, up):
    zx, zy, zz = eye[0] - c[0], eye[1] - c[1], eye[2] - c[2]
    zl = math.hypot(zx, zy, zz)
    zx /= zl; zy /= zl; zz /= zl                          # noqa: E702
    xx = up[1] * zz - up[2] * zy
    xy = up[2] * zx - up[0] * zz
    xz = up[0] * zy - up[1] * zx
    xl = math.hypot(xx, xy, xz) or 1
    xx /= xl; xy /= xl; xz /= xl                          # noqa: E702
    yx = zy * xz - zz * xy
    yy = zz * xx - zx * xz
    yz = zx * xy - zy * xx
    return [xx, yx, zx, 0, xy, yy, zy, 0, xz, yz, zz, 0,
            -(xx * eye[0] + xy * eye[1] + xz * eye[2]),
            -(yx * eye[0] + yy * eye[1] + yz * eye[2]),
            -(zx * eye[0] + zy * eye[1] + zz * eye[2]), 1]


def mat_mul(a, b):
    o = [0.0] * 16
    for c in range(4):
        for r in range(4):
            o[c * 4 + r] = 0
            for k in range(4):
                o[c * 4 + r] += a[k * 4 + r] * b[c * 4 + k]
    return o


def orbit_eye(target, radius, pitch, yaw):
    return [
        target[0] + radius * math.cos(pitch) * math.sin(yaw),
        target[1] + radius * math.sin(pitch),
        target[2] + radius * math.cos(pitch) * math.cos(yaw),
    ]


def project(mvp, p):
    """Apply a column-major flat mat4 to a 3D point -> NDC (perspective
    divide), exactly what the vertex shader's gl_Position path does."""
    x = mvp[0] * p[0] + mvp[4] * p[1] + mvp[8] * p[2] + mvp[12]
    y = mvp[1] * p[0] + mvp[5] * p[1] + mvp[9] * p[2] + mvp[13]
    z = mvp[2] * p[0] + mvp[6] * p[1] + mvp[10] * p[2] + mvp[14]
    w = mvp[3] * p[0] + mvp[7] * p[1] + mvp[11] * p[2] + mvp[15]
    return [x / w, y / w, z / w]
