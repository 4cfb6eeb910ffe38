"""Analytic synthetic RGB-D scenes with ground truth, for tests and demos.

A copy of the JAX package's ``data.synthetic`` (numpy only);
``write_raw_scene`` writes its PNGs with the port's codec (``utils.png``).

The reference ships no tests and no synthetic data; this module provides the
golden-scene harness SURVEY.md §4 calls for: a box room (background,
instance 0) containing colored objects (instances 4, 5, ...), rendered
analytically per pixel — exact depth, color, and instance maps from any
camera pose, so trained fields can be scored against closed-form truth
(depth error, PSNR, silhouette IoU).

Beyond the basic spheres-in-a-box fixture, ``archetype_scene`` builds the
perception STRESS archetypes (textured surfaces, touching/occluding
objects, non-convex shapes, cluttered tabletop, grazing walls) that probe
the regimes where the weights-free segmentation/association actually
breaks — the reference's CropFormer handles these with learned weights
(mask_gen.py:231-367); the weights-free stages must earn them
geometrically. ``write_raw_scene`` emits a raw rgb/depth/traj directory
plus held-aside GT instance maps for scoring.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


# --------------------------------------------------------------------------- #
# textures (world-space, deterministic, vectorized: [N,3] points -> [N,3] rgb)
# --------------------------------------------------------------------------- #


def solid(color):
    c = np.asarray(color, np.float64)

    def f(p):
        return np.broadcast_to(c, (p.shape[0], 3))

    return f


def checker(c1, c2, scale: float = 1.0):
    """3D checkerboard: parity of the integer cell coordinates."""
    c1, c2 = np.asarray(c1, np.float64), np.asarray(c2, np.float64)

    def f(p):
        parity = np.floor(p * scale).sum(axis=1).astype(np.int64) & 1
        return np.where(parity[:, None] == 0, c1, c2)

    return f


def stripes(c1, c2, axis: int = 0, scale: float = 2.0):
    c1, c2 = np.asarray(c1, np.float64), np.asarray(c2, np.float64)

    def f(p):
        parity = np.floor(p[:, axis] * scale).astype(np.int64) & 1
        return np.where(parity[:, None] == 0, c1, c2)

    return f


def speckle(c1, c2, freq=(13.1, 7.7, 9.3)):
    """Smooth deterministic pseudo-noise blend between two colors."""
    c1, c2 = np.asarray(c1, np.float64), np.asarray(c2, np.float64)
    fr = np.asarray(freq, np.float64)

    def f(p):
        w = 0.5 + 0.5 * np.sin(p * fr).prod(axis=1)
        return c1[None] * (1 - w[:, None]) + c2[None] * w[:, None]

    return f


# --------------------------------------------------------------------------- #
# primitives
# --------------------------------------------------------------------------- #


@dataclass
class Sphere:
    center: np.ndarray
    radius: float
    color: np.ndarray  # [3] in 0..1
    inst_id: int
    texture: object = None  # optional callable [N,3]->[N,3]

    def intersect(self, o, d):
        oc = o - self.center
        b = np.sum(oc * d, -1)
        a = np.sum(d * d, -1)
        c = np.sum(oc * oc, -1) - self.radius**2
        disc = b * b - a * c
        hit = disc > 0
        t = (-b - np.sqrt(np.maximum(disc, 0.0))) / a
        return t, hit & (t > 1e-4)

    def color_at(self, p):
        return self.texture(p) if self.texture else solid(self.color)(p)


@dataclass
class Box:
    """Axis-aligned (or rotated via ``rot``) solid box."""
    center: np.ndarray
    half: np.ndarray          # [3] half extents
    color: np.ndarray
    inst_id: int
    rot: np.ndarray = None    # optional 3x3 world<-local
    texture: object = None

    def _local(self, o, d):
        if self.rot is None:
            return o - self.center, d
        return (o - self.center) @ self.rot, d @ self.rot

    def intersect(self, o, d):
        ol, dl = self._local(o, d)
        # sign-preserving clamp: replacing a tiny NEGATIVE component with
        # +1e-12 would swap the near/far slab roles for axis-parallel rays
        inv = 1.0 / np.where(np.abs(dl) < 1e-12, np.copysign(1e-12, dl), dl)
        t1 = (-self.half - ol) * inv
        t2 = (self.half - ol) * inv
        t_near = np.minimum(t1, t2).max(axis=1)
        t_far = np.maximum(t1, t2).min(axis=1)
        hit = (t_far > t_near) & (t_near > 1e-4)
        return t_near, hit

    def color_at(self, p):
        return self.texture(p) if self.texture else solid(self.color)(p)


@dataclass
class Torus:
    """Sphere-traced torus: axis = local z, radii (major R, minor r)."""
    center: np.ndarray
    r_major: float
    r_minor: float
    color: np.ndarray
    inst_id: int
    rot: np.ndarray = None
    texture: object = None

    def _sdf(self, p):
        q = np.stack(
            [np.linalg.norm(p[:, :2], axis=1) - self.r_major, p[:, 2]], axis=1
        )
        return np.linalg.norm(q, axis=1) - self.r_minor

    def intersect(self, o, d):
        if self.rot is None:
            ol, dl = o - self.center, d
        else:
            ol, dl = (o - self.center) @ self.rot, d @ self.rot
        dn_len = np.linalg.norm(dl, axis=1)
        dn = dl / dn_len[:, None]
        # bounding sphere prune
        bound = self.r_major + self.r_minor
        b = np.sum(ol * dn, -1)
        c = np.sum(ol * ol, -1) - bound**2
        disc = b * b - c
        may = disc > 0
        s_in = np.where(may, np.maximum(-b - np.sqrt(np.maximum(disc, 0)), 1e-4), 0.0)
        s_out = np.where(may, -b + np.sqrt(np.maximum(disc, 0)), 0.0)
        s = s_in.copy()
        hit = np.zeros(o.shape[0], bool)
        alive = may.copy()
        for _ in range(160):
            if not alive.any():
                break
            p = ol[alive] + s[alive, None] * dn[alive]
            sd = self._sdf(p)
            conv = sd < 1e-4
            idx = np.where(alive)[0]
            hit[idx[conv]] = True
            s[alive] += np.maximum(sd, 0.0)
            still = ~conv & (s[alive] <= s_out[alive])
            alive[idx] = still
        t = s / np.maximum(dn_len, 1e-12)   # back to z=1-plane ray units
        return t, hit & (t > 1e-4)

    def color_at(self, p):
        return self.texture(p) if self.texture else solid(self.color)(p)


@dataclass
class BoxRoom:
    half_extent: np.ndarray  # room spans [-he, he]
    color: np.ndarray
    inst_id: int = 0
    texture: object = None

    def color_at(self, p):
        return self.texture(p) if self.texture else solid(self.color)(p)


@dataclass
class SyntheticScene:
    room: BoxRoom
    spheres: list[Sphere] = field(default_factory=list)   # back-compat alias
    objects: list = field(default_factory=list)           # any primitives

    @property
    def all_objects(self):
        return list(self.spheres) + list(self.objects)

    def render(self, t_wc: np.ndarray, dirs_c: np.ndarray):
        """Render exact rgb (uint8 [H,W,3]), depth (f32 [H,W], z-depth
        convention), inst (int32 [H,W]) from camera pose t_wc using the
        cached camera-frame dirs [H,W,3] (z=1 plane, unnormalized)."""
        h, w, _ = dirs_c.shape
        r = t_wc[:3, :3]
        o = t_wc[:3, 3]
        d = dirs_c.reshape(-1, 3) @ r.T       # world dirs, |d_z-cam| scaling kept
        o = np.broadcast_to(o, d.shape)

        # room: from inside a box, take the exit (max) slab intersection
        inv = 1.0 / np.where(np.abs(d) < 1e-12, np.copysign(1e-12, d), d)
        t_lo = (-self.room.half_extent - o) * inv
        t_hi = (self.room.half_extent - o) * inv
        t_exit = np.minimum.reduce([np.maximum(t_lo, t_hi)[:, i] for i in range(3)])
        best_t = t_exit.copy()
        color = self.room.color_at(o + t_exit[:, None] * d).copy()
        inst = np.full(d.shape[0], self.room.inst_id, np.int32)

        for obj in self.all_objects:
            t, hit = obj.intersect(o, d)
            hit &= t < best_t
            if not hit.any():
                continue
            best_t = np.where(hit, t, best_t)
            p_hit = o[hit] + t[hit, None] * d[hit]
            color[hit] = obj.color_at(p_hit)
            inst[hit] = obj.inst_id

        # z-depth = t * dir_z(camera frame); camera dirs have z=1 => depth = t
        depth = best_t.reshape(h, w).astype(np.float32)
        rgb = (np.clip(color, 0, 1).reshape(h, w, 3) * 255).astype(np.uint8)
        return rgb, depth, inst.reshape(h, w)


def default_scene(n_spheres: int = 2) -> SyntheticScene:
    rng = np.random.default_rng(7)
    colors = np.array(
        [[0.85, 0.2, 0.15], [0.15, 0.55, 0.85], [0.2, 0.8, 0.3],
         [0.9, 0.8, 0.1], [0.7, 0.3, 0.8]]
    )
    spheres = []
    for i in range(n_spheres):
        ang = 2 * np.pi * i / max(n_spheres, 1)
        spheres.append(
            Sphere(
                center=np.array([1.2 * np.cos(ang), 1.2 * np.sin(ang), 0.0]),
                radius=0.35 + 0.1 * (i % 2),
                color=colors[i % len(colors)],
                inst_id=4 + i,
            )
        )
    return SyntheticScene(
        room=BoxRoom(half_extent=np.array([3.0, 3.0, 2.0]), color=np.array([0.6, 0.6, 0.55])),
        spheres=spheres,
    )


def _rot_z(a: float) -> np.ndarray:
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])


def _rot_x(a: float) -> np.ndarray:
    c, s = np.cos(a), np.sin(a)
    return np.array([[1.0, 0.0, 0.0], [0.0, c, -s], [0.0, s, c]])


# --------------------------------------------------------------------------- #
# perception stress archetypes
# --------------------------------------------------------------------------- #

ARCHETYPES = ("spheres", "textured", "touching", "nonconvex", "tabletop",
              "grazing", "clones", "occlusion")


def archetype_scene(name: str):
    """(scene, orbit_kwargs) for a named perception stress archetype.

    spheres    the original easy fixture (control row)
    textured   checkerboard walls + striped/speckled objects: color edges
               everywhere that are NOT object boundaries (over-segmentation
               pressure on the color-edge cue)
    touching   boxes in contact + a tangent sphere: no depth discontinuity
               at the contact seams (under-segmentation pressure)
    nonconvex  torus + L-shaped box (two boxes, one instance): hole in the
               2D mask, concave OBB, self-occlusion across the orbit
    tabletop   table (top + 4 legs, one instance) with three small objects
               resting ON it: contact with the support surface, small
               masks, mutual occlusion under a high orbit
    grazing    long thin boxes hugging a wall viewed at grazing angles:
               sloped-surface depth gradients that a naive depth-edge cue
               fragments
    """
    A = np.asarray
    if name == "spheres":
        return default_scene(n_spheres=2), dict(radius=2.6, height=0.0)
    if name == "textured":
        room = BoxRoom(
            half_extent=A([3.0, 3.0, 2.0]), color=A([0.6, 0.6, 0.55]),
            texture=checker([0.62, 0.6, 0.52], [0.5, 0.52, 0.58], scale=1.4),
        )
        objs = [
            Sphere(A([1.1, 0.0, 0.0]), 0.42, A([0.85, 0.2, 0.15]), 4,
                   texture=stripes([0.85, 0.2, 0.15], [0.9, 0.75, 0.2],
                                   axis=2, scale=6.0)),
            Sphere(A([-0.9, 0.9, 0.2]), 0.35, A([0.15, 0.55, 0.85]), 5,
                   texture=speckle([0.15, 0.55, 0.85], [0.1, 0.25, 0.5])),
            Box(A([-0.4, -1.1, 0.3]), A([0.35, 0.3, 0.45]),
                A([0.2, 0.8, 0.3]), 6,
                texture=checker([0.2, 0.8, 0.3], [0.15, 0.5, 0.25],
                                scale=5.0)),
        ]
        return SyntheticScene(room=room, objects=objs), dict(radius=2.55,
                                                             height=-0.25)
    if name == "touching":
        room = BoxRoom(A([3.0, 3.0, 2.0]), A([0.6, 0.6, 0.55]))
        # three boxes in a row in EXACT contact; a sphere tangent on top
        objs = [
            Box(A([-0.62, 0.0, 0.25]), A([0.3, 0.3, 0.35]),
                A([0.85, 0.25, 0.2]), 4),
            Box(A([0.0, 0.0, 0.30]), A([0.32, 0.28, 0.30]),
                A([0.2, 0.45, 0.85]), 5),
            Box(A([0.60, 0.0, 0.27]), A([0.28, 0.3, 0.33]),
                A([0.95, 0.8, 0.2]), 6),
            Sphere(A([0.0, 0.0, -0.30]), 0.30, A([0.3, 0.8, 0.35]), 7),
        ]
        return SyntheticScene(room=room, objects=objs), dict(radius=2.5,
                                                             height=-0.55)
    if name == "nonconvex":
        room = BoxRoom(A([3.0, 3.0, 2.0]), A([0.58, 0.58, 0.55]))
        objs = [
            Torus(A([0.9, 0.35, -0.1]), 0.52, 0.16, A([0.85, 0.3, 0.2]), 4,
                  rot=_rot_x(np.pi / 3)),
            # L-shape: two boxes, ONE instance id
            Box(A([-0.9, -0.3, 0.25]), A([0.55, 0.22, 0.22]),
                A([0.2, 0.5, 0.85]), 5),
            Box(A([-1.23, -0.3, -0.25]), A([0.22, 0.22, 0.3]),
                A([0.2, 0.5, 0.85]), 5),
        ]
        return SyntheticScene(room=room, objects=objs), dict(radius=2.55,
                                                             height=-0.35)
    if name == "tabletop":
        room = BoxRoom(A([3.0, 3.0, 2.0]), A([0.6, 0.58, 0.55]))
        table = A([0.45, 0.35, 0.5])  # brown-ish
        # z is DOWN in the orbit convention (up_w = -z): top at z=0,
        # legs below (z>0), objects resting on top (z<0)
        objs = [
            Box(A([0.0, 0.0, 0.03]), A([0.85, 0.6, 0.05]), table, 4),
            Box(A([0.72, 0.47, 0.55]), A([0.06, 0.06, 0.47]), table, 4),
            Box(A([-0.72, 0.47, 0.55]), A([0.06, 0.06, 0.47]), table, 4),
            Box(A([0.72, -0.47, 0.55]), A([0.06, 0.06, 0.47]), table, 4),
            Box(A([-0.72, -0.47, 0.55]), A([0.06, 0.06, 0.47]), table, 4),
            Sphere(A([0.35, 0.15, -0.20]), 0.18, A([0.85, 0.2, 0.2]), 5),
            Box(A([-0.3, -0.12, -0.14]), A([0.14, 0.11, 0.16]),
                A([0.2, 0.5, 0.85]), 6, rot=_rot_z(0.5)),
            Torus(A([0.05, 0.32, -0.09]), 0.15, 0.07,
                  A([0.9, 0.75, 0.2]), 7),
        ]
        return SyntheticScene(room=room, objects=objs), dict(radius=2.3,
                                                             height=-1.35)
    if name == "grazing":
        room = BoxRoom(A([3.0, 3.0, 2.0]), A([0.6, 0.6, 0.55]))
        objs = [
            # long thin box hugging the +x wall (15 cm proud of it)
            Box(A([2.85, 0.0, 0.0]), A([0.15, 1.6, 0.25]),
                A([0.8, 0.3, 0.2]), 4),
            # thin "picture frame" flush on the -y wall
            Box(A([0.4, -2.92, -0.4]), A([0.55, 0.08, 0.4]),
                A([0.2, 0.45, 0.8]), 5),
            # free-standing control object
            Sphere(A([-0.8, 0.7, 0.1]), 0.35, A([0.25, 0.75, 0.3]), 6),
        ]
        # tight orbit close to the +x wall => grazing views of box 4
        return SyntheticScene(room=room, objects=objs), dict(radius=2.7,
                                                             height=-0.2)
    if name == "clones":
        # ADVERSARIAL: four IDENTICAL spheres — same radius, same color,
        # no texture. Caption, CLIP, and color-histogram similarities all
        # collide at ~1.0 across every pair, so association must keep the
        # four apart on geometry alone (3D AABB IoU + projected 2D IoU,
        # reference mask_graph.py:464-735). 2x2 grid with gaps >> radius;
        # a merge of any two craters their matched per-GT IoU.
        room = BoxRoom(A([3.0, 3.0, 2.0]), A([0.6, 0.6, 0.55]))
        col = A([0.75, 0.25, 0.2])
        objs = [
            Sphere(A([sx, sy, 0.15]), 0.30, col, 4 + i)
            for i, (sx, sy) in enumerate(
                [(0.85, 0.85), (-0.85, 0.85), (0.85, -0.85), (-0.85, -0.85)]
            )
        ]
        return SyntheticScene(room=room, objects=objs), dict(radius=2.6,
                                                             height=-0.6)
    if name == "occlusion":
        # ADVERSARIAL: full occlusion + return. The small sphere (id 5)
        # sits 3 cm behind a fat central pillar; while the camera orbits
        # the far side the pillar hides it COMPLETELY for 13 contiguous
        # frames of 40 (+ edge frames of <15 px slivers — ~15 frames with
        # no usable mask), then it returns — association must re-identify
        # it across the gap rather than mint a new instance (stresses the
        # cross-frame cluster accumulation, reference
        # mask_graph.py:737-895). The second sphere (id 6) gets its own
        # shorter 7-frame gap on the opposite arc — a second re-id case.
        room = BoxRoom(A([3.0, 3.0, 2.0]), A([0.6, 0.6, 0.55]))
        objs = [
            Box(A([0.0, 0.0, 0.0]), A([0.45, 0.45, 0.95]),
                A([0.25, 0.5, 0.8]), 4),
            Sphere(A([0.70, 0.0, 0.2]), 0.22, A([0.85, 0.3, 0.2]), 5),
            Sphere(A([-0.9, 0.9, 0.3]), 0.28, A([0.3, 0.75, 0.3]), 6),
        ]
        return SyntheticScene(room=room, objects=objs), dict(radius=2.5,
                                                             height=-0.3)
    raise KeyError(f"unknown archetype {name!r}; have {ARCHETYPES}")


def apply_sensor_noise(rgb, depth, rng, level: float = 1.0,
                       fx: float | None = None):
    """Kinect-class RGB-D sensor noise for robustness stress (applied to
    the rendered images only — GT instance maps stay clean).

    Depth: axial Gaussian with sigma(z) = 1.2 mm + 1.9 mm * (z - 0.4)^2
    — the structured-light noise model of Khoshelham & Elberink 2012
    (~6 mm at 2 m), scaled by ``level``; plus occlusion-boundary dropout:
    structured-light/ToF sensors lose returns where local depth relief is
    large (projector shadowing, mixed pixels) — pixels whose 3x3 depth
    range exceeds 8 cm go invalid (0) with probability 0.25*level; plus
    grazing-incidence dropout when ``fx`` is given: pixels whose depth
    slope implies the surface is > ~76 deg off the ray (|grad z| * fx / z
    > 4, i.e. tan of the incidence angle) lose returns with probability
    0.5*level — the stretched-speckle/low-return regime of structured
    light. The uint16-mm write quantizes to 1 mm downstream.

    RGB: additive Gaussian (sigma = 3*level counts) under a per-frame
    exposure gain (lognormal, sigma 6%*level) and per-channel white-
    balance gains (lognormal, sigma 3%*level) — auto-exposure/AWB flicker
    that breaks "colors are constant across frames" assumptions.

    ``level`` 1.0 ~ a real Kinect at these ranges; 2-3 = stress."""
    z = np.asarray(depth, np.float64)
    sigma = (0.0012 + 0.0019 * np.square(np.clip(z, 0.4, None) - 0.4))
    zn = np.where(z > 0, z + rng.normal(size=z.shape) * sigma * level, 0.0)
    zn = np.clip(zn, 0.0, None)
    # occlusion-boundary detector: the 1D second difference
    # |z - (left+right)/2| is ~0 on any PLANAR ramp however steep (a
    # linear ramp's center is its neighbor average) and ~half the step
    # size at a discontinuity. (A 3x3-median test fails here: on a
    # STRAIGHT step edge each pixel's window holds a 6-of-9 majority of
    # its own side, so the median equals the pixel and never fires; a raw
    # min/max relief test would instead fire on every slanted surface at
    # coarse resolutions, where the pixel footprint ~z/fx is cm-scale.)
    zp = np.pad(z, 1, mode="edge")
    lap_x = np.abs(z - 0.5 * (zp[1:-1, :-2] + zp[1:-1, 2:]))
    lap_y = np.abs(z - 0.5 * (zp[:-2, 1:-1] + zp[2:, 1:-1]))
    drop = (np.maximum(lap_x, lap_y) > 0.05) \
        & (rng.random(z.shape) < min(0.9, 0.25 * level))
    if fx is not None:
        # grazing incidence: one pixel subtends z/fx meters laterally, so
        # |grad z| * fx / z approximates tan(angle between surface and the
        # viewing ray's normal plane); > 4 ~ 76 deg. Gate on the MIN of the
        # two one-sided x/y differences so occlusion steps (one-sided by
        # construction) don't double-count — they're handled above.
        gy_f = np.abs(np.diff(z, axis=0, append=z[-1:, :]))
        gy_b = np.abs(np.diff(z, axis=0, prepend=z[:1, :]))
        gx_f = np.abs(np.diff(z, axis=1, append=z[:, -1:]))
        gx_b = np.abs(np.diff(z, axis=1, prepend=z[:, :1]))
        slope = np.maximum(np.minimum(gy_f, gy_b), np.minimum(gx_f, gx_b))
        tan_inc = slope * fx / np.clip(z, 0.4, None)
        drop |= (tan_inc > 4.0) & (rng.random(z.shape)
                                   < min(0.9, 0.5 * level))
    zn = np.where(drop, 0.0, zn)
    exposure = np.exp(rng.normal(0.0, 0.06 * level))
    wb = np.exp(rng.normal(0.0, 0.03 * level, size=3))
    rgbn = np.clip(
        rgb.astype(np.float64) * (exposure * wb)[None, None, :]
        + rng.normal(size=rgb.shape) * 3.0 * level,
        0, 255,
    ).astype(np.uint8)
    return rgbn, zn


def perturb_pose(t_wc: np.ndarray, rng, level: float = 1.0,
                 drift: np.ndarray | None = None):
    """SLAM-grade pose error: the WRITTEN trajectory differs from the pose
    the frame was actually rendered with. Per-frame jitter (sigma 3 mm
    translation / 0.15 deg rotation, x level) composed onto a slowly
    random-walking drift (sigma 1 mm / 0.05 deg per frame, x level) —
    tracking error is autocorrelated, not white. Returns (perturbed pose,
    new drift 6-vector [rx ry rz tx ty tz])."""
    if drift is None:
        drift = np.zeros(6)
    drift = drift + np.concatenate([
        rng.normal(0.0, np.deg2rad(0.05) * level, 3),
        rng.normal(0.0, 0.001 * level, 3),
    ])
    jitter = np.concatenate([
        rng.normal(0.0, np.deg2rad(0.15) * level, 3),
        rng.normal(0.0, 0.003 * level, 3),
    ])
    err = drift + jitter

    def _rot(v):
        ang = np.linalg.norm(v)
        if ang < 1e-12:
            return np.eye(3)
        k = v / ang
        kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
        return np.eye(3) + np.sin(ang) * kx + (1 - np.cos(ang)) * (kx @ kx)

    t = np.array(t_wc, np.float64)
    t[:3, :3] = _rot(err[:3]) @ t[:3, :3]
    t[:3, 3] = t[:3, 3] + err[3:]
    return t, drift


# write_raw_scene renders and writes this many frames at once
_WRITE_THREADS = 4


def write_raw_scene(root, scene, dirs_c, n_frames: int = 40,
                    orbit_kwargs: dict | None = None, assoc_stride: int = 10,
                    gt_dir: str = "gt_instance", depth_scale: float = 1e-3,
                    noise_level: float = 0.0, noise_seed: int = 7):
    """Write a RAW scene directory (rgb/, depth/, traj_w_c.txt — exactly
    what a sensor provides) plus held-aside GT instance maps under
    ``gt_dir`` (one per assoc frame, uint16) for scoring association
    output the perception stages never saw. Returns the list of GT maps.

    ``noise_level`` > 0 passes every written frame through
    ``apply_sensor_noise`` (GT maps stay clean) AND perturbs the WRITTEN
    trajectory with ``perturb_pose`` (autocorrelated SLAM-style error:
    frames are rendered at the true pose, the traj file lies by a few mm
    and ~0.1-0.2 deg — what a real tracked sequence hands downstream).
    Frames are rendered and written on _WRITE_THREADS threads (numpy and
    zlib release the GIL); the noise draws in frame order between the two."""
    import os
    from concurrent.futures import ThreadPoolExecutor

    from openobj_torch.utils.png import write_png

    ok = orbit_kwargs or {}
    for d in ("rgb", "depth", gt_dir):
        os.makedirs(os.path.join(root, d), exist_ok=True)
    rng_noise = np.random.default_rng(noise_seed) if noise_level else None
    # pixel-footprint scale for grazing-incidence dropout: dirs use the
    # z=1 convention, so one column step is 1/fx in x
    fx_eff = float(1.0 / max(abs(dirs_c[0, 1, 0] - dirs_c[0, 0, 0]), 1e-9))
    true_poses = [orbit_pose(2 * np.pi * i / n_frames, **ok) for i in range(n_frames)]

    def write(i, frame):
        rgb, depth, inst = frame
        write_png(os.path.join(root, "rgb", f"rgb_{i}.png"), rgb)
        write_png(os.path.join(root, "depth", f"depth_{i}.png"),
                  (depth / depth_scale).astype(np.uint16))
        if i % assoc_stride:
            return None
        gt = inst.astype(np.uint16)
        write_png(os.path.join(root, gt_dir, f"semantic_instance_{i // assoc_stride}.png"), gt)
        return gt.astype(np.int32)

    with ThreadPoolExecutor(_WRITE_THREADS) as ex:
        frames = list(ex.map(lambda t: scene.render(t, dirs_c), true_poses))
        poses, drift = [], None
        for i, t_wc in enumerate(true_poses):
            if rng_noise is not None:
                t_wc, drift = perturb_pose(t_wc, rng_noise, noise_level, drift)
                rgb, depth = apply_sensor_noise(*frames[i][:2], rng_noise, noise_level,
                                                fx=fx_eff)
                frames[i] = (rgb, depth, frames[i][2])
            poses.append(np.asarray(t_wc).reshape(-1))
        maps = list(ex.map(write, range(n_frames), frames))
    np.savetxt(os.path.join(root, "traj_w_c.txt"), np.stack(poses),
               delimiter=" ")
    return [m for m in maps if m is not None]


def orbit_pose(angle: float, radius: float = 2.6, height: float = 0.0) -> np.ndarray:
    """Camera on a horizontal orbit, looking at the origin. OpenCV-style
    camera: +z forward, +x right, +y down."""
    eye = np.array([radius * np.cos(angle), radius * np.sin(angle), height])
    fwd = -eye / np.linalg.norm(eye)
    up_w = np.array([0.0, 0.0, -1.0])
    right = np.cross(fwd, up_w)
    right /= np.linalg.norm(right)
    y_cam = np.cross(fwd, right)  # right-handed basis: z = x cross y
    y_cam /= np.linalg.norm(y_cam)
    t = np.eye(4)
    t[:3, 0] = right
    t[:3, 1] = y_cam
    t[:3, 2] = fwd
    t[:3, 3] = eye
    return t


def make_sequence(scene: SyntheticScene, dirs_c: np.ndarray, n_frames: int = 12):
    """Yield (rgb, depth, inst, t_wc) around an orbit."""
    for i in range(n_frames):
        t_wc = orbit_pose(2 * np.pi * i / n_frames)
        rgb, depth, inst = scene.render(t_wc, dirs_c)
        yield rgb, depth, inst, t_wc
