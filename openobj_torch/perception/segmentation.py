"""First-party RGB-D entity segmentation — the default stage-1 segmenter.

Port of ``openobj_tpu.perception.segmentation``: host numpy in float64, as
in the JAX package, so the labels come out equal element for element. The
sequential merge pass runs in the native library
(``native.felz_union_find``) and raises where it cannot be built; the Python
loop (``_union_find_python``) is kept only as the plain version that the
tests hold the native one against.

The reference's stage 1 runs CropFormer, a pretrained entity-segmentation
transformer (maskclustering/mask_gen.py:231-367). That
model is third-party weights the framework cannot ship; the pluggable
``segmenter`` callable (mask_generation.py) accepts any replacement. This
module provides a weights-free default so the FULL perception pipeline —
segmentation -> captions -> features -> association -> training — runs
end-to-end on raw posed RGB-D with no external models mounted.

Algorithm: Felzenszwalb–Huttenlocher efficient graph segmentation
(IJCV 2004 — the published algorithm, implemented from the paper) over the
4-connected pixel grid, with an RGB-D edge weight:

    w(a, b) = (1 - dw) * ||rgb_a - rgb_b||_2 / (255 * sqrt(3))
            +      dw  * min(1, jump(a, b) / (rel * min(z_a, z_b)))

where ``jump`` is the SLOPE-COMPENSATED depth discontinuity: the raw
difference z_b - z_a minus the slope predicted by the neighboring pixel
on either side, taking the SMALLER of the two deviations. A smooth
surface — however slanted, at whatever resolution — has jump ~ 0 because
adjacent differences repeat; an occluding step keeps jump ~ |z_b - z_a|
because neither side's slope predicts it. The min (not max) matters:
edges one pixel away from a step have one contaminated side (its
neighbor d1 crosses the step) but a clean matching side — max would
charge them the full step and peel persistent 1-px sliver segments off
every occlusion boundary. The cost of min is that concave creases
(wall meets floor) score ~0 in depth — the matching-side slope predicts
the crease edge — so crease separation falls to the color term and,
downstream, to the geometric bg anchoring (merge.classify_bg_hull
handles multi-plane unions). A raw first difference would instead
charge every edge on a slanted surface its full per-pixel depth step,
which fragments walls viewed at grazing angles and any smooth surface
at small image sizes (per-pixel slope scales with 1/width). Depth discontinuities are the
strongest object-boundary evidence an RGB-D frame carries (a relative
gap, so a 2 cm step at 0.5 m counts like an 8 cm step at 2 m); color
separates objects lying flush against their support (a book on a desk).
Pixels with invalid depth (z <= 0) fall back to the color term alone. Components are entities in CropFormer's class-agnostic
sense — walls and floors segment too, and the association stage's caption
anchoring (merge.py) is what routes them to the reserved background ids.

Scores: the downstream contract filters at ``score >= score_thresh`` and
paints masks best-last (mask_generation.py:42-57). A weights-free
segmenter has no learned confidence, so the score is a size/boundary-
contrast proxy in (0, 1]: larger, crisper components rank higher.
"""

from __future__ import annotations

import numpy as np


def _union_find_segment(n_px: int, edges_a, edges_b, weights, k: float,
                        min_size: int):
    """Felzenszwalb merge pass + small-component cleanup.

    edges must be PRE-SORTED by weight ascending. Returns the root label
    of every pixel. The merge loop is inherently sequential (each decision
    depends on the components built so far), so it runs in the native C++
    kernel (native/geometry.cc felz_union_find, ~50x the Python loop)."""
    from openobj_torch import native

    return native.felz_union_find(edges_a, edges_b, weights, n_px, k, min_size)


def _union_find_python(n_px: int, edges_a, edges_b, weights, k: float,
                       min_size: int):
    """The plain version of ``_union_find_segment`` (~1.6 s/Mpx), the
    same merge rule and cleanup in a Python loop."""
    parent = np.arange(n_px, dtype=np.int64)
    size = np.ones(n_px, dtype=np.int64)
    # max internal edge weight of the component rooted here (paper's Int(C))
    internal = np.zeros(n_px, dtype=np.float64)

    def find(x):
        root = x
        while parent[root] != root:
            root = parent[root]
        while parent[x] != root:        # path compression
            parent[x], x = root, parent[x]
        return root

    ea = edges_a.tolist()
    eb = edges_b.tolist()
    ws = weights.tolist()
    for a, b, w in zip(ea, eb, ws):
        ra, rb = find(a), find(b)
        if ra == rb:
            continue
        # MInt(C1, C2) = min(Int(C1) + k/|C1|, Int(C2) + k/|C2|)
        if w <= min(internal[ra] + k / size[ra],
                    internal[rb] + k / size[rb]):
            if size[ra] < size[rb]:
                ra, rb = rb, ra
            parent[rb] = ra
            size[ra] += size[rb]
            internal[ra] = w            # edges arrive sorted: w is the max
    # post-process (paper §4): absorb any component < min_size into the
    # neighbor across its cheapest boundary edge
    for a, b in zip(ea, eb):
        ra, rb = find(a), find(b)
        if ra != rb and (size[ra] < min_size or size[rb] < min_size):
            if size[ra] < size[rb]:
                ra, rb = rb, ra
            parent[rb] = ra
            size[ra] += size[rb]
    return np.asarray([find(i) for i in range(n_px)], dtype=np.int64)


def _rag_merge(labels: np.ndarray, ea, eb, cd, dd, col_flat: np.ndarray,
               theta_color: float, theta_depth: float,
               max_iters: int = 4,
               jump=None, nb_slope=None, zmin=None, fx: float | None = None,
               contig_px: float = 0.35, headon_px: float = 0.25,
               headon_frac: float = 0.3) -> np.ndarray:
    """Region-adjacency merge pass: fuse neighboring components whose
    shared boundary has MEDIAN color distance < ``theta_color`` AND
    MEDIAN depth discontinuity < ``theta_depth`` AND whose region MEAN
    colors differ by < ``theta_color`` (each cue judged separately, NOT
    on the blended union-find weight).

    Felzenszwalb's criterion is size-adaptive (MInt shrinks as k/|C|), so
    large smooth components stop merging long before their boundaries are
    object-like: a close-up sphere peels into limb bands, a wall into
    corner patches — measured on the sphere fixture, the spurious internal
    boundaries have median weight 0.01-0.10 while true object boundaries
    sit at ~0.8. The cues must be tested SEPARATELY because two touching
    objects (a sphere resting against a torus, boxes in contact) have a
    depth-smooth seam whose blended weight (0.3·cd) can dip under any
    single threshold that still re-fuses same-surface fragments — the
    color median keeps them apart while the depth median re-fuses limb
    bands. The median over the WHOLE shared boundary is robust to the
    handful of high-weight edges at a limb, while an object resting on a
    support keeps its identity because most of its outline is a depth
    step (only the contact band is smooth).

    The region-MEAN test exists for MIXED SLIVERS: min-size absorption
    can weld a few cut-off pixels of object A onto a fragment of
    touching object B (A-side rim edges are depth-expensive, the A|B
    contact edge is the cheapest boundary left), producing a two-color
    sliver whose boundary to EACH parent object is internally solid —
    boundary medians read 0.0 both ways and the sliver bridges two
    distinct objects into one region (measured: a 21 px green+blue
    sliver fusing a tangent sphere into the box it rests on). The
    sliver's mean color is far from both pure parents, so the mean test
    kills exactly the bridge while same-surface fragments (identical
    means) and shading-varied real surfaces (means average out) pass.

    A second, color-INDEPENDENT branch (enabled when ``fx`` is given)
    merges TEXTURE BANDS: region chains whose shared seams are HEAD-ON
    DEPTH-CONTINUOUS — among seam edges viewed head-on (neighboring
    per-pixel slope below ``headon_px`` x the pixel's world footprint
    dx = z/fx), the median slope-compensated jump is below ``contig_px``
    x dx, with head-on edges >= ``headon_frac`` of the seam (and >= 4).
    Stripes/checker painted ON one smooth surface produce fragments
    whose seams are geometrically seamless — zero-thickness color
    regions are texture, not objects. Measured separations that set the
    constants (perception stress matrix, 96x72, dx ~ 37 mm): stripe-band
    seams median jump 0-8 mm (~0.2 dx, MERGE) vs boxes in exact contact
    21-26 mm (~0.6 dx, KEEP, their faces are offset), sphere-on-table
    contact 27 mm (KEEP), tangency 155 mm (KEEP). The head-on gate is
    what makes the rule safe near silhouettes: at a curved object's limb
    the grazing slope "explains" the occlusion step (slope-compensated
    jump ~ 0 against the wall behind!), but those limb edges all fail
    the head-on test — without the gate this branch would weld objects
    into their backgrounds.

    Continuity alone cannot tell a stripe band from a book lying flat
    on a desk (both are zero-thickness color patches on a smooth
    surface; only semantics differ), so the branch additionally demands
    COLOR REPETITION: candidate pairs form components, and a component
    merges only if it has >= 3 regions AND two NON-ADJACENT regions
    with near-equal mean colors (< theta_color). A striped/checkered
    surface alternates a small palette — the repeat is structural and
    skips a band; a single flush object never repeats (component of 2),
    and distinct-colored touching objects have no repeat at all
    (measured: pure pairwise continuity welded the touching-boxes
    archetype 0.828 -> 0.346 before this gate; per-frame fragment seams
    occasionally dip under any threshold). Non-adjacency matters: one
    object's own front+top fragments share a color but also share a
    seam — they must not count as the repeat that licenses welding a
    neighboring object in. Known residual cost, documented: two same-
    flat objects on one surface read as texture and merge — that
    disambiguation takes appearance priors this weights-free path does
    not have (the reference buys them with CropFormer's learned
    weights, mask_gen.py:231-367).

    Iterated to fixpoint: merging two fragments pools their boundaries
    and size-weights their means for the next round."""
    labels = labels.copy()
    do_contig = fx is not None and jump is not None and contig_px > 0
    for _ in range(max_iters):
        la, lb = labels[ea], labels[eb]
        m = la != lb
        if not m.any():
            break
        ids, inv = np.unique(labels, return_inverse=True)
        nreg = len(ids)
        sums = np.zeros((nreg, 3))
        np.add.at(sums, inv, col_flat)
        cnts = np.bincount(inv, minlength=nreg).astype(np.float64)
        means = sums / cnts[:, None]
        pos = {int(v): i for i, v in enumerate(ids)}
        base = np.int64(labels.max()) + 1
        a = np.minimum(la[m], lb[m]).astype(np.int64)
        b = np.maximum(la[m], lb[m]).astype(np.int64)
        key = a * base + b
        order = np.argsort(key, kind="stable")
        key_s = key[order]
        cd_s, dd_s = cd[m][order], dd[m][order]
        if do_contig:
            jp_s = jump[m][order]
            dx_s = zmin[m][order] / float(fx)       # pixel world footprint
            ho_s = (nb_slope[m][order] < headon_px * dx_s) & (dx_s > 0)
        uniq, starts = np.unique(key_s, return_index=True)
        ends = np.append(starts[1:], len(key_s))
        merged = False
        parent: dict[int, int] = {}

        def find(x):
            while parent.get(x, x) != x:
                parent[x] = parent.get(parent[x], parent[x])
                x = parent[x]
            return x

        contig_pairs: list[tuple[int, int]] = []
        adjacent: set[tuple[int, int]] = set()
        for kk, s, e in zip(uniq, starts, ends):
            ia, ib = int(kk // base), int(kk % base)
            adjacent.add((ia, ib))
            mean_d = float(np.sqrt(
                ((means[pos[ia]] - means[pos[ib]]) ** 2).mean()
            ))
            ok = (mean_d < theta_color
                  and float(np.median(cd_s[s:e])) < theta_color
                  and float(np.median(dd_s[s:e])) < theta_depth)
            if not ok and do_contig:
                ho = ho_s[s:e]
                n_ho = int(ho.sum())
                if (n_ho >= 4 and n_ho >= headon_frac * (e - s)
                        and float(np.median(jp_s[s:e][ho])) < (
                            contig_px * float(np.median(dx_s[s:e][ho])))):
                    contig_pairs.append((ia, ib))
            if ok:
                pa, pb = find(ia), find(ib)
                if pa != pb:
                    parent[pb] = pa
                    merged = True
        if contig_pairs:
            # color-repetition gate (docstring): group the continuity
            # candidates, merge only components with a structural repeat
            cpar: dict[int, int] = {}

            def cfind(x):
                while cpar.get(x, x) != x:
                    cpar[x] = cpar.get(cpar[x], cpar[x])
                    x = cpar[x]
                return x

            for ia, ib in contig_pairs:
                ra2, rb2 = cfind(ia), cfind(ib)
                if ra2 != rb2:
                    cpar[rb2] = ra2
            comps: dict[int, list[int]] = {}
            members = {r for p in contig_pairs for r in p}
            for r in members:
                comps.setdefault(cfind(r), []).append(r)
            for comp in comps.values():
                if len(comp) < 3:
                    continue
                repeat = False
                for xi in range(len(comp)):
                    for yi in range(xi + 1, len(comp)):
                        u, v = comp[xi], comp[yi]
                        if (min(u, v), max(u, v)) in adjacent:
                            continue
                        du = float(np.sqrt(
                            ((means[pos[u]] - means[pos[v]]) ** 2).mean()
                        ))
                        if du < theta_color:
                            repeat = True
                            break
                    if repeat:
                        break
                if repeat:
                    r0 = comp[0]
                    for r in comp[1:]:
                        pa, pb = find(r0), find(r)
                        if pa != pb:
                            parent[pb] = pa
                            merged = True
        if not merged:
            break
        # vectorized remap: labels are union-find roots, so a dense
        # unique->inverse pass + one ndarray LUT lookup replaces the
        # per-pixel Python lambda (np.vectorize) that dominated merge
        # iterations at full resolution
        uniq, inv = np.unique(labels, return_inverse=True)
        lut = np.asarray([find(int(r)) for r in uniq], dtype=labels.dtype)
        labels = lut[inv].reshape(labels.shape)
    return labels


def _box_mean(img: np.ndarray, r: int) -> np.ndarray:
    """Mean over (2r+1)² windows (edge-replicated), via an integral image."""
    size = 2 * r + 1
    p = np.pad(img, ((r, r), (r, r), (0, 0)), mode="edge").astype(np.float64)
    s = np.zeros((p.shape[0] + 1, p.shape[1] + 1, img.shape[2]))
    s[1:, 1:] = p.cumsum(0).cumsum(1)
    tot = (s[size:, size:] - s[:-size, size:]
           - s[size:, :-size] + s[:-size, :-size])
    return tot / float(size * size)


def felzenszwalb_rgbd(
    rgb: np.ndarray,
    depth: np.ndarray | None = None,
    k: float = 3.0,
    min_size: int = 64,
    depth_weight: float = 0.7,
    rel_depth: float = 0.08,
    slope_tol: float = 3.0,
    merge_color: float = 0.12,
    merge_depth: float = 0.30,
    texture_window: int = 2,
    texture_grad: float = 0.10,
    texture_frac: float = 0.25,
    fx: float | None = None,
    contig_px: float = 0.35,
) -> np.ndarray:
    """Segment one (sub-sampled) RGB-D frame -> int label image [H, W].

    ``fx`` (the focal length of THIS image, i.e. already divided by any
    subsampling stride) enables the head-on depth-continuity merge in
    the RAG pass (texture bands painted on one smooth surface re-fuse
    regardless of color; see _rag_merge). None = off. ``contig_px`` is
    its jump threshold in pixel-world-footprint units.

    ``slope_tol`` scales the slope-proportional depth tolerance: an edge
    whose slope-compensated jump stays below slope_tol x the neighboring
    per-pixel slope is treated as the same surface (admits the hyperbolic
    curvature of a plane under perspective at any grazing angle, which a
    fixed relative tolerance cannot — the per-pixel slope scales with
    1/image-width, so small frames and steep surfaces would fragment).

    ``texture_window`` > 0 makes the color cue texture-robust: where BOTH
    sides of an edge are locally textured (per-window color std above
    ``texture_std``), the edge color distance is min(raw pixel distance,
    distance between the two sides' SHIFTED local-mean colors) — for the
    edge (a, b) the windows are re-centered ``w`` pixels AWAY from the
    edge, so each (2w+1)² window lies (mostly) on its own side. A
    high-frequency pattern (stripes, checker, speckle) has large raw
    distances at every internal band boundary but near-identical side
    means — each side's window averages over the same pattern mix — so
    texture edges score ~0. The GATE is what keeps small solid objects
    alive: without it, the shifted windows of two adjacent tiny
    solid-colored objects (a 10 px torus beside a 10 px sphere) overshoot
    their own object and the min() erases exactly the seam that separates
    them. The gate statistic is the strong-edge FRACTION (share of window
    pixels whose own raw gradient exceeds ``texture_grad``), not local
    color variance: a clean boundary raises the variance of every window
    it crosses — boundary-induced variance is indistinguishable from
    texture — but it contributes only its thin outline to the edge count
    (~2·(2w+1) of (2w+1)² pixels ≈ 12%% at w=2), while genuine texture
    has strong interior edges every few pixels (> 25%%). Only edges whose
    BOTH side windows exceed ``texture_frac`` use the mean-based
    distance. ``merge_color``/``merge_depth`` gate the region-adjacency
    merge pass (_rag_merge); <= 0 disables it."""
    h, w = rgb.shape[:2]
    col = np.asarray(rgb, np.float64) / 255.0
    col_m = tex_frac = None
    if texture_window > 0:
        col_m = _box_mean(col, texture_window)
        # strong-edge indicator per pixel: its right or down raw gradient
        # exceeds texture_grad
        gh = np.sqrt(((col[:, 1:] - col[:, :-1]) ** 2).sum(-1) / 3.0)
        gv = np.sqrt(((col[1:, :] - col[:-1, :]) ** 2).sum(-1) / 3.0)
        strong = np.zeros((h, w))
        strong[:, :-1] = np.maximum(strong[:, :-1], gh > texture_grad)
        strong[:-1, :] = np.maximum(strong[:-1, :], gv > texture_grad)
        tex_frac = _box_mean(strong[..., None], texture_window)[..., 0]
    idx = np.arange(h * w).reshape(h, w)

    def _depth_jump(z: np.ndarray):
        """Slope-compensated discontinuity for edges along axis 1.

        z is [H, W] (transpose for vertical edges); returns a pair of
        [H, W-1] arrays (jump, nb_slope) — for the edge (i, j)-(i, j+1):
        jump is the MIN over both sides of |d1 - neighbor's d1| (a smooth,
        even slanted, surface repeats d1 on at least one side; an
        occlusion step matches neither neighbor — and min keeps the
        step's immediate-neighbor edges cheap, see module docstring), and
        nb_slope is the smaller neighboring |d1| (the surface's own
        per-pixel depth slope, used to scale the tolerance: a
        perspective-projected plane's depth is hyperbolic along a pixel
        row, so its second difference grows with slope — |d2| <=
        2 |d1|^2 / z — while a true step dwarfs either side's slope).
        Missing/invalid neighbors fall back to |d1| / 0.
        """
        d1 = z[:, 1:] - z[:, :-1]                       # [H, W-1]
        valid = (z[:, 1:] > 0) & (z[:, :-1] > 0)
        big = np.abs(d1).max() + 1.0 if d1.size else 1.0
        # deviation vs the slope on the left / right of the edge
        dev_l = np.abs(d1)
        dev_l[:, 1:] = np.where(valid[:, :-1],
                                np.abs(d1[:, 1:] - d1[:, :-1]),
                                dev_l[:, 1:])
        dev_r = np.abs(d1)
        dev_r[:, :-1] = np.where(valid[:, 1:],
                                 np.abs(d1[:, :-1] - d1[:, 1:]),
                                 dev_r[:, :-1])
        # smaller neighboring slope (invalid side -> +inf so min picks
        # the other; both invalid -> 0, disabling the slope tolerance)
        sl_l = np.full_like(d1, big)
        sl_l[:, 1:] = np.where(valid[:, :-1], np.abs(d1[:, :-1]), big)
        sl_r = np.full_like(d1, big)
        sl_r[:, :-1] = np.where(valid[:, 1:], np.abs(d1[:, 1:]), big)
        nb = np.minimum(sl_l, sl_r)
        nb[nb >= big] = 0.0
        return np.minimum(dev_l, dev_r), nb

    zmap = np.asarray(depth, np.float64) if depth is not None else None
    if zmap is not None:
        jump_h, nb_h = _depth_jump(zmap)
        jv, nv = _depth_jump(zmap.T)
        jump_v, nb_v = jv.T, nv.T
    else:
        jump_h = nb_h = jump_v = nb_v = None

    def edge_set(sl_a, sl_b, jump, nb_slope, axis):
        a = idx[sl_a].reshape(-1)
        b = idx[sl_b].reshape(-1)
        cd_raw = np.sqrt(
            ((col[sl_a] - col[sl_b]) ** 2).sum(-1).reshape(-1) / 3.0
        )
        # texture-robust color term for the UNION-FIND weight only. The
        # RAG merge judges RAW color: fragments it re-fuses come from the
        # size-adaptive criterion (limb bands, wall patches — same surface
        # color, raw cd ~ 0), never from texture (texture edges are ~0
        # here, so textured regions don't fragment in the first place)
        cd = cd_raw
        if col_m is not None:
            # Gate centers a full window DIAMETER into each side (not
            # just the radius): a genuine texture extends — it is still
            # edge-dense 2r+1 px from any internal band boundary — while
            # around the seam between two adjacent small solid objects the
            # deep probes land on smooth surface (their own solid
            # interiors or the support) and read ~0, so the gate shuts
            # and the seam keeps its raw contrast. At the radius, every
            # window still touches the edge and a small object's own
            # OUTLINE saturates the statistic (measured: seam windows
            # 0.20-0.44 vs texture interiors 0.20-0.36 — inseparable;
            # at the diameter the seam sides read ~0 and textures keep
            # >= 0.3). Known cost: texture band edges within 2r+1 px of
            # the object silhouette lose the guard (the outer probe exits
            # the object) and may fragment — the association's 3D-overlap
            # cue re-groups those rim fragments downstream; variants that
            # kept the guard alive at the rim (radius-only min, radius-min
            # AND diameter-max) measurably re-merged adjacent small
            # objects end-to-end, which no downstream stage can undo.
            r = 2 * texture_window + 1
            n = col.shape[axis]
            lo = np.maximum(np.arange(n - 1) - r, 0)          # side-a centers
            hi = np.minimum(np.arange(1, n) + r, n - 1)       # side-b centers
            ma = col_m[:, lo] if axis == 1 else col_m[lo, :]
            mb = col_m[:, hi] if axis == 1 else col_m[hi, :]
            fa = tex_frac[:, lo] if axis == 1 else tex_frac[lo, :]
            fb = tex_frac[:, hi] if axis == 1 else tex_frac[hi, :]
            textured = (np.minimum(fa, fb) > texture_frac).reshape(-1)
            mean_d = np.sqrt(((ma - mb) ** 2).sum(-1).reshape(-1) / 3.0)
            cd = np.where(textured, np.minimum(cd, mean_d), cd)
        if zmap is not None:
            za = zmap[sl_a].reshape(-1)
            zb = zmap[sl_b].reshape(-1)
            valid = (za > 0) & (zb > 0)
            zmn = np.where(valid, np.minimum(za, zb), 0.0)
            tol = np.maximum(rel_depth * np.minimum(za, zb),
                             slope_tol * nb_slope.reshape(-1))
            jp = np.where(valid, jump.reshape(-1), np.inf)
            dd = np.where(valid, np.minimum(
                jump.reshape(-1) / np.maximum(tol, 1e-6), 1.0), 0.0)
            # max, not a convex blend: either cue alone asserts a
            # boundary. A convex blend buries the color seam between two
            # TOUCHING objects (depth-smooth contact => w = 0.3*cd, under
            # early-stage k/|C|) — with the local-mean texture guard on cd
            # the raw-color veto is safe to restore to full strength
            wgt = np.where(valid, np.maximum(cd, depth_weight * dd), cd)
            nbs = nb_slope.reshape(-1)
        else:
            dd = np.zeros_like(cd)
            wgt = cd
            jp = np.full_like(cd, np.inf)
            nbs = np.zeros_like(cd)
            zmn = np.zeros_like(cd)
        return a, b, wgt, cd_raw, dd, jp, nbs, zmn

    ar, br, wr, cr, dr, jr, nr, zr = edge_set(
        np.s_[:, :-1], np.s_[:, 1:], jump_h, nb_h, axis=1)
    ad, bd, wd, cdn, ddn, jdn, ndn, zdn = edge_set(
        np.s_[:-1, :], np.s_[1:, :], jump_v, nb_v, axis=0)
    ea = np.concatenate([ar, ad])
    eb = np.concatenate([br, bd])
    ws = np.concatenate([wr, wd])
    cds = np.concatenate([cr, cdn])
    dds = np.concatenate([dr, ddn])
    jps = np.concatenate([jr, jdn])
    nbs = np.concatenate([nr, ndn])
    zms = np.concatenate([zr, zdn])
    order = np.argsort(ws, kind="stable")
    labels = _union_find_segment(
        h * w, ea[order], eb[order], ws[order], k, min_size
    )
    if merge_color > 0 and merge_depth > 0:
        labels = _rag_merge(labels, ea, eb, cds, dds, col.reshape(-1, 3),
                            merge_color, merge_depth,
                            jump=jps, nb_slope=nbs, zmin=zms, fx=fx,
                            contig_px=contig_px)
    return labels.reshape(h, w)


class GraphSegmenter:
    """Weights-free default for the stage-1 ``segmenter`` slot.

    ``segmenter(rgb [, depth]) -> (masks [N, H, W] bool, scores [N])`` —
    mask_generation.py's injection signature, with the optional depth the
    RGB-D pipeline passes when it has one. ``stride`` sub-samples the
    pixel grid before segmenting (the union-find is sequential Python);
    masks are nearest-upsampled back to full resolution, which is exact
    for region masks up to the stride's boundary quantization — the
    association stage's 3D evidence (projection.py DBSCAN denoise) eats
    that jitter by design.
    """

    def __init__(self, k: float = 3.0, min_size: int = 64,
                 depth_weight: float = 0.7, rel_depth: float = 0.08,
                 stride: int = 2, max_masks: int = 64,
                 slope_tol: float = 3.0, merge_color: float = 0.12,
                 merge_depth: float = 0.30, texture_window: int = 2,
                 texture_grad: float = 0.10, texture_frac: float = 0.25,
                 fx: float | None = None, contig_px: float = 0.35):
        self.k = k
        self.min_size = min_size
        self.depth_weight = depth_weight
        self.rel_depth = rel_depth
        self.stride = stride
        self.max_masks = max_masks
        self.slope_tol = slope_tol
        self.merge_color = merge_color
        self.merge_depth = merge_depth
        self.texture_window = texture_window
        self.texture_grad = texture_grad
        self.texture_frac = texture_frac
        # full-resolution focal length; scaled by stride at call time.
        # Enables the head-on depth-continuity (texture-band) RAG merge.
        self.fx = fx
        self.contig_px = contig_px

    def __call__(self, rgb: np.ndarray, depth: np.ndarray | None = None):
        h, w = rgb.shape[:2]
        s = self.stride
        rgb_s = rgb[::s, ::s]
        depth_s = depth[::s, ::s] if depth is not None else None
        labels = felzenszwalb_rgbd(
            rgb_s, depth_s, self.k, self.min_size,
            self.depth_weight, self.rel_depth, self.slope_tol,
            self.merge_color, self.merge_depth, self.texture_window,
            self.texture_grad, self.texture_frac,
            fx=None if self.fx is None else self.fx / s,
            contig_px=self.contig_px,
        )
        if s > 1:   # nearest-neighbor upsample back to [H, W]
            labels = labels.repeat(s, 0)[:h].repeat(s, 1)[:, :w]

        ids, counts = np.unique(labels, return_counts=True)
        order = np.argsort(-counts)[: self.max_masks]
        masks, scores = [], []
        col = np.asarray(rgb, np.float64) / 255.0
        # boundary contrast: mean color distance across the mask's right/
        # down boundary edges (crisper boundaries -> higher confidence)
        dx = np.sqrt(((col[:, :-1] - col[:, 1:]) ** 2).sum(-1) / 3.0)
        dy = np.sqrt(((col[:-1, :] - col[1:, :]) ** 2).sum(-1) / 3.0)
        for i in order:
            m = labels == ids[i]
            bx = m[:, :-1] ^ m[:, 1:]
            by = m[:-1, :] ^ m[1:, :]
            nb = bx.sum() + by.sum()
            contrast = (
                (dx[bx].sum() + dy[by].sum()) / nb if nb else 0.0
            )
            # size factor saturates at ~4x min area; contrast in [0, 1]
            sz = 1.0 - np.exp(-counts[i] / (4.0 * self.min_size * s * s))
            scores.append(float(np.clip(0.5 + 0.5 * sz * (0.5 + contrast),
                                        0.0, 1.0)))
            masks.append(m)
        if not masks:
            return (np.zeros((0, h, w), bool), np.zeros((0,), np.float64))
        return np.stack(masks), np.asarray(scores, np.float64)
