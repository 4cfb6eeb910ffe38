"""The viewer side of the port against the JAX package: viewer_math, the
class tables, the YAML reader, the colourings, the HTML and the encoders.

All of it is host code (numpy and Python), so the comparisons are exact:
the JS strings, the class tables and ``write_yaml``'s bytes, the uint8
colourings, the HTML bytes, the encoders' arrays and the twins' floats are
equal, not close. The JAX package's part-feature PCA colouring calls
scikit-learn's PCA, whose default solver at 512 features and few rows is a
randomized one, seeded afresh on every call; the ``exact_pca`` fixture holds
it to its exact ("full") solver, which the port's numpy PCA reproduces.
sklearn computes it in float32 on float32 features and the port in float64;
their colours differ by ~1e-6 before the uint8 cast, and are equal after it
on these bundles. PyYAML is
used here only, as the reference the port's reader is held to.
"""

import functools
import gzip
import os
import pickle

import numpy as np
import pytest
import sklearn.decomposition
import yaml

import openobj_tpu
from openobj_tpu.viz import class_tables as jct
from openobj_tpu.viz import colors as jcolors
from openobj_tpu.viz import query as jquery
from openobj_tpu.viz import viewer as jviewer
from openobj_tpu.viz import viewer_math as jvm
from openobj_torch.utils import yaml_subset
from openobj_torch.viz import class_tables as tct
from openobj_torch.viz import colors as tcolors
from openobj_torch.viz import query as tquery
from openobj_torch.viz import viewer as tviewer
from openobj_torch.viz import viewer_math as tvm
from torch_threads import one_torch_thread  # noqa: E402,F401

TABLES = [("replica", False), ("replica", True), ("scannet", False)]
SKLEARN_PCA = sklearn.decomposition.PCA
PCA_ATOL = 1e-12      # float64 PCA colours in [0, 1], eigh or SVD on both sides


@pytest.fixture(autouse=True)
def exact_pca(monkeypatch):
    monkeypatch.setattr(sklearn.decomposition, "PCA",
                        functools.partial(sklearn.decomposition.PCA, svd_solver="full"))


def make_bundle(n_v: int = 20, seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    b = {}
    for oid in (4, 7, 9):
        clip = rng.normal(size=(3, 512)).astype(np.float32)
        cap = rng.normal(size=(3, 384)).astype(np.float32)
        b[oid] = {
            "mesh": {"vertices": rng.normal(size=(n_v, 3)).astype(np.float32),
                     "faces": rng.integers(0, n_v, (12, 3)).astype(np.int32)},
            "color": rng.integers(0, 255, (n_v, 3)).astype(np.uint8),
            "part_feat": rng.normal(size=(n_v, 512)).astype(np.float32),
            "clip_feat": clip / np.linalg.norm(clip, axis=-1, keepdims=True),
            "caption_feat": cap / np.linalg.norm(cap, axis=-1, keepdims=True),
            "class_id": oid % 3 + 18,
        }
    return b


# --------------------------------------------------------------------------- #
# viewer_math
# --------------------------------------------------------------------------- #


def test_viewer_math_js_and_twins():
    assert tvm.JS_MAT4 == jvm.JS_MAT4 and tvm.JS_ORBIT_EYE == jvm.JS_ORBIT_EYE
    rng = np.random.default_rng(0)
    for _ in range(20):
        fovy, aspect = rng.uniform(0.3, 2.0), rng.uniform(0.5, 2.5)
        near, far = rng.uniform(0.01, 1.0), rng.uniform(5.0, 100.0)
        assert tvm.perspective(fovy, aspect, near, far) == jvm.perspective(
            fovy, aspect, near, far)
        eye, c, up = (list(rng.normal(size=3)) for _ in range(3))
        assert tvm.look_at(eye, c, up) == jvm.look_at(eye, c, up)
        a, b = list(rng.normal(size=16)), list(rng.normal(size=16))
        assert tvm.mat_mul(a, b) == jvm.mat_mul(a, b)
        tgt, r, p, y = list(rng.normal(size=3)), rng.uniform(0.1, 5), *rng.normal(size=2)
        assert tvm.orbit_eye(tgt, r, p, y) == jvm.orbit_eye(tgt, r, p, y)
        assert tvm.project(a, eye) == jvm.project(a, eye)


# --------------------------------------------------------------------------- #
# class tables and the YAML reader
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("name,strict", TABLES)
def test_class_tables(tmp_path, name, strict):
    t, j = tct.for_dataset(name, strict_reference=strict), \
        jct.for_dataset(name, strict_reference=strict)
    assert t.mapping == j.mapping and t.names == j.names
    assert t.colors.keys() == j.colors.keys()
    for k in t.colors:
        np.testing.assert_array_equal(t.colors[k], j.colors[k])
    assert tct.class_names(name) == jct.class_names(name)
    for cid in range(-1, len(t.mapping) + 2):
        np.testing.assert_array_equal(t.color_of(cid), j.color_of(cid))
        assert t.name_of(cid) == j.name_of(cid)
    tp, jp = tmp_path / "t.yaml", tmp_path / "j.yaml"
    tct.write_yaml(name, str(tp), strict_reference=strict)
    jct.write_yaml(name, str(jp), strict_reference=strict)
    assert tp.read_bytes() == jp.read_bytes()
    # the CLI writes the same file
    cli = tmp_path / "cli.yaml"
    tct._main([name, str(cli)] + ["--strict-reference"] * strict)
    assert cli.read_bytes() == jp.read_bytes()
    # the port's reader gives what PyYAML gives, and the maps read back equal
    text = tp.read_text()
    assert yaml_subset.load(text) == yaml.safe_load(text)
    back = tcolors.ClassColorMap.from_yaml(str(tp))
    ref = jcolors.ClassColorMap.from_yaml(str(tp))
    assert back.mapping == ref.mapping == t.mapping and back.names == ref.names == t.names
    for k in ref.colors:
        np.testing.assert_array_equal(back.colors[k], ref.colors[k])
        np.testing.assert_array_equal(back.color_of(k), t.color_of(k))


@pytest.mark.parametrize("text", [
    # the shipped colour tables of the JAX package
    *[open(os.path.join(os.path.dirname(openobj_tpu.__file__), "configs", "colors",
                        f"{n}_classes.yaml")).read() for n in ("replica", "scannet")],
    # flow mappings (test_viewer's colour map)
    "mapping: {0: 0, 1: 1, 2: 1}\nmapped_class: {0: unknown, 1: chair}\n"
    "mapped_colors: {0: [0, 0, 0], 1: [1.0, 0.5, 0.0]}\n",
    # the reference's commented colour table layout
    "mapping:\n  0: 0  # unknown\n  83: 42 # tissue-paper -> tissue-paper\n"
    "mapped_class:\n  0: unknown\n  42: 'appliance'\n"
    "mapped_colors:\n  0: [0, 0, 0]\n  42: [0.1, 0.2, 0.3]\n",
    # render_config.yaml shapes: classes as a list of mappings
    "classes:\n- name: wall\n- name: floor\n- name: chair\n",
    "---\ndataset: replica  # a comment\nclasses:\n  - id: 0\n    name: undefined\n"
    "    color: [0, 0, 0]\n  - id: 1\n    name: \"base-cabinet\"\n    color: [12, 34, 56]\n"
    "  -\n    id: 2\n    name: it's\n    nested: {a: [1, 2.5], b: ~}\n",
])
def test_yaml_reader_equals_safe_load(text):
    assert yaml_subset.load(text) == yaml.safe_load(text)


@pytest.mark.parametrize("text", [
    "a: &anchor 1\n", "a: *anchor\n", "a: !tag 1\n", "a: |\n  block\n",
    "a: b: c\n", "a:\n  plain\n  over two lines\n", "a: [1, 2\n", "a:\n\t- 1\n",
    "a: 1\n  b: 2\n",
])
def test_yaml_reader_refuses_the_rest(text):
    with pytest.raises(ValueError):
        yaml_subset.load(text)


# --------------------------------------------------------------------------- #
# colourings, HTML, encoders
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("shape", [(40, 16), (160, 16), (2000, 64), (30, 64)])
def test_part_feature_pca_colors_solvers(monkeypatch, shape):
    """The port picks sklearn's default solver: XᵀX's eigenvectors for tall
    inputs (160 x 16, 2000 x 64), the SVD otherwise; the JAX function runs
    sklearn's default here, and its exact solver in the other tests."""
    monkeypatch.setattr(sklearn.decomposition, "PCA", SKLEARN_PCA)
    rng = np.random.default_rng(shape[0])
    # float64: on float32 input sklearn computes in float32, the port in float64
    x = rng.normal(size=shape) @ rng.normal(size=(shape[1], shape[1]))
    x[:, 2] = 0.5                                  # a constant column
    got = tquery.part_feature_pca_colors(x)
    np.testing.assert_allclose(got, jquery.part_feature_pca_colors(x), rtol=0, atol=PCA_ATOL)
    assert x[0, 2] == 0.5                          # the input is left as it was


def _equal_modes(a, b):
    assert a.keys() == b.keys()
    for m in a:
        assert a[m].keys() == b[m].keys(), m
        for oid in a[m]:
            assert a[m][oid].dtype == b[m][oid].dtype == np.uint8
            np.testing.assert_array_equal(a[m][oid], b[m][oid], err_msg=f"{m} {oid}")


@pytest.mark.parametrize("table,offset", [(None, 0), ("replica", 0), ("replica", 1),
                                          ("scannet", 0)])
def test_bundle_colorings(table, offset):
    b = make_bundle()
    b[9]["class_id"] = None
    b[7]["part_feat"] = None          # the rgb fallback
    tc = tct.for_dataset(table) if table else None
    jc = jct.for_dataset(table) if table else None
    _equal_modes(tviewer.bundle_colorings(b, class_colors=tc, class_id_offset=offset),
                 jviewer.bundle_colorings(b, class_colors=jc, class_id_offset=offset))


@pytest.mark.parametrize("top_k", [None, 1, 2])
def test_bake_queries(top_k):
    b = make_bundle()
    tclip, tsbert = tviewer.make_encoders("fake")
    jclip, jsbert = jviewer.make_encoders("fake")
    for text in ("a red chair", "wall"):
        ts = tquery.query_objects(text, b, tclip, tsbert)
        js = jquery.query_objects(text, b, jclip, jsbert)
        assert ts == js
        _equal_modes({"q": tviewer.bake_object_query(b, ts, top_k=top_k)},
                     {"q": jviewer.bake_object_query(b, js, top_k=top_k)})
        tp = tquery.query_part(text, "leg", b, tclip, tsbert, top_k_objects=top_k or 1)
        jp = jquery.query_part(text, "leg", b, jclip, jsbert, top_k_objects=top_k or 1)
        _equal_modes({"p": tviewer.bake_part_query(b, tp)},
                     {"p": jviewer.bake_part_query(b, jp)})


@pytest.mark.parametrize("live_query", [False, True])
def test_build_html_bytes(tmp_path, live_query):
    b = make_bundle()
    clip, sbert = tviewer.make_encoders("fake")
    scores = tquery.query_objects("a chair", b, clip, sbert)
    part = tquery.query_part("a chair", "leg", b, clip, sbert, top_k_objects=2)
    colorings = {"query": tviewer.bake_object_query(b, scores, top_k=1),
                 "part_query": tviewer.bake_part_query(b, part)}
    kw = dict(colorings=colorings, scores=scores, initial="part_query",
              title="room_0 map", ceiling_height=1.5, hide_thresh=0.4,
              live_query=live_query, class_id_offset=1)
    tp = tviewer.build_html(b, str(tmp_path / "t" / "v.html"),
                            class_colors=tct.for_dataset("replica"), **kw)
    jp = jviewer.build_html(b, str(tmp_path / "j" / "v.html"),
                            class_colors=jct.for_dataset("replica"), **kw)
    html = open(tp, "rb").read()
    assert html == open(jp, "rb").read()
    assert tvm.JS_MAT4.encode() in html and tvm.JS_ORBIT_EYE.encode() in html


def test_viewer_main(tmp_path, capsys):
    b = make_bundle()
    path = str(tmp_path / "map.pkl.gz")
    with gzip.open(path, "wb") as f:
        pickle.dump(b, f)
    yml = str(tmp_path / "colors.yaml")
    jct.write_yaml("replica", yml)
    outs = {}
    for tag, mod in (("t", tviewer), ("j", jviewer)):
        d = tmp_path / tag
        args = [path, "--out-html", str(d / "v.html"), "--query", "a red chair",
                "--part-query", "leg", "--top-k", "2", "--class-colors", yml,
                "--ply-dir", str(d / "plys")]
        mod.main(args)
        outs[tag] = capsys.readouterr().out.replace(str(d), "<out>")
    assert outs["t"] == outs["j"]
    # the HTML differs only in its default title
    t_html = (tmp_path / "t" / "v.html").read_text()
    j_html = (tmp_path / "j" / "v.html").read_text()
    assert t_html.replace("openobj-torch map", "openobj-tpu map") == j_html
    plys = sorted(os.listdir(tmp_path / "t" / "plys"))
    assert plys == sorted(os.listdir(tmp_path / "j" / "plys")) == \
        ["obj_4.ply", "obj_7.ply", "obj_9.ply"]
    for p in plys:
        assert (tmp_path / "t" / "plys" / p).read_bytes() == \
            (tmp_path / "j" / "plys" / p).read_bytes()


def test_make_encoders(tmp_path):
    texts = ["chair", "a red chair", "table", ""]
    for t_enc, j_enc in zip(tviewer.make_encoders("fake"), jviewer.make_encoders("fake")):
        a, b = t_enc(texts), j_enc(texts)
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    rng = np.random.default_rng(5)
    vocab = tmp_path / "vocab.npz"
    np.savez(vocab, terms=np.array(["chair", "table", "lamp"]),
             clip=rng.normal(size=(3, 512)).astype(np.float32),
             sbert=rng.normal(size=(3, 384)).astype(np.float32))
    for t_enc, j_enc in zip(tviewer.make_encoders("vocab", str(vocab)),
                            jviewer.make_encoders("vocab", str(vocab))):
        np.testing.assert_array_equal(t_enc(["lamp", "chair"]), j_enc(["lamp", "chair"]))
        with pytest.raises(KeyError):
            t_enc(["sofa"])
    with pytest.raises(ValueError):
        tviewer.make_encoders("nope")
