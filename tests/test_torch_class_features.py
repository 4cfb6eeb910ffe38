"""The class-feature table (the --class-features npz) of the port against
the JAX package's: ``build_class_features`` and ``main`` for every source of
names (``--names``, ``--dataset``, ``--from-yaml``, ``--from-tsv``), read
back by both packages' ``train.load_class_features``.

The tables are host numpy on the fake and vocabulary encoders, so they must
be equal, not close. render_config.yaml is read by the port without PyYAML;
the files here have the shape of Replica's (``classes:`` as a list of
mappings with ``name``), and the names must be what the JAX package reads
with PyYAML.
"""

import numpy as np
import pytest

from openobj_tpu import train as jtrain
from openobj_tpu.perception import class_features as jcf
from openobj_tpu.viz import viewer as jviewer
from openobj_torch import train as ttrain
from openobj_torch.perception import class_features as tcf
from openobj_torch.viz import viewer as tviewer
from torch_threads import one_torch_thread  # noqa: E402,F401

RENDER_CONFIG = (
    "# render settings\n"
    "width: 1200\nheight: 680\n"
    "classes:\n"
    "  - id: 0\n    name: undefined\n    color: [0, 0, 0]\n"
    "  - id: 1\n    name: 'base-cabinet'\n    color: [12, 34, 56]\n"
    "  - id: 2\n    name: floor mat  # two words\n"
    "  - {id: 3, name: \"tv-screen\"}\n"
)
TSV = "id\tcategory\tnyu40class\n1\twall\twall\n2\tchair\tchair\n3\tfloor\tfloor\n" \
      "4\toffice chair\tchair\n5\tcounter\tcounter\n"


def _equal_tables(a, b):
    assert a.keys() == b.keys() == {"names", "clipfeat", "capfeat"}
    assert list(a["names"]) == list(b["names"])
    for k in ("clipfeat", "capfeat"):
        assert a[k].dtype == b[k].dtype == np.float32
        np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("kind", ["fake", "vocab"])
def test_build_class_features(tmp_path, kind):
    names = ["wall", "floor", "chair", "tv-screen"]
    vocab = None
    if kind == "vocab":
        rng = np.random.default_rng(0)
        vocab = str(tmp_path / "vocab.npz")
        np.savez(vocab, terms=np.array(names),
                 clip=rng.normal(size=(4, 512)).astype(np.float32),
                 sbert=rng.normal(size=(4, 384)).astype(np.float32))
    t = tcf.build_class_features(names, *tviewer.make_encoders(kind, vocab))
    j = jcf.build_class_features(names, *jviewer.make_encoders(kind, vocab))
    _equal_tables(t, j)
    np.testing.assert_allclose(np.linalg.norm(t["clipfeat"], axis=-1), 1.0, rtol=1e-6)


def test_names_from_files(tmp_path):
    y, t = tmp_path / "render_config.yaml", tmp_path / "labels.tsv"
    y.write_text(RENDER_CONFIG)
    t.write_text(TSV)
    names = tcf.class_names_from_render_config(str(y))
    assert names == jcf.class_names_from_render_config(str(y)) == \
        ["undefined", "base-cabinet", "floor mat", "tv-screen"]
    assert tcf.class_names_from_scannet_tsv(str(t)) == \
        jcf.class_names_from_scannet_tsv(str(t)) == ["wall", "chair", "floor", "counter"]


@pytest.mark.parametrize("source", [
    ["--names", "wall, floor ,chair"], ["--dataset", "replica"], ["--dataset", "scannet"],
    ["--from-yaml", "render_config.yaml"], ["--from-tsv", "labels.tsv"],
])
def test_main(tmp_path, capsys, source):
    (tmp_path / "render_config.yaml").write_text(RENDER_CONFIG)
    (tmp_path / "labels.tsv").write_text(TSV)
    if source[0].startswith("--from"):
        source = [source[0], str(tmp_path / source[1])]
    tout, jout = str(tmp_path / "t.npz"), str(tmp_path / "j.npz")
    tcf.main(source + [tout])
    jcf.main(source + [jout])
    said = capsys.readouterr().out.splitlines()
    assert said[0].replace(tout, "<out>") == said[1].replace(jout, "<out>")
    for load in (ttrain.load_class_features, jtrain.load_class_features):
        _equal_tables(load(tout), load(jout))
    with np.load(tout, allow_pickle=True) as zt, np.load(jout, allow_pickle=True) as zj:
        assert zt["names"].dtype == zj["names"].dtype == object
