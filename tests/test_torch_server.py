"""The query server of the port against the JAX package's: the service's
answers for the same bundle and encoders, and real HTTP round trips on
127.0.0.1 (a free port) in each package.

The answers are JSON of host numpy results, so they must be equal, not
close: the ranked scores, the normalized scores and the base64 colourings.
The JAX package's part-feature PCA (the viewer HTML's 'partpca' mode) is
held to scikit-learn's exact solver, as in ``test_torch_viewer``.
"""

import json
import threading
import urllib.error
import urllib.request

import pytest

from openobj_tpu.viz import server as jserver
from openobj_tpu.viz import viewer as jviewer
from openobj_torch.viz import server as tserver
from openobj_torch.viz import viewer as tviewer
from test_torch_viewer import exact_pca, make_bundle  # noqa: F401
from torch_threads import one_torch_thread  # noqa: E402,F401

QUERIES = [("a red chair", None, None), ("wooden table", None, 1), ("wall", None, 2),
           ("a red chair", "leg", None), ("lamp", "shade", 2), ("sofa", "cushion", 3)]


@pytest.fixture
def services():
    b = make_bundle()
    return (tserver.QueryService(b, *tviewer.make_encoders("fake"), title="room_0 map"),
            jserver.QueryService(b, *jviewer.make_encoders("fake"), title="room_0 map"))


@pytest.mark.parametrize("text,part,topk", QUERIES)
def test_query_service(services, text, part, topk):
    t, j = services
    got = t.query(text, part=part, topk=topk)
    assert got == j.query(text, part=part, topk=topk)
    assert json.dumps(got) == json.dumps(j.query(text, part=part, topk=topk))


def test_objects_and_html(services):
    t, j = services
    assert t.objects() == j.objects()
    assert t.html() == j.html() and "qtext" in t.html()
    assert t.html() is t.html()            # built once


def _get(url):
    with urllib.request.urlopen(url, timeout=10) as r:
        return r.status, r.headers.get_content_type(), r.read()


def test_http_round_trip(services):
    t, j = services
    answers = {}
    for name, mod, service in (("t", tserver, t), ("j", jserver, j)):
        httpd = mod.make_server(service, port=0)
        assert httpd.server_address[0] == "127.0.0.1"
        thread = threading.Thread(target=httpd.serve_forever, daemon=True)
        thread.start()
        try:
            base = f"http://127.0.0.1:{httpd.server_address[1]}"
            got = {"/": _get(base + "/"), "/objects": _get(base + "/objects")}
            for text, part, topk in QUERIES:
                q = f"/query?text={urllib.request.quote(text)}" + \
                    (f"&part={part}" if part else "") + (f"&topk={topk}" if topk else "")
                got[q] = _get(base + q)
                assert json.loads(got[q][2]) == service.query(text, part=part, topk=topk)
            for bad, code in (("/query", 400), ("/query?text=x&topk=abc", 400),
                              ("/nope", 404)):
                with pytest.raises(urllib.error.HTTPError) as e:
                    _get(base + bad)
                assert e.value.code == code
        finally:
            httpd.shutdown()
            httpd.server_close()
            thread.join(timeout=10)
        assert not thread.is_alive()
        assert got["/"][2].decode() == service.html()
        assert json.loads(got["/objects"][2]) == service.objects()
        answers[name] = got
    assert answers["t"] == answers["j"]
