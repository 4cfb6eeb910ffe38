"""Interactive open-vocabulary query server.

Port of ``openobj_tpu.viz.server`` (stdlib ``http.server``, host numpy):
the same routes and the same JSON for the same bundle and encoders. Only
``--encoders hf`` touches a torch device (``--device``, the card by
default).

The reference's viewer re-encodes the user's text on every F/P keypress
inside its Open3D event loop (visualization/vis_interaction.py:322-438). The HTML viewer (viz.viewer) bakes query
colorings at export time instead; this module closes the gap: a tiny
stdlib HTTP server that holds the map bundle + text encoders and serves

  GET /                 the viewer HTML with a live query box
  GET /query?text=...[&part=...][&topk=K]   JSON: ranked object scores +
                        a per-vertex coloring ('live' mode in the viewer)
  GET /objects          JSON metadata (ids, captions if present, classes)

Query math is viz.query (0.2·sbert + 0.8·clip object similarity,
per-vertex part-CLIP cosine), identical to the baked path. Encoders are
injectable exactly as in viz.viewer.make_encoders ("hf", "vocab", "fake").

    python -m openobj_torch.viz.server runs/room_0/map_vis.pkl.gz \
        --encoders vocab --vocab vocab.npz --port 8008

Binds 127.0.0.1 by default; this is a trusted-LAN dev tool, not a hardened
service.
"""

from __future__ import annotations

import argparse
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np

from openobj_torch.viz import colors as C
from openobj_torch.viz import query as Q
from openobj_torch.viz import viewer as V


_b64 = V._b64      # one encoding contract for baked and served colorings


class QueryService:
    """Bundle + encoders + query->coloring logic, HTTP-free (testable)."""

    def __init__(self, bundle: dict[int, dict], clip_encoder, sbert_encoder,
                 class_colors=None, title: str = "openobj-torch map"):
        self.bundle = bundle
        self.clip_encoder = clip_encoder
        self.sbert_encoder = sbert_encoder
        self.class_colors = class_colors
        self.title = title
        self._html: str | None = None
        self._lock = threading.Lock()

    def html(self) -> str:
        with self._lock:
            if self._html is None:
                import os
                import tempfile

                fd, path = tempfile.mkstemp(suffix=".html")
                os.close(fd)
                try:
                    V.build_html(
                        self.bundle, path, class_colors=self.class_colors,
                        title=self.title, live_query=True,
                    )
                    with open(path) as f:
                        self._html = f.read()
                finally:
                    os.unlink(path)
            return self._html

    def query(self, text: str, part: str | None = None,
              topk: int | None = None) -> dict:
        """Returns a JSON-ready dict: scores (normalized, str oid keys),
        colors (b64 uint8 [V,3] per oid), ranked [(oid, raw_sim)...]."""
        scores = Q.query_objects(
            text, self.bundle, self.clip_encoder, self.sbert_encoder
        )
        ranked = sorted(scores.items(), key=lambda kv: -kv[1])
        if part:
            part_scores = Q.query_part(
                text, part, self.bundle, self.clip_encoder,
                self.sbert_encoder, top_k_objects=topk or 1,
            )
            coloring = V.bake_part_query(self.bundle, part_scores)
        else:
            coloring = V.bake_object_query(self.bundle, scores, top_k=topk)
        norm = C.normalize_scores(scores)
        return {
            "query": text,
            "part": part,
            "scores": {str(o): float(s) for o, s in norm.items()},
            "ranked": [[int(o), float(s)] for o, s in ranked],
            "colors": {str(o): _b64(c.astype(np.uint8))
                       for o, c in coloring.items()},
        }

    def objects(self) -> dict:
        out = {}
        for oid, e in self.bundle.items():
            out[str(oid)] = {
                "n_vertices": int(e["mesh"]["vertices"].shape[0]),
                "class_id": int(e["class_id"]) if e.get("class_id") is not None
                else None,
                "has_part_feat": e.get("part_feat") is not None,
            }
        return out


def make_handler(service: QueryService):
    class Handler(BaseHTTPRequestHandler):
        def _send(self, code: int, body: bytes, ctype: str):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _json(self, obj, code: int = 200):
            self._send(code, json.dumps(obj).encode(),
                       "application/json; charset=utf-8")

        def do_GET(self):  # noqa: N802 (http.server API)
            u = urlparse(self.path)
            try:
                if u.path in ("/", "/index.html"):
                    self._send(200, service.html().encode(),
                               "text/html; charset=utf-8")
                elif u.path == "/query":
                    q = parse_qs(u.query)
                    text = (q.get("text") or [""])[0]
                    if not text:
                        self._json({"error": "missing text"}, 400)
                        return
                    part = (q.get("part") or [None])[0] or None
                    topk = q.get("topk")
                    try:
                        topk_i = int(topk[0]) if topk else None
                    except ValueError:
                        self._json({"error": f"bad topk {topk[0]!r}"}, 400)
                        return
                    try:
                        out = service.query(text, part=part, topk=topk_i)
                    except KeyError as e:
                        # vocab encoders raise KeyError on unknown terms
                        self._json({"error": f"unknown term {e}"}, 400)
                        return
                    self._json(out)
                elif u.path == "/objects":
                    self._json(service.objects())
                else:
                    self._json({"error": "not found"}, 404)
            except Exception as e:  # noqa: BLE001 — report, keep serving
                self._json({"error": str(e)}, 500)

        def log_message(self, fmt, *args):  # quiet by default
            pass

    return Handler


def serve(service: QueryService, host: str = "127.0.0.1", port: int = 8008):
    """Blocking serve loop; returns the server if port=0 binding is needed
    programmatically (use make_server + serve_forever in a thread)."""
    srv = make_server(service, host, port)
    print(f"serving {len(service.bundle)} objects on http://{host}:{srv.server_address[1]}/")
    srv.serve_forever()


def make_server(service: QueryService, host: str = "127.0.0.1",
                port: int = 0) -> ThreadingHTTPServer:
    return ThreadingHTTPServer((host, port), make_handler(service))


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="live open-vocab query server over a map bundle")
    ap.add_argument("bundle")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8008)
    ap.add_argument("--encoders", default="fake",
                    choices=("fake", "hf", "vocab"))
    ap.add_argument("--vocab", default=None)
    ap.add_argument("--class-colors", default=None)
    ap.add_argument("--device", default="cuda",
                    help="torch device of the transformers encoders; read only "
                         "with --encoders hf (default: the card)")
    args = ap.parse_args(argv)

    from openobj_torch.viz.export import load_map_bundle

    bundle = load_map_bundle(args.bundle)
    clip_enc, sbert_enc = V.make_encoders(args.encoders, args.vocab, device=args.device)
    class_colors = (
        C.ClassColorMap.from_yaml(args.class_colors)
        if args.class_colors else None
    )
    serve(
        QueryService(bundle, clip_enc, sbert_enc, class_colors=class_colors),
        host=args.host, port=args.port,
    )


if __name__ == "__main__":
    main()
