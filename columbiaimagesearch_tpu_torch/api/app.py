"""Copy of columbiaimagesearch_tpu/api/app.py:1-401, with one repair:
``make_server`` listens with a backlog of ``LISTEN_BACKLOG`` connections.
The JAX server keeps socketserver's default of 5, so a burst of concurrent
clients overflows it and the dropped connections come back only after the
TCP connect retry (1 s, 3 s, 7 s, ...), or are reset. And one addition:
while a profiler session is open, each request ``make_server`` handles is
the span ``cis.http`` on its handler's thread, from reading the body to
writing the reply (``common/profiling.py``).

REST search API on the stdlib HTTP server.

Same endpoint surface as the reference's Flask-RESTful APIResponder
(reference: cufacesearch/api/api.py:28-557): ``/<endpoint>/<mode>`` with
search modes ``byURL``/``byPATH``/``bySHA1``/``byB64``, ops modes
``status``/``refresh``/``check_new_updates``/``check_all_updates``, HTML
``view_similar_by*`` views, the same options whitelist, per-request
``Timing``, and the auto-refresh-after-an-hour behavior of
``check_new_updates`` (api.py:26,340-366).

Flask/gevent/gunicorn are replaced by ``http.server.ThreadingHTTPServer`` —
dependency-free and adequate because the heavy lifting is batched device
work; the handler logic lives in :class:`SearchAPI`, which is
transport-independent (reusable behind any WSGI server).
"""

import json
import time
import urllib.parse
from datetime import datetime
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from columbiaimagesearch_tpu_torch.common.profiling import span

REFRESH_DELAY = 3600
#: listen backlog of ``make_server`` (see the module docstring)
LISTEN_BACKLOG = 1024

VALID_OPTIONS = ["near_dup", "near_dup_th", "no_blur", "detect_only",
                 "max_height", "max_returned", "reranking", "rerank_nb"]


class SearchAPI:
    """Transport-independent request processing."""

    def __init__(self, searcher, input_type="image"):
        self.searcher = searcher
        self.input_type = input_type
        self.start_time = datetime.now()

    # ----------------------------------------------------------- utilities

    def get_options_dict(self, options):
        """Whitelist-parse the options JSON (reference: api/api.py:202-223)."""
        errors = []
        options_dict = {}
        if options:
            try:
                options_dict = json.loads(options) if isinstance(options, str) \
                    else dict(options)
            except Exception as inst:
                errors.append({"options": f"could not parse options: {inst}"})
                options_dict = {}
            for k in list(options_dict):
                if k not in VALID_OPTIONS:
                    errors.append({"option": f"unknown option {k}"})
                    del options_dict[k]
        return options_dict, errors

    @staticmethod
    def append_errors(outp, errors):
        if errors:
            outp.setdefault("Errors", []).extend(errors)
        return outp

    @staticmethod
    def get_clean_urls_from_query(query):
        """Comma-in-URL disambiguation (reference: api/api.py:387-408)."""
        tmp = ["http" + x for x in query.split("http") if x]
        return [u[:-1] if u.endswith(",") else u for u in tmp]

    # -------------------------------------------------------------- routes

    def process(self, mode, query=None, options=None):
        """Dispatch one request; returns (status_code, payload_dict_or_html)."""
        if query is None or mode in ("status", "refresh", "check_new_updates",
                                     "check_all_updates"):
            return 200, self.process_mode(mode)
        start = time.time()
        try:
            if mode == "byURL":
                resp = self.search_byURL(query, options)
            elif mode == "bySHA1":
                resp = self.search_bySHA1(query, options)
            elif mode == "byPATH":
                resp = self.search_byPATH(query, options)
            elif mode == "byB64":
                resp = self.search_byB64(query, options)
            elif mode == "view_image_sha1":
                return 200, self.view_image_sha1(query)
            elif mode.startswith("view_similar_by"):
                sub = mode[len("view_similar_by"):]
                inner = self.process("by" + sub, query, options)[1]
                return 200, self.view_similar(query, inner, options)
            else:
                return 400, {"error": f"unknown_mode: {mode}"}
        except Exception as inst:
            return 500, {"error": f"{type(inst).__name__}: {inst}"}
        resp["Timing"] = time.time() - start
        return 200, resp

    def process_mode(self, mode):
        if mode == "status":
            return self.status()
        elif mode == "refresh":
            self.searcher.load_codes()
            return {"refresh": "just ran a full refresh"}
        elif mode == "check_all_updates":
            added = self.searcher.load_codes()
            d = self.status()
            d["added"] = added
            return d
        elif mode == "check_new_updates":
            if time.time() - self.searcher.last_refresh > REFRESH_DELAY:
                self.searcher.load_codes()
            return self.status()
        return {"error": f"unknown_mode: {mode}."
                         " Did you forget to give 'data' parameter?"}

    def status(self):
        d = {"status": "OK",
             "API_start_time": self.start_time.isoformat(" "),
             "API_uptime": str(datetime.now() - self.start_time)}
        d.update({k: str(v) for k, v in self.searcher.status().items()})
        return d

    # ------------------------------------------------------------- queries

    def search_byURL(self, query, options=None):
        urls = self.get_clean_urls_from_query(query)
        options_dict, errors = self.get_options_dict(options)
        return self.append_errors(
            self.searcher.search_imageURL_list(urls, options_dict), errors)

    def search_byPATH(self, query, options=None):
        options_dict, errors = self.get_options_dict(options)
        return self.append_errors(
            self.searcher.search_image_path_list(query.split(","),
                                                 options_dict), errors)

    def search_bySHA1(self, query, options=None):
        """Resolve stored URLs/paths for the sha1s, then search
        (reference: api/api.py:260-285)."""
        sha1s = query.split(",")
        options_dict, errors = self.get_options_dict(options)
        rows = self.searcher.indexer.get_columns_from_sha1_rows(
            sha1s, columns=[self.searcher.img_column])
        imgs = []
        for row in rows:
            val = row[1][self.searcher.img_column]
            imgs.append(val.decode() if isinstance(val, bytes) else val)
        if self.searcher.file_input:
            outp = self.searcher.search_image_path_list(imgs, options_dict)
        else:
            outp = self.searcher.search_imageURL_list(imgs, options_dict)
        return self.append_errors(outp, errors)

    def search_byB64(self, query, options=None):
        b64s = [x for x in query.split(",") if not x.startswith("data:")]
        options_dict, errors = self.get_options_dict(options)
        return self.append_errors(
            self.searcher.search_imageB64_list(b64s, options_dict), errors)

    def view_image_sha1(self, query):
        """HTML page showing the stored image(s) for sha1(s)
        (reference: api/api.py view_image_sha1 mode). Rows holding a stored
        image buffer are embedded as a base64 data URI like the reference's
        HTML rendering (api/api.py:410-538); otherwise the stored URL is
        used."""
        import base64

        sha1s = query.split(",")
        buff_col = self.searcher.indexer.get_col_imgbuff()
        rows = self.searcher.indexer.get_columns_from_sha1_rows(
            sha1s, columns=[self.searcher.img_column, buff_col])
        cells = []
        for row in rows:
            buf = row[1].get(buff_col)
            if buf:
                if isinstance(buf, str):
                    buf = buf.encode()
                try:  # stored buffers may already be b64 text
                    base64.b64decode(buf, validate=True)
                    b64 = buf.decode()
                except Exception:
                    b64 = base64.b64encode(buf).decode()
                src = f"data:image/jpeg;base64,{b64}"
            else:
                val = row[1].get(self.searcher.img_column, b"")
                src = val.decode() if isinstance(val, bytes) else val
            cells.append(f"<td><img src='{src}' height='200'/><br/>{row[0]}"
                         "</td>")
        return ("<html><body><table><tr>" + "".join(cells)
                + "</tr></table></body></html>")

    # ---------------------------------------------------------------- html

    def view_similar(self, query, response, options=None):
        """HTML rendering of a search response (the role of
        www/templates/view_similar_images.html and, for faces,
        view_similar_faces_wbbox.html). Like the reference templates,
        images are BLURRED unless the ``no_blur`` option is set, and face
        results are drawn on canvases with their bounding boxes."""
        options_dict, _ = self.get_options_dict(options)
        no_blur = bool(options_dict.get("no_blur", False))
        max_height = int(options_dict.get("max_height", 120))
        blur = ("" if no_blur else
                "filter:blur(8px);-webkit-filter:blur(8px);")
        if self.input_type != "image":
            return self._view_similar_faces(response, blur, max_height)
        rows = []
        m = self.searcher.do.map
        for entry in response.get(m["all_similar_images"], []):
            block = entry.get(m["similar_images"], {})
            sha1 = entry.get(m["query_sha1"], "")
            cells = "".join(
                f"<td><img class='sim' src='{u}' height='{max_height}'/>"
                f"<br/>{s}<br/>{d:.4f}</td>"
                for s, u, d in zip(block.get(m["image_sha1s"], []),
                                   block.get(m["cached_image_urls"], []),
                                   block.get(m["distances"], [])))
            rows.append(f"<tr><th>{sha1}</th>{cells}</tr>")
        return ("<html><head><style>img.sim{" + blur + "}</style></head>"
                "<body><h3>Similar images</h3><table border='1'>"
                + "".join(rows) + "</table></body></html>")

    def _view_similar_faces(self, response, blur, max_height):
        """Canvas-rendered face results with red bbox overlays
        (reference: www/templates/view_similar_faces_wbbox.html — canvas
        sized to the natural image, 6px red rect, distance text)."""
        m = self.searcher.do.map
        script = (
            "<script>function drawFace(cid,url,l,t,r,b,label){"
            "var c=document.getElementById(cid);"
            "var x=c.getContext('2d');var im=new Image();im.src=url;"
            "im.onload=function(){c.width=im.width;c.height=im.height;"
            "x.drawImage(im,0,0);"
            "if(r>l){x.rect(l,t,r-l,b-t);x.lineWidth=6;"
            "x.strokeStyle='#ff0000';x.stroke();}"
            "if(label){x.font='18px serif';x.fillText(label,10,25);}};}"
            "</script>")
        parts = [f"<html><head><style>canvas.sim{{{blur}"
                 f"max-height:{max_height}px;}}"
                 f"canvas.query{{max-height:{max_height}px;}}</style>"
                 f"{script}</head><body>"]
        calls = []
        nid = 0
        for entry in response.get(m["all_similar_faces"], []):
            sha1 = entry.get(m["query_sha1"], "")
            url = entry.get(m["query_url"], "")
            qbox = entry.get(m["query_face"], {}) or {}
            nid += 1
            cid = f"q{nid}"
            parts.append(f"<h2>Query face: {sha1}</h2>"
                         f"<canvas class='query' id='{cid}'></canvas>")
            calls.append(
                f"drawFace('{cid}','{url}',{qbox.get('left', 0)},"
                f"{qbox.get('top', 0)},{qbox.get('right', 0)},"
                f"{qbox.get('bottom', 0)},'');")
            block = entry.get(m["similar_faces"], {})
            parts.append("<h3>Results:</h3>")
            for s, u, bbox, d in zip(block.get(m["image_sha1s"], []),
                                     block.get(m["cached_image_urls"], []),
                                     block.get(m["faces"], []),
                                     block.get(m["distances"], [])):
                nid += 1
                cid = f"r{nid}"
                parts.append(f"<canvas class='sim' id='{cid}'></canvas>")
                calls.append(
                    f"drawFace('{cid}','{u}',{bbox.get('left', 0)},"
                    f"{bbox.get('top', 0)},{bbox.get('right', 0)},"
                    f"{bbox.get('bottom', 0)},'{d:.4f}');")
        parts.append("<script>" + "".join(calls) + "</script></body></html>")
        return "".join(parts)


def wsgi_app(searcher, endpoint="cuimgsearch", input_type="image"):
    """WSGI application serving ``/<endpoint>/<mode>`` — the reference's
    gunicorn entry point role (reference: api/gunicorn_api.py:21-75,
    www/run_search_api.py:34-66). Works under any WSGI server
    (``gunicorn 'module:app'`` with ``app = wsgi_app(searcher)``); unlike
    the reference's per-worker searcher copies, one device-resident
    searcher serves every worker thread (device batching replaces worker
    processes)."""
    import json as _json
    from urllib.parse import parse_qs

    api = SearchAPI(searcher, input_type=input_type)
    prefix = "/" + endpoint.strip("/") + "/"

    def app(environ, start_response):
        path = environ.get("PATH_INFO", "")
        if not path.startswith(prefix):
            body = _json.dumps({"error": "unknown endpoint"}).encode()
            start_response("404 Not Found",
                           [("Content-Type", "application/json"),
                            ("Content-Length", str(len(body)))])
            return [body]
        mode = path[len(prefix):].strip("/")
        params = parse_qs(environ.get("QUERY_STRING", ""))
        data = params.get("data", [None])[0]
        options = params.get("options", [None])[0]
        try:
            length = int(environ.get("CONTENT_LENGTH") or 0)
        except ValueError:
            length = 0
        if length and environ.get("REQUEST_METHOD") in ("POST", "PUT"):
            raw = environ["wsgi.input"].read(length).decode()
            ctype = environ.get("CONTENT_TYPE", "")
            form = {}
            if "json" in ctype:
                try:
                    form = _json.loads(raw)
                except Exception:
                    form = {}
            elif raw:
                form = {k: v[0] for k, v in parse_qs(raw).items()}
                if not form:
                    try:
                        form = _json.loads(raw)
                    except Exception:
                        form = {}
            if not isinstance(form, dict):  # e.g. a JSON array body
                form = {}
            data = form.get("data", data)
            options = form.get("options", options)
            if isinstance(options, (dict, list)):
                options = _json.dumps(options)
        code, payload = api.process(mode, data, options)
        is_html = isinstance(payload, str)
        body = (payload if is_html else _json.dumps(payload)).encode()
        status = {200: "200 OK", 400: "400 Bad Request",
                  404: "404 Not Found"}.get(code, "500 Internal Server Error")
        start_response(status,
                       [("Content-Type",
                         "text/html" if is_html else "application/json"),
                        ("Content-Length", str(len(body)))])
        return [body]

    app.api = api
    return app


def make_server(searcher, endpoint="cuimgsearch", port=5000, host="127.0.0.1",
                input_type="image"):
    """Build a ThreadingHTTPServer serving ``/<endpoint>/<mode>``."""
    api = SearchAPI(searcher, input_type=input_type)
    prefix = "/" + endpoint.strip("/") + "/"

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # quiet
            pass

        def _reply(self, code, payload):
            is_html = isinstance(payload, str)
            body = (payload if is_html else json.dumps(payload)).encode()
            self.send_response(code)
            self.send_header("Content-Type",
                             "text/html" if is_html else "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _route(self, query_string, body_form=None):
            parsed = urllib.parse.urlparse(self.path)
            if not parsed.path.startswith(prefix):
                return self._reply(404, {"error": "unknown endpoint"})
            mode = parsed.path[len(prefix):].strip("/")
            params = urllib.parse.parse_qs(parsed.query)
            data = params.get("data", [None])[0]
            options = params.get("options", [None])[0]
            if body_form:
                data = body_form.get("data", data)
                options = body_form.get("options", options)
                if isinstance(options, (dict, list)):
                    options = json.dumps(options)
            code, payload = api.process(mode, data, options)
            self._reply(code, payload)

        def do_GET(self):
            with span("cis.http"):
                self._route(self.path)

        def do_POST(self):
            with span("cis.http"):
                self._post()

        def _post(self):
            length = int(self.headers.get("Content-Length", 0))
            raw = self.rfile.read(length).decode() if length else ""
            form = {}
            ctype = self.headers.get("Content-Type", "")
            if raw:
                if "json" in ctype:
                    form = json.loads(raw)
                else:
                    form = {k: v[0] for k, v in
                            urllib.parse.parse_qs(raw).items()}
                    if not form and raw:
                        try:
                            form = json.loads(raw)
                        except Exception:
                            form = {}
            self._route(self.path, form)

        do_PUT = do_POST

    class Server(ThreadingHTTPServer):
        request_queue_size = LISTEN_BACKLOG

    server = Server((host, port), Handler)
    server.api = api
    return server
