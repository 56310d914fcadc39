"""Copy of columbiaimagesearch_tpu/searcher/output_mapping.py:1-159.

Search result JSON formatting (CamelCase / snake_case).

Same output schema as the reference
(reference: cufacesearch/searcher/output_mapping.py:1-230): per-query entries
with ``QuerySha1``/``QueryURL``, nested ``Similar<Input>s`` blocks with
``ImageSha1s``, ``CachedImageURLs``, ``Distances`` and (for detections) bbox
dicts, plus global counters.
"""

from collections import OrderedDict

COORD_MAP = ["left", "top", "right", "bottom"]
INPUT_TYPES = ["image", "face"]


class DictOutput:
    def __init__(self, mode="CamelCase"):
        self.map = {}
        self.coord_map = COORD_MAP
        self.input_types = INPUT_TYPES
        self.url_field = "info:s3_url"
        if mode == "CamelCase":
            self._fill(camel=True)
        else:
            self._fill(camel=False)

    def _fill(self, camel: bool):
        def style(snake):
            if not camel:
                return snake
            # NB: not str.title() — "sha1s".title() would give "Sha1S".
            return "".join("URL" if p == "url" else p[:1].upper() + p[1:]
                           for p in snake.split("_"))

        base = ["query_sha1", "query_url", "image_sha1s", "img_info",
                "distances", "cached_image_urls"]
        for k in base:
            self.map[k] = style(k)
        self.map["query_url"] = "QueryURL" if camel else "query_url"
        self.map["cached_image_urls"] = ("CachedImageURLs" if camel
                                         else "cached_image_urls")
        for inp in self.input_types:
            for k in [f"query_{inp}", f"similar_{inp}s", f"{inp}s",
                      f"number_{inp}s", f"number_similar_{inp}s",
                      f"all_similar_{inp}s"]:
                self.map[k] = style(k)

    def _url_of(self, sim_row):
        try:
            val = sim_row[1][self.url_field]
            if isinstance(val, bytes):
                val = val.decode()
            return val.strip()
        except Exception:
            return ""

    def format_output(self, dets, sim_images, sim_dets, sim_score,
                      options_dict=None, input_type="image"):
        """Build the response OrderedDict
        (reference: output_mapping.py:78-230)."""
        del options_dict
        m = self.map
        output = []
        images_query = set()
        nb_dets_query = 0
        nb_similar = 0

        if input_type != "image":
            for i, det in enumerate(dets):
                sha1, bboxes, url = det[0], det[1], det[2]
                if not bboxes:
                    entry = {m["query_sha1"]: sha1}
                    if url:
                        entry[m["query_url"]] = url
                    entry[m["img_info"]] = list(det[3:5])
                    images_query.add(sha1)
                    entry[m[f"similar_{input_type}s"]] = OrderedDict([
                        (m[f"number_{input_type}s"], 0),
                        (m["image_sha1s"], []),
                        (m[f"{input_type}s"], []),
                        (m["cached_image_urls"], []),
                        (m["distances"], []),
                    ])
                    output.append(entry)
                    continue
                for j, bbox in enumerate(bboxes):
                    nb_dets_query += 1
                    entry = {m["query_sha1"]: sha1,
                             m[f"query_{input_type}"]: bbox}
                    if url:
                        entry[m["query_url"]] = url
                    entry[m["img_info"]] = list(det[3:])
                    images_query.add(sha1)
                    n = 0
                    if sim_dets[i] and len(sim_dets[i]) > j and sim_dets[i][j]:
                        n = len(sim_dets[i][j])
                    block = OrderedDict([
                        (m[f"number_{input_type}s"], n),
                        (m["image_sha1s"], []),
                        (m[f"{input_type}s"], []),
                        (m["img_info"], []),
                        (m["cached_image_urls"], []),
                        (m["distances"], []),
                    ])
                    for jj in range(n):
                        nb_similar += 1
                        sim_row = sim_images[i][j][jj]
                        block[m["image_sha1s"]].append(str(sim_row[0]).strip())
                        block[m["cached_image_urls"]].append(
                            self._url_of(sim_row) if len(sim_row) > 1 else "")
                        sim_det = sim_dets[i][j][jj]
                        bbox_dict = {
                            self.coord_map[k]: int(float(coord))
                            for k, coord in
                            enumerate(str(sim_det).split("_")[1:5])
                        }
                        block[m[f"{input_type}s"]].append(bbox_dict)
                        block[m["img_info"]].append("")
                        block[m["distances"]].append(float(sim_score[i][j][jj]))
                    entry[m[f"similar_{input_type}s"]] = block
                    output.append(entry)

            return OrderedDict([
                (m["number_images"], len(images_query)),
                (m[f"number_{input_type}s"], nb_dets_query),
                (m[f"number_similar_{input_type}s"], nb_similar),
                (m[f"all_similar_{input_type}s"], output),
            ])

        # Full-image mode
        for i, det in enumerate(dets):
            sha1 = det[0]
            entry = {m["query_sha1"]: sha1}
            if det[1]:
                entry[m["query_url"]] = det[1]
            n = 0
            if i < len(sim_images) and sim_images[i] and sim_images[i][0]:
                n = len(sim_images[i][0])
            block = OrderedDict([
                (m["number_images"], n),
                (m["image_sha1s"], []),
                (m["cached_image_urls"], []),
                (m["distances"], []),
            ])
            for j in range(n):
                nb_similar += 1
                sim_row = sim_images[i][0][j]
                block[m["image_sha1s"]].append(str(sim_row[0]).strip())
                block[m["cached_image_urls"]].append(
                    self._url_of(sim_row) if len(sim_row) > 1 else "")
                block[m["distances"]].append(float(sim_score[i][0][j]))
            entry[m["similar_images"]] = block
            output.append(entry)

        return OrderedDict([
            (m["number_images"], len(dets)),
            (m["number_similar_images"], nb_similar),
            (m["all_similar_images"], output),
        ])
