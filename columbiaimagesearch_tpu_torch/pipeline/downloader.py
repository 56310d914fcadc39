"""Image downloader worker: crawl-doc messages -> per-image messages.

Copy of columbiaimagesearch_tpu/pipeline/downloader.py:1-84.

The role of the reference's KafkaImageDownloader (+Threaded variants)
(reference: cufacesearch/ingester/kafka_image_downloader.py:14-459): consume
documents that reference image URLs, download each image on a thread pool,
compute its sha1/info, and emit one message per image
(``{sha1, s3_url, img_info, img_buffer?}``) to the images topic for the
checker.
"""

import concurrent.futures

from columbiaimagesearch_tpu_torch.common.profiling import ThroughputStats
from columbiaimagesearch_tpu_torch.imgio.imgio import (
    buffer_to_B64,
    get_buffer_from_URL,
    get_SHA1_img_info_from_buffer,
)


class ImageDownloader:
    def __init__(self, ingester, pusher, nb_threads=8, with_buffer=False,
                 url_fields=("obj_stored_url", "obj_original_url", "url"),
                 image_dl_timeout=4, verbose=0):
        """:param ingester: source of doc messages (dicts)
        :param pusher: destination for per-image messages
        :param with_buffer: include the b64 image buffer in the message
        :param url_fields: document fields searched for image URLs
        """
        self.ingester = ingester
        self.pusher = pusher
        self.nb_threads = nb_threads
        self.with_buffer = with_buffer
        self.url_fields = url_fields
        self.image_dl_timeout = image_dl_timeout
        self.stats = ThroughputStats("ImageDownloader", report_every=1000)
        self.verbose = verbose

    def extract_urls(self, doc):
        """Pull image URLs out of a doc message
        (the reference's CDR 'objects' parsing, kafka_image_downloader.py)."""
        urls = []
        if "urls" in doc:
            urls.extend(doc["urls"])
        for obj in doc.get("objects", []):
            for field in self.url_fields:
                if obj.get(field):
                    urls.append(obj[field])
                    break
        for field in self.url_fields:
            if doc.get(field):
                urls.append(doc[field])
        return list(dict.fromkeys(urls))  # dedup, keep order

    def process_one(self, url):
        try:
            buf = get_buffer_from_URL(url,
                                      image_dl_timeout=self.image_dl_timeout)
            sha1, img_type, w, h = get_SHA1_img_info_from_buffer(buf)
        except Exception:
            self.stats.toc_fail()
            return None
        msg = {"sha1": sha1, "s3_url": url,
               "img_info": {"format": img_type, "width": w, "height": h}}
        if self.with_buffer:
            msg["img_buffer"] = buffer_to_B64(buf).decode()
        self.stats.toc_ok()
        return msg

    def run_once(self, max_docs=None):
        """Drain the doc source; returns number of image messages emitted."""
        emitted = 0
        n_docs = 0
        with concurrent.futures.ThreadPoolExecutor(self.nb_threads) as pool:
            for doc in self.ingester.get_msg_json():
                n_docs += 1
                urls = self.extract_urls(doc)
                for msg in pool.map(self.process_one, urls):
                    if msg is not None:
                        self.pusher.send(msg)
                        emitted += 1
                if max_docs and n_docs >= max_docs:
                    break
        return emitted
