"""Batch ingest bus (copy of columbiaimagesearch_tpu/pipeline/ingest.py:
1-206): the role of the reference's Kafka/Kinesis plumbing.

The reference moves image messages through Kafka topics or Kinesis shards
(reference: cufacesearch/ingester/kafka_ingester.py:20-251,
kinesis_ingester.py:16-361, pusher/kafka_pusher.py, local_images_pusher.py).
Here the bus is a thin abstraction: producers call ``send(msg)``,
consumers iterate ``get_msg_json()``. Backends:

- :class:`MemoryBus` — in-process topic with consumer offsets journaled to a
  JSON file (the resume semantics of the Kinesis sequence-number journal,
  kinesis_ingester.py:63-69,342-347);
- :class:`LocalDirIngester` — walks a directory and emits per-image messages
  ``{sha1, img_path, img_info}`` like the reference's LocalImagePusher
  (pusher/local_images_pusher.py:21-221).

The Kafka and Kinesis backends sit behind the same two methods
(``pipeline/kafka_backend.py``, ``pipeline/kinesis_backend.py``).
"""

import json
import os
import threading

from columbiaimagesearch_tpu_torch.imgio.imgio import (
    get_buffer_from_filepath,
    get_SHA1_img_info_from_buffer,
)


class GenericIngester:
    def get_msg_json(self):
        """Yield message dicts; returns when the source is drained."""
        raise NotImplementedError()


class GenericPusher:
    def send(self, msg):
        raise NotImplementedError()


class MemoryBus:
    """A named topic store with per-group consumer offsets.

    With ``journal_path`` both the topics and the committed offsets persist
    to a JSON file, so a restarted process resumes exactly where each
    consumer group left off (the role of Kafka's broker log + committed
    offsets / Kinesis's stream + sequence-number journal).
    """

    def __init__(self, journal_path=None):
        self.topics = {}
        self.lock = threading.Lock()
        self.journal_path = journal_path
        self.offsets = {}
        self._jf = None
        if journal_path:
            if os.path.exists(journal_path):
                n_lines = self._replay(journal_path)
                n_msgs = sum(len(v) for v in self.topics.values())
                # Heavily churned log (many offset commits per message):
                # rewrite as one snapshot so future replays are O(messages).
                if n_lines > 4 * max(n_msgs, 1) and n_lines > 10000:
                    self.compact()
            if self._jf is None:
                self._jf = open(journal_path, "a")

    def _replay(self, path):
        """Rebuild state from the append-only journal (one JSON per line:
        ``{"t", "m"}`` = published message, ``{"o", "p"}`` = offset commit;
        a line holding a legacy full-state snapshot is also accepted).
        Returns the number of journal lines replayed."""
        n_lines = 0
        with open(path) as f:
            for line in f:
                n_lines += 1
                line = line.strip()
                if not line:
                    continue
                try:
                    entry = json.loads(line)
                except ValueError:
                    continue  # torn tail write from a crash
                if "t" in entry:
                    self.topics.setdefault(entry["t"], []).append(entry["m"])
                elif "o" in entry:
                    self.offsets[entry["o"]] = entry["p"]
                elif "topics" in entry or "offsets" in entry:
                    self.topics = entry.get("topics", self.topics)
                    self.offsets = entry.get("offsets", self.offsets)
        return n_lines

    def _append(self, entry):
        # O(1) append per event (the old implementation rewrote the whole
        # journal per message: O(N^2) on the durable ingest path).
        if self._jf is not None:
            self._jf.write(json.dumps(entry) + "\n")
            self._jf.flush()

    def compact(self):
        """Rewrite the journal as one snapshot (drops replay cost after
        long runs); safe to call any time."""
        if not self.journal_path:
            return
        with self.lock:
            tmp = self.journal_path + ".tmp"
            with open(tmp, "w") as f:
                f.write(json.dumps({"topics": self.topics,
                                    "offsets": self.offsets}) + "\n")
            if self._jf is not None:
                self._jf.close()
            os.replace(tmp, self.journal_path)
            self._jf = open(self.journal_path, "a")

    def publish(self, topic, msg):
        with self.lock:
            self.topics.setdefault(topic, []).append(msg)
            self._append({"t": topic, "m": msg})

    def consume(self, topic, group):
        """Yield messages after the group's committed offset."""
        key = f"{topic}:{group}"
        while True:
            with self.lock:
                msgs = self.topics.get(topic, [])
                pos = self.offsets.get(key, 0)
                if pos >= len(msgs):
                    return
                msg = msgs[pos]
                self.offsets[key] = pos + 1
                self._append({"o": key, "p": pos + 1})
            yield msg


class MemoryBusPusher(GenericPusher):
    def __init__(self, bus: MemoryBus, topic: str):
        self.bus = bus
        self.topic = topic

    def send(self, msg):
        self.bus.publish(self.topic, msg)


class MemoryBusIngester(GenericIngester):
    def __init__(self, bus: MemoryBus, topic: str, group: str = "default"):
        self.bus = bus
        self.topic = topic
        self.group = group

    def get_msg_json(self):
        yield from self.bus.consume(self.topic, self.group)


class LocalDirIngester(GenericIngester):
    """Walk a directory; one message per (new) image file.

    ``source_archive`` (a local .zip/.tar[.gz/.bz2]) is extracted into the
    root on first use — the dataset-bootstrap role of the reference's
    LocalImagePusher source_zip (reference: pusher/local_images_pusher.py:
    208-216; the download half is out of scope on a no-egress box, so the
    archive must already be local).
    """

    IMG_EXTS = (".jpg", ".jpeg", ".png", ".gif", ".bmp", ".webp")

    def __init__(self, root, seen=None, source_archive=None):
        self.root = root
        self.seen = seen if seen is not None else set()
        if source_archive:
            self._extract(source_archive)

    def _extract(self, archive):
        os.makedirs(self.root, exist_ok=True)
        marker = os.path.join(
            self.root, "." + os.path.basename(archive) + ".extracted")
        if os.path.exists(marker):
            return
        if archive.endswith(".zip"):
            import zipfile

            with zipfile.ZipFile(archive) as z:
                z.extractall(self.root)
        else:
            import tarfile

            with tarfile.open(archive) as t:
                t.extractall(self.root)
        with open(marker, "w") as f:
            f.write("ok")

    def get_msg_json(self):
        for dirpath, _, files in os.walk(self.root):
            for name in sorted(files):
                if not name.lower().endswith(self.IMG_EXTS):
                    continue
                path = os.path.join(dirpath, name)
                if path in self.seen:
                    continue
                self.seen.add(path)
                try:
                    buf = get_buffer_from_filepath(path)
                    sha1, img_type, w, h = get_SHA1_img_info_from_buffer(buf)
                except Exception:
                    continue
                yield {"sha1": sha1, "img_path": path,
                       "img_info": {"format": img_type, "width": w,
                                    "height": h}}
