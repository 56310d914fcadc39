"""ExtractionChecker: image messages -> image rows + update batches (copy
of columbiaimagesearch_tpu/pipeline/checker.py:1-144).

Same bookkeeping semantics as the reference
(reference: cufacesearch/updater/extraction_checker.py:30-459): consume
image messages, dedup by sha1, skip already-processed images (checked via
the ``<extr>_processed``/``_updateid`` columns), group into updates of
``batch_update_size`` (or flush after ``max_delay``), write image rows and
an update row ``index_update_<extr>_<date>_<seq>``, and optionally publish
the update id to a bus for processors.

Batch-first difference: ``run_once`` drains the ingester synchronously and
returns the update ids it created; the daemon loop of the reference
(DaemonExtractionChecker) becomes an ordinary loop the caller owns.
"""

import os
import time

from columbiaimagesearch_tpu_torch.store.kvindexer import KVIndexer


class ExtractionChecker:
    def __init__(self, indexer: KVIndexer, extr_str: str, ingester,
                 pusher=None, batch_update_size=None, max_delay=600,
                 verbose=0):
        self.indexer = indexer
        self.extr_str = extr_str
        self.ingester = ingester
        self.pusher = pusher
        self.batch_update_size = (batch_update_size
                                  or indexer.batch_update_size)
        self.max_delay = max_delay
        self.verbose = verbose
        self.dict_sha1_infos = {}
        self.last_flush = time.time()
        # Process identifier appended to update ids so concurrent checkers
        # (and restarts) never collide; must not contain underscores
        # (reference: extraction_checker.py:200-203).
        self.pp = f"pid{os.getpid()}"

    # ------------------------------------------------------------ internal

    def store_img_infos(self, msg):
        """(reference: extraction_checker.py:151-184)"""
        sha1 = str(msg["sha1"])
        self.dict_sha1_infos.setdefault(sha1, {})
        for k, v in msg.items():
            if k == "sha1":
                continue
            if k == "img_info" and isinstance(v, dict):
                self.dict_sha1_infos[sha1].update(
                    {f"info_{ik}": iv for ik, iv in v.items()})
            else:
                self.dict_sha1_infos[sha1][k] = v

    def get_unprocessed_sha1s(self, sha1s):
        """Filter out sha1s whose extraction already exists OR that are
        already assigned to an update (both check columns, like the
        reference: extraction_checker.py:130-139 ``set_check_columns`` uses
        ``_processed`` and ``_updateid``; 225-258 get_unprocessed_rows)."""
        base = self.indexer.extrcf + ":" + self.extr_str
        check_cols = (base + "_processed", base + "_updateid")
        rows = self.indexer.get_columns_from_sha1_rows(
            sha1s, columns=[self.indexer.extrcf])
        claimed = {r for r, cols in rows
                   if any(c in cols for c in check_cols)}
        return [s for s in sha1s if s not in claimed]

    def _row_for(self, sha1):
        info = self.dict_sha1_infos.get(sha1, {})
        row = {}
        if "img_path" in info:
            row[self.indexer.get_col_imgpath()] = info["img_path"]
        if "s3_url" in info:
            row[self.indexer.get_col_imgurl()] = info["s3_url"]
        if "img_buffer" in info:
            row[self.indexer.get_col_imgbuff()] = info["img_buffer"]
        for k, v in info.items():
            if k.startswith("info_"):
                row[self.indexer.imginfocf + ":" + k[5:]] = str(v)
        return row

    def flush_update(self, sha1s):
        """Write image rows + one update row; returns the update id
        (reference: extraction_checker.py:185-224,391-431)."""
        if not sha1s:
            return None
        rows = {s: self._row_for(s) for s in sha1s}
        for s in sha1s:
            rows[s][self.indexer.extrcf + ":" + self.extr_str
                    + "_updateid"] = "pending"
        self.indexer.push_dict_rows(rows, self.indexer.table_sha1infos_name)
        tmp_update_id, _ = self.indexer.get_next_update_id(
            extr_type=self.extr_str)
        # Append processid + timestamp for safe use with multiple consumers,
        # even after restart (reference: extraction_checker.py:200-203).
        update_id = tmp_update_id + "-" + self.pp + "-" + str(time.time())
        self.indexer.push_dict_rows(
            {update_id: {
                self.indexer.get_col_listsha1s(): ",".join(sha1s),
                self.indexer.get_col_upcreate(): str(time.time()),
            }},
            self.indexer.table_updateinfos_name)
        if self.pusher is not None:
            self.pusher.send({update_id: ",".join(sha1s)})
        self.last_flush = time.time()
        return update_id

    # ------------------------------------------------------------- running

    def run_once(self, max_msgs=None):
        """Drain the ingester, build updates; returns list of update ids
        (the reference's run loop body, extraction_checker.py:260-459)."""
        created = []
        pending = []
        seen = set()
        count = 0
        for msg in self.ingester.get_msg_json():
            # Messages carry either one sha1 or a list.
            sha1s = ([str(s) for s in msg["list_sha1s"]]
                     if "list_sha1s" in msg else [str(msg["sha1"])])
            for s in sha1s:
                if s in seen:
                    continue
                seen.add(s)
                if "list_sha1s" not in msg:
                    self.store_img_infos(msg)
                pending.append(s)
            count += 1
            if len(pending) >= self.batch_update_size:
                fresh = self.get_unprocessed_sha1s(
                    pending[:self.batch_update_size])
                uid = self.flush_update(fresh)
                if uid:
                    created.append(uid)
                pending = pending[self.batch_update_size:]
            if max_msgs and count >= max_msgs:
                break
        if pending:
            fresh = self.get_unprocessed_sha1s(pending)
            uid = self.flush_update(fresh)
            if uid:
                created.append(uid)
        return created
