"""ExtractionProcessor: updates -> features, device-batched (copy of
columbiaimagesearch_tpu/pipeline/processor.py:1-177).

Same claim/retry bookkeeping as the reference
(reference: cufacesearch/updater/extraction_processor.py:110-957): scan
unprocessed updates, claim with a ``started`` timestamp (stale claims are
re-claimable after ``TIME_ELAPSED_FAILED``), acquire image buffers
(row buffer column, local path, or URL download on a thread pool), extract,
push feature columns, mark the update ``processed`` (and ``completed`` when
every row has its extraction).

Batch-first difference: the reference shards each update across forked
DaemonBatchExtractor processes each running single-image CPU forwards
(extraction_processor.py:670-764); here the whole update is ONE
``GenericExtractor.process_batch`` call (the port's extractor, on the card
by default) — host decode feeding a batched device forward.

Addition of the port: each processed update appends its stage times
(``fetch``: claim, row read and buffer acquisition; ``extract``:
``process_batch``, i.e. decode, device forward and column encode;
``write``: the sqlite writes) to ``update_times``, measured with
``common.profiling.StageTimer``.
"""

import concurrent.futures
import time

from columbiaimagesearch_tpu_torch.common.profiling import StageTimer

TIME_ELAPSED_FAILED = 3600


class ExtractionProcessor:
    def __init__(self, indexer, extractor, nb_threads=8,
                 time_elapsed_failed=TIME_ELAPSED_FAILED, verbose=0):
        self.indexer = indexer
        self.extractor = extractor
        self.extr_str = extractor.extr_str.split(":", 1)[1]
        self.nb_threads = nb_threads
        self.time_elapsed_failed = time_elapsed_failed
        self.verbose = verbose
        #: one dict per processed update: id, image count, stage seconds
        self.update_times = []

    # -------------------------------------------------------------- claims

    def is_update_claimable(self, cols):
        """Unstarted, or started too long ago
        (reference: extraction_processor.py:247-293)."""
        col_upproc = self.indexer.get_col_upproc()
        col_upstart = self.indexer.get_col_upstart()
        if col_upproc in cols:
            return False
        if col_upstart in cols:
            try:
                started = float(cols[col_upstart])
            except (TypeError, ValueError):
                started = 0.0
            if time.time() - started < self.time_elapsed_failed:
                return False
        return True

    def claim(self, update_id):
        self.indexer.push_dict_rows(
            {update_id: {self.indexer.get_col_upstart(): str(time.time())}},
            self.indexer.table_updateinfos_name)

    # ------------------------------------------------------------- buffers

    def _get_buffer(self, sha1, cols):
        """Row buffer column > local path > URL download
        (reference: extraction_processor.py:562-662)."""
        import io

        from columbiaimagesearch_tpu_torch.imgio.imgio import (
            get_buffer_from_B64,
            get_buffer_from_filepath,
            get_buffer_from_URL,
        )

        col_buff = self.indexer.get_col_imgbuff()
        col_path = self.indexer.get_col_imgpath()
        col_url = self.indexer.get_col_imgurl()
        col_urlbak = self.indexer.get_col_imgurlbak()
        if col_buff in cols:
            try:
                return get_buffer_from_B64(cols[col_buff])
            except Exception:
                pass
        if col_path in cols:
            path = cols[col_path]
            if isinstance(path, bytes):
                path = path.decode()
            try:
                return get_buffer_from_filepath(path)
            except Exception:
                pass
        for col in (col_url, col_urlbak):
            if col in cols:
                url = cols[col]
                if isinstance(url, bytes):
                    url = url.decode()
                try:
                    return get_buffer_from_URL(url)
                except Exception:
                    continue
        return None

    def fetch_buffers(self, rows):
        """Thread-pool acquisition (the ThreadedDownloaderBufferOnly role,
        reference: extraction_processor.py:50-108)."""
        out = {}
        with concurrent.futures.ThreadPoolExecutor(self.nb_threads) as pool:
            futs = {pool.submit(self._get_buffer, r, c): r
                    for r, c in rows}
            for fut in concurrent.futures.as_completed(futs):
                out[futs[fut]] = fut.result()
        return out

    # ------------------------------------------------------------ the work

    def process_update(self, update_id, sha1s):
        """Extract one update; returns (#processed, #failed)."""
        timer = StageTimer()
        with timer.stage("fetch"):
            self.claim(update_id)
            rows = self.indexer.get_rows_by_batch(
                sha1s, self.indexer.table_sha1infos_name)
            buffers = self.fetch_buffers(rows)
        ordered = [(r, buffers.get(r)) for r, _ in rows]
        valid = [(r, b) for r, b in ordered if b is not None]
        missing = [r for r, b in ordered if b is None]

        out_rows = {}
        n_ok = 0
        if valid:
            with timer.stage("extract"):
                outs = self.extractor.process_batch([b for _, b in valid])
            for (sha1, _), cols in zip(valid, outs):
                cols[self.extractor.extr_str + "_updateid"] = update_id
                out_rows[sha1] = cols
                if cols.get(self.extractor.extr_str_processed) == "1":
                    n_ok += 1
        for sha1 in missing:
            out_rows[sha1] = dict(self.extractor.failed_out_dict())
        with timer.stage("write"):
            if out_rows:
                self.indexer.push_dict_rows(
                    out_rows, self.indexer.table_sha1infos_name)

            marks = {self.indexer.get_col_upproc(): str(time.time())}
            if not missing and n_ok + (len(valid) - n_ok) == len(sha1s):
                marks[self.indexer.get_col_upcomp()] = str(1)
            self.indexer.push_dict_rows({update_id: marks},
                                        self.indexer.table_updateinfos_name)
        self.update_times.append(dict(
            update_id=update_id, images=len(sha1s), ok=n_ok,
            **{f"{k}_s": v for k, v in timer.totals.items()}))
        return n_ok, len(sha1s) - n_ok

    def run_once(self, start_date="1970-01-01", max_updates=None):
        """Process all claimable unprocessed updates; returns update ids
        processed (the reference's run/process_batch loop,
        extraction_processor.py:518-907)."""
        done = []
        col_list = self.indexer.get_col_listsha1s()
        for batch in self.indexer.get_unprocessed_updates_from_date(
                start_date, extr_type=self.extr_str):
            for update_id, cols in batch:
                if not self.is_update_claimable(cols):
                    continue
                if col_list not in cols:
                    continue
                sha1s = cols[col_list]
                if isinstance(sha1s, bytes):
                    sha1s = sha1s.decode()
                self.process_update(update_id, sha1s.split(","))
                done.append(update_id)
                if max_updates and len(done) >= max_updates:
                    return done
        return done

    def check_missing(self, start_date="1970-01-01"):
        """Re-extraction pass for images whose features are missing
        (reference: extraction_processor.py:366-419)."""
        redone = []
        for batch in self.indexer.get_missing_extr_updates_from_date(
                start_date, extr_type=self.extr_str):
            for update_id, cols in batch:
                sha1s = cols[self.indexer.get_col_listsha1s()]
                if isinstance(sha1s, bytes):
                    sha1s = sha1s.decode()
                self.process_update(update_id, sha1s.split(","))
                redone.append(update_id)
        return redone
