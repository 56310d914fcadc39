"""Run the extraction pipeline on the port: checker + processor loop (copy
of scripts/run_processing.py:1-64, with the port's builders).

The role of the reference's scripts/run_processing.sh + the daemon wrappers
(reference: updater/extraction_checker.py:462-487 DaemonExtractionChecker,
updater/extraction_processor.py:890-907): poll the ingest source, build
updates, extract them, forever, with linear restart backoff on errors
(crash-only: persistent state in the KV store makes every restart safe).
As in the copied loop, an error inside a pass is retried after the
backoff even with ``--once``: callers check the store, not the exit code.

Usage: python -m columbiaimagesearch_tpu_torch.pipeline.run_processing \\
          -c conf/conf_extraction_local.json [--once]

``--device`` (default ``cuda``) is where the extractor runs. Without a
card the default raises at once, before the loop; ``--device cpu``
extracts on the CPU. Each processed update prints one line
``[run_processing] update {json}`` with its image count and stage seconds
(``ExtractionProcessor.update_times``).
"""

import argparse
import json
import sys
import time


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("-c", "--conf", required=True)
    ap.add_argument("--poll-delay", type=int, default=60,
                    help="seconds between ingest polls")
    ap.add_argument("--once", action="store_true",
                    help="run a single pass and exit")
    ap.add_argument("--device", default="cuda",
                    help="torch device to extract on (default: cuda)")
    args = ap.parse_args(argv)

    from columbiaimagesearch_tpu_torch.common.factory import (
        build_checker,
        build_indexer,
        build_processor,
    )
    from columbiaimagesearch_tpu_torch.device import resolve_device

    device = resolve_device(args.device)    # no card: raise, do not retry
    indexer = build_indexer(args.conf)
    checker = build_checker(args.conf, indexer=indexer)
    processor = build_processor(args.conf, indexer=indexer, device=device)

    nb_err = 0
    while True:
        try:
            n_logged = len(processor.update_times)
            created = checker.run_once()
            processed = processor.run_once()
            for entry in processor.update_times[n_logged:]:
                print(f"[run_processing] update {json.dumps(entry)}",
                      flush=True)
            if created or processed:
                print(f"[run_processing] +{len(created)} updates created, "
                      f"{len(processed)} processed", flush=True)
            nb_err = 0
            if args.once:
                return
            time.sleep(args.poll_delay)
        except KeyboardInterrupt:
            return
        except Exception as inst:  # noqa: BLE001 — the loop retries forever
            nb_err += 1
            delay = min(10 * nb_err, 600)
            print(f"[run_processing] error ({nb_err}): {inst}; "
                  f"restarting in {delay}s", file=sys.stderr, flush=True)
            time.sleep(delay)


if __name__ == "__main__":
    main()
