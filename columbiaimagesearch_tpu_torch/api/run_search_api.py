"""Run the search REST API on the port (copy of scripts/run_search_api.py:
1-72, with the port's builders).

Builds the searcher from a conf file and serves ``/<endpoint>/<mode>``.
Searcher construction retries like the reference's worker boot
(gunicorn_api.py:43-51); the serving route is pre-warmed before the server
takes traffic.

Usage: python -m columbiaimagesearch_tpu_torch.api.run_search_api \\
          -c conf/conf_search_local.json -e cuimgsearch -p 5000

``--device`` (default ``cuda``) is where the model, the index and the
featurizer live. Without a card the default raises at once, before the
boot retries; ``--device cpu`` serves from the CPU. A conf with
``SEARCHLOPQ_sharded`` (conf/conf_search_sharded.json) row-shards the
index over every visible card, or over one CPU shard with ``--device
cpu``.
"""

import argparse
import json
import sys
import time


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("-c", "--conf", required=True)
    ap.add_argument("-e", "--endpoint", default="cuimgsearch")
    ap.add_argument("-p", "--port", type=int, default=5000)
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--retry-delay", type=int, default=60)
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve from (default: cuda)")
    args = ap.parse_args(argv)

    from columbiaimagesearch_tpu_torch.api.app import make_server
    from columbiaimagesearch_tpu_torch.common.factory import build_searcher
    from columbiaimagesearch_tpu_torch.device import resolve_device

    device = resolve_device(args.device)    # no card: raise, do not retry

    searcher = None
    while searcher is None:
        try:
            searcher = build_searcher(args.conf, device=device)
        except Exception as inst:  # noqa: BLE001 — boot retries forever
            print(f"[run_search_api] searcher init failed: {inst}; "
                  f"retrying in {args.retry_delay}s", file=sys.stderr)
            time.sleep(args.retry_delay)

    # Warm every serving wave size before taking traffic (conf key
    # "prewarm_waves"; defaults to the coalescer's max batch).
    try:
        with open(args.conf) as f:
            conf = json.load(f)
        coalescing = conf.get("SEARCHLOPQ_coalesce_window_ms") is not None
        max_wave = int(conf.get(
            "SEARCHLOPQ_prewarm_waves",
            conf.get("SEARCHLOPQ_coalesce_max_batch", 8)
            if coalescing else 1))
        if max_wave > 0:
            warmed = searcher.prewarm_serving(max_wave)
            print(f"[run_search_api] pre-warmed wave buckets {warmed}",
                  file=sys.stderr)
    except Exception as inst:  # noqa: BLE001 — warm-up is best-effort
        print(f"[run_search_api] prewarm skipped: {inst}", file=sys.stderr)

    server = make_server(searcher, endpoint=args.endpoint, port=args.port,
                         host=args.host,
                         input_type=searcher.input_type)
    print(f"[run_search_api] serving /{args.endpoint}/<mode> "
          f"on {args.host}:{server.server_address[1]}", flush=True)
    server.serve_forever()


if __name__ == "__main__":
    main()
