"""Debug printer for any ingester/bus topic (copy of
scripts/bus_printer.py:1-67, with the port's builders).

The role of the reference's KafkaPrinter
(reference: cufacesearch/ingester/kafka_printer.py:7-50): drain a topic and
print up to ``max_print`` messages, optionally only selected fields — the
quick "what is on this topic" inspection tool.

Usage:
    python -m columbiaimagesearch_tpu_torch.pipeline.bus_printer \\
        --journal /data/bus.jsonl --topic images \\
        [--group printer] [--max-print 10] [--fields sha1 img_path]
    python -m columbiaimagesearch_tpu_torch.pipeline.bus_printer \\
        --conf conf.json [--prefix IMG_ING_] ...
"""

import argparse
import json


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--journal", help="MemoryBus journal file")
    ap.add_argument("--topic", default="images")
    ap.add_argument("--group", default="printer")
    ap.add_argument("--conf", help="conf JSON; builds the ingester via the "
                                   "factory (IMG_ING_ prefix)")
    ap.add_argument("--prefix", default="IMG_ING_")
    ap.add_argument("--max-print", type=int, default=10)
    ap.add_argument("--fields", nargs="*", default=None)
    args = ap.parse_args(argv)

    if args.conf:
        from columbiaimagesearch_tpu_torch.common.factory import (
            build_ingester,
        )

        with open(args.conf) as f:
            conf = json.load(f)
        ingester = build_ingester(conf, prefix=args.prefix)
    elif args.journal:
        from columbiaimagesearch_tpu_torch.pipeline.ingest import (
            MemoryBus,
            MemoryBusIngester,
        )

        bus = MemoryBus(journal_path=args.journal)
        ingester = MemoryBusIngester(bus, args.topic, args.group)
    else:
        ap.error("need --journal or --conf")

    count = 0
    for msg in ingester.get_msg_json():
        if count >= args.max_print:
            print(f"[BusPrinter] Reached maximum number of print out. "
                  f"Leaving.")
            return
        if args.fields:
            shown = [msg.get(f) for f in args.fields if f in msg]
        else:
            shown = [json.dumps(msg)]
        print(f"[BusPrinter: msg] keys: {sorted(msg)}, data: {shown}")
        count += 1
    print(f"[BusPrinter] topic drained after {count} messages.")


if __name__ == "__main__":
    main()
