"""Push local images onto the message bus, forever (copy of
scripts/run_images_pusher.py:1-67, with the port's builders).

The role of the reference's LocalImagePusher service
(reference: pusher/local_images_pusher.py:21-221 + scripts/
run_images_pusher.sh): walk a local directory (optionally seeded from an
archive), emit one message per new image to the configured pusher
(memory bus / Kafka / Kinesis), sleep, rescan for new files. Runs on the
host only.

Usage: python -m columbiaimagesearch_tpu_torch.pipeline.run_images_pusher \\
          -c conf/conf_ingester_local.json [--once]
"""

import argparse
import sys
import time


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("-c", "--conf", required=True)
    ap.add_argument("--poll-delay", type=int, default=60,
                    help="seconds between directory rescans "
                         "(reference local_images_pusher.py:219-221)")
    ap.add_argument("--once", action="store_true",
                    help="one pass over the directory, then exit")
    args = ap.parse_args(argv)

    from columbiaimagesearch_tpu_torch.common.factory import (
        build_ingester,
        build_pusher,
    )
    from columbiaimagesearch_tpu_torch.common.profiling import ThroughputStats

    source = build_ingester(args.conf)   # IMG_ING_: the local dir walker
    pusher = build_pusher(args.conf)     # IMG_PUSH_: memory/kafka/kinesis
    stats = ThroughputStats("images_pusher", report_every=1000)

    nb_err = 0
    while True:
        try:
            n = 0
            for msg in source.get_msg_json():
                pusher.send(msg)
                stats.toc_ok()
                n += 1
            if n:
                print(f"[images_pusher] pushed {n} new images", flush=True)
            nb_err = 0
            if args.once:
                return
            time.sleep(args.poll_delay)
        except KeyboardInterrupt:
            return
        except Exception as inst:  # noqa: BLE001 — the loop retries forever
            nb_err += 1
            delay = min(10 * nb_err, 600)
            print(f"[images_pusher] error ({nb_err}): {inst}; "
                  f"retrying in {delay}s", file=sys.stderr)
            time.sleep(delay)


if __name__ == "__main__":
    main()
