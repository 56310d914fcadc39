"""Closed-loop HTTP clients of the ``http_closed`` traffic kind, in a child
process of the benchmark: each of its threads posts one image a request
to the search API and sends the next as soon as the reply is in (no think
time). It imports neither torch nor the program, so the clients share the
host with the server and not its interpreter.

    python3 -m portbench.http_clients

is driven by ``kinds/http_closed.py`` over standard input and output, one
JSON line a message. The first line sets the process up: the server's
``port`` and ``path``, the ``threads``, the ``seeds`` of their image
choices (one a thread), each image's ``sha1s`` and the reply's ``limit``;
then one line a pool image, its form body. The process answers
``{"ready": true}``, then runs each command and answers with its counts:

- ``{"cmd": "count", "n": k}``: ``k`` requests in all, over the threads;
- ``{"cmd": "window", "t0": a, "t1": b}``: from ``time.monotonic()`` ``a``
  to ``b``, counting the replies that end inside it;
- ``{"cmd": "quit"}``, or the end of standard input: exit.

A reply counts as failed unless it is HTTP 200, names the posted image's
SHA1 as its query and carries ``limit`` results in ascending distance.
"""

import http.client
import json
import random
import sys
import threading
import time


def check(body, sha1, limit):
    """None for a good reply body, else what is wrong with it."""
    try:
        reply = json.loads(body)
        entry = reply["AllSimilarImages"][0]
        block = entry["SimilarImages"]
        ids, dists = block["ImageSha1s"], block["Distances"]
    except (ValueError, KeyError, IndexError, TypeError) as e:
        return f"malformed reply ({type(e).__name__}: {e}): {body[:200]!r}"
    if entry["QuerySha1"] != sha1:
        return f"reply for {entry['QuerySha1']}, posted {sha1}"
    if len(ids) != limit or len(dists) != limit:
        return f"{len(ids)} results, asked for {limit}"
    if any(b < a for a, b in zip(dists, dists[1:])):
        return "distances out of order"
    return None


class Clients:
    def __init__(self, setup, forms):
        self.port, self.path = setup["port"], setup["path"]
        self.seeds, self.sha1s = setup["seeds"], setup["sha1s"]
        self.limit = setup["limit"]
        self.forms = forms
        self.rngs = [random.Random(s) for s in self.seeds]
        self.lock = threading.Lock()

    def post(self, rng):
        """One request: (image, None or the fault, end time)."""
        i = rng.randrange(len(self.forms))
        conn = http.client.HTTPConnection("127.0.0.1", self.port,
                                          timeout=600)
        try:
            conn.request("POST", self.path, self.forms[i], {
                "Content-Type": "application/x-www-form-urlencoded"})
            r = conn.getresponse()
            body = r.read()
            fault = (f"HTTP {r.status}: {body[:200]!r}" if r.status != 200
                     else check(body, self.sha1s[i], self.limit))
        except (OSError, http.client.HTTPException) as e:
            fault = f"{type(e).__name__}: {e}"
        finally:
            conn.close()
        return i, fault, time.monotonic()

    def run(self, cmd):
        """Run one command on every thread; its counts."""
        counts = {"ok": 0, "failed": 0, "errors": [], "lat_ms": []}
        left = [cmd.get("n", 0)]

        def tally(fault, ms):
            with self.lock:
                if fault is None:
                    counts["ok"] += 1
                    counts["lat_ms"].append(ms)
                else:
                    counts["failed"] += 1
                    if len(counts["errors"]) < 3:
                        counts["errors"].append(fault)

        def by_count(rng):
            while True:
                with self.lock:
                    if left[0] <= 0:
                        return
                    left[0] -= 1
                t = time.monotonic()
                _, fault, end = self.post(rng)
                tally(fault, (end - t) * 1e3)

        def by_time(rng):
            t0, t1 = cmd["t0"], cmd["t1"]
            time.sleep(max(0.0, t0 - time.monotonic()))
            while time.monotonic() < t1:
                t = time.monotonic()
                _, fault, end = self.post(rng)
                if end <= t1:
                    tally(fault, (end - t) * 1e3)

        body = by_count if cmd["cmd"] == "count" else by_time
        cpu, wall = time.process_time(), time.monotonic()
        threads = [threading.Thread(target=body, args=(rng,))
                   for rng in self.rngs]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        counts["cpu_s"] = time.process_time() - cpu
        counts["wall_s"] = time.monotonic() - wall
        return counts


def main():
    setup = json.loads(sys.stdin.readline())
    forms = [sys.stdin.readline().rstrip("\n").encode()
             for _ in range(len(setup["sha1s"]))]
    clients = Clients(setup, forms)
    print(json.dumps({"ready": True}), flush=True)
    for line in sys.stdin:
        cmd = json.loads(line)
        if cmd["cmd"] == "quit":
            break
        print(json.dumps(clients.run(cmd)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
