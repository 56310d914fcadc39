"""The import heap's freeze (``common/heap.py``): the first searcher of a
process, single or sharded, collects once and freezes what survived; later
searchers freeze nothing more, concurrent first searchers freeze once, the
searchers' own state stays collectable, and a wave's answers stay those of
the JAX searcher.

Each case runs in a fresh interpreter, so that which test a worker ran
first cannot decide what was frozen.
"""

import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from tests.test_torch_searcher import _assert_results_match

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: the start of every case: a model and corpus as test_torch_searcher's,
#: and the count that the interpreter froze at start-up, if any
PRELUDE = """
import gc, json, sys, threading, time, weakref
import numpy as np
from columbiaimagesearch_tpu_torch.index.model import LOPQModel
from columbiaimagesearch_tpu_torch.index.searcher import LOPQSearcherTorch
from columbiaimagesearch_tpu_torch.parallel.mesh import SHARD_AXIS, make_mesh
from columbiaimagesearch_tpu_torch.parallel.sharded import (
    ShardedLOPQIndex, ShardedLOPQSearcher)
from tests.oracle_lopq import random_params

V, M, S, D, N = 16, 8, 32, 64, 4000
rng = np.random.RandomState(21)
params = random_params(rng, V=V, M=M, S=S, D=D)
model = LOPQModel.from_numpy(*params, device="cpu")
coarse = rng.randint(0, V, (N, 2))
fine = rng.randint(0, S, (N, M))
ids = [f"img{i}" for i in range(N)]
feats = rng.randn(N, D).astype(np.float32)
queries = rng.randn(5, D).astype(np.float32)
before = gc.get_freeze_count()


def build(kind):
    if kind == "single":
        return LOPQSearcherTorch(model)
    mesh = make_mesh(axis=SHARD_AXIS, devices=["cpu"] * 2)
    if kind == "sharded_index":
        return ShardedLOPQIndex(model, mesh=mesh)
    return ShardedLOPQSearcher(model, mesh=mesh)


def filled(kind):
    s = build(kind)
    s.add_codes((coarse, fine), ids, feats=feats)
    s.search_batch(queries, quota=300, limit=20, with_dists=True)
    return s
"""


def _run(body):
    """``PRELUDE`` then ``body`` in a fresh interpreter: what ``body``
    printed last, as JSON."""
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-c", PRELUDE + textwrap.dedent(body)], cwd=REPO,
        env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_first_searcher_freezes_the_heap():
    out = _run("""
        s = LOPQSearcherTorch(model)
        print(json.dumps(dict(s.heap_stats, now=gc.get_freeze_count(),
                              before=before)))
    """)
    assert out["settled_here"] is True
    # torch and numpy alone leave far more than this; reference counting
    # may since have freed a few of them (the freeze's own temporaries)
    assert out["before"] + 10_000 < out["now"] <= out["frozen_objects"]
    assert 0 < out["settle_s"] < 60


@pytest.mark.parametrize("first, second", [
    ("single", "single"),
    ("single", "sharded_index"),
    ("sharded_searcher", "single"),
])
def test_later_searchers_freeze_nothing_more(first, second):
    out = _run(f"""
        a = build({first!r})
        n = gc.get_freeze_count()
        b = build({second!r})
        inner = [x.index.heap_stats for x in (a, b)
                 if isinstance(x, ShardedLOPQSearcher)]
        print(json.dumps(dict(a=a.heap_stats, b=b.heap_stats, inner=inner,
                              n=n, after=gc.get_freeze_count(),
                              before=before)))
    """)
    assert out["a"]["settled_here"] is True
    assert out["before"] < out["n"] <= out["a"]["frozen_objects"]
    assert out["after"] <= out["n"]
    assert out["b"] == dict(out["a"], settled_here=False)
    # the sharded facade's index is built after the facade settled
    n_facades = (first, second).count("sharded_searcher")
    assert [h["settled_here"] for h in out["inner"]] == [False] * n_facades


def test_concurrent_first_searchers_freeze_once():
    out = _run("""
        freezes = []
        real_freeze = gc.freeze

        def slow_freeze():
            freezes.append(threading.get_ident())
            time.sleep(0.05)     # hold the window open for the others
            real_freeze()

        gc.freeze = slow_freeze
        sys.setswitchinterval(1e-6)
        kinds = ["single", "sharded_index", "sharded_searcher"] * 3
        barrier = threading.Barrier(len(kinds))
        stats = [None] * len(kinds)

        def worker(i):
            barrier.wait(timeout=30)
            stats[i] = build(kinds[i]).heap_stats

        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(len(kinds))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        print(json.dumps(dict(freezes=len(freezes), stats=stats,
                              alive=sum(t.is_alive() for t in threads),
                              now=gc.get_freeze_count())))
    """)
    assert out["alive"] == 0
    assert out["freezes"] == 1
    stats = out["stats"]
    assert sum(s["settled_here"] for s in stats) == 1
    assert len({s["frozen_objects"] for s in stats}) == 1
    assert out["now"] <= stats[0]["frozen_objects"]
    assert {s["settle_s"] for s in stats} == {stats[0]["settle_s"]}


@pytest.mark.parametrize("kind", ["single", "sharded_searcher"])
def test_searchers_in_a_cycle_are_collected(kind):
    """The state a searcher builds is allocated after the freeze, and so
    is the first searcher itself: dropped in a reference cycle, each is
    collected."""
    out = _run(f"""
        dead = []
        for _ in range(2):          # the one that froze, then a later one
            s = filled({kind!r})
            n = gc.get_freeze_count()
            s.myself = s
            ref = weakref.ref(s)
            del s
            gc.collect()
            dead.append(ref() is None)
        print(json.dumps(dict(dead=dead, n=n, now=gc.get_freeze_count())))
    """)
    assert out["dead"] == [True, True]
    # building, filling and searching froze nothing
    assert out["now"] <= out["n"]


def test_a_wave_after_the_freeze_answers_as_the_jax_searcher():
    from columbiaimagesearch_tpu.index.model import LOPQModel as JaxModel
    from columbiaimagesearch_tpu.index.model import LOPQCode
    from columbiaimagesearch_tpu.index.searcher import (
        LOPQSearcherTPU,
        ResultDist,
    )

    from tests.oracle_lopq import random_params

    out = _run("""
        s = LOPQSearcherTorch(model)
        s.add_codes((coarse, fine), ids)
        got = s.search_batch(queries, quota=300, limit=20, with_dists=True)
        print(json.dumps(dict(settled=s.heap_stats["settled_here"], got=[
            ([[r.id, float(r.dist), [int(c) for c in r.code.coarse],
               [int(f) for f in r.code.fine]] for r in rows], visited)
            for rows, visited in got])))
    """)
    assert out["settled"] is True
    rng = np.random.RandomState(21)
    params = random_params(rng, V=16, M=8, S=32, D=64)
    coarse = rng.randint(0, 16, (4000, 2))
    fine = rng.randint(0, 32, (4000, 8))
    ids = [f"img{i}" for i in range(4000)]
    rng.randn(4000, 64)             # the features, unused here
    queries = rng.randn(5, 64).astype(np.float32)
    js = LOPQSearcherTPU(JaxModel(parameters=params))
    js.add_codes((coarse, fine), ids)
    want = js.search_batch(queries, quota=300, limit=20, with_dists=True)
    assert len(out["got"]) == len(want) == len(queries)
    for w, (rows, visited) in zip(want, out["got"]):
        got = [ResultDist(i, LOPQCode(tuple(c), tuple(f)), d)
               for i, d, c, f in rows]
        _assert_results_match(w, (got, visited))
