"""The port's recall evaluation (``index/eval_recall.py``) against
scripts/eval_recall.py on the CPU, at n 20,000, dim 32, V 16, 20 queries.

The JAX script runs whole (``sys.argv`` patched) with its searcher class
wrapped to record the model, the rerank store's rows (the data) and each
wave's queries. The port's host-seed data and queries equal those rows
exactly, and its ground truth equals the JAX script's brute force
(``chunk_nn``, copied below) exactly. With the JAX model carried across,
each method's recall@k is within 0.05 of the JAX script's (ADC ties may
order rows differently), and the artifact has the JAX artifact's keys.
"""

import json
import os
import sys

import numpy as np
import pytest

from columbiaimagesearch_tpu_torch.index import eval_recall
from columbiaimagesearch_tpu_torch.index.model import LOPQModel

ARGS = ["--n", "20000", "--dim", "32", "--V", "16", "--train-n", "4000",
        "--queries", "20", "--quota", "2000", "--probe-widths", "0,8"]
RECALL_ATOL = 0.05


def _jax_chunk_nn(queries, X):
    """The JAX script's brute force (scripts/eval_recall.py:157-164), one
    chunk (20,000 rows is less than one)."""
    import jax.numpy as jnp

    qd, Xc = jnp.asarray(queries), jnp.asarray(X)
    d = (jnp.sum(Xc * Xc, 1)[None, :]
         - 2.0 * jnp.dot(qd, Xc.T, preferred_element_type=jnp.float32,
                         precision="highest"))
    return np.asarray(jnp.argmin(d, axis=1)).astype(np.int64)


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """The JAX script's artifact and what its searchers were given."""
    mp = pytest.MonkeyPatch()
    had_cache_env = "JAX_COMPILATION_CACHE_DIR" in os.environ
    try:
        from columbiaimagesearch_tpu.index import searcher as jax_searcher

        from scripts import eval_recall as jax_eval_recall

        seen = {"queries": []}
        Base = jax_searcher.LOPQSearcherTPU

        class Recording(Base):
            def __init__(self, model, *a, **kw):
                seen["model"] = model
                super().__init__(model, *a, **kw)

            def add_codes(self, codes, ids=None, feats=None):
                if feats is not None:
                    seen["X"] = np.array(feats)
                return super().add_codes(codes, ids, feats=feats)

            def search_batch(self, X, *a, **kw):
                seen["queries"].append(np.array(X))
                return super().search_batch(X, *a, **kw)

        mp.setattr(jax_searcher, "LOPQSearcherTPU", Recording)
        out = tmp_path_factory.mktemp("jax") / "recall.json"
        mp.setattr(sys, "argv", ["eval_recall.py", *ARGS, "--cpu", "--out",
                                 str(out)])
        jax_eval_recall.main()
        with open(out) as f:
            seen["artifact"] = json.load(f)
    finally:
        mp.undo()
        if not had_cache_env:
            os.environ.pop("JAX_COMPILATION_CACHE_DIR", None)
    return seen


def test_data_queries_and_ground_truth_equal_jax(jax_run):
    args = eval_recall.parse_args(ARGS + ["--cpu"])
    data = eval_recall.SynthData(args.n, args.dim, args.train_n,
                                 args.queries, args.query_noise,
                                 args.stream_synth, "cpu")
    np.testing.assert_array_equal(data.X, jax_run["X"])
    for q in jax_run["queries"]:
        np.testing.assert_array_equal(data.queries, q)
    assert data.train.shape == (4000, 32)
    nns = eval_recall.ground_truth(data)
    np.testing.assert_array_equal(nns, _jax_chunk_nn(data.queries, data.X))
    # A chunk of fewer rows than the data: the same neighbours.
    small = eval_recall.CH
    try:
        eval_recall.CH = 6000
        assert data.n_chunks == 4
        np.testing.assert_array_equal(eval_recall.ground_truth(data), nns)
        rows = data.rows_of([3, 19999, 6000])
        np.testing.assert_array_equal(rows, data.X[[3, 19999, 6000]])
    finally:
        eval_recall.CH = small


def test_methods_on_the_carried_model_match_jax_recalls(jax_run):
    """Each method of the port on the JAX-trained model within 0.05 of
    the JAX script's recall@k; the artifact has the JAX artifact's keys."""
    jm = jax_run["model"]
    model = LOPQModel.from_numpy(jm.Cs, jm.Rs, jm.mus, jm.subquantizers,
                                 device="cpu")
    args = eval_recall.parse_args(ARGS + ["--cpu"])
    data = eval_recall.SynthData(args.n, args.dim, args.train_n,
                                 args.queries, args.query_noise, False, "cpu")
    nns = eval_recall.ground_truth(data)
    coarse, fine = eval_recall.encode(model, data)
    want_c, want_f = jm.predict_batch(data.X)
    np.testing.assert_array_equal(coarse, want_c)
    np.testing.assert_array_equal(fine, want_f)
    runs = eval_recall.probed_sweep(model, coarse, fine, data.queries, nns,
                                    [0, 8], [args.quota])
    runs.append(eval_recall.probed_rerank(model, coarse, fine, data.X,
                                          data.queries, nns, args.quota,
                                          "auto"))
    row, exact_ids = eval_recall.exhaustive_exact(model, coarse, fine,
                                                  data.queries, nns)
    runs.append(row)
    assert len(exact_ids) == 20 and all(len(i) == 100 for i in exact_ids)
    want = jax_run["artifact"]["runs"]
    assert len(runs) == len(want) == 4
    for got, w in zip(runs, want):
        assert set(got) == set(w)
        for k in ("method", "probe_width", "rerank", "rerank_dtype"):
            assert got.get(k) == w.get(k)
        for k in (1, 10, 100):
            assert abs(got[f"recall@{k}"] - w[f"recall@{k}"]) <= RECALL_ATOL, (
                got, w)


def test_main_writes_the_jax_artifact_schema(jax_run, tmp_path, capsys):
    out = tmp_path / "port.json"
    artifact = eval_recall.main(ARGS + ["--cpu", "--out", str(out),
                                        "--skip-exact"])
    with open(out) as f:
        assert json.load(f) == artifact
    want = jax_run["artifact"]
    assert set(want["config"]) <= set(artifact["config"])
    assert artifact["config"]["device"] == "cpu"
    assert [r["method"] for r in artifact["runs"]] == \
        [r["method"] for r in want["runs"][:3]]
    printed = [json.loads(line) for line in
               capsys.readouterr().out.splitlines() if line.startswith("{")]
    assert printed == artifact["runs"]


def test_stream_synth_chunks_are_seeded_on_the_device():
    """``--stream-synth``: chunk c is remade from a generator seeded
    1000 + c, the last chunk cut at n; rows_of and the ground truth read
    the same rows."""
    small = eval_recall.CH
    try:
        eval_recall.CH = 4096
        data = eval_recall.SynthData(10000, 16, 100, 5, 0.1, True, "cpu")
        assert data.X is None and data.n_chunks == 3
        c2 = data.chunk(2)
        assert c2.shape == (10000 - 2 * 4096, 16)
        np.testing.assert_array_equal(data.chunk(2).numpy(), c2.numpy())
        assert not np.array_equal(data.chunk(1)[:10].numpy(),
                                  data.chunk(0)[:10].numpy())
        X = np.concatenate([data.chunk(c).numpy() for c in range(3)])
        np.testing.assert_array_equal(data.rows_of([5, 9999, 4096]),
                                      X[[5, 9999, 4096]])
        nns = eval_recall.ground_truth(data)
        d = ((data.queries[:, None, :] - X[None]) ** 2).sum(-1)
        np.testing.assert_array_equal(nns, d.argmin(1))
    finally:
        eval_recall.CH = small
