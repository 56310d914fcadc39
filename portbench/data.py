"""Inputs made from seeds: the model tables and the corpus rows from the
configuration's ``index_seed``, the queries from the run's ``--seed``, all
on the device in a few large calls. Every feature is unit-norm, as the
facade's served routes hand queries to the index (``searcher_lopq.py``
``search_from_feats`` L2-normalizes each) and as the corpus must be for
those queries to find it (ingest indexes the features as extracted).

The generators are copies of ``chip_smoke.py``'s (``mixture``,
``raw_source``, ``raw_rows``, ``make_model``), seeded through one
generator a stream, so each input can be drawn again alone:
the reference draws the corpus rows anew once the program's state is
freed. The benchmark, not the program, makes every input; the program
gets the tables, the rows and the queries, and the reference gets the
same ones.
"""

import torch

#: streams of one seed: each input has its own generator
MODEL, ROWS, QUERIES, SAMPLE = 1, 2, 3, 4
#: rows a chunk of the raw noise's squared norm outside the PCA basis
PERP_CHUNK = 1 << 15


def derive(seed, stream):
    """A 63-bit generator seed for ``stream`` of the run's ``seed`` (any
    whole number, larger than 32 bits too)."""
    return (int(seed) * 0x9E3779B97F4A7C15 + stream * 0xBF58476D1CE4E5B9) \
        % (1 << 63)


def generator(dev, seed, stream):
    g = torch.Generator(device=dev)
    g.manual_seed(derive(seed, stream))
    return g


def components(n, dim, g):
    """``n`` unit-norm mixture centres of width ``dim``."""
    comp = torch.randn(n, dim, generator=g, device=g.device)
    return comp / comp.norm(dim=1, keepdim=True)


def mixture(n, comp, g, noise, chunk=1 << 20):
    """``n`` rows of the gaussian mixture: one centre each plus
    ``noise * N(0, I)`` (bench.py:110-125's rows)."""
    D = comp.shape[1]
    out = torch.empty((n, D), dtype=torch.float32, device=comp.device)
    for lo in range(0, n, chunk):
        k = min(chunk, n - lo)
        which = torch.randint(0, comp.shape[0], (k,), generator=g,
                              device=comp.device)
        out[lo:lo + k].normal_(0.0, noise, generator=g)
        out[lo:lo + k] += comp[which]
    return out


def orthonormal_rows(n, dim, g):
    """[n, dim] with orthonormal rows (a seeded QR), n <= dim."""
    return torch.linalg.qr(torch.randn(dim, n, generator=g,
                                       device=g.device))[0].T.contiguous()


def make_tables(train, V, M, S, g):
    """A well-formed random LOPQ model's tables: coarse centroids and
    subquantizers sampled from ``train``, orthogonal rotations from a
    seeded QR, residual means from one assignment pass. Returns a dict of
    Cs [2, V, Dh], Rs [2, V, Dh, Dh], mus [2, V, Dh], subs [2, F, S, Dsub]
    float32."""
    dev = train.device
    n, D = train.shape
    Dh, F = D // 2, M // 2
    Dsub = Dh // F
    halves = train.reshape(n, 2, Dh)
    Cs = torch.stack([halves[torch.randperm(n, generator=g, device=dev)[:V],
                             s] for s in range(2)])
    Rs = torch.linalg.qr(torch.randn(2 * V, Dh, Dh, generator=g,
                                     device=dev))[0].reshape(2, V, Dh, Dh)
    mus = torch.zeros((2, V, Dh), device=dev)
    proj = torch.empty((2, n, Dh), device=dev)
    for s in range(2):
        x = halves[:, s]
        a = torch.argmin((Cs[s] * Cs[s]).sum(1)[None] - 2.0 * x @ Cs[s].T,
                         dim=1)
        res = x - Cs[s][a]
        cnt = torch.bincount(a, minlength=V).clamp(min=1)
        mus[s] = torch.zeros((V, Dh), device=dev).index_add_(0, a, res) \
            / cnt[:, None]
        for lo in range(0, n, 8192):
            aa = a[lo:lo + 8192]
            proj[s, lo:lo + 8192] = torch.bmm(
                Rs[s][aa], (res[lo:lo + 8192] - mus[s][aa])[:, :, None])[..., 0]
    subs = torch.stack([torch.stack([
        proj[s, torch.randperm(n, generator=g, device=dev)[:S],
             f * Dsub:(f + 1) * Dsub] for f in range(F)]) for s in range(2)])
    return dict(Cs=Cs.contiguous(), Rs=Rs.contiguous(), mus=mus,
                subs=subs.contiguous())


class Inputs:
    """Every input of one run of a search configuration (``cfg``, the
    configuration file's dict) on ``dev``. The index (the model's tables
    and the corpus) comes from the configuration's ``index_seed``, as a
    deployment serves one index; the queries come from the run's ``seed``.
    (With an index drawn from each run's seed, the seeded model's cell
    sizes, and with them the probe ladder's rungs, moved a run's rate by
    up to 45% from seed to seed.)

    A feature is a draw of the mixture of ``cfg["components"]`` unit
    centres at width ``cfg["dim"]`` (the index space) with ``row_noise``,
    scaled to unit norm. A ``lopq_pca`` configuration serves raw
    ``cfg["raw_dim"]``-wide features: a raw feature is a mixture draw
    through a seeded orthonormal basis plus ``raw_noise``
    (``chip_smoke.py`` ``raw_rows``), scaled to unit norm, and the model's
    PCA is that basis. The corpus and the model's training rows are the
    PCA image of such features, drawn in the index space directly: the
    mixture draw plus the basis' share of the raw noise, over the raw
    feature's norm, whose part outside the basis is the raw noise's
    squared norm over ``raw_dim - dim`` more gaussians. The same
    distribution, without 4,096-wide rows that no request reads.
    """

    def __init__(self, cfg, seed, dev):
        self.cfg, self.seed, self.dev = cfg, int(seed), dev
        g = generator(dev, cfg["index_seed"], MODEL)
        D = cfg["dim"]
        self.pca = None
        if cfg["model_type"] == "lopq_pca":
            basis = orthonormal_rows(D, cfg["raw_dim"], g)   # [D, raw_dim]
            self.pca = dict(P=basis.T.contiguous(),
                            mu=torch.zeros(cfg["raw_dim"], device=dev))
        self.comp = components(cfg["components"], D, g)
        train = self._index_rows(cfg["train_rows"], g)
        self.tables = make_tables(train, cfg["V"], cfg["M"], cfg["subq"], g)
        del train

    def _index_rows(self, n, g):
        """``n`` corpus rows, [n, dim] float32, drawn from ``g``."""
        c = self.cfg
        noise = c["row_noise"]
        if self.pca is not None:
            # independent gaussians add in variance
            noise = (noise ** 2 + c["raw_noise"] ** 2) ** 0.5
        y = mixture(n, self.comp, g, noise)
        sq = (y * y).sum(1)
        if self.pca is not None:
            extra = c["raw_dim"] - c["dim"]
            for lo in range(0, n, PERP_CHUNK):
                k = min(PERP_CHUNK, n - lo)
                w = torch.randn((k, extra), generator=g, device=y.device)
                sq[lo:lo + k] += c["raw_noise"] ** 2 * w.square_().sum(1)
        return y.div_(sq.sqrt_()[:, None])

    def rows(self):
        """The corpus, [rows, dim] float32; the same on every call."""
        g = generator(self.dev, self.cfg["index_seed"], ROWS)
        return self._index_rows(self.cfg["rows"], g)

    def queries(self, n):
        """``n`` unit-norm queries as the program receives them: raw
        features of a ``lopq_pca`` configuration, index-space rows
        otherwise."""
        g = generator(self.dev, self.seed, QUERIES)
        x = mixture(n, self.comp, g, self.cfg["row_noise"])
        if self.pca is not None:
            raw = torch.empty((n, self.cfg["raw_dim"]), device=self.dev)
            raw.normal_(0.0, self.cfg["raw_noise"], generator=g)
            x = raw.addmm_(x, self.pca["P"].T)
        return x.div_(torch.linalg.vector_norm(x, dim=1, keepdim=True))
