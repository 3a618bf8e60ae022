"""Searcher plugin API + a bundled TPE searcher (copy of
``ray_tpu/tune/searcher.py``, with the same draws from ``random``).

Reference: ``python/ray/tune/search/searcher.py`` (``Searcher.suggest`` /
``on_trial_complete`` — the interface Optuna/HyperOpt/Ax plug into) and
``search/concurrency_limiter.py``. Sequential searchers see every completed
trial before proposing the next config, unlike ``BasicVariantGenerator``
which pre-expands the whole grid up front; the TuneController pulls
suggestions lazily as concurrency slots free up.

``TPESearcher`` is the bundled non-trivial example: a per-dimension
Tree-structured Parzen Estimator (Bergstra et al. 2011, the algorithm behind
HyperOpt) — observations are split into good/bad by quantile, candidates are
drawn from a KDE over the good set and ranked by the good/bad density ratio.
"""

from __future__ import annotations

import math
import random
from typing import Any, Optional

from ray_tpu_torch.tune.search import Categorical, Domain, Float, GridSearch, Integer, _set_path, _walk

FINISHED = "FINISHED"  # sentinel: searcher is done proposing


class Searcher:
    """Subclass and implement ``suggest``/``on_trial_complete``."""

    def __init__(self, metric: Optional[str] = None, mode: Optional[str] = None):
        self.metric = metric
        self.mode = mode  # None = inherit from TuneConfig at fit time
        self._space: Optional[dict] = None

    def set_search_properties(self, metric: Optional[str], mode: Optional[str], space: dict) -> None:
        # constructor args always win — TuneConfig only fills gaps (its mode
        # DEFAULT of "min" must never override an explicit searcher mode)
        self.metric = self.metric or metric
        if self.mode is None:
            self.mode = mode
        self._space = space

    @property
    def resolved_mode(self) -> str:
        return self.mode or "min"

    def suggest(self, trial_id: str) -> Optional[dict]:
        """A config for this trial; None = wait; FINISHED = no more trials."""
        raise NotImplementedError

    def on_trial_result(self, trial_id: str, result: dict) -> None:
        pass

    def on_trial_complete(
        self, trial_id: str, result: Optional[dict] = None, error: bool = False
    ) -> None:
        pass


class ConcurrencyLimiter(Searcher):
    """Caps in-flight suggestions (reference: ConcurrencyLimiter)."""

    def __init__(self, searcher: Searcher, max_concurrent: int = 4):
        super().__init__(searcher.metric, searcher.mode)  # None passes through
        self.searcher = searcher
        self.max_concurrent = max_concurrent
        self._live: set[str] = set()

    def set_search_properties(self, metric, mode, space):
        super().set_search_properties(metric, mode, space)
        self.searcher.set_search_properties(metric, mode, space)

    def suggest(self, trial_id: str):
        if len(self._live) >= self.max_concurrent:
            return None
        out = self.searcher.suggest(trial_id)
        if isinstance(out, dict):
            self._live.add(trial_id)
        return out

    def on_trial_result(self, trial_id, result):
        self.searcher.on_trial_result(trial_id, result)

    def on_trial_complete(self, trial_id, result=None, error=False):
        self._live.discard(trial_id)
        self.searcher.on_trial_complete(trial_id, result, error)


class RandomSearcher(Searcher):
    """Pure-prior sampling through the Searcher interface (baseline)."""

    def __init__(self, metric=None, mode=None, seed: Optional[int] = None):
        super().__init__(metric, mode)
        self.rng = random.Random(seed)

    def suggest(self, trial_id: str):
        cfg: dict = {}
        for path, v in _walk(self._space or {}):
            if isinstance(v, Domain):
                _set_path(cfg, path, v.sample(self.rng))
            elif isinstance(v, (GridSearch, dict)):
                raise ValueError("grid_search is not supported by sequential searchers")
            else:
                _set_path(cfg, path, v)
        return cfg


class TPESearcher(Searcher):
    """Independent per-dimension TPE.

    good/bad split at the ``gamma`` quantile of observed scores; Float and
    Integer dims use a Gaussian KDE over the good set (bandwidth shrinking
    with #observations), Categorical dims a smoothed count ratio. The first
    ``n_initial`` suggestions sample the prior.
    """

    def __init__(
        self,
        metric: Optional[str] = None,
        mode: Optional[str] = None,
        n_initial: int = 8,
        gamma: float = 0.25,
        n_candidates: int = 24,
        seed: Optional[int] = None,
    ):
        super().__init__(metric, mode)
        self.n_initial = n_initial
        self.gamma = gamma
        self.n_candidates = n_candidates
        self.rng = random.Random(seed)
        self._obs: list[tuple[dict, float]] = []   # (flat config, score)
        self._pending: dict[str, dict] = {}

    # -- observation feed --------------------------------------------------

    def on_trial_complete(self, trial_id, result=None, error=False):
        flat = self._pending.pop(trial_id, None)
        if flat is None or error or not result or self.metric not in result:
            return
        score = float(result[self.metric])
        if self.resolved_mode == "max":
            score = -score
        self._obs.append((flat, score))

    # -- suggestion --------------------------------------------------------

    def suggest(self, trial_id: str):
        if self._space is None:
            raise RuntimeError("set_search_properties was never called")
        leaves = list(_walk(self._space))
        flat: dict[tuple, Any] = {}
        cfg: dict = {}
        use_tpe = len(self._obs) >= self.n_initial
        good, bad = self._split() if use_tpe else ([], [])
        for path, v in leaves:
            if isinstance(v, Domain):
                if use_tpe:
                    val = self._suggest_dim(path, v, good, bad)
                else:
                    val = v.sample(self.rng)
                flat[path] = val
                _set_path(cfg, path, val)
            elif isinstance(v, (GridSearch, dict)) and (
                isinstance(v, GridSearch) or "grid_search" in v
            ):
                raise ValueError("grid_search is not supported by TPESearcher")
            else:
                _set_path(cfg, path, v)
        self._pending[trial_id] = flat
        return cfg

    def _split(self):
        ranked = sorted(self._obs, key=lambda o: o[1])
        n_good = max(1, math.ceil(self.gamma * len(ranked)))
        return ranked[:n_good], ranked[n_good:]

    def _suggest_dim(self, path, domain: Domain, good, bad):
        gvals = [o[0][path] for o in good if path in o[0]]
        bvals = [o[0][path] for o in bad if path in o[0]]
        if not gvals:
            return domain.sample(self.rng)
        if isinstance(domain, Categorical):
            return self._categorical(domain, gvals, bvals)
        if isinstance(domain, (Float, Integer)):
            lo = float(domain.lower)
            hi = float(domain.upper)
            log = isinstance(domain, Float) and domain.log
            tx = math.log if log else (lambda x: float(x))
            inv = math.exp if log else (lambda x: x)
            val = self._numeric(tx(lo), tx(hi), [tx(v) for v in gvals], [tx(v) for v in bvals])
            val = inv(val)
            if isinstance(domain, Integer):
                val = min(domain.upper - 1, max(domain.lower, int(round(val))))
            else:
                val = min(hi, max(lo, val))
            return val
        return domain.sample(self.rng)

    def _numeric(self, lo, hi, gvals, bvals):
        width = max(hi - lo, 1e-12)
        bw = max(width / max(math.sqrt(len(gvals)), 1.0), 1e-3 * width)

        def logpdf(x, vals):
            if not vals:
                return -math.log(width)  # uniform fallback
            acc = 0.0
            for m in vals:
                acc += math.exp(-0.5 * ((x - m) / bw) ** 2)
            return math.log(max(acc / (len(vals) * bw * math.sqrt(2 * math.pi)), 1e-300))

        best, best_score = None, -math.inf
        for _ in range(self.n_candidates):
            m = self.rng.choice(gvals)
            x = min(hi, max(lo, self.rng.gauss(m, bw)))
            score = logpdf(x, gvals) - logpdf(x, bvals)
            if score > best_score:
                best, best_score = x, score
        return best

    def _categorical(self, domain: Categorical, gvals, bvals):
        def probs(vals):
            counts = {c: 1.0 for c in domain.categories}  # +1 smoothing
            for v in vals:
                counts[v] = counts.get(v, 1.0) + 1.0
            total = sum(counts.values())
            return {c: counts[c] / total for c in domain.categories}

        pg, pb = probs(gvals), probs(bvals)
        ratio = {c: pg[c] / pb[c] for c in domain.categories}
        cands = [self._weighted_choice(pg) for _ in range(self.n_candidates)]
        return max(cands, key=lambda c: ratio[c])

    def _weighted_choice(self, p: dict):
        r = self.rng.random()
        acc = 0.0
        for c, w in p.items():
            acc += w
            if r <= acc:
                return c
        return next(iter(p))
