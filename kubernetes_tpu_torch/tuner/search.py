"""Seeded black-box search over integer weight rows.

Two strategies, one contract — propose {priority name: int weight} rows,
score them with a caller-supplied reward, return the best:

- `CEMSearch` (the default): cross-entropy method. Each generation
  samples `population` rows from an independent per-key Gaussian,
  scores them, keeps the `elite_frac` best, and refits mean/std to the
  elites. Integer weights, clipped into [lo, hi] — and `hi` is itself
  clipped under the apis/policy MAX_WEIGHT bound, so every candidate
  the search can express passes the SAME validation ProfileSet
  construction (and set_row) runs.
- `BanditSearch` (the fallback): epsilon-greedy hill climb around the
  incumbent row — one key perturbed per step. Used when the world set
  is too thin for population ranking to mean anything (CEM elites over
  one tiny world collapse to noise), or when the evaluation budget
  can't fund a single CEM generation.

Everything is driven by one `random.Random(seed)`: same seed + same
worlds (the simulator is deterministic) => identical candidate
sequence, identical ranking, identical winner. Ties break toward the
lexicographically smallest row, so equal-reward runs are stable too.
"""
from __future__ import annotations

import random
from typing import Callable, Optional

from kubernetes_tpu_torch.apis.policy import MAX_WEIGHT

#: default search domain: generous spread around the hand-set vectors
#: (weights are RELATIVE — the oracle sums weight * normalized score, so
#: [1, 100] spans 100:1 priority ratios, far past anything hand-tuned)
DEFAULT_LO = 1
DEFAULT_HI = 100


class TuneResult:
    __slots__ = ("best_weights", "best_reward", "evaluated", "history",
                 "strategy")

    def __init__(self, best_weights: dict, best_reward: float,
                 evaluated: int, history: list, strategy: str):
        self.best_weights = best_weights
        self.best_reward = best_reward
        self.evaluated = evaluated
        self.history = history      # per-generation (best, mean) rewards
        self.strategy = strategy

    def as_dict(self) -> dict:
        return {"best_weights": dict(self.best_weights),
                "best_reward": round(self.best_reward, 6),
                "evaluated": self.evaluated,
                "strategy": self.strategy,
                "history": [(round(b, 3), round(m, 3))
                            for b, m in self.history]}


def _row_key(w: dict) -> tuple:
    return tuple(sorted(w.items()))


class CEMSearch:
    def __init__(self, keys, seed: int = 0, population: int = 16,
                 elite_frac: float = 0.25, iterations: int = 6,
                 lo: int = DEFAULT_LO, hi: int = DEFAULT_HI,
                 init: Optional[dict] = None):
        self.keys = list(keys)
        if not self.keys:
            raise ValueError("CEMSearch needs at least one priority key")
        self.rng = random.Random(seed)
        self.population = max(4, int(population))
        self.n_elite = max(2, int(self.population * elite_frac))
        self.iterations = max(1, int(iterations))
        self.lo = max(1, int(lo))                     # policy: positive
        self.hi = min(int(hi), MAX_WEIGHT - 1)        # policy: < MAX_WEIGHT
        span = self.hi - self.lo
        init = init or {}
        self.mu = {k: float(init.get(k, (self.lo + self.hi) / 2))
                   for k in self.keys}
        self.sigma = {k: max(1.0, span / 4) for k in self.keys}

    def _sample(self) -> dict:
        return {k: int(min(self.hi, max(
            self.lo, round(self.rng.gauss(self.mu[k], self.sigma[k])))))
            for k in self.keys}

    def run(self, score_fn: Callable[[dict], float]) -> TuneResult:
        from kubernetes_tpu_torch.tuner import TUNER_CANDIDATES
        best_w: Optional[dict] = None
        best_r = float("-inf")
        evaluated = 0
        history = []
        for _gen in range(self.iterations):
            pop = [self._sample() for _ in range(self.population)]
            scored = [(score_fn(w), _row_key(w), w) for w in pop]
            evaluated += len(scored)
            TUNER_CANDIDATES.labels("cem").inc(len(scored))
            # reward desc, then row asc: equal rewards rank stably
            scored.sort(key=lambda t: (-t[0], t[1]))
            elites = scored[:self.n_elite]
            if elites[0][0] > best_r or (
                    elites[0][0] == best_r and best_w is not None
                    and elites[0][1] < _row_key(best_w)):
                best_r, best_w = elites[0][0], dict(elites[0][2])
            history.append((elites[0][0],
                            sum(s for s, _k, _w in scored) / len(scored)))
            for k in self.keys:
                vals = [w[k] for _s, _kk, w in elites]
                mean = sum(vals) / len(vals)
                var = sum((v - mean) ** 2 for v in vals) / len(vals)
                self.mu[k] = mean
                # a variance floor keeps late generations exploring one
                # step either way instead of freezing on the first elite
                self.sigma[k] = max(1.0, var ** 0.5)
        return TuneResult(best_w or {}, best_r, evaluated, history, "cem")


class BanditSearch:
    """Epsilon-greedy hill climb around an incumbent row."""

    def __init__(self, keys, seed: int = 0, steps: int = 32,
                 epsilon: float = 0.2, lo: int = DEFAULT_LO,
                 hi: int = DEFAULT_HI, init: Optional[dict] = None):
        self.keys = list(keys)
        if not self.keys:
            raise ValueError("BanditSearch needs at least one priority key")
        self.rng = random.Random(seed)
        self.steps = max(1, int(steps))
        self.epsilon = float(epsilon)
        self.lo = max(1, int(lo))
        self.hi = min(int(hi), MAX_WEIGHT - 1)
        init = init or {}
        self.current = {k: int(min(self.hi, max(self.lo, init.get(k, 1))))
                        for k in self.keys}

    def _neighbor(self, w: dict) -> dict:
        out = dict(w)
        k = self.rng.choice(self.keys)
        if self.rng.random() < self.epsilon:
            out[k] = self.rng.randint(self.lo, self.hi)   # explore: jump
        else:
            step = self.rng.choice((-4, -2, -1, 1, 2, 4))
            out[k] = int(min(self.hi, max(self.lo, out[k] + step)))
        return out

    def run(self, score_fn: Callable[[dict], float]) -> TuneResult:
        from kubernetes_tpu_torch.tuner import TUNER_CANDIDATES
        best_w = dict(self.current)
        best_r = score_fn(best_w)
        evaluated = 1
        history = [(best_r, best_r)]
        for _ in range(self.steps):
            cand = self._neighbor(best_w)
            r = score_fn(cand)
            evaluated += 1
            TUNER_CANDIDATES.labels("bandit").inc()
            if r > best_r or (r == best_r
                              and _row_key(cand) < _row_key(best_w)):
                best_r, best_w = r, cand
            history.append((best_r, r))
        return TuneResult(best_w, best_r, evaluated, history, "bandit")


def tune(worlds: list, keys, seed: int = 0,
         incumbent: Optional[dict] = None, budget: int = 96,
         gang_weight: int = 0, lo: int = DEFAULT_LO,
         hi: int = DEFAULT_HI, min_worlds_for_cem: int = 2) -> TuneResult:
    """The offline search entrypoint: score = summed simulator reward
    over `worlds`. CEM when the world set and budget can fund population
    ranking; the bandit fallback otherwise. Deterministic for a given
    (worlds, keys, seed, budget)."""
    from kubernetes_tpu_torch.tuner import TUNER_BEST_REWARD
    from kubernetes_tpu_torch.tuner.simulator import simulate

    def score(w: dict) -> float:
        return sum(simulate(world, w, gang_weight=gang_weight).reward
                   for world in worlds)

    population = 16
    use_cem = (len(worlds) >= min_worlds_for_cem
               and budget >= 2 * population)
    if use_cem:
        iters = max(1, budget // population)
        res = CEMSearch(keys, seed=seed, population=population,
                        iterations=iters, lo=lo, hi=hi,
                        init=incumbent).run(score)
    else:
        res = BanditSearch(keys, seed=seed, steps=max(1, budget - 1),
                           lo=lo, hi=hi, init=incumbent).run(score)
    TUNER_BEST_REWARD.set(res.best_reward)
    return res
