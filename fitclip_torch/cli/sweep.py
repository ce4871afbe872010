"""Hyperparameter search (port of ``fitclip_tpu/cli/sweep.py``, numpy only,
copied; the reference's Optuna sweeper role, config/hparam_search/). Two
samplers:

- ``random``: the reference config's RandomSampler semantics;
- ``tpe``: a Tree-structured Parzen Estimator (Bergstra et al.): after a few
  random startup trials, the history splits at the best quantile; numeric
  params draw candidates from a Parzen (Gaussian-kernel) density over the
  good values and keep the one with the best good/bad density ratio;
  categorical params sample from smoothed good counts.

Each trial deep-copies the composed config, samples the search space, runs the
command and reads the optimized metric from the run's return value.
"""

import copy
import logging
import math
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np

LOGGER = logging.getLogger(__name__)


def sample_value(spec: Mapping[str, Any], rng: np.random.Generator):
    kind = spec.get("type", "uniform")
    if kind == "uniform":
        return float(rng.uniform(spec["low"], spec["high"]))
    if kind == "loguniform":
        return float(math.exp(rng.uniform(math.log(spec["low"]),
                                          math.log(spec["high"]))))
    if kind == "int":
        return int(rng.integers(spec["low"], spec["high"] + 1))
    if kind == "choice":
        options = spec["options"]
        return options[int(rng.integers(0, len(options)))]
    raise ValueError(f"Unknown search-space type: {kind}")


class TpeSampler:
    """Minimal TPE over the flat search space. Maximization is handled by the
    caller passing scores already oriented so HIGHER is better."""

    def __init__(self, space: Mapping[str, Mapping[str, Any]],
                 rng: np.random.Generator, n_startup: int = 8,
                 gamma: float = 0.25, n_candidates: int = 24) -> None:
        self.space = space
        self.rng = rng
        self.n_startup = n_startup
        self.gamma = gamma
        self.n_candidates = n_candidates
        self.history: List[Tuple[Dict[str, Any], float]] = []

    def tell(self, params: Dict[str, Any], score: float) -> None:
        self.history.append((params, float(score)))

    def _split(self):
        ranked = sorted(self.history, key=lambda kv: kv[1], reverse=True)
        n_good = max(1, int(math.ceil(self.gamma * len(ranked))))
        return ranked[:n_good], ranked[n_good:]

    @staticmethod
    def _to_internal(spec, value) -> float:
        return math.log(value) if spec.get("type") == "loguniform" else float(value)

    @staticmethod
    def _from_internal(spec, value: float):
        if spec.get("type") == "loguniform":
            return float(math.exp(value))
        if spec.get("type") == "int":
            return int(round(value))
        return float(value)

    def _parzen_draw(self, spec, good_vals, bad_vals):
        low = self._to_internal(spec, spec["low"])
        high = self._to_internal(spec, spec["high"])
        span = high - low
        centers = np.asarray([self._to_internal(spec, v) for v in good_vals])
        bad = np.asarray([self._to_internal(spec, v) for v in bad_vals])
        # Parzen bandwidth: heuristic span / sqrt(n), floored.
        width = max(span / max(math.sqrt(len(centers)), 1.0), 1e-3 * span)

        def density(points, at):
            if len(points) == 0:
                return np.full_like(at, 1.0 / span)
            diffs = (at[:, None] - points[None, :]) / width
            return np.exp(-0.5 * diffs ** 2).sum(axis=1) / (len(points) * width)

        picks = centers[self.rng.integers(0, len(centers), self.n_candidates)]
        candidates = np.clip(picks + self.rng.normal(0, width, self.n_candidates),
                             low, high)
        ratio = density(centers, candidates) / (density(bad, candidates) + 1e-12)
        value = self._from_internal(spec, float(candidates[int(np.argmax(ratio))]))
        # Re-clamp in EXTERNAL space: the log-space round-trip can exceed the
        # bound by float epsilon (exp(log(100)) = 100.00000000000004).
        return min(max(value, spec["low"]), spec["high"])

    def _categorical_draw(self, spec, good_vals):
        options = spec["options"]
        counts = np.ones(len(options), dtype=np.float64)  # +1 smoothing prior
        for value in good_vals:
            counts[options.index(value)] += 1.0
        return options[int(self.rng.choice(len(options), p=counts / counts.sum()))]

    def suggest(self) -> Dict[str, Any]:
        if len(self.history) < self.n_startup:
            return {path: sample_value(spec, self.rng)
                    for path, spec in self.space.items()}
        good, bad = self._split()
        sampled: Dict[str, Any] = {}
        for path, spec in self.space.items():
            good_vals = [p[path] for p, _ in good]
            bad_vals = [p[path] for p, _ in bad]
            if spec.get("type") == "choice":
                sampled[path] = self._categorical_draw(spec, good_vals)
            else:
                sampled[path] = self._parzen_draw(spec, good_vals, bad_vals)
        return sampled


def _set_dotted(cfg: Dict[str, Any], path: str, value) -> None:
    node = cfg
    keys = path.split(".")
    for key in keys[:-1]:
        node = node.setdefault(key, {})
    node[keys[-1]] = value


def run_sweep(cfg: Dict[str, Any], run_fn) -> Tuple[Optional[float], Dict[str, Any]]:
    """Returns (best_value, best_params)."""
    sweep_cfg = cfg["hparam_search"]
    n_trials = int(sweep_cfg.get("n_trials", 10))
    direction = sweep_cfg.get("direction", "maximize")
    space = sweep_cfg.get("search_space", {})
    rng = np.random.default_rng(int(sweep_cfg.get("seed", 0)))
    sampler_kind = sweep_cfg.get("sampler", "random")
    sampler = None
    if sampler_kind == "tpe":
        sampler = TpeSampler(space, rng,
                             n_startup=int(sweep_cfg.get("n_startup_trials", 8)))
    elif sampler_kind != "random":
        raise ValueError(f"Unknown sampler {sampler_kind!r}: expected random|tpe")
    sign = 1.0 if direction == "maximize" else -1.0

    best_value: Optional[float] = None
    best_params: Dict[str, Any] = {}
    for trial in range(n_trials):
        trial_cfg = copy.deepcopy(cfg)
        trial_cfg.pop("hparam_search", None)
        if sampler is not None:
            sampled = sampler.suggest()
        else:
            sampled = {path: sample_value(spec, rng) for path, spec in space.items()}
        for path, value in sampled.items():
            _set_dotted(trial_cfg, path, value)
        LOGGER.info("trial %d/%d: %s", trial + 1, n_trials, sampled)
        value = run_fn(trial_cfg)
        if value is None:
            LOGGER.warning("trial %d returned no optimized metric "
                           "(set optimized_metric_name)", trial + 1)
            continue
        if sampler is not None:
            sampler.tell(sampled, sign * float(value))
        better = (best_value is None or
                  (value > best_value if direction == "maximize" else value < best_value))
        if better:
            best_value, best_params = float(value), sampled
        LOGGER.info("trial %d value=%s best=%s", trial + 1, value, best_value)
    LOGGER.info("sweep done: best=%s with %s", best_value, best_params)
    return best_value, best_params
