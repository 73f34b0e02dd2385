"""Tree-structured Parzen Estimator for 1-D log-uniform search (the port's copy
of ``dusty_gan_tpu/utils/tpe.py``: the same seed gives the same trials).

A dependency-free implementation of the sampler the reference drives
through Ray Tune + HyperOpt (``tune_tolerance.py:161-184``): after a
random startup phase, observations are split at the gamma-quantile of the
objective; two adaptive Parzen (Gaussian-mixture) densities l(x) / g(x)
are fit to the good / bad halves in log space, and the next trial
maximizes the expected-improvement surrogate l(x)/g(x) over candidates
drawn from l. Bandwidths follow HyperOpt's adaptive-Parzen rule (distance
to neighbors, clipped), and a uniform prior component regularizes both
mixtures.

Only the 1-D continuous case is implemented — that is the whole search
space of the tolerance tuner (log-uniform tol).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Tuple

import numpy as np


def _adaptive_parzen(points: np.ndarray, lo: float, hi: float):
    """HyperOpt-style mixture: sorted centers, bandwidth = max gap to the
    neighboring centers (domain edges padding), clipped to sane bounds;
    plus a uniform prior component."""
    pts = np.sort(np.asarray(points, np.float64))
    ext = np.concatenate([[lo], pts, [hi]])
    bw = np.maximum(pts - ext[:-2], ext[2:] - pts)
    span = hi - lo
    bw = np.clip(bw, span / min(100.0, 1.0 + len(pts)), span)
    return pts, bw


def _log_mixture_pdf(x: np.ndarray, pts: np.ndarray, bw: np.ndarray,
                     lo: float, hi: float) -> np.ndarray:
    """log pdf of (uniform prior + equally-weighted Gaussians)."""
    k = len(pts)
    x = np.asarray(x, np.float64)[:, None]
    z = (x - pts[None, :]) / bw[None, :]
    comp = np.exp(-0.5 * z * z) / (bw[None, :] * np.sqrt(2 * np.pi))
    prior = 1.0 / (hi - lo)
    pdf = (prior + comp.sum(axis=1)) / (k + 1.0)
    return np.log(np.maximum(pdf, 1e-300))


def _sample_mixture(rng: np.random.RandomState, n: int, pts: np.ndarray,
                    bw: np.ndarray, lo: float, hi: float) -> np.ndarray:
    k = len(pts)
    out = np.empty(n)
    for i in range(n):
        j = rng.randint(-1, k)  # -1 = the uniform prior component
        if j < 0:
            out[i] = rng.uniform(lo, hi)
        else:
            # truncate by resampling (few iterations in practice)
            for _ in range(32):
                v = rng.normal(pts[j], bw[j])
                if lo <= v <= hi:
                    break
            out[i] = np.clip(v, lo, hi)
    return out


def tpe_minimize(
    objective: Callable[[float], float],
    lo: float,
    hi: float,
    num_samples: int = 100,
    seed: int = 0,
    n_startup: int = 20,
    gamma: float = 0.25,
    n_candidates: int = 24,
    log_space: bool = True,
    callback: Callable[[int, float, float, float], None] = None,
) -> Tuple[float, float, List[Dict]]:
    """Minimize ``objective(x)`` over [lo, hi] (sampled log-uniformly when
    ``log_space``).  Returns (best_x, best_y, trials).  Thin wrapper over
    ``tpe_minimize_batched`` with batch=1 (same proposal rule — one
    implementation to maintain)."""
    state = {"i": 0, "best_x": None, "best_y": float("inf")}

    def objective_batch(xs):
        ys = []
        for x in xs:
            y = float(objective(x))
            ys.append(y)
            if y < state["best_y"]:
                state["best_x"], state["best_y"] = x, y
            if callback is not None:
                callback(state["i"], x, y, state["best_x"])
            state["i"] += 1
        return ys

    return tpe_minimize_batched(
        objective_batch, lo, hi, num_samples=num_samples, seed=seed,
        n_startup=n_startup, gamma=gamma, n_candidates=n_candidates,
        log_space=log_space, batch=1,
    )


def tpe_minimize_batched(
    objective_batch: Callable[[List[float]], List[float]],
    lo: float,
    hi: float,
    num_samples: int = 100,
    seed: int = 0,
    n_startup: int = 20,
    gamma: float = 0.25,
    n_candidates: int = 64,
    log_space: bool = True,
    batch: int = 1,
) -> Tuple[float, float, List[Dict]]:
    """q-parallel TPE: per round propose ``batch`` points (startup: iid
    uniforms; after: the top-q EI candidates, a standard q-EI
    approximation) and evaluate them with ONE ``objective_batch(xs)``
    call — the evaluator can then vectorize the batch over a device mesh
    (the reference runs trials concurrently under Ray,
    tune_tolerance.py:161-184).  ``batch=1`` degenerates to sequential
    TPE with the same proposal rule."""
    tlo, thi = (np.log(lo), np.log(hi)) if log_space else (lo, hi)
    to_x = (lambda t: float(np.exp(t))) if log_space else float

    rng = np.random.RandomState(seed)
    ts: List[float] = []
    ys: List[float] = []
    trials: List[Dict] = []
    while len(trials) < num_samples:
        q = min(batch, num_samples - len(trials))
        if len(ts) < n_startup:
            props = [float(rng.uniform(tlo, thi)) for _ in range(q)]
        else:
            order = np.argsort(ys)
            n_below = max(1, int(np.ceil(gamma * len(ys))))
            below = np.asarray(ts)[order[:n_below]]
            above = np.asarray(ts)[order[n_below:]]
            l_pts, l_bw = _adaptive_parzen(below, tlo, thi)
            g_pts, g_bw = _adaptive_parzen(above, tlo, thi)
            cands = _sample_mixture(rng, max(n_candidates, 4 * q), l_pts, l_bw,
                                    tlo, thi)
            ei = _log_mixture_pdf(cands, l_pts, l_bw, tlo, thi) - _log_mixture_pdf(
                cands, g_pts, g_bw, tlo, thi
            )
            props = [float(c) for c in cands[np.argsort(-ei)[:q]]]
        xs = [to_x(t) for t in props]
        ys_new = [float(y) for y in objective_batch(xs)]
        assert len(ys_new) == len(xs)
        ts.extend(props)
        ys.extend(ys_new)
        trials.extend({"x": x, "y": y} for x, y in zip(xs, ys_new))
    b = int(np.argmin(ys))
    return to_x(ts[b]), float(ys[b]), trials
