"""Equal-quality stopping driver (a copy of smallpt_tpu/engine/quality.py,
which is pure numpy; the port keeps its own so that it imports nothing of
the JAX package).

The reference's only stopping rules are a fixed spp count (legacy,
smallpt.cpp:276) and "run forever" (interactive, smallpt.cpp:901-941);
this is the production third mode: render until the per-pixel relative
standard error of the luminance mean falls below a target at a pixel
quantile, then drain.

Budget semantics: ``max_spp`` bounds the TOTAL sample pool at
``max_spp * n_pixels`` (the cost of a uniform max_spp render). Adaptive
allocation may push hot pixels above max_spp and leave converged pixels
below it — that is the point of adaptivity; the POOL, not any single
pixel, is what stops the render early.
"""

from __future__ import annotations

import numpy as np

_EPS = 1e-2  # stderr denominators: near-black pixels must not demand
#              unbounded samples for invisible error


def adaptive_allocation(sigma: np.ndarray, add_samples_total: int,
                        n_pixels: int) -> np.ndarray:
    """Distribute a pool of new samples across pixels proportional to
    their luminance standard deviation — the near-optimal per-pixel MC
    allocation, shared by every step_adaptive. Returns int64 (G,) extras
    summing exactly to add_samples_total.

    Uniform floor of 1 when the pool allows it (a pixel whose bootstrap
    samples agreed must keep sampling or its variance signal never
    improves); per-pixel share capped at 8x the mean (raw proportional
    allocation dumps the pool on firefly pixels and starves the rest);
    largest-remainder rounding spends the pool exactly."""
    G = n_pixels
    base = 1 if add_samples_total >= 2 * G else 0
    pool = add_samples_total - base * G
    w_alloc = np.minimum(sigma, 8.0 * sigma.mean())
    alloc = w_alloc / w_alloc.sum() * pool
    extra = np.floor(alloc).astype(np.int64)
    short = int(pool - extra.sum())
    if short > 0:
        order = np.argsort(alloc - extra)[::-1][:short]
        extra[order] += 1
    return extra + base


def drive_to_quality(
    *,
    n_pixels: int,
    have_spp: int,
    moments,
    step_uniform,
    step_adaptive,
    flush,
    rel_err: float,
    quantile: float,
    max_spp: int,
    min_spp: int,
    adaptive: bool,
) -> dict:
    """Drive a renderer to a stderr target or a total-pool budget.

    moments() -> (mean, var, n) flat float64 arrays over pixels (completed
    samples); step_uniform(add_samples), step_adaptive(add_samples_total),
    flush() are the renderer's own stepping surface; have_spp is the
    per-pixel budget already allocated uniformly.

    Returns {"spp_min", "spp_max", "rel_err_q", "rounds"} measured AFTER
    the final drain."""
    rounds = 0
    pool = max_spp * n_pixels  # total-sample budget (uniform-render cost)
    spent = have_spp * n_pixels

    def _q():
        mean, var, n = moments()
        ok = n >= 2
        stderr = np.sqrt(
            np.maximum(var[ok], 0.0) / np.maximum(n[ok], 1)
        ) / (np.abs(mean[ok]) + _EPS)
        q = float(np.quantile(stderr, quantile)) if ok.any() else np.inf
        return n, ok, q

    if have_spp < min_spp:
        # uniform bootstrap: the variance signal (and the stderr stop
        # test) is meaningless below a per-pixel sample floor
        add = min(min_spp, max_spp) - have_spp
        step_uniform(add)
        spent += add * n_pixels
        rounds += 1
    while True:
        n, ok, q = _q()
        done = ok.all() and n.min() >= min_spp and q <= rel_err
        if done or spent >= pool:
            flush()
            n, _, q = _q()
            return {
                "spp_min": int(n.min()), "spp_max": int(n.max()),
                "rel_err_q": q, "rounds": rounds,
            }
        # geometric ramp: double the total work per round, floored at one
        # fresh sample/pixel, clamped to the remaining pool
        add_total = int(min(max(spent, n_pixels), pool - spent))
        if adaptive:
            step_adaptive(add_total)
        else:
            step_uniform(max(1, add_total // n_pixels))
            add_total = max(1, add_total // n_pixels) * n_pixels
        spent += add_total
        rounds += 1
