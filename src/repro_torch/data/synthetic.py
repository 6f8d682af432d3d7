"""Synthetic weighted-element streams (paper §5.1 datasets), numpy only.

The port's own copy of the JAX package's ``data/synthetic.py`` (``weights``,
``stream``, ``with_repeats``, ``netflow``, ``netflow_keyed``): the same draws
in the same order, so one seed gives both packages the same stream.
Weights: Uniform(0,1), Gauss N(1, 0.1) (clipped positive), Gamma(1, 2).
``with_repeats`` emulates real streams: occurrences follow a Zipf law, so the
same (id, weight) pair arrives many times.
"""

from __future__ import annotations

import numpy as np

DISTRIBUTIONS = ("uniform", "gauss", "gamma")


def weights(dist: str, n: int, rng: np.random.Generator) -> np.ndarray:
    """n float32 weights of the named distribution."""
    if dist == "uniform":
        w = rng.uniform(0.0, 1.0, n) + 1e-6
    elif dist == "gauss":
        w = np.abs(rng.normal(1.0, 0.1, n)) + 1e-6
    elif dist == "gamma":
        w = rng.gamma(1.0, 2.0, n) + 1e-6
    else:
        raise ValueError(dist)
    return w.astype(np.float32)


def stream(dist: str, n_elements: int, seed: int = 0):
    """Distinct elements only: (ids uint32, weights f32, true_C float)."""
    rng = np.random.default_rng(seed)
    ids = rng.choice(np.iinfo(np.uint32).max, size=n_elements, replace=False).astype(np.uint32)
    w = weights(dist, n_elements, rng)
    return ids, w, float(w.astype(np.float64).sum())


def with_repeats(dist: str, n_elements: int, n_stream: int, seed: int = 0, zipf_a: float = 1.3):
    """Zipf-repeated stream over n_elements distincts, length n_stream;
    true_C counts only the elements that appear."""
    ids, w, _ = stream(dist, n_elements, seed)
    rng = np.random.default_rng(seed + 1)
    ranks = rng.zipf(zipf_a, n_stream) % n_elements
    true_c = float(w[np.unique(ranks)].astype(np.float64).sum())
    return ids[ranks], w[ranks], true_c


def netflow(n_flows: int, n_packets: int, seed: int = 0):
    """CAIDA-like: (src,dst) flow ids weighted by (fixed) flow packet size.

    Returns (flow ids uint32[n_packets], sizes f32[n_packets], true_c) where
    true_c sums the sizes of the distinct flows that appear.
    """
    rng = np.random.default_rng(seed)
    flow_ids = rng.choice(np.iinfo(np.uint32).max, size=n_flows, replace=False).astype(np.uint32)
    sizes = np.clip(rng.lognormal(6.0, 1.0, n_flows), 40, 65535).astype(np.float32)
    ranks = rng.zipf(1.2, n_packets) % n_flows
    true_c = float(sizes[np.unique(ranks)].astype(np.float64).sum())
    return flow_ids[ranks], sizes[ranks], true_c


def netflow_keyed(n_keys: int, n_flows: int, n_packets: int, seed: int = 0):
    """Keyed CAIDA-like stream for per-key monitoring.

    Each packet carries (key, flow id, size): ``key`` is the monitored entity
    drawn Zipf over n_keys, the flow id is drawn Zipf from a shared pool, and
    the weight is the flow's fixed size. Returns (keys int32, flow ids
    uint32, sizes f32, true_c float64[n_keys]) where true_c[k] sums the
    sizes of DISTINCT flows seen under key k.
    """
    rng = np.random.default_rng(seed)
    flow_ids = rng.choice(np.iinfo(np.uint32).max, size=n_flows, replace=False).astype(np.uint32)
    sizes = np.clip(rng.lognormal(6.0, 1.0, n_flows), 40, 65535).astype(np.float32)
    keys = (rng.zipf(1.3, n_packets) % n_keys).astype(np.int32)
    ranks = rng.zipf(1.2, n_packets) % n_flows
    pairs = np.unique(np.stack([keys, ranks], axis=1), axis=0)
    true_c = np.zeros(n_keys, dtype=np.float64)
    np.add.at(true_c, pairs[:, 0], sizes[pairs[:, 1]].astype(np.float64))
    return keys, flow_ids[ranks], sizes[ranks], true_c
