"""Synthetic keyed flow streams (paper §5.1, CAIDA-like), numpy only.

The port's own copy of ``netflow`` and ``netflow_keyed`` from the JAX
package's ``data/synthetic.py``: the same draws in the same order, so one
seed gives both packages the same stream.
"""

from __future__ import annotations

import numpy as np


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
