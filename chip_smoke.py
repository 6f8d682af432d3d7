#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py [--seed 0]

Builds the eight CUDA kernels of the port (K1 qsketch_update, K2 qdyn_qr,
K3 dyn_array_update, K4 estimate, K5 float_sketch_update, K6
sketch_array_update, K7 window_union, K8 virtual_pool_route) from
``src/repro_torch/csrc``, then, at the README's configuration (m = 256,
b = 8) and K = 2^20 tenants:

  1. device: the card's name and power limit, torch and CUDA versions;
  2. build: time and ptxas report (registers, shared memory, spills);
  3. main path: a Zipf-bursty stream of sparse 64-bit tenants through the
     key directory into the DynArray monitor, the same stream through the
     scalar full-QSketch monitor and one whole-stream QSketch-Dyn sketch,
     then the anytime read and the fused MLE read; K1-K4 must have
     launched during this phase;
  3a. per-key SketchArray monitor: the same stream through
     ``update_array(..., dcfg=...)`` (K6), then ``estimate_array``;
  3b. windowed alerts: the same stream over 16 epochs of a
     ``WindowMonitor`` ring of E = 8 (K3 twice per batch), a flood of fresh
     ids on one mid-rank tenant at epoch 13, the anytime read and the
     AnomalyBank every epoch, and the windowed reads (w = 4 through K7,
     w = 8 from the cache) after the last epoch;
  3c. the paper's five-method comparison (LM, FastGM, FastExpSketch,
     QSketch, QSketch-Dyn through ``METHODS``; K1, K2, K5): RRMSE over
     benchmarks/accuracy.py's quick profile and update throughput over
     benchmarks/throughput.py's stream shape;
  3d. the register-sharing virtual tier (K8, K3 on the hot rows): 2^20
     Zipf tenants (benchmarks/virtual_dyn_array.py's stream, its full
     profile's base and pinned count) into a 2^26-slot pool, the chunked
     read of every tenant, the reference's accuracy gates, a promotion;
  4. kernels against their plain PyTorch versions on the card, at the
     paths' shapes and on their data;
  5. where an update's time goes (torch.profiler): DynArray, SketchArray
     and virtual-tier batches;
  6. CPU replay of a stream prefix: the card's state against the port's
     plain CPU path;
  6b. CPU replay of the window path (K = 2^16, E = 4, the ring wrapped);
  6c. CPU replay of the virtual path (a 2^20-slot pool, 64 pinned);
  7. accuracy against the exact weighted cardinality of the stream.

Each path runs with the launch counts set to 0 just before it and read
just after; every kernel of the path must have launched.
Prints one JSON ``{"kernels": [...]}`` line, then, last, the contract line
``{"ok": true, "device": {...}}``. Any failed phase raises, so the script
exits non-zero before the last line. Without a CUDA device, or without
``src/repro_torch`` beside it, it exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
CHUNK = 4096  # arrival granularity of the load generator (benchmarks/ingest.py)
N_ELEMENTS = 4_194_304  # stream length
BATCH = 65_536  # elements per update
MAIN_KERNELS = ("qsketch_update", "qdyn_qr", "dyn_array_update", "estimate")
# Windowed-alerts phase: ring size of experiments/bench/window_array.json,
# 16 epochs of 4 batches, a flood of fresh ids on the rank-50 tenant.
N_EPOCHS_RING = 8
N_EPOCHS = 16
FLOOD_EPOCH = 13
FLOOD_RANK = 50
# Five-method comparison: benchmarks/accuracy.py's quick profile (lines
# 31-34) and benchmarks/throughput.py's stream (n_stream // 8 distinct
# gamma-weighted elements with Zipf repeats).
ACC_MS = (64, 256, 1024)
ACC_N = 20_000
ACC_RUNS = 20
TPUT_STREAM = 4_194_304
# Virtual tier: benchmarks/virtual_dyn_array.py's stream at the smoke's
# tenant count with its full profile's base and pinned count; the pool that
# VirtualConfig's docstring sizes for 1e7 tenants (2^26 slots, 64 MiB).
VIRT_TENANTS = 2**20
VIRT_BASE = 8000.0
VIRT_SEED = 3
VIRT_POOL = 2**26
VIRT_PINNED = 64
VIRT_READ_CHUNK = 2**16  # tenants per estimate call

# Peak rates of one H100 SXM (NVIDIA data sheet, at its 700 W limit).
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# Scalar operations per unit of work, counted from the kernel sources:
# K1 per (element, register) pair — third murmur round 7, fmix 8,
# unit map 3, negate 1, logf 1, log2f 1, subtract 1, floor 1, clip 2, max 1.
K1_OPS_PER_PAIR = 27
# K5 per (element, register) pair — third murmur round 7, fmix 8, unit map
# 3, logf 1, negate 1, divide 1, weight test 1, min 1.
K5_OPS_PER_PAIR = 23
# K8 per element — three hashes (two words with salt_g, three with salt_h
# and with salt_pool: 22 + 29 + 29), unit map 3, logf, negate, log2f,
# subtract, floor 5, the r_max clamp and the non-finite tests 4, two
# high-word products 2.
K8_OPS_PER_ELEMENT = 94
# K2/K3 per (element, occupied bin): multiply, negate, exp, multiply-add.
QR_OPS_PER_BIN = 4
# K4 per (row, occupied bin, Newton evaluation): f and f' terms (2 z
# products, 2 clamps, 2 compares, expm1, divide, subtract, sinh, 2 logs,
# exp, 6 multiplies/adds) and the two multiply-adds into the sums.
K4_OPS_PER_BIN = 22
K4_EVALS = 31  # 30 Newton steps + the final derivative


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def zipf_bursty_stream(n, k, seed, *, s=1.2, burst_every=4, burst_frac=0.5, n_hot=4):
    """Zipf-bursty arrivals (the shape of benchmarks/ingest.py), on the host.

    Tenant ranks are Zipf(s) over k tenants; every ``burst_every``-th chunk
    of CHUNK elements puts ``burst_frac`` of its elements on ``n_hot``
    random hot tenants. Element ids come from a pool of n/2 random 64-bit
    ids, so duplicates occur; each pool id carries one gamma(1, 2) + 1e-4
    weight (weight is a function of the element). Each rank maps to a fixed
    random 64-bit tenant id. Returns (tenant uint64[n], pool index int64[n],
    pool ids uint64, pool weights float32, tenant id of each rank uint64[k]).
    """
    rng = np.random.default_rng(seed)
    p = 1.0 / np.arange(1, k + 1, dtype=np.float64) ** s
    cdf = np.cumsum(p / p.sum())
    tenant_ids = rng.integers(0, 2**64, k, dtype=np.uint64)
    pool_ids = rng.integers(0, 2**64, max(n // 2, 16), dtype=np.uint64)
    pool_w = (rng.gamma(1.0, 2.0, len(pool_ids)) + 1e-4).astype(np.float32)
    ranks = np.minimum(np.searchsorted(cdf, rng.random(n)), k - 1)
    for c0 in range((burst_every - 1) * CHUNK, n, burst_every * CHUNK):
        b = min(CHUNK, n - c0)
        hot = rng.integers(0, k, n_hot)
        nb = int(b * burst_frac)
        ranks[c0 : c0 + nb] = hot[rng.integers(0, n_hot, nb)]
    pool_idx = rng.integers(0, len(pool_ids), n)
    return tenant_ids[ranks], pool_idx, pool_ids, pool_w, tenant_ids


def to_device(stream, dev):
    import torch

    tenants, pool_idx, pool_ids, pool_w, _ = stream
    t = torch.from_numpy(tenants.view(np.int64)).to(dev)
    return {
        "t_lo": t & 0xFFFFFFFF,
        "t_hi": (t >> 32) & 0xFFFFFFFF,
        "ids": torch.from_numpy(pool_ids.view(np.int64)[pool_idx]).to(dev),
        "w": torch.from_numpy(pool_w[pool_idx]).to(dev),
    }


def sync(dev):
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run_main_path(cfg, dev, data, n, batch, capacity):
    """The main path: DynArray monitor, scalar monitor, QSketch-Dyn, reads."""
    from repro_torch.core import dyn_array, qsketch_dyn
    from repro_torch.sketchstream import monitor

    mon = monitor.DynArrayMonitor.for_capacity(cfg, capacity, device=dev)
    state = mon.init()
    scalar = monitor.init(cfg, device=dev)
    dyn = qsketch_dyn.init(cfg, device=dev)
    spans = [slice(i, min(i + batch, n)) for i in range(0, n, batch)]
    out = {}

    sync(dev)
    t0 = time.perf_counter()
    for sl in spans:
        state = mon.update(state, (data["t_lo"][sl], data["t_hi"][sl]), data["ids"][sl], data["w"][sl])
    sync(dev)
    out["update_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    for sl in spans:
        scalar = monitor.update(cfg, scalar, data["ids"][sl], data["w"][sl])
    sync(dev)
    out["scalar_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    for sl in spans:
        dyn = qsketch_dyn.update_batch(cfg, dyn, data["ids"][sl], data["w"][sl])
    sync(dev)
    out["dyn_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    anytime = mon.estimate(state).clone()
    sync(dev)
    out["anytime_ms"] = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    fused = dyn_array.estimate_mle_all(cfg, mon_state_view(state), solver="fused")
    sync(dev)
    out["fused_ms"] = (time.perf_counter() - t0) * 1e3
    out.update(
        mon=mon, state=state, scalar=scalar, dyn=dyn, anytime=anytime, fused=fused,
        scalar_chat=float(monitor.estimate(cfg, scalar)), dyn_chat=float(qsketch_dyn.estimate(dyn)),
    )
    return out


def mon_state_view(state):
    """The DynArrayState inside a DynArrayMonitorState (same tensors)."""
    from repro_torch.core.types import DynArrayState

    return DynArrayState(regs=state.regs, hists=state.hists, chats=state.chats)


def host_truth(slots, pool_idx, pool_w, capacity):
    """Exact weighted cardinality per slot of the elements (slot, pool
    index) given — each distinct (slot, id) pair counts its weight once —
    and the number of distinct ids per slot."""
    pairs = np.unique((slots.astype(np.int64) << 32) | pool_idx)
    truth = np.bincount(pairs >> 32, weights=pool_w[pairs & 0xFFFFFFFF].astype(np.float64),
                        minlength=capacity)
    return truth, np.bincount(pairs >> 32, minlength=capacity)


def median_rel_err(est, truth, sel):
    return float(np.median(np.abs(est[sel].astype(np.float64) - truth[sel]) / truth[sel]))


def run_sketch_array_path(cfg, dev, data, n, batch, capacity):
    """Phase 3a: the stream through the per-key SketchArray monitor (sparse
    tenant ids routed by ``dcfg``), then the batched MLE read."""
    from repro_torch.core import DirectoryConfig
    from repro_torch.sketchstream import monitor

    dcfg = DirectoryConfig(capacity=capacity, seed=cfg.seed)
    state = monitor.init_array(cfg, capacity, device=dev)
    spans = [slice(i, min(i + batch, n)) for i in range(0, n, batch)]
    sync(dev)
    t0 = time.perf_counter()
    for sl in spans:
        state = monitor.update_array(cfg, state, (data["t_lo"][sl], data["t_hi"][sl]), data["ids"][sl],
                                     data["w"][sl], dcfg=dcfg)
    sync(dev)
    update_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    est = monitor.estimate_array(cfg, state)
    sync(dev)
    return {"state": state, "dcfg": dcfg, "est": est, "update_s": update_s,
            "read_ms": (time.perf_counter() - t0) * 1e3}


def sketch_array_checks(cfg, stream, data, sa, capacity):
    """Phase 3a's gate: the full-QSketch rows against the exact weighted
    cardinality of the stream on the 1,000 heaviest slots."""
    import torch

    from repro_torch.core import key_directory

    _, pool_idx, _, pool_w, _ = stream
    slots = key_directory.route_slots(sa["dcfg"], (data["t_lo"], data["t_hi"])).cpu().numpy()
    truth, _ = host_truth(slots, pool_idx, pool_w, capacity)
    top = np.argsort(truth)[-1000:]
    est = sa["est"].cpu().numpy()
    med = median_rel_err(est, truth, top)
    print(f"  estimate_array, 1000 heaviest slots: median relative error {med:.5f}")
    check(bool(torch.isfinite(sa["est"]).all()) and sa["est"].shape == (capacity,), "finite, one per slot")
    # A full QSketch row has no untouched-register collapse: m = 256 gives a
    # relative standard error of a few percent on every row.
    check(med < 0.1, "per-key SketchArray accuracy")


def flood_batch(stream, seed, batch, dev):
    """Phase 3b's flood: ``batch`` fresh distinct 64-bit ids with gamma(1, 2)
    + 1e-4 weights, all on the rank-``FLOOD_RANK`` tenant."""
    import torch

    rng = np.random.default_rng(seed + 1)
    ids = np.unique(rng.integers(0, 2**64, batch + 64, dtype=np.uint64))[:batch]
    check(len(ids) == batch, "flood ids are distinct")
    rng.shuffle(ids)
    w = (rng.gamma(1.0, 2.0, batch) + 1e-4).astype(np.float32)
    tenant = np.full(batch, stream[4][FLOOD_RANK], dtype=np.uint64).view(np.int64)
    t = torch.from_numpy(tenant).to(dev)
    return {"t_lo": t & 0xFFFFFFFF, "t_hi": (t >> 32) & 0xFFFFFFFF,
            "ids": torch.from_numpy(ids.view(np.int64)).to(dev), "w": torch.from_numpy(w).to(dev)}


def run_window_path(cfg, dev, data, flood, n, batch, capacity):
    """Phase 3b: the stream over N_EPOCHS epochs of a WindowMonitor ring
    (rotating after each), the flood at FLOOD_EPOCH, the anytime read and
    the AnomalyBank every epoch, the windowed reads after the last epoch."""
    import torch

    from repro_torch.core import key_directory, window_array
    from repro_torch.sketchstream import anomaly, monitor

    e = N_EPOCHS_RING
    mon = monitor.WindowMonitor.for_capacity(cfg, capacity, e, evict_after=e, device=dev)
    bcfg = anomaly.AnomalyConfig(warmup=e + 2, min_weight=1000.0, cusum_h=8.0)
    state, bank = mon.init(), anomaly.init(capacity, device=dev)
    flood_slot = int(key_directory.route_slots(mon.dcfg, (flood["t_lo"][:1], flood["t_hi"][:1]))[0])
    per_epoch = n // N_EPOCHS
    out = {"update_s": 0.0, "rotate_ms": [], "anytime_ms": [], "flood_slot": flood_slot,
           "flagged_at": [], "others": set()}
    for ep in range(N_EPOCHS):
        sync(dev)
        t0 = time.perf_counter()
        for i in range(ep * per_epoch, (ep + 1) * per_epoch, batch):
            sl = slice(i, i + batch)
            state = mon.update(state, (data["t_lo"][sl], data["t_hi"][sl]), data["ids"][sl], data["w"][sl])
        if ep == FLOOD_EPOCH:
            state = mon.update(state, (flood["t_lo"], flood["t_hi"]), flood["ids"], flood["w"])
        sync(dev)
        out["update_s"] += time.perf_counter() - t0
        t0 = time.perf_counter()
        est = mon.estimate(state)
        sync(dev)
        out["anytime_ms"].append((time.perf_counter() - t0) * 1e3)
        bank, scores = anomaly.step(bcfg, bank, est)
        alerts = anomaly.top_alerts(bcfg, scores, n=5)
        over = set((scores > bcfg.cusum_h).nonzero().flatten().tolist()) - {flood_slot}
        out["others"] |= over
        if ep >= FLOOD_EPOCH and flood_slot in [s for s, _ in alerts]:
            out["flagged_at"].append(ep)
        tag = " ".join(f"{s}:{sc:.1f}" for s, sc in alerts) or "-"
        print(f"    epoch {ep:2d}: window estimate total {float(est.sum()):.1f}; alerting slots "
              f"{int((scores > bcfg.cusum_h).sum())}; top-5 {tag}")
        if ep == N_EPOCHS - 1:
            for w in (4, e):
                sync(dev)
                t0 = time.perf_counter()
                out[f"w{w}"] = mon.estimate(state, w=w)
                sync(dev)
                out[f"w{w}_ms"] = (time.perf_counter() - t0) * 1e3
            out["union4"] = window_array.window_union_regs(state.window, 4)
            out[f"union{e}"] = state.window.union_regs.clone()
            out["metrics"] = {k: float(v) for k, v in mon.metrics(state).items()}
        sync(dev)
        t0 = time.perf_counter()
        state = mon.rotate(state)
        sync(dev)
        out["rotate_ms"].append((time.perf_counter() - t0) * 1e3)
    out.update(mon=mon, state=state, epoch_len=per_epoch)
    return out


def window_checks(cfg, stream, data, flood, win, n, capacity):
    """Phase 3b's gates: the flood is flagged; on the heavy slots whose
    union row has every register touched, each windowed read equals the
    float64 oracle of the reference's estimator on the window's union
    registers, and its median relative error against the exact weighted
    cardinality of the window's epochs is no worse than the oracle's own."""
    from repro_torch.core import estimation, estimators, key_directory

    _, pool_idx, _, pool_w, _ = stream
    slots = key_directory.route_slots(win["mon"].dcfg, (data["t_lo"], data["t_hi"])).cpu().numpy()
    flood_w = float(flood["w"].double().sum())
    for w in (N_EPOCHS_RING, 4):
        first = (N_EPOCHS - w) * win["epoch_len"]
        truth, n_distinct = host_truth(slots[first:n], pool_idx[first:n], pool_w, capacity)
        truth[win["flood_slot"]] += flood_w  # fresh ids: distinct from every stream id
        n_distinct[win["flood_slot"]] += len(flood["w"])
        top = np.argsort(truth)[-1000:]
        union = win[f"union{w}"][top].cpu().numpy()
        dense = top[(union > cfg.r_min).all(1)]
        est = win[f"w{w}"].cpu().numpy()
        check(bool(np.isfinite(est).all()) and est.shape == (capacity,), f"estimate(w={w}) finite, one per slot")
        rows = {int(s): r for s, r in zip(top, union)}
        oracle = np.array([estimators.mle_numpy(cfg, rows[int(s)]) * cfg.m for s in dense])
        off = np.abs(est[dense] - oracle) - (estimation.LUT_RTOL * oracle + estimation.ATOL_FLOOR)
        check(len(dense) > 0, f"estimate(w={w}): some heavy slot has every union register touched")
        med = median_rel_err(est, truth, dense)
        med_oracle = float(np.median(np.abs(oracle - truth[dense]) / truth[dense]))
        print(f"  estimate(w={w}) over the last {w} epochs, 1000 heaviest slots: {len(dense)} have every register "
              f"touched (median {int(np.median(n_distinct[dense]))} distinct elements); median relative error "
              f"there {med:.5f}, the float64 oracle's {med_oracle:.5f}; largest excess over LUT_RTOL against "
              f"the oracle {float(off.max()):.3e}")
        check(bool((off <= 0).all()),
              f"estimate(w={w}) equals the float64 MLE of the window's union registers within LUT_RTOL")
        # Each estimate lies within LUT_RTOL of the oracle, so each relative
        # error moves by at most LUT_RTOL * (1 + that error): below
        # 2 * LUT_RTOL wherever the oracle is off by less than 100 %.
        check(med <= med_oracle + 2 * estimation.LUT_RTOL,
              f"estimate(w={w}) accuracy no worse than the reference estimator's on the same registers")
    print(f"  flood slot {win['flood_slot']} in the top-5 alerts at epochs {win['flagged_at']}; "
          f"{len(win['others'])} other slots alerted at some epoch")
    check(len(win["flagged_at"]) > 0, "the flood tenant is among the top-5 alerts at some epoch >= 13")


def run_methods(dev, batch, *, ms=ACC_MS, n=ACC_N, runs=ACC_RUNS, n_stream=TPUT_STREAM):
    """Phase 3c: every ``METHODS`` entry on the card. Accuracy as
    benchmarks/accuracy.py's register sweep runs it (one update of n
    distinct elements per run; ``cfg.seed = 1000 + r``, stream seed r),
    each run's estimate against its own stream's truth; throughput over
    benchmarks/throughput.py's stream at m = 256 in batches of ``batch``."""
    import torch

    from repro_torch.core import METHODS, SketchConfig
    from repro_torch.data import synthetic

    out = {"rrmse": {}, "eps": {}}
    t0 = time.perf_counter()
    for dist in synthetic.DISTRIBUTIONS:
        streams = []
        for r in range(runs):
            ids, w, true_c = synthetic.stream(dist, n, seed=r)
            streams.append((torch.from_numpy(ids.astype(np.int64)).to(dev), torch.from_numpy(w).to(dev), true_c))
        for m in ms:
            for name, meth in METHODS.items():
                rel = []
                for r, (ids, w, true_c) in enumerate(streams):
                    cfg = SketchConfig(m=m, b=8, seed=1000 + r)
                    st = meth["update"](cfg, meth["init"](cfg, device=dev), ids, w)
                    rel.append((float(meth["estimate"](cfg, st)) - true_c) / true_c)
                out["rrmse"][(name, dist, m)] = float(np.sqrt(np.mean(np.square(rel))))
    out["accuracy_s"] = time.perf_counter() - t0

    ids, w, _ = synthetic.with_repeats("gamma", n_stream // 8, n_stream)
    ids, w = torch.from_numpy(ids.astype(np.int64)).to(dev), torch.from_numpy(w).to(dev)
    cfg = SketchConfig(m=256, b=8)
    for name, meth in METHODS.items():
        st = meth["init"](cfg, device=dev)
        sync(dev)
        t0 = time.perf_counter()
        for i in range(0, n_stream, batch):
            st = meth["update"](cfg, st, ids[i : i + batch], w[i : i + batch])
        sync(dev)
        out["eps"][name] = n_stream / (time.perf_counter() - t0)
    out["lm_batch"] = (ids[:batch], w[:batch])
    return out


def methods_checks(meth_out):
    """Phase 3c's gate: every method within twice Eq. 2's Cramér-Rao bound
    1/sqrt(m-2) (20 runs give the sample RRMSE a relative standard error of
    about 16 %)."""
    from repro_torch.core import METHODS
    from repro_torch.data import synthetic

    worst = 0.0
    for dist in synthetic.DISTRIBUTIONS:
        for m in ACC_MS:
            bound = 1.0 / np.sqrt(m - 2)
            row = " ".join(f"{name} {meth_out['rrmse'][(name, dist, m)]:.4f}" for name in METHODS)
            print(f"    {dist:7s} m={m:4d} (1/sqrt(m-2) = {bound:.4f}): RRMSE {row}")
            for name in METHODS:
                worst = max(worst, meth_out["rrmse"][(name, dist, m)] / bound)
    print(f"  largest RRMSE over 1/sqrt(m-2): {worst:.3f} (gate 2)")
    check(worst <= 2.0, "every method's RRMSE within 2/sqrt(m-2)")


def virtual_stream(n_tenants, base, seed):
    """benchmarks/virtual_dyn_array.py's ``_zipf_stream``: per-tenant element
    counts max(base/rank^1.05, 4), globally unique element ids, weights
    U(0.5, 1.5), shuffled into one stream. Returns (tenant ids uint64 by
    rank, tenant rank of each element, element ids uint32, weights float32,
    exact weight per tenant)."""
    rng = np.random.default_rng(seed)
    tids = rng.integers(0, 1 << 63, n_tenants, dtype=np.uint64)
    sizes = np.maximum(base / (np.arange(n_tenants) + 1.0) ** 1.05, 4.0).astype(np.int64)
    tidx = np.repeat(np.arange(n_tenants, dtype=np.int32), sizes)
    n = tidx.shape[0]
    ids = rng.permutation(np.arange(n, dtype=np.uint32))
    w = rng.uniform(0.5, 1.5, n).astype(np.float32)
    truth = np.bincount(tidx, weights=w.astype(np.float64), minlength=n_tenants)
    order = rng.permutation(n)
    return tids, tidx[order], ids[order], w[order], truth


def virtual_to_device(vs, dev):
    import torch

    tids, tidx, ids, w, _ = vs
    t = torch.from_numpy(tids[tidx].view(np.int64)).to(dev)
    return {"t_lo": t & 0xFFFFFFFF, "t_hi": (t >> 32) & 0xFFFFFFFF,
            "ids": torch.from_numpy(ids.astype(np.int64)).to(dev), "w": torch.from_numpy(w).to(dev)}


def run_virtual_path(cfg, dev, vs, vdata, batch, pool_size=VIRT_POOL):
    """Phase 3d: the stream through a ``VirtualDynMonitor`` (the largest
    VIRT_PINNED tenants pinned), then the read of every tenant in chunks."""
    import torch

    from repro_torch.core import key_directory
    from repro_torch.sketchstream import monitor

    tids = vs[0]
    n = vdata["w"].shape[0]
    mon = monitor.VirtualDynMonitor.for_pool(cfg, pool_size, pinned=tuple(int(t) for t in tids[:VIRT_PINNED]),
                                             device=dev)
    state = mon.init()
    sync(dev)
    t0 = time.perf_counter()
    for i in range(0, n, batch):
        sl = slice(i, i + batch)
        state = mon.update(state, (vdata["t_lo"][sl], vdata["t_hi"][sl]), vdata["ids"][sl], vdata["w"][sl])
    sync(dev)
    update_s = time.perf_counter() - t0
    q_lo, q_hi = key_directory.split_uint64(tids, dev)
    t0 = time.perf_counter()
    est = torch.cat([mon.estimate(state, (q_lo[i : i + VIRT_READ_CHUNK], q_hi[i : i + VIRT_READ_CHUNK]))
                     for i in range(0, len(tids), VIRT_READ_CHUNK)])
    sync(dev)
    return {"mon": mon, "state": state, "est": est, "update_s": update_s,
            "read_ms": (time.perf_counter() - t0) * 1e3, "metrics": {k: float(v) for k, v in mon.metrics(state).items()}}


def virtual_checks(cfg, dev, vs, virt, batch):
    """Phase 3d's gates: the JAX package's own (tests/test_virtual_dyn_array.py)
    and the DynArray gates of this script, fixed before any run."""
    import torch

    from repro_torch.core import dyn_array, estimation, key_directory
    from repro_torch.core import virtual_dyn_array as vda

    tids, tidx, ids, w, truth = vs
    mon, st = virt["mon"], virt["state"].array
    est = virt["est"].cpu().numpy().astype(np.float64)
    n_tenants = len(tids)
    check(bool(np.isfinite(est).all()) and est.shape == (n_tenants,), "one finite estimate per tenant")
    hist_ok = bool(torch.equal(st.pool_hist, vda.rebuild_pool_hist(cfg, st.pool)))
    print(f"  pool_hist equals rebuild_pool_hist: {hist_ok}; sum {int(st.pool_hist.sum())}")
    check(hist_ok and int(st.pool_hist.sum()) == VIRT_POOL, "the pool histogram is the pool's, summing to M")
    tail_w = float(truth[VIRT_PINNED:].sum())
    w_tail = float(st.w_tail)
    print(f"  w_tail {w_tail:.1f} against the float64 tail weight {tail_w:.1f} "
          f"(relative {abs(w_tail - tail_w) / tail_w:.3e}); n_tail {int(st.n_tail)}")
    check(abs(w_tail - tail_w) <= 1e-4 * tail_w, "w_tail within rtol 1e-4 of the exact tail weight")

    rel = np.abs(est - truth) / truth
    pin_med, pin_p90 = float(np.median(rel[:VIRT_PINNED])), float(np.quantile(rel[:VIRT_PINNED], 0.9))
    floor = float(vda.noise_floor(cfg, mon.vcfg, st))
    above = np.flatnonzero((np.arange(n_tenants) >= VIRT_PINNED) & (truth > 2 * floor))
    check(len(above) > 0, "some tail tenants lie above 2x the noise floor")
    v_err = float(rel[above].mean())
    print(f"  pinned tenants (exact martingales): median relative error {pin_med:.5f}, p90 {pin_p90:.5f}")
    print(f"  noise floor {floor:.4f} weight; {len(above)} tail tenants above 2x the floor, mean relative "
          f"error {v_err:.5f}")

    # The benchmark's bar: the same tenants' dedicated noise-free rows (a
    # DynArray fed only their elements), read through the same solve.
    row_of = np.full(n_tenants, -1, np.int64)
    row_of[above] = np.arange(len(above))
    sel = np.flatnonzero(row_of[tidx] >= 0)
    dense = dyn_array.init(cfg, len(above), dev)
    keys = torch.from_numpy(row_of[tidx[sel]]).to(dev)
    ids_t, w_t = torch.from_numpy(ids[sel].astype(np.int64)).to(dev), torch.from_numpy(w[sel]).to(dev)
    for i in range(0, len(sel), batch):
        dense = dyn_array.update_batch(cfg, dense, keys[i : i + batch], ids_t[i : i + batch], w_t[i : i + batch])
    d_est = estimation.estimate_rows_virtual(cfg, dense.regs).cpu().numpy().astype(np.float64)
    d_err = float((np.abs(d_est - truth[above]) / truth[above]).mean())
    print(f"  benchmark bar: tail above 2x the floor, virtual {v_err:.5f} against the dense register-only "
          f"read {d_err:.5f} (within 2x: {v_err <= 2.0 * max(d_err, 1e-3)})")

    ghosts = np.random.default_rng(99).integers(0, 1 << 63, 64, dtype=np.uint64)
    ghost_med = float(virt["mon"].estimate(virt["state"], key_directory.split_uint64(ghosts, dev)).median())
    print(f"  64 unseen tenants: median estimate {ghost_med:.4f} (floor {floor:.4f})")

    # Promote the largest tail tenant (epoch fence) and feed it fresh ids.
    riser = int(tids[VIRT_PINNED])
    mon2, st2 = mon.promote(virt["state"], riser)
    rng = np.random.default_rng(5)
    w2 = rng.uniform(0.5, 1.5, 4096).astype(np.float32)
    fresh = torch.arange(len(ids), len(ids) + 4096, device=dev)
    st2 = mon2.update(st2, key_directory.split_uint64(np.full(4096, riser, np.uint64), dev), fresh,
                      torch.from_numpy(w2).to(dev))
    resumed = float(mon2.estimate(st2, key_directory.split_uint64([riser], dev))[0])
    exact = float(w2.astype(np.float64).sum())
    print(f"  promoted rank {VIRT_PINNED}, then 4096 fresh elements: estimate {resumed:.2f} against "
          f"{exact:.2f} (relative {abs(resumed - exact) / exact:.5f})")
    check(pin_med <= 0.1 and pin_p90 <= 0.3, "pinned tenants' anytime accuracy")
    check(v_err < 0.5, "tail above 2x the noise floor: mean relative error < 0.5")
    check(ghost_med <= floor, "unseen tenants read at most the noise floor")
    check(abs(resumed - exact) <= 0.2 * exact, "a promoted tenant reads its post-promotion weight")


def window_replay(cfg, data, dev, capacity, batch, e=4, n_epochs=5):
    """Phase 6b: a prefix of the window path on the card and on the CPU —
    one batch per epoch and a rotate between epochs, so the E-th rotate
    evicts epoch 0 and the last epoch is written into its recycled plane —
    then the windowed read over the last two epochs, which wraps round the
    ring. Integer state bit for bit; chats and the read to rtol 1e-5. (Each
    rotate runs the histogram MLE over all K rows; on the CPU that is most
    of this phase's time.)"""
    import torch

    from repro_torch.sketchstream import monitor

    cpu = torch.device("cpu")
    states, reads = [], []
    for d in (dev, cpu):
        mon = monitor.WindowMonitor.for_capacity(cfg, capacity, e, evict_after=e, device=d)
        st = mon.init()
        t0 = time.perf_counter()
        for ep in range(n_epochs):
            sl = slice(ep * batch, (ep + 1) * batch)
            st = mon.update(st, (data["t_lo"][sl].to(d), data["t_hi"][sl].to(d)), data["ids"][sl].to(d),
                            data["w"][sl].to(d))
            if ep < n_epochs - 1:
                st = mon.rotate(st)
        reads.append(mon.estimate(st, w=2).cpu())
        sync(d)
        print(f"  {d.type}: {n_epochs} epochs of {batch} elements at K = {capacity}, E = {e} "
              f"in {time.perf_counter() - t0:.3f} s")
        states.append(st)
    b, a = states
    fields = ("regs", "hists", "union_regs", "union_hists", "head", "filled", "epoch_id")
    equal = all(torch.equal(getattr(b.window, f).cpu(), getattr(a.window, f)) for f in fields)
    equal &= all(torch.equal(getattr(b.directory, f).cpu(), getattr(a.directory, f)) for f in a.directory._fields)
    equal &= torch.equal(b.n_seen.cpu(), a.n_seen)
    close = {
        "chats": (b.window.chats.cpu(), a.window.chats),
        "union_chats": (b.window.union_chats.cpu(), a.window.union_chats),
        "estimate(w=2)": (reads[0], reads[1]),
    }
    ok = True
    for name, (x, y) in close.items():
        good = bool(torch.allclose(x, y, rtol=1e-5, atol=1e-6))
        ok &= good
        print(f"  {name}: max relative difference {rel_err(x, y):.3e} (allclose rtol 1e-5, atol 1e-6: {good})")
    print(f"  integer state equal (ring, union, head/filled/epoch_id, directory, n_seen): {equal}; "
          f"head {int(a.window.head)}, epoch_id {int(a.window.epoch_id)}")
    check(equal, "card and CPU window integer state differ")
    check(ok, "card and CPU window chats or reads differ beyond rtol 1e-5")


def virtual_replay(cfg, vs, vdata, dev, batch, pool_size=2**20, n_batches=4, n_read=8192):
    """Phase 6c: a prefix of the virtual stream through the same monitor
    (a smaller pool, the same pinned tenants) on the card and on the CPU:
    pool, pool histogram, counters and hot rows bit for bit; w_tail, the
    hot chats, the tail's row solves (on the card's gathered rows of the
    ``n_read`` largest tail tenants) and the pool calibration to rtol 1e-5."""
    import torch

    from repro_torch.core import estimation, estimators, key_directory
    from repro_torch.core import virtual_dyn_array as vda
    from repro_torch.sketchstream import monitor

    cpu = torch.device("cpu")
    pinned = tuple(int(t) for t in vs[0][:VIRT_PINNED])
    states, mons = [], []
    for d in (dev, cpu):
        mon = monitor.VirtualDynMonitor.for_pool(cfg, pool_size, pinned=pinned, device=d)
        mons.append(mon)
        st = mon.init()
        t0 = time.perf_counter()
        for i in range(n_batches):
            sl = slice(i * batch, (i + 1) * batch)
            st = mon.update(st, (vdata["t_lo"][sl].to(d), vdata["t_hi"][sl].to(d)), vdata["ids"][sl].to(d),
                            vdata["w"][sl].to(d))
        sync(d)
        print(f"  {d.type}: {n_batches * batch} elements into a {pool_size}-slot pool in "
              f"{time.perf_counter() - t0:.3f} s")
        states.append(st)
    b, a = states
    equal = all(torch.equal(getattr(b.array, f).cpu(), getattr(a.array, f)) for f in ("pool", "pool_hist", "n_tail"))
    equal &= torch.equal(b.array.hot.regs.cpu(), a.array.hot.regs)
    equal &= torch.equal(b.array.hot.hists.cpu(), a.array.hot.hists) and torch.equal(b.n_seen.cpu(), a.n_seen)
    vcfg = mons[0].vcfg
    rows = vda.virtual_rows(cfg, vcfg, b.array, *key_directory.split_uint64(vs[0][VIRT_PINNED:VIRT_PINNED + n_read], dev))
    tcfg = vda.tail_config(cfg, vcfg)
    chat_d, chat_c = estimation.estimate_rows_virtual(tcfg, rows).cpu(), estimation.estimate_rows_virtual(tcfg, rows.cpu())
    off, ties = grid_flips(tcfg, rows, chat_d, chat_c)
    print(f"  tail row solves ({n_read} tenants): {off.numel()} rows beyond rtol 1e-5, "
          f"{int(ties.sum())} of them near ties of the grid")
    for i in range(min(8, off.numel())):
        r = int(off[i])
        h = estimators.histograms(tcfg, rows[r:r + 1].cpu())[0]
        bins = {int(k) + cfg.r_min: int(h[k]) for k in torch.nonzero(h)[:, 0]}
        print(f"    row {r}: card {float(chat_d[r])!r} cpu {float(chat_c[r])!r} near tie {bool(ties[i])}; "
              f"histogram {{register value: count}} {bins}")
    check(bool(ties.all()), "a card/CPU tail row solve differs beyond rtol 1e-5 off a grid near tie")
    keep = torch.ones_like(chat_c, dtype=torch.bool)
    keep[off] = False
    close = {"w_tail": (b.array.w_tail.cpu(), a.array.w_tail), "hot chats": (b.array.hot.chats.cpu(), a.array.hot.chats),
             "tail row solves off the near ties": (chat_d[keep], chat_c[keep]),
             "pool calibration": (vda.pool_calibration(cfg, vcfg, b.array).cpu(),
                                  vda.pool_calibration(cfg, mons[1].vcfg, a.array))}
    ok = True
    for name, (x, y) in close.items():
        good = bool(torch.allclose(x, y, rtol=1e-5, atol=1e-6))
        ok &= good
        print(f"  {name}: max relative difference {rel_err(x.reshape(-1), y.reshape(-1)):.3e} "
              f"(allclose rtol 1e-5, atol 1e-6: {good})")
    print(f"  integer state equal (pool, pool_hist, n_tail, hot regs and hists, n_seen): {equal}; "
          f"raised slots {int((a.array.pool > cfg.r_min).sum())}")
    check(equal, "card and CPU virtual integer state differ")
    check(ok, "card and CPU w_tail, hot chats or tail reads differ beyond rtol 1e-5")


def grid_flips(tcfg, rows, chat_d, chat_c):
    """The rows whose virtual row solve on the card (``chat_d``) and on the
    CPU (``chat_c``) differ beyond rtol 1e-5, and whether each is a near tie
    of the grid argmax: the float64 log-likelihood margin between the two
    devices' final grid points is within twice the float32 rounding of the
    likelihood there (the largest difference of either device's float32
    value from the float64 one). A real divergence of the likelihood fails
    this; a flip at a near tie passes it."""
    import torch

    from repro_torch.core import estimation, estimators

    off = torch.nonzero((chat_d - chat_c).abs() > 1e-5 * chat_c.abs() + 1e-6)[:, 0]
    if not off.numel():
        return off, torch.ones((0,), dtype=torch.bool)
    hd = estimators.histograms(tcfg, rows[off.to(rows.device)])
    h64 = hd.cpu()
    lam64 = torch.log(tcfg.m / torch.clamp(h64[:, 0].double(), min=0.5))
    # Final grid points are multiples of 1/32: recover them exactly.
    grid64 = torch.stack([torch.round(32 * torch.log2(c[off].double() / (tcfg.m * lam64))) / 32
                          for c in (chat_d, chat_c)], 1)
    ll64 = estimation._virtual_loglik(tcfg, h64, lam64, grid64)
    err = torch.zeros(off.numel(), dtype=torch.float64)
    for h in (hd, h64):
        t0 = h[:, 0].to(torch.float32)
        lam = torch.log(torch.full_like(t0, float(tcfg.m)) / torch.clamp(t0, min=0.5))
        ll = estimation._virtual_loglik(tcfg, h, lam, grid64.to(h.device, torch.float32))
        err += (ll.cpu().double() - ll64).abs().max(1).values
    return off, (ll64[:, 0] - ll64[:, 1]).abs() <= 2 * err


def rel_err(got, want, floor=1e-6):
    """Largest relative difference over entries whose reference exceeds ``floor``."""
    sel = want.abs() > floor
    if not bool(sel.any()):
        return 0.0
    return float(((got[sel] - want[sel]).abs() / want[sel].abs()).max())


def time_ms(fn, reps, dev, rounds=5, reset=None):
    """Milliseconds per call: CUDA events around ``reps`` back-to-back calls,
    the median of ``rounds`` such runs (a host stall in one run does not
    set the figure). With ``reset``, each call gets events of its own and
    ``reset()`` runs before it, outside them (a kernel that updates its
    input in place then starts every call from the same input)."""
    import torch

    if reset is not None:
        reset()
    fn()  # warm
    sync(dev)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    per_call = []
    for _ in range(rounds):
        if reset is None:
            start.record()
            for _ in range(reps):
                fn()
            end.record()
            end.synchronize()
            per_call.append(start.elapsed_time(end) / reps)
        else:
            total = 0.0
            for _ in range(reps):
                reset()
                start.record()
                fn()
                end.record()
                end.synchronize()
                total += start.elapsed_time(end)
            per_call.append(total / reps)
    return float(np.median(per_call))


def kernel_checks(cfg, dev, data, main, sa, win, meth, virt, vdata, batch, launches):
    """Each kernel's wrapper against its plain version on the paths' shapes."""
    import torch

    from repro_torch.core import baselines, estimators, key_directory
    from repro_torch.core import virtual_dyn_array as vda
    from repro_torch.kernels import (
        dyn_array_update, estimate, float_sketch_update, ops, qdyn_qr, qsketch_update, ref,
        sketch_array_update, virtual_pool_update, window_union,
    )
    from repro_torch.sketchstream import monitor

    sl = slice(0, batch)
    lo, hi = data["ids"][sl] & 0xFFFFFFFF, (data["ids"][sl] >> 32) & 0xFFFFFFFF
    w = data["w"][sl].contiguous()
    log2w = torch.log2(w)
    state = main["state"]
    keys = key_directory.route_slots(main["mon"].dcfg, (data["t_lo"][sl], data["t_hi"][sl])).contiguous()
    s = ops.scales(cfg, dev)
    regs1 = main["scalar"].regs
    hist = main["dyn"].hist
    rows = []

    def entry(name, source, replaces, err, tol_ok, fn_k, fn_p, reps, bytes_, ops_, extra="", reset=None):
        ms = time_ms(fn_k, reps, dev, reset=reset)
        plain_ms = time_ms(fn_p, max(1, reps // 10), dev, rounds=3)
        b_ms, o_ms = bytes_ / HBM_BYTES_PER_S * 1e3, ops_ / F32_OPS_PER_S * 1e3
        bound_by = "bytes" if b_ms >= o_ms else "operations"
        row = {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name], "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(b_ms, o_ms), "bound_by": bound_by, "library_ms": None,
        }
        print(f"  {name}: max_abs_err={err:.3e} ok={tol_ok} ms={ms:.5f} plain_ms={plain_ms:.4f} "
              f"bound_ms={row['bound_ms']:.5f} ({bound_by}; bytes {b_ms:.5f}, operations {o_ms:.5f}){extra}")
        check(tol_ok, f"{name} kernel disagrees with its plain version")
        rows.append(row)

    # K1: one batch folded into the scalar monitor's registers.
    args1 = dict(salt=cfg.salt_h, r_min=cfg.r_min, r_max=cfg.r_max)
    got = qsketch_update.update_regs(lo, hi, log2w, regs1, **args1)
    want = ref.qsketch_update_ref(lo, hi, log2w, regs1, **args1)
    err = float((got.int() - want.int()).abs().max())
    entry("qsketch_update", "src/repro_torch/csrc/qsketch_update.cu",
          "src/repro/kernels/qsketch_update.py:50", err, bool(torch.equal(got, want)),
          lambda: qsketch_update.update_regs(lo, hi, log2w, regs1, **args1),
          lambda: ref.qsketch_update_ref(lo, hi, log2w, regs1, **args1), 50,
          batch * 20 + cfg.m * 2, batch * cfg.m * K1_OPS_PER_PAIR)

    # K2: one batch against the whole-stream QSketch-Dyn histogram.
    got = qdyn_qr.q_r(w, hist, s, cfg.m)
    want = ref.qdyn_qr_ref(w, hist, s, cfg.m)
    err = float((got - want).abs().max())
    occ = int((hist > 0).sum())
    entry("qdyn_qr", "src/repro_torch/csrc/keyed_qr.cu", "src/repro/kernels/qdyn_qr.py:27",
          err, err <= 1e-6,
          lambda: qdyn_qr.q_r(w, hist, s, cfg.m), lambda: ref.qdyn_qr_ref(w, hist, s, cfg.m), 50,
          batch * 8 + cfg.num_bins * 8, batch * (occ * QR_OPS_PER_BIN + 3),
          extra=f" occupied_bins={occ}")

    # K3: one batch against the DynArray's per-key histogram rows.
    hists = state.hists
    got = dyn_array_update.keyed_q_r(w, hists, keys, s, cfg.m)
    want = ref.keyed_qr_ref(w, hists, keys, s, cfg.m)
    err = float((got - want).abs().max())
    uniq = torch.unique(keys)
    occ_rows = int((hists[keys] > 0).sum())
    entry("dyn_array_update", "src/repro_torch/csrc/keyed_qr.cu",
          "src/repro/kernels/dyn_array_update.py:39", err, err <= 1e-6,
          lambda: dyn_array_update.keyed_q_r(w, hists, keys, s, cfg.m),
          lambda: ref.keyed_qr_ref(w, hists, keys, s, cfg.m), 50,
          uniq.numel() * cfg.num_bins * 4 + batch * 16 + cfg.num_bins * 4,
          occ_rows * QR_OPS_PER_BIN + batch * 3, extra=f" distinct_rows={uniq.numel()}")

    # K4: the fused MLE over every DynArray row.
    regs = state.regs
    chat, std, conv = estimate.estimate_rows(cfg, regs)
    chat_p, std_p, conv_p = ref.estimate_rows_ref(cfg, regs)
    err = float((chat - chat_p).abs().max())
    close = bool(torch.allclose(chat, chat_p, rtol=1e-5, atol=1e-6)) and bool(
        torch.allclose(std, std_p, rtol=1e-5, atol=1e-6)) and bool(torch.equal(conv, conv_p))
    occ_bins = int((estimators.histograms(cfg, regs) > 0).sum())
    k = regs.shape[0]
    entry("estimate", "src/repro_torch/csrc/estimate.cu", "src/repro/kernels/estimate.py:45",
          err, close,
          lambda: estimate.estimate_rows(cfg, regs), lambda: ref.estimate_rows_ref(cfg, regs), 10,
          k * cfg.m + k * 12, occ_bins * K4_EVALS * K4_OPS_PER_BIN,
          extra=f" rows={k} mean_occupied_bins={occ_bins / k:.3f} "
                f"max_rel_err(rows above 1e-6)={rel_err(chat, chat_p):.3e}")

    # K6: the path's first batch, with the path's keys, folded into fresh
    # registers of the path's size (the path's first update), so every
    # touched row rises. The kernel updates in place: each timed call
    # starts from a fresh copy, made outside its events.
    keys6 = key_directory.route_slots(sa["dcfg"], (data["t_lo"][sl], data["t_hi"][sl])).contiguous()
    fresh6 = monitor.init_array(cfg, sa["state"].regs.shape[0], device=dev).regs
    work6 = fresh6.clone()
    want = ref.sketch_array_update_ref(lo, hi, log2w, keys6, fresh6, **args1)
    got = sketch_array_update.update_regs(lo, hi, log2w, keys6, work6, **args1)
    err = float((got.int() - want.int()).abs().max())
    raised = want != fresh6
    n_raised, rows_raised = int(raised.sum()), int(raised.any(1).sum())
    check(n_raised > 0, "K6's check batch raises registers")
    uniq6 = int(torch.unique(keys6).numel())
    entry("sketch_array_update", "src/repro_torch/csrc/sketch_array_update.cu",
          "src/repro/kernels/sketch_array_update.py:43", err, bool(torch.equal(got, want)),
          lambda: sketch_array_update.update_regs(lo, hi, log2w, keys6, work6, **args1),
          lambda: ref.sketch_array_update_ref(lo, hi, log2w, keys6, fresh6, **args1), 50,
          batch * 28 + uniq6 * cfg.m * 2, batch * cfg.m * K1_OPS_PER_PAIR,
          extra=f" distinct_rows={uniq6} registers_raised={n_raised} rows_raised={rows_raised}",
          reset=lambda: work6.copy_(fresh6))

    # K7: the windowed union histograms of the ring after its path, at a
    # head whose windows wrap round the ring; timed at the path's w = 4.
    ring = win["state"].window.regs
    e, k7, m7 = ring.shape
    head = torch.tensor(2, dtype=torch.int32, device=dev)
    equal, err = True, 0.0
    for w in (1, 4, 7):
        got = window_union.union_hists(ring, head, w, r_min=cfg.r_min, nb=cfg.num_bins)
        want = ref.window_union_ref(ring, head, w, r_min=cfg.r_min, nb=cfg.num_bins)
        equal &= bool(torch.equal(got, want))
        err = max(err, float((got - want).abs().max()))
    entry("window_union", "src/repro_torch/csrc/window_union.cu", "src/repro/kernels/window_union.py:40",
          err, equal,
          lambda: window_union.union_hists(ring, head, 4, r_min=cfg.r_min, nb=cfg.num_bins),
          lambda: ref.window_union_ref(ring, head, 4, r_min=cfg.r_min, nb=cfg.num_bins), 10,
          4 * k7 * m7 + k7 * cfg.num_bins * 4 + 4, 4 * k7 * m7 + k7 * m7,
          extra=f" ring=({e}, {k7}, {m7}) head=2 w=1,4,7 equal={equal}")

    # K5: the phase-3c throughput stream's first batch folded into fresh
    # LM registers at m = 256 (the path's first update; every register
    # falls). The wrapper folds into a copy, so calls do not compound.
    ids5, w5 = meth["lm_batch"]
    lo5, hi5 = ids5 & 0xFFFFFFFF, (ids5 >> 32) & 0xFFFFFFFF
    fresh5 = baselines.init(cfg, device=dev).regs
    got = float_sketch_update.update_regs(lo5, hi5, w5, fresh5, salt=cfg.salt_h)
    want = ref.float_sketch_update_ref(lo5, hi5, w5, fresh5, salt=cfg.salt_h)
    err = float((got - want).abs().max())
    # + 0.0 maps -0.0 (u = 1.0 gives e = -0.0; the kernel stores +0.0) to +0.0.
    ulps = int(((got + 0.0).view(torch.int32) - (want + 0.0).view(torch.int32)).abs().max())
    entry("float_sketch_update", "src/repro_torch/csrc/float_sketch_update.cu",
          "src/repro/kernels/qsketch_update.py:123", err, bool(torch.equal(got, want)),
          lambda: float_sketch_update.update_regs(lo5, hi5, w5, fresh5, salt=cfg.salt_h),
          lambda: ref.float_sketch_update_ref(lo5, hi5, w5, fresh5, salt=cfg.salt_h), 50,
          lo5.shape[0] * 20 + cfg.m * 8, lo5.shape[0] * cfg.m * K5_OPS_PER_PAIR,
          extra=f" largest_ulp_difference={ulps} registers_lowered={int((got < fresh5).sum())}")

    # K8: the phase-3d stream's first batch under the path's geometry.
    vcfg = virt["mon"].vcfg
    sl8 = slice(0, batch)
    args8 = [vdata["ids"][sl8] & 0xFFFFFFFF, (vdata["ids"][sl8] >> 32) & 0xFFFFFFFF,
             vdata["t_lo"][sl8].contiguous(), vdata["t_hi"][sl8].contiguous(), torch.log2(vdata["w"][sl8])]
    kw8 = dict(salt_g=cfg.salt_g, salt_h=cfg.salt_h, salt_pool=vcfg.salt_pool, m=vda.tail_m(cfg, vcfg),
               pool_size=vcfg.pool_size, r_min=cfg.r_min, r_max=cfg.r_max)
    p8, y8 = virtual_pool_update.route(*args8, **kw8)
    p8r, y8r = ref.virtual_pool_route_ref(*args8, **kw8)
    equal8 = bool(torch.equal(p8, p8r)) and bool(torch.equal(y8, y8r))
    err = float(max((p8 - p8r).abs().max(), (y8 - y8r).abs().max()))
    b8 = args8[0].shape[0]
    entry("virtual_pool_route", "src/repro_torch/csrc/virtual_pool_route.cu",
          "src/repro/kernels/virtual_pool_update.py:38", err, equal8,
          lambda: virtual_pool_update.route(*args8, **kw8),
          lambda: ref.virtual_pool_route_ref(*args8, **kw8), 50,
          b8 * (4 * 8 + 4 + 4 + 4), b8 * K8_OPS_PER_ELEMENT,
          extra=f" p_and_y_equal={equal8} distinct_slots={int(torch.unique(p8).numel())}")
    return rows


def profile_updates(update, start, batch, dev, n_batches=4):
    """Device time by kernel and the device idle share over the stream's
    first ``n_batches`` batches, ``update(state, span)`` each, from the
    state ``start()`` gives (made before each timed run, outside it)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    spans = [slice(i * batch, (i + 1) * batch) for i in range(n_batches)]

    def window(state):
        for sl in spans:
            state = update(state, sl)
        sync(dev)

    state = start()
    sync(dev)
    t0 = time.perf_counter()
    window(state)
    wall = time.perf_counter() - t0
    state = start()
    sync(dev)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        window(state)
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.time_range.elapsed_us() for e in kernels)
    if not kernels or busy_us <= 0:
        ms = time_ms(lambda: window(state), 2, dev) / n_batches
        print(f"  profiler recorded no device time; CUDA events: {ms:.4f} ms per batch; idle share not measured")
        return
    by_name = {}
    for e in kernels:
        tot, cnt = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (tot + e.time_range.elapsed_us(), cnt + 1)
    idle = 1.0 - busy_us * 1e-6 / wall
    print(f"  {n_batches} batches: wall {wall * 1e3:.3f} ms (unprofiled), device busy {busy_us / 1e3:.3f} ms, "
          f"device idle share {idle:.4f}, device kernels launched {len(kernels)}")
    for name, (tot, cnt) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]:
        print(f"    {tot / 1e3 / n_batches:8.4f} ms/batch  x{cnt // n_batches:<4d} {name[:90]}")


def cpu_replay(cfg, data, dev, n_prefix, capacity, batch):
    """The prefix of the stream through the DynArray monitor on the card and
    on the CPU: integer state bit for bit, chats to rtol 1e-5."""
    import torch

    from repro_torch.core import hashing, qsketch_dyn
    from repro_torch.sketchstream import monitor

    cpu = torch.device("cpu")
    states = []
    for d in (dev, cpu):
        part = {k: v[:n_prefix].to(d) for k, v in data.items()}
        mon = monitor.DynArrayMonitor.for_capacity(cfg, capacity, device=d)
        st = mon.init()
        t0 = time.perf_counter()
        for i in range(0, n_prefix, batch):
            sl = slice(i, i + batch)
            st = mon.update(st, (part["t_lo"][sl], part["t_hi"][sl]), part["ids"][sl], part["w"][sl])
        sync(d)
        print(f"  {d.type}: {n_prefix} elements at K = {capacity} in {time.perf_counter() - t0:.3f} s")
        states.append(st)
    b, a = states
    equal = all(torch.equal(getattr(b, f).cpu(), getattr(a, f)) for f in ("regs", "hists", "n_seen"))
    equal &= all(torch.equal(getattr(b.directory, f).cpu(), getattr(a.directory, f))
                 for f in a.directory._fields)
    chats_ok = bool(torch.allclose(b.chats.cpu(), a.chats, rtol=1e-5, atol=1e-6))
    # Where the card's logs differ from the CPU's: -ln u, and the quantized y.
    diffs = []
    for d in (dev, cpu):
        ids, w = data["ids"][:n_prefix].to(d), data["w"][:n_prefix].to(d)
        lo, hi = hashing.split_id64(ids)
        j, y = qsketch_dyn._choose_and_quantize(cfg, lo, hi, w)
        diffs.append((hashing.neg_log_uniform((lo, hi, j), cfg.salt_h).cpu(), y.cpu()))
    (e_card, y_card), (e_cpu, y_cpu) = diffs
    e_diff, y_diff = int((e_card != e_cpu).sum()), int((y_card != y_cpu).sum())
    print(f"  -ln u differs in {e_diff} of {n_prefix} elements; quantized y differs in {y_diff}")
    print(f"  integer state equal: {equal}; chats max relative difference "
          f"{rel_err(b.chats.cpu(), a.chats):.3e} (allclose rtol 1e-5, atol 1e-6: {chats_ok})")
    check(equal, "card and CPU integer state differ")
    check(chats_ok, "card and CPU chats differ beyond rtol 1e-5")


def accuracy(cfg, stream, data, main, n):
    """Relative errors against the exact weighted cardinality of the stream."""
    import torch

    from repro_torch.core import key_directory

    _, pool_idx, _, pool_w, _ = stream
    dcfg = main["mon"].dcfg
    slots = key_directory.route_slots(dcfg, (data["t_lo"], data["t_hi"])).cpu().numpy()
    truth, _ = host_truth(slots, pool_idx, pool_w, dcfg.capacity)
    top = np.argsort(truth)[-1000:]
    est = main["anytime"].cpu().numpy().astype(np.float64)
    rel = np.abs(est[top] - truth[top]) / truth[top]
    med, p90 = float(np.median(rel)), float(np.quantile(rel, 0.9))
    print(f"  anytime chats, 1000 heaviest tenant slots: median relative error {med:.5f}, "
          f"p90 {p90:.5f} (truth {truth[top].min():.1f} .. {truth[top].max():.1f})")
    regs = main["state"].regs
    full = (regs > cfg.r_min).all(1).cpu().numpy()
    sel = top[full[top]]
    fused = main["fused"].cpu().numpy().astype(np.float64)
    if len(sel):
        fr = np.abs(fused[sel] - truth[sel]) / truth[sel]
        print(f"  fused MLE on the {len(sel)} of them with every register touched: median relative "
              f"error {float(np.median(fr)):.5f}")
    whole = float(pool_w[np.unique(pool_idx)].astype(np.float64).sum())
    e_scalar = abs(main["scalar_chat"] - whole) / whole
    e_dyn = abs(main["dyn_chat"] - whole) / whole
    print(f"  whole stream: truth {whole:.1f}; scalar QSketch MLE {main['scalar_chat']:.1f} "
          f"(relative error {e_scalar:.5f}); QSketch-Dyn anytime {main['dyn_chat']:.1f} "
          f"(relative error {e_dyn:.5f})")
    check(bool(torch.isfinite(main["anytime"]).all()) and bool(torch.isfinite(main["fused"]).all()),
          "estimates must be finite")
    check(main["anytime"].shape == (dcfg.capacity,) and main["fused"].shape == (dcfg.capacity,),
          "one estimate per tenant slot")
    # m = 256 registers: relative standard error of a few percent per sketch.
    check(med < 0.1 and p90 < 0.3, "per-tenant anytime accuracy")
    check(e_scalar < 0.25 and e_dyn < 0.25, "whole-stream accuracy")


def warm_up(cfg, dev, data, batch):
    """One small pass through every entry point (library loads, allocator,
    sort workspaces) before the measured run."""
    from repro_torch.core import METHODS, dyn_array, qsketch_dyn
    from repro_torch.sketchstream import anomaly, monitor

    sl = slice(0, batch)
    keys = (data["t_lo"][sl], data["t_hi"][sl])
    mon = monitor.DynArrayMonitor.for_capacity(cfg, 1024, device=dev)
    st = mon.update(mon.init(), keys, data["ids"][sl], data["w"][sl])
    monitor.update(cfg, monitor.init(cfg, device=dev), data["ids"][sl], data["w"][sl])
    qsketch_dyn.update_batch(cfg, qsketch_dyn.init(cfg, device=dev), data["ids"][sl], data["w"][sl])
    dyn_array.estimate_mle_all(cfg, mon_state_view(st), solver="fused")
    arr = monitor.update_array(cfg, monitor.init_array(cfg, 1024, device=dev), keys, data["ids"][sl],
                               data["w"][sl], dcfg=mon.dcfg)
    monitor.estimate_array(cfg, arr)
    wmon = monitor.WindowMonitor.for_capacity(cfg, 1024, 4, evict_after=4, device=dev)
    ws = wmon.rotate(wmon.update(wmon.init(), keys, data["ids"][sl], data["w"][sl]))
    wmon.estimate(ws, w=2)
    anomaly.step(anomaly.AnomalyConfig(), anomaly.init(1024, device=dev), wmon.estimate(ws))
    for meth in METHODS.values():
        meth["estimate"](cfg, meth["update"](cfg, meth["init"](cfg, device=dev), data["ids"][sl], data["w"][sl]))
    vmon = monitor.VirtualDynMonitor.for_pool(cfg, 2**16, pinned=(1, 2), device=dev)
    vs = vmon.update(vmon.init(), keys, data["ids"][sl], data["w"][sl])
    vmon.estimate(vs, (keys[0][:1024], keys[1][:1024]))
    sync(dev)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0, help="seed of the generated stream")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs a GPU", file=sys.stderr)
        return 1
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: {ROOT / 'src' / 'repro_torch'} not found", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core import SketchConfig
    from repro_torch.kernels import _build, ops

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    capacity = 2**20
    print("phase 1: device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    print(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")

    print("phase 2: build")
    t0 = time.perf_counter()
    built = _build.build()
    print(f"  built {sorted(built)} in {time.perf_counter() - t0:.2f} s (one nvcc per source, in parallel)")
    for name, b in built.items():
        for line in b.ptxas.splitlines():
            if "Used" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    t0 = time.perf_counter()
    stream = zipf_bursty_stream(N_ELEMENTS, capacity, args.seed)
    data = to_device(stream, dev)
    print(f"stream: {N_ELEMENTS} elements, {capacity} tenants, seed {args.seed}, "
          f"made in {time.perf_counter() - t0:.2f} s")

    cfg = SketchConfig(m=256, b=8)
    warm_up(cfg, dev, data, BATCH)
    print("phase 3: main path")
    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launch_counts()
    main_out = run_main_path(cfg, dev, data, N_ELEMENTS, BATCH, capacity)
    launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    n_batches = -(-N_ELEMENTS // BATCH)
    st = main_out["state"]
    print(f"  DynArray monitor update: {N_ELEMENTS} elements in {main_out['update_s']:.4f} s = "
          f"{N_ELEMENTS / main_out['update_s']:.1f} elements/s "
          f"({main_out['update_s'] / n_batches * 1e3:.4f} ms per batch of {BATCH})")
    print(f"  scalar monitor (K1): {N_ELEMENTS / main_out['scalar_s']:.1f} elements/s; "
          f"QSketch-Dyn update_batch (K2): {N_ELEMENTS / main_out['dyn_s']:.1f} elements/s")
    print(f"  reads: anytime estimate {main_out['anytime_ms']:.4f} ms; "
          f"estimate_mle_all(solver='fused') {main_out['fused_ms']:.4f} ms")
    print(f"  peak device memory of the path (stream included): {peak / 2**30:.3f} GiB")
    print(f"  directory: n_routed={int(st.directory.n_routed)} n_collisions={int(st.directory.n_collisions)}; "
          f"touched rows {int((st.hists.sum(1) > 0).sum())}")
    print(f"  launches: {json.dumps(launches)}")
    check(all(launches[k] > 0 for k in MAIN_KERNELS), "every kernel of the path must launch")
    check(int(st.n_seen) == N_ELEMENTS, "n_seen counts the stream")
    print(f"  phase 3 took {time.perf_counter() - t_phase:.1f} s")

    print("phase 3a: per-key SketchArray monitor (K6)")
    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launch_counts()
    sa_out = run_sketch_array_path(cfg, dev, data, N_ELEMENTS, BATCH, capacity)
    sa_launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    print(f"  update_array(dcfg=...): {N_ELEMENTS} elements in {sa_out['update_s']:.4f} s = "
          f"{N_ELEMENTS / sa_out['update_s']:.1f} elements/s "
          f"({sa_out['update_s'] / n_batches * 1e3:.4f} ms per batch of {BATCH})")
    print(f"  estimate_array (histograms + newton over {capacity} rows): {sa_out['read_ms']:.4f} ms")
    print(f"  peak device memory of the phase (earlier phases' state included): {peak / 2**30:.3f} GiB")
    print(f"  launches: {json.dumps(sa_launches)}")
    check(sa_launches["sketch_array_update"] > 0, "K6 must launch on the SketchArray path")
    check(int(sa_out["state"].n_seen) == N_ELEMENTS, "n_seen counts the stream")
    sketch_array_checks(cfg, stream, data, sa_out, capacity)
    print(f"  phase 3a took {time.perf_counter() - t_phase:.1f} s")

    print(f"phase 3b: windowed alerts (K7): ring E = {N_EPOCHS_RING}, {N_EPOCHS} epochs, "
          f"flood at epoch {FLOOD_EPOCH}")
    t_phase = time.perf_counter()
    flood = flood_batch(stream, args.seed, BATCH, dev)
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launch_counts()
    win_out = run_window_path(cfg, dev, data, flood, N_ELEMENTS, BATCH, capacity)
    win_launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    n_win = N_ELEMENTS + BATCH
    wst = win_out["state"].window
    ring_bytes = sum(t.numel() * t.element_size() for t in wst[:6])
    print(f"  WindowMonitor.update: {n_win} elements in {win_out['update_s']:.4f} s = "
          f"{n_win / win_out['update_s']:.1f} elements/s")
    print(f"  rotate: median {float(np.median(win_out['rotate_ms'])):.4f} ms "
          f"(min {min(win_out['rotate_ms']):.4f}, max {max(win_out['rotate_ms']):.4f}) over {N_EPOCHS}")
    print(f"  reads: anytime median {float(np.median(win_out['anytime_ms'])):.4f} ms; "
          f"estimate(w=4) via K7 {win_out['w4_ms']:.4f} ms; estimate(w={N_EPOCHS_RING}) from the cached "
          f"union histograms {win_out[f'w{N_EPOCHS_RING}_ms']:.4f} ms")
    print(f"  ring state {ring_bytes / 2**30:.3f} GiB; peak device memory of the phase (earlier phases' "
          f"state included): {peak / 2**30:.3f} GiB")
    print(f"  metrics: {json.dumps(win_out['metrics'])}")
    print(f"  launches: {json.dumps(win_launches)}")
    check(win_launches["window_union"] > 0 and win_launches["dyn_array_update"] > 0,
          "K7 and K3 must launch on the window path")
    check(int(win_out["state"].n_seen) == n_win, "n_seen counts the stream and the flood")
    window_checks(cfg, stream, data, flood, win_out, N_ELEMENTS, capacity)

    print(f"  phase 3b took {time.perf_counter() - t_phase:.1f} s")

    print("phase 3c: the paper's five-method comparison (K1, K2, K5)")
    t_phase = time.perf_counter()
    ops.reset_launch_counts()
    meth_out = run_methods(dev, BATCH)
    meth_launches = ops.launch_counts()
    print(f"  accuracy: {len(ACC_MS)} m x 3 distributions x 5 methods x {ACC_RUNS} runs of {ACC_N} distinct "
          f"elements in {meth_out['accuracy_s']:.1f} s")
    methods_checks(meth_out)
    print("  update throughput, " + f"{TPUT_STREAM} elements (gamma, Zipf repeats over {TPUT_STREAM // 8}) "
          f"in batches of {BATCH} at m = 256: "
          + "; ".join(f"{k} {v:.1f} elements/s" for k, v in meth_out["eps"].items()))
    print(f"  launches: {json.dumps(meth_launches)}")
    check(all(meth_launches[k] > 0 for k in ("qsketch_update", "qdyn_qr", "float_sketch_update")),
          "K1, K2 and K5 must launch on the five-method path")
    print(f"  phase 3c took {time.perf_counter() - t_phase:.1f} s")

    print(f"phase 3d: the virtual tier (K8, K3): {VIRT_TENANTS} tenants, {VIRT_POOL}-slot pool, "
          f"{VIRT_PINNED} pinned")
    t_phase = time.perf_counter()
    vs = virtual_stream(VIRT_TENANTS, VIRT_BASE, VIRT_SEED)
    vdata = virtual_to_device(vs, dev)
    n_virt = len(vs[1])
    print(f"  stream: {n_virt} elements, made in {time.perf_counter() - t_phase:.2f} s")
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launch_counts()
    virt_out = run_virtual_path(cfg, dev, vs, vdata, BATCH)
    virt_launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    from repro_torch.core import virtual_dyn_array as vda

    vcfg = virt_out["mon"].vcfg
    print(f"  VirtualDynMonitor.update: {n_virt} elements in {virt_out['update_s']:.4f} s = "
          f"{n_virt / virt_out['update_s']:.1f} elements/s")
    print(f"  estimate of all {VIRT_TENANTS} tenants in chunks of {VIRT_READ_CHUNK}: {virt_out['read_ms']:.2f} ms")
    print(f"  metrics: {json.dumps(virt_out['metrics'])}")
    print(f"  memory_bytes {vda.memory_bytes(cfg, vcfg)} against dense_memory_bytes(K = {VIRT_TENANTS}) "
          f"{vda.dense_memory_bytes(cfg, VIRT_TENANTS)} "
          f"({vda.dense_memory_bytes(cfg, VIRT_TENANTS) / vda.memory_bytes(cfg, vcfg):.1f}x)")
    print(f"  peak device memory of the phase (earlier phases' state included): {peak / 2**30:.3f} GiB")
    print(f"  launches: {json.dumps(virt_launches)}")
    check(virt_launches["virtual_pool_route"] > 0 and virt_launches["dyn_array_update"] > 0,
          "K8 and K3 must launch on the virtual path")
    check(int(virt_out["state"].n_seen) == n_virt, "n_seen counts the stream")
    virtual_checks(cfg, dev, vs, virt_out, BATCH)
    print(f"  phase 3d took {time.perf_counter() - t_phase:.1f} s")

    launches = {**{k: launches[k] for k in MAIN_KERNELS},
                "float_sketch_update": meth_launches["float_sketch_update"],
                "sketch_array_update": sa_launches["sketch_array_update"],
                "window_union": win_launches["window_union"],
                "virtual_pool_route": virt_launches["virtual_pool_route"]}
    print("phase 4: kernels against their plain versions on the card")
    t_phase = time.perf_counter()
    rows = kernel_checks(cfg, dev, data, main_out, sa_out, win_out, meth_out, virt_out, vdata, BATCH, launches)
    print(f"  phase 4 took {time.perf_counter() - t_phase:.1f} s")

    print("phase 5: where an update's time goes")
    t_phase = time.perf_counter()
    from repro_torch.sketchstream import monitor

    def span(sl):
        return (data["t_lo"][sl], data["t_hi"][sl]), data["ids"][sl], data["w"][sl]

    print("  DynArray monitor, re-fed into the path's final state:")
    profile_updates(lambda s, sl: main_out["mon"].update(s, *span(sl)), lambda: st, BATCH, dev)
    print("  SketchArray monitor (update_array, dcfg), into fresh registers as the path began:")
    profile_updates(lambda s, sl: monitor.update_array(cfg, s, *span(sl), dcfg=sa_out["dcfg"]),
                    lambda: monitor.init_array(cfg, capacity, device=dev), BATCH, dev)

    def vspan(sl):
        return (vdata["t_lo"][sl], vdata["t_hi"][sl]), vdata["ids"][sl], vdata["w"][sl]

    print("  VirtualDynMonitor, into a fresh pool as the path began:")
    profile_updates(lambda s, sl: virt_out["mon"].update(s, *vspan(sl)), virt_out["mon"].init, BATCH, dev)
    print(f"  phase 5 took {time.perf_counter() - t_phase:.1f} s")

    print("phase 6: CPU replay")
    t_phase = time.perf_counter()
    cpu_replay(cfg, data, dev, min(2**18, N_ELEMENTS), 2**16, BATCH)

    print("phase 6b: CPU replay of the window path")
    window_replay(cfg, data, dev, 2**16, BATCH)

    print("phase 6c: CPU replay of the virtual path")
    virtual_replay(cfg, vs, vdata, dev, BATCH)
    print(f"  phases 6-6c took {time.perf_counter() - t_phase:.1f} s")

    print("phase 7: accuracy")
    t_phase = time.perf_counter()
    accuracy(cfg, stream, data, main_out, N_ELEMENTS)
    print(f"  phase 7 took {time.perf_counter() - t_phase:.1f} s")

    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
