#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py [--seed 0]

Builds the four CUDA kernels of the path (K1 qsketch_update, K2 qdyn_qr,
K3 dyn_array_update, K4 estimate) from ``src/repro_torch/csrc``, then, at
the README's configuration (m = 256, b = 8) and K = 2^20 tenants:

  1. device: the card's name and power limit, torch and CUDA versions;
  2. build: time and ptxas report (registers, shared memory, spills);
  3. main path: a Zipf-bursty stream of sparse 64-bit tenants through the
     key directory into the DynArray monitor, the same stream through the
     scalar full-QSketch monitor and one whole-stream QSketch-Dyn sketch,
     then the anytime read and the fused MLE read; every kernel must have
     launched during this phase;
  4. kernels against their plain PyTorch versions on the card, at the
     path's shapes and on its data;
  5. where an update's time goes (torch.profiler);
  6. CPU replay of a stream prefix: the card's state against the port's
     plain CPU path;
  7. accuracy against the exact weighted cardinality of the stream.

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

# Peak rates of one H100 SXM (NVIDIA data sheet, at its 700 W limit).
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# Scalar operations per unit of work, counted from the kernel sources:
# K1 per (element, register) pair — third murmur round 7, fmix 8,
# unit map 3, negate 1, logf 1, log2f 1, subtract 1, floor 1, clip 2, max 1.
K1_OPS_PER_PAIR = 27
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
    pool ids uint64, pool weights float32).
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
    return tenant_ids[ranks], pool_idx, pool_ids, pool_w


def to_device(stream, dev):
    import torch

    tenants, pool_idx, pool_ids, pool_w = stream
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


def rel_err(got, want, floor=1e-6):
    """Largest relative difference over entries whose reference exceeds ``floor``."""
    sel = want.abs() > floor
    if not bool(sel.any()):
        return 0.0
    return float(((got[sel] - want[sel]).abs() / want[sel].abs()).max())


def time_ms(fn, reps, dev, rounds=5):
    """Milliseconds per call: CUDA events around ``reps`` back-to-back calls,
    the median of ``rounds`` such runs (a host stall in one run does not
    set the figure)."""
    import torch

    fn()  # warm
    sync(dev)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    per_call = []
    for _ in range(rounds):
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        per_call.append(start.elapsed_time(end) / reps)
    return float(np.median(per_call))


def kernel_checks(cfg, dev, data, main, batch, launches):
    """Each kernel's wrapper against its plain version on the path's shapes."""
    import torch

    from repro_torch.core import estimators, key_directory
    from repro_torch.kernels import dyn_array_update, estimate, ops, qdyn_qr, qsketch_update, ref

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

    def entry(name, source, replaces, err, tol_ok, fn_k, fn_p, reps, bytes_, ops_, extra=""):
        ms = time_ms(fn_k, reps, dev)
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
    return rows


def profile_updates(mon, state, data, batch, dev, n_batches=4):
    """Device time by kernel and the device idle share over ``n_batches``
    DynArray updates (re-feeding the stream's first batches)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    spans = [slice(i * batch, (i + 1) * batch) for i in range(n_batches)]

    def window():
        nonlocal state
        for sl in spans:
            state = mon.update(state, (data["t_lo"][sl], data["t_hi"][sl]), data["ids"][sl], data["w"][sl])
        sync(dev)

    sync(dev)
    t0 = time.perf_counter()
    window()
    wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        window()
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.time_range.elapsed_us() for e in kernels)
    if not kernels or busy_us <= 0:
        ms = time_ms(window, 2, dev) / n_batches
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

    _, pool_idx, _, pool_w = stream
    dcfg = main["mon"].dcfg
    slots = key_directory.route_slots(dcfg, (data["t_lo"], data["t_hi"])).cpu().numpy()
    pairs = np.unique((slots << 32) | pool_idx)
    truth = np.bincount(pairs >> 32, weights=pool_w[pairs & 0xFFFFFFFF].astype(np.float64),
                        minlength=dcfg.capacity)
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
    from repro_torch.core import dyn_array, qsketch_dyn
    from repro_torch.sketchstream import monitor

    sl = slice(0, batch)
    mon = monitor.DynArrayMonitor.for_capacity(cfg, 1024, device=dev)
    st = mon.update(mon.init(), (data["t_lo"][sl], data["t_hi"][sl]), data["ids"][sl], data["w"][sl])
    monitor.update(cfg, monitor.init(cfg, device=dev), data["ids"][sl], data["w"][sl])
    qsketch_dyn.update_batch(cfg, qsketch_dyn.init(cfg, device=dev), data["ids"][sl], data["w"][sl])
    dyn_array.estimate_mle_all(cfg, mon_state_view(st), solver="fused")
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
    check(all(v > 0 for v in launches.values()), "every kernel of the path must launch")
    check(int(st.n_seen) == N_ELEMENTS, "n_seen counts the stream")

    print("phase 4: kernels against their plain versions on the card")
    rows = kernel_checks(cfg, dev, data, main_out, BATCH, launches)

    print("phase 5: where an update's time goes")
    profile_updates(main_out["mon"], st, data, BATCH, dev)

    print("phase 6: CPU replay")
    cpu_replay(cfg, data, dev, min(2**18, N_ELEMENTS), 2**16, BATCH)

    print("phase 7: accuracy")
    accuracy(cfg, stream, data, main_out, N_ELEMENTS)

    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
