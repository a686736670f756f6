#!/usr/bin/env python3
"""On-card smoke run of the PyTorch / CUDA port (``src/repro_torch``).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. device: the card's name and power limit, the CUDA version, TF32 off;
  2. build the Hopper ``l2_topk`` kernel from ``csrc/`` into ``build/`` and
     hold it against its plain PyTorch version on the card, over shapes,
     auth-word widths, predicate widths, bounds and sparse authorization;
  3. the main path at SIFT1M shape (1,000,000 x 128 float32, 32 roles):
     EffVEDA lattice, ScoreScan engines on the card, packed leftovers,
     ``VectorStore.search`` over batches of 64 queries; every hit held to
     the authorized brute-force oracle (the plain version over the full
     data on the card); the kernel's launch count must equal the node and
     shard launches the waves issued;
  4. a reduced second pass (200,000 rows, 64 roles = 2 auth words, a
     one-word predicate plane, a ``where`` clause on half the queries);
  5. kernel, plain-version and bound times at the main path's shapes
     (device time per call from torch.profiler, and the time between CUDA
     events around back-to-back calls), and the device time per batch by
     kernel (torch.profiler).

It prints one JSON line per phase, the kernel table line, and last the
device record.  It imports nothing of JAX or of the reference package.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

K = 10
BATCH = 64
HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (NVIDIA data sheet)
F32_FLOPS = 67e12              # H100 SXM float32 outside the tensor cores
SIFT_SKEW = dict(block_zipf=(1.0, 1.5), perm_zipf=(2.0, 1.5))


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int) -> float:
    """Mean ms per call of ``fn`` between CUDA events, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int) -> float:
    """Device time per call of ``fn``: the self time of every kernel it
    launched, from torch.profiler, after a warm-up.  Unlike ``cuda_ms``
    it leaves out the gaps while the host prepares the next launch."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total = sum(e.self_device_time_total for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA)
    assert total > 0, "the profiler saw no device time"
    return total / 1e3 / iters


def kernel_bound(b, n, d, k, w, p):
    """Least time (ms) for one launch: inputs read once, outputs written
    once, over HBM; the 2*B*N*d distance FLOPs over the float32 rate."""
    nbytes = 4 * (b * d + n * d + n + w * n + b * w + b + p * n + 2 * b * p)
    nbytes += 8 * b * k
    flops = 2.0 * b * n * d
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


# --------------------------------------------------------------- phase 2
def kernel_case(rng, b, n, d, k, w, p, bound="inf", auth="rand"):
    """Random operands for one kernel-vs-plain case, on the card."""
    from repro_torch.kernels.l2_topk import l2_topk_ref
    dev = torch.device("cuda")
    q = torch.from_numpy(rng.standard_normal((b, d)).astype(np.float32))
    db = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32))
    q, db = q.to(dev), db.to(dev)
    if auth == "none":
        words = np.zeros((n, w), np.uint32)
    elif auth == "few":                       # 3 authorized rows < k
        words = np.zeros((n, w), np.uint32)
        words[:3, 0] = 1
    else:
        words = rng.integers(0, 2 ** 16, size=(n, w)).astype(np.uint32)
    roles = np.zeros((b, w), np.uint32)
    for row in range(b):
        if auth == "rand":
            roles[row, rng.integers(w)] = np.uint32(1 << int(rng.integers(16)))
        else:
            roles[row, 0] = 1
    pk = {}
    if p:
        attr = rng.integers(0, 2 ** 32, size=(n, p), dtype=np.uint64)
        req = np.zeros((b, p), np.uint32)
        forb = np.zeros((b, p), np.uint32)
        for row in range(b):
            req[row, rng.integers(p)] |= np.uint32(1 << int(rng.integers(32)))
            forb[row, rng.integers(p)] |= np.uint32(1 << int(rng.integers(32)))
        pk = dict(attr_bits=attr.astype(np.uint32), require=req,
                  forbid=forb & ~req)
    bnd = np.full(b, np.inf, np.float32)
    if bound == "mid":                         # between the k/2-th and next
        rd, _ = l2_topk_ref(q, db, words, roles, np.inf, k, **pk)
        rd = rd.cpu().numpy()
        lo, hi = rd[:, k // 2 - 1], rd[:, k // 2]
        bnd = np.where(np.isfinite(hi), (lo + hi) / 2, np.inf)
        bnd = bnd.astype(np.float32)
    return q, db, words, roles, bnd, pk


def check_kernel_against_plain(rng) -> float:
    from repro_torch.core.metrics import norm_scale, topk_agreement
    from repro_torch.kernels.l2_topk import l2_topk_ref, ops
    groups = {
        "shapes": [(1, 1, 16, 1, 1, 0), (7, 1000, 16, 10, 1, 0),
                   (64, 1000, 128, 128, 1, 0), (7, 1000, 17, 10, 1, 0),
                   (1, 258_879, 128, 10, 1, 0),
                   (64, 258_879, 128, 10, 1, 0)],
        "auth_words": [(64, 27_820, 128, 10, 1, 0),
                       (64, 27_820, 128, 10, 2, 0),
                       (7, 1000, 16, 10, 8, 0)],
        "predicates": [(7, 1000, 128, 10, 2, 2), (64, 27_820, 128, 128, 2, 2),
                       (64, 27_820, 128, 10, 1, 1)],
        "bounds": [(7, 1000, 16, 10, 1, 0, "mid"),
                   (64, 258_879, 128, 10, 1, 0, "mid"),
                   (64, 258_879, 128, 10, 2, 0, "inf")],
        "sparse_auth": [(7, 1000, 16, 10, 2, 0, "inf", "none"),
                        (7, 1000, 16, 10, 1, 0, "inf", "few"),
                        (3, 1000, 16, 128, 1, 2, "inf", "few")],
    }
    worst = 0.0
    for name, cases in groups.items():
        errs, swaps = [], 0
        for case in cases:
            q, db, words, roles, bnd, pk = kernel_case(rng, *case)
            before = ops.launches
            d, i = ops.l2_topk(q, db, words, roles, case[3], bound=bnd, **pk)
            torch.cuda.synchronize()
            assert ops.launches == before + 1, "kernel not launched"
            rd, ri = l2_topk_ref(q, db, words, roles,
                                 torch.from_numpy(bnd).cuda(), case[3], **pk)
            res = topk_agreement(d.cpu().numpy(), i.cpu().numpy(),
                                 rd.cpu().numpy(), ri.cpu().numpy(),
                                 norm_scale(q.cpu().numpy(),
                                            db.cpu().numpy()))
            assert res["ok"], (name, case, res)
            if len(case) > 7 and case[7] == "none":
                assert (i == -1).all() and torch.isinf(d).all()
            if len(case) > 7 and case[7] == "few":
                assert ((i >= 0).sum(dim=1) <= 3).all()
                assert (i[:, 3:] == -1).all()
            errs.append(res["max_abs_err"])
            swaps += int(res["swaps"].sum())
        worst = max(worst, max(errs))
        emit("kernel_vs_plain", group=name, cases=len(cases), ok=True,
             max_abs_err=max(errs), near_tie_swaps=swaps,
             rule="rtol 1e-5, atol 1e-5*(|q|^2+max|v|^2); ids equal "
                  "except <=1 near-tie swap per query")
    return worst


# ----------------------------------------------------------- phases 3, 4
def count_issued(store):
    """Count the engine calls the waves issue (one kernel launch each), the
    rows they scan and the host time spent inside them (upload, launch,
    the synchronising copy back), by wrapping each ScoreScan engine's batch
    search."""
    issued = {"launches": 0, "rows": 0, "row_queries": 0, "call_s": 0.0}
    engines = list(store.engines.values())
    if store.leftover_shard is not None:
        engines.append(store.leftover_shard)
    for eng in engines:
        inner = eng.search_masked_batch

        def counted(qs, k, roles, bounds=None, require=None, forbid=None,
                    _inner=inner, _n=len(eng)):
            if _n:
                issued["launches"] += 1
                issued["rows"] += _n
                issued["row_queries"] += _n * len(qs)
            t0 = time.perf_counter()
            out = _inner(qs, k, roles, bounds=bounds, require=require,
                         forbid=forbid)
            issued["call_s"] += time.perf_counter() - t0
            return out
        eng.search_masked_batch = counted
    return issued


def oracle(store, data_dev, data_norms, queries, k):
    """Authorized top-k of every query by the plain version over the full
    data on the card: per distinct (roles, where), the exact authorized
    (and predicate) mask as single-word auth bits."""
    from repro_torch.kernels.l2_topk import l2_topk_ref
    groups = defaultdict(list)
    for n, q in enumerate(queries):
        groups[(q.roles, q.where)].append(n)
    dist = np.full((len(queries), k), np.inf, np.float32)
    ids = np.full((len(queries), k), -1, np.int64)
    for (roles, where), rows in groups.items():
        mask = store.authorized_mask_multi(roles)
        if where:
            mask = mask & store.predicate_mask(*store.compile_where(where))
        auth = torch.from_numpy(mask.astype(np.int32)).cuda()
        for s in range(0, len(rows), BATCH):
            part = rows[s:s + BATCH]
            qt = torch.from_numpy(np.stack([queries[n].vector
                                            for n in part])).cuda()
            d, i = l2_topk_ref(qt, data_dev, auth, np.uint32(1), np.inf, k,
                               db_norms=data_norms)
            dist[part], ids[part] = d.cpu().numpy(), i.cpu().numpy()
    return dist, ids


def drive(store, queries, data, name):
    """Warm up, then search every batch of 64 with the launch counts set
    to 0 just before; check paths, launches and every hit."""
    from repro_torch.core.metrics import norm_scale, recall_at_k, \
        topk_agreement
    from repro_torch.kernels.l2_topk import ops
    store.search(queries[:BATCH])                     # warm-up batch
    issued = count_issued(store)
    ops.launches = 0
    results, times = [], []
    for s in range(0, len(queries), BATCH):
        t0 = time.perf_counter()
        results += store.search(queries[s:s + BATCH])
        times.append(time.perf_counter() - t0)
    launches = ops.launches
    paths = {r.path for r in results}
    assert paths == {"batched+packed"}, paths
    assert launches > 0 and launches == issued["launches"], \
        (launches, issued)
    data_dev = torch.from_numpy(data).cuda()
    t0 = time.perf_counter()
    od, oi = oracle(store, data_dev, torch.sum(data_dev * data_dev, dim=1),
                    queries, K)
    oracle_s = time.perf_counter() - t0
    del data_dev
    sd = np.full((len(queries), K), np.inf, np.float32)
    si = np.full((len(queries), K), -1, np.int64)
    for n, r in enumerate(results):
        for j, (dd, ii) in enumerate(r.hits):
            sd[n, j], si[n, j] = dd, ii
    qs = np.stack([q.vector for q in queries])
    res = topk_agreement(sd, si, od, oi, norm_scale(qs, data))
    assert res["ok"], (name, res)
    recall = float(np.mean([recall_at_k(si[n][si[n] >= 0],
                                        oi[n][oi[n] >= 0], K)
                            for n in range(len(queries))]))
    total = float(sum(times))
    emit(name, queries=len(queries), batch=BATCH, ok=True,
         queries_per_s=len(queries) / total,
         ms_per_batch=[t * 1e3 for t in times],
         ms_per_batch_mean=total * 1e3 / len(times),
         l2_topk_launches=launches, launches_issued=issued["launches"],
         launches_per_batch=launches / len(times),
         rows_scanned=issued["rows"], row_query_pairs=issued["row_queries"],
         engine_call_ms_per_batch=issued["call_s"] * 1e3 / len(times),
         recall_at_10=recall, max_abs_err=res["max_abs_err"],
         near_tie_swaps=int(res["swaps"].sum()), oracle_s=oracle_s)
    return launches, total * 1e3 / len(times)


def breakdown(store, queries, host_ms_per_batch):
    """Device time per batch by kernel, from torch.profiler over two
    batches, and the device's busy share of an unprofiled batch."""
    from torch.profiler import ProfilerActivity, profile
    batches = [queries[s:s + BATCH] for s in range(0, 2 * BATCH, BATCH)]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for batch in batches:
            store.search(batch)
        torch.cuda.synchronize()
    device_ms = defaultdict(float)
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        name = next((n for n in ("l2_topk_partial", "l2_topk_merge",
                                 "Memcpy") if n in e.key), "other")
        device_ms[name] += e.self_device_time_total / 1e3 / len(batches)
    total = sum(device_ms.values())
    assert total > 0, "the profiler saw no device time"
    emit("breakdown", batches=len(batches),
         device_ms_per_batch=total, device_ms_by_kernel=dict(device_ms),
         host_ms_per_batch=host_ms_per_batch,
         device_busy_share=total / host_ms_per_batch)


def build_store(n, n_roles, n_queries, pred):
    from repro_torch.ann.scorescan import scorescan_factory
    from repro_torch.core import (HNSWCostModel, PredicateSchema, Query,
                                  build_effveda, build_vector_storage)
    from repro_torch.data.pipeline import make_retrieval_dataset
    t0 = time.perf_counter()
    ds = make_retrieval_dataset(n_vectors=n, dim=128, n_roles=n_roles,
                                n_permissions=96, n_queries=n_queries,
                                seed=0, **SIFT_SKEW)
    t_data = time.perf_counter() - t0
    res = build_effveda(ds.policy, HNSWCostModel(lam_threshold=2000),
                        beta=1.1, k=K)
    pk, where = {}, None
    if pred:
        colors = tuple(f"c{i}" for i in range(20))
        edges = (0.0, 10.0, 20.0, 30.0)
        schema = PredicateSchema.make(tags={"color": colors},
                                      ranges={"price": edges})
        rng = np.random.default_rng(7)
        color = rng.integers(0, 20, n)
        price = rng.uniform(0.0, 40.0, n)
        words = np.uint32(1) << color.astype(np.uint32)      # tag bit
        for j, e in enumerate(edges):                       # thermometer
            words |= (price >= e).astype(np.uint32) << np.uint32(20 + j)
        words = words[:, None]
        for r in range(0, n, n // 50):                      # layout check
            assert (schema.encode({"color": colors[color[r]],
                                   "price": float(price[r])}) == words[r]).all()
        pk = dict(pred_schema=schema, attr_words=words)
        where = (("ge", "price", 10.0), ("lacks", "color", "c1"))
    t0 = time.perf_counter()
    store = build_vector_storage(
        res, ds.vectors,
        engine_factory=scorescan_factory(ds.policy, device="cuda",
                                         attr_words=pk.get("attr_words")),
        pack_leftovers=True, device="cuda", **pk)
    torch.cuda.synchronize()
    t_store = time.perf_counter() - t0
    queries = [Query(vector=v, roles=(int(r),), k=K,
                     where=where if n_ % 2 == 0 else None)
               for n_, (v, r) in enumerate(zip(ds.queries, ds.query_roles))]
    sizes = sorted((len(e) for e in store.engines.values()), reverse=True)
    emit("build", vectors=n, dim=128, n_roles=n_roles,
         auth_words=store.mask_width, pred_words=store.pred_width,
         nodes=len(store.engines), largest_node=sizes[0],
         smallest_node=sizes[-1], leftover_blocks=len(res.leftovers),
         packed_shard_rows=len(store.leftover_shard), sa=store.sa(),
         dataset_s=t_data, store_s=t_store,
         device_bytes=torch.cuda.memory_allocated())
    return ds, store, queries


# --------------------------------------------------------------- phase 5
def time_kernel(store, queries, label):
    """Kernel, plain-version and bound times for one engine at B=64:
    ``ms`` / ``plain_ms`` are device time per call (torch.profiler),
    ``call_ms`` / ``plain_call_ms`` the time between CUDA events around
    back-to-back calls, host work of the wrappers included."""
    from repro_torch.kernels.l2_topk import l2_topk_words_ref, ops
    eng = (store.leftover_shard if label == "packed_shard"
           else max(store.engines.values(), key=len))
    qs = np.stack([q.vector for q in queries[:BATCH]])
    rows = store.role_mask_rows([q.roles for q in queries[:BATCH]])
    args = eng.kernel_operands(qs, rows)
    kd, ki = ops.l2_topk_words(k=K, **args)
    pd, pi = l2_topk_words_ref(k=K, **args)
    err = torch.where(torch.isfinite(pd), (kd - pd).abs(), 0).max().item()
    assert torch.equal(torch.isinf(kd), torch.isinf(pd))
    def kern():
        return ops.l2_topk_words(k=K, **args)

    def plain():
        return l2_topk_words_ref(k=K, **args)
    ms, plain_ms = device_ms(kern, 50), device_ms(plain, 10)
    call_ms, plain_call_ms = cuda_ms(kern, 50), cuda_ms(plain, 10)
    n, d = args["db"].shape
    bound_ms, bound_by = kernel_bound(BATCH, n, d, K, args["auth_words"]
                                      .shape[0], 0)
    out = dict(rows=n, batch=BATCH, dim=d, k=K, ms=ms, plain_ms=plain_ms,
               call_ms=call_ms, plain_call_ms=plain_call_ms,
               bound_ms=bound_ms, bound_by=bound_by, max_abs_err=err)
    emit("timing", shape=label, **out)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    from repro_torch.kernels.l2_topk import kernel

    t_start = time.perf_counter()
    card = card_line()
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit("device", card=card, torch=torch.__version__,
         cuda=torch.version.cuda, name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), tf32=False)

    t0 = time.perf_counter()
    lib = kernel.build()
    ptxas = [ln.strip() for ln in kernel.build_log.splitlines()
             if "registers" in ln or "spill" in ln]
    emit("build_kernel", library=str(lib.relative_to(ROOT)),
         seconds=time.perf_counter() - t0,
         max_registers=max((int(ln.split("Used ")[1].split()[0])
                            for ln in ptxas if "Used " in ln), default=None),
         stack_and_spill_bytes=sum(int(w) for ln in ptxas if "spill" in ln
                                   for w in ln.split() if w.isdigit()))

    worst = check_kernel_against_plain(np.random.default_rng(0))

    ds, store, queries = build_store(1_000_000, 32, 512, pred=False)
    launches, ms_per_batch = drive(store, queries, ds.vectors, "main_path")
    breakdown(store, queries, ms_per_batch)
    node_t = time_kernel(store, queries, "largest_node")
    shard_t = time_kernel(store, queries, "packed_shard")
    del ds, store, queries
    torch.cuda.empty_cache()

    ds, store, queries = build_store(200_000, 64, 256, pred=True)
    launches_filtered, _ = drive(store, queries, ds.vectors,
                                 "filtered_two_word_pass")
    del ds, store, queries

    entry = {
        "name": "l2_topk", "route": "cuda",
        "source": "src/repro_torch/kernels/l2_topk/csrc/l2_topk.cu",
        "replaces": "src/repro/kernels/l2_topk/kernel.py:119",
        "launches": launches,
        "max_abs_err": max(worst, node_t["max_abs_err"],
                           shard_t["max_abs_err"]),
        "ms": node_t["ms"], "plain_ms": node_t["plain_ms"],
        "call_ms": node_t["call_ms"],
        "plain_call_ms": node_t["plain_call_ms"],
        "bound_ms": node_t["bound_ms"], "bound_by": node_t["bound_by"],
        "library_ms": None,
        "shape": "largest node: B=64, N=%d, d=128, k=10, W=1, P=0"
                 % node_t["rows"],
        "packed_shard": shard_t,
        "launches_filtered_pass": launches_filtered,
        "library_note": "no single PyTorch call computes an authorized, "
                        "bounded top-k",
    }
    emit("done", seconds=time.perf_counter() - t_start)
    print(json.dumps({"kernels": [entry]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
