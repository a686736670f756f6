#!/usr/bin/env python3
"""On-card smoke run of the PyTorch / CUDA port (``src/repro_torch``).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. device: the card's name and power limit, the CUDA version, TF32 off;
  2. build the Hopper kernels (``l2_topk``, ``flash_attention``) from their
     ``csrc/`` into ``build/``, one nvcc each, started together;
  3. hold ``l2_topk`` against its plain PyTorch version on the card, over
     shapes, auth-word widths, predicate widths, bounds and sparse
     authorization; hold ``flash_attention`` against its plain version
     over causal / kv-length / offset / GQA cases and the RAG path's
     prefill and decode shapes, in f32 and bf16;
  4. the retrieval main path at SIFT1M shape (1,000,000 x 128 float32, 32
     roles): EffVEDA lattice, ScoreScan engines on the card, packed
     leftovers, ``VectorStore.search`` over batches of 64 queries; every hit
     held to the authorized brute-force oracle (the plain version over the
     full data on the card); the kernel's launch count must equal the node
     and shard launches the waves issued;
  5. RAG serving at full width on that store: SmolLM-360M in bf16 with
     random weights, 16 requests, k = 10 passages of 100 tokens (a
     1,001-token prompt), 32 greedy decode tokens through
     ``RAGServer.serve_batch``; every passage authorized for its role and
     equal to the oracle's; the flash kernel launched in every layer of
     prefill and of each decode step (32 x 33); the device time by kernel;
  6. the same model in f32: prefill plus 4 teacher-forced decode steps with
     the kernel and with the plain version, logits within rtol 1e-3;
  7. a reduced second retrieval pass (200,000 rows, 64 roles = 2 auth
     words, a one-word predicate plane, a ``where`` clause on half the
     queries);
  8. kernel, plain-version, library and bound times at the main paths'
     shapes (device time per call from torch.profiler, and the time between
     CUDA events around back-to-back calls).

It prints one JSON line per phase, the kernel table line, the card line,
and last the device record.  It imports nothing of JAX or of the reference
package.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import subprocess
import sys
import time
from collections import defaultdict
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

K = 10
BATCH = 64
HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (NVIDIA data sheet)
F32_FLOPS = 67e12              # H100 SXM float32 outside the tensor cores
ARCH = "smollm-360m"
RAG_REQUESTS = 16
RAG_K = 10
PASSAGE_TOKENS = 100           # prompt = 10 x 100 + 1 sentinel = 1,001
DECODE_TOKENS = 32
PROMPT = RAG_K * PASSAGE_TOKENS + 1
FLASH_TOL = dict(rtol=2e-4, atol=2e-5)
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


def flash_bound(b, sq, hq, hkv, hd, causal, q_offset, kv_len, in_bytes):
    """Least time (ms) for one attention call: q and the kv_len positions
    of k and v read once, the f32 output written once, over HBM; the 4*hd
    float32 operations per valid (row, column) pair of each query head
    (Q.K^T and P.V) over the float32 rate, counting only the pairs these
    offsets and lengths leave valid."""
    rows = np.arange(sq)
    seen = np.minimum(kv_len, rows + q_offset + 1) if causal else \
        np.full(sq, kv_len)
    pairs = float(np.clip(seen, 0, None).sum())
    nbytes = in_bytes * (b * sq * hq * hd + 2 * b * kv_len * hkv * hd)
    nbytes += 4 * b * sq * hq * hd
    flops = 4.0 * hd * hq * b * pairs
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def build_kernels():
    """Build every kernel library at once (one nvcc each, in threads) and
    report nvcc's register and spill lines for each."""
    from repro_torch.kernels.flash_attention import kernel as flash_kernel
    from repro_torch.kernels.l2_topk import kernel as l2_kernel
    libs = {"l2_topk": l2_kernel.LIBRARY,
            "flash_attention": flash_kernel.LIBRARY}

    def timed(lib):
        t0 = time.perf_counter()
        path = lib.build()
        return path, time.perf_counter() - t0

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(libs)) as pool:
        futures = {name: pool.submit(timed, lib)
                   for name, lib in libs.items()}
        built = {name: f.result() for name, f in futures.items()}
    for name, (path, seconds) in built.items():
        ptxas = [ln.strip() for ln in libs[name].build_log.splitlines()
                 if "registers" in ln or "spill" in ln]
        emit("build_kernel", kernel=name,
             library=str(path.relative_to(ROOT)), seconds=seconds,
             max_registers=max((int(ln.split("Used ")[1].split()[0])
                                for ln in ptxas if "Used " in ln),
                               default=None),
             stack_and_spill_bytes=sum(int(w) for ln in ptxas
                                       if "spill" in ln
                                       for w in ln.split() if w.isdigit()))
    emit("build_all", seconds=time.perf_counter() - t0)


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


def flash_inputs(rng, b, hq, hkv, sq, sk, hd, dtype):
    """q (B, Sq, Hq, hd), k and v (B, Sk, Hkv, hd) of unit normals, on the
    card in ``dtype``."""
    return tuple(torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to("cuda", dtype)
        for shape in ((b, sq, hq, hd), (b, sk, hkv, hd), (b, sk, hkv, hd)))


# (B, Hq, Hkv, Sq, Sk, hd, causal, q_offset, kv_len)
FLASH_CASES = {
    "aligned_gqa": (2, 4, 2, 128, 128, 32, True, 0, 128),
    "padding": (1, 2, 2, 100, 100, 64, True, 0, 100),
    "decode_kv_len": (1, 4, 1, 1, 256, 32, False, 255, 200),
    "offset": (2, 2, 2, 64, 192, 16, True, 128, 192),
    "full_tile": (1, 8, 8, 256, 256, 128, True, 0, 256),
    "unaligned": (1, 3, 1, 37, 75, 20, True, 38, 75),
    "prefill_into_cache": (1, 3, 1, 33, 41, 64, True, 0, 33),
    "chunk_at_offset": (2, 6, 2, 20, 80, 16, True, 30, 50),
    "nothing_valid": (2, 15, 5, 1, 8, 64, True, 0, 0),
    "rag_prefill": (RAG_REQUESTS, 15, 5, PROMPT, PROMPT + DECODE_TOKENS, 64,
                    True, 0, PROMPT),
    "rag_first_decode": (RAG_REQUESTS, 15, 5, 1, PROMPT + DECODE_TOKENS, 64,
                         True, PROMPT, PROMPT + 1),
    "rag_last_decode": (RAG_REQUESTS, 15, 5, 1, PROMPT + DECODE_TOKENS, 64,
                        True, PROMPT + DECODE_TOKENS - 1,
                        PROMPT + DECODE_TOKENS),
}


def check_flash_against_plain(rng) -> float:
    """The kernel against its plain version on the same inputs, f32 and
    bf16 (the same bf16 values on both sides, f32 math in both): rtol 2e-4,
    atol 2e-5, the reference's own kernel test tolerance."""
    from repro_torch.kernels.flash_attention import flash_attention_ref, ops
    worst = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        errs = {}
        for name, case in FLASH_CASES.items():
            b, hq, hkv, sq, sk, hd, causal, off, kv_len = case
            q, k, v = flash_inputs(rng, b, hq, hkv, sq, sk, hd, dtype)
            before = ops.launches
            out = ops.flash_attention(q, k, v, causal=causal, q_offset=off,
                                      kv_len=kv_len)
            torch.cuda.synchronize()
            assert ops.launches == before + 1, "kernel not launched"
            ref = flash_attention_ref(q, k, v, causal=causal, q_offset=off,
                                      kv_len=kv_len)
            assert out.dtype == torch.float32 and out.shape == ref.shape
            assert torch.isfinite(out).all(), name
            torch.testing.assert_close(out, ref, **FLASH_TOL)
            if kv_len == 0:
                assert (out == 0).all(), name
            errs[name] = (out - ref).abs().max().item()
            del q, k, v, out, ref
        worst = max(worst, max(errs.values()))
        emit("flash_vs_plain", dtype=str(dtype).split(".")[-1],
             cases=len(errs), ok=True, max_abs_err=max(errs.values()),
             max_abs_err_by_case=errs,
             rule="rtol 2e-4, atol 2e-5 (elementwise, f32 output)")
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


# ------------------------------------------------------------ phases 5, 6
def tensor_bytes(tree) -> int:
    """Bytes of every tensor in a nested dict / list of tensors."""
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    items = tree.values() if isinstance(tree, dict) else tree
    return sum(tensor_bytes(t) for t in items)


def kernel_family(name: str) -> str:
    for key, family in (("flash_attention", "flash_attention"),
                        ("l2_topk", "l2_topk"), ("Memcpy", "memcpy")):
        if key in name:
            return family
    if any(key in name.lower() for key in ("gemm", "xmma", "nvjet",
                                            "cutlass")):
        return "matmul"
    return "other"


def rag_phase(ds, store):
    """RAG serving at full width on the main path's store: one warm-up
    batch, then the counts set to 0, one measured ``serve_batch``, the
    counts read; then one profiled batch for the device time by kernel."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_config
    from repro_torch.core import Query
    from repro_torch.core.metrics import norm_scale, recall_at_k, \
        topk_agreement
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.l2_topk import ops as l2_ops
    from repro_torch.launch.serve import RAGServer
    from repro_torch.models import init_params
    cfg = get_config(ARCH)
    assert cfg.dtype == "bfloat16"
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         "cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    server = RAGServer(cfg=cfg, params=params, store=store,
                       passage_tokens=PASSAGE_TOKENS, device="cuda")
    qs = ds.queries[:RAG_REQUESTS]
    roles = [int(r) for r in ds.query_roles[:RAG_REQUESTS]]
    server.serve_batch(qs, roles, k=RAG_K, decode_tokens=2)     # warm-up
    torch.cuda.reset_peak_memory_stats()
    base_bytes = torch.cuda.memory_allocated()
    l2_ops.launches = flash_ops.launches = 0
    out = server.serve_batch(qs, roles, k=RAG_K,
                             decode_tokens=DECODE_TOKENS)
    flash_launches, l2_launches = flash_ops.launches, l2_ops.launches
    peak_bytes = torch.cuda.max_memory_allocated() - base_bytes
    assert flash_launches == cfg.n_layers * (1 + DECODE_TOKENS), \
        flash_launches
    assert l2_launches > 0

    # every passage authorized, and the oracle's authorized top-k
    hits = server.retrieve_batch(qs, roles, RAG_K)
    assert out["retrieved"] == [[i for _, i in h] for h in hits]
    for r, pids in zip(roles, out["retrieved"]):
        assert len(pids) == RAG_K
        assert ds.policy.authorized_mask(r)[pids].all(), "leak!"
        assert store.authorized_mask(r)[pids].all(), "leak!"
    data_dev = torch.from_numpy(ds.vectors).cuda()
    od, oi = oracle(store, data_dev, torch.sum(data_dev * data_dev, dim=1),
                    [Query(vector=q, roles=(r,), k=RAG_K)
                     for q, r in zip(qs, roles)], RAG_K)
    del data_dev
    sd = np.array([[d for d, _ in h] for h in hits], np.float32)
    si = np.array([[i for _, i in h] for h in hits], np.int64)
    agree = topk_agreement(sd, si, od, oi, norm_scale(qs, ds.vectors))
    assert agree["ok"], agree
    tokens = out["tokens"]
    assert tokens.shape == (RAG_REQUESTS, DECODE_TOKENS)
    assert ((tokens >= 0) & (tokens < cfg.vocab_size)).all()

    kv_bytes = (2 * cfg.n_layers * RAG_REQUESTS * (PROMPT + DECODE_TOKENS)
                * cfg.n_kv_heads * cfg.hd * 2)
    n_tok = RAG_REQUESTS * DECODE_TOKENS
    result = dict(
        arch=ARCH, dtype=cfg.dtype, n_layers=cfg.n_layers,
        requests=RAG_REQUESTS, k=RAG_K, prompt_tokens=PROMPT,
        decode_tokens=DECODE_TOKENS, ok=True,
        retrieval_ms=out["t_retrieval_s"] * 1e3,
        prefill_ms=out["t_prefill_s"] * 1e3,
        decode_ms_per_token=out["t_decode_s"] * 1e3 / DECODE_TOKENS,
        decode_tokens_per_s=n_tok / out["t_decode_s"],
        prefill_tokens_per_s=RAG_REQUESTS * PROMPT / out["t_prefill_s"],
        serve_ms=(out["t_retrieval_s"] + out["t_generate_s"]) * 1e3,
        flash_launches=flash_launches, l2_topk_launches=l2_launches,
        passages_authorized=True,
        recall_at_10=float(np.mean([recall_at_k(si[n], oi[n], RAG_K)
                                    for n in range(RAG_REQUESTS)])),
        max_abs_dist_err=agree["max_abs_err"],
        near_tie_swaps=int(agree["swaps"].sum()),
        param_bytes=tensor_bytes(params), kv_cache_bytes=kv_bytes,
        peak_bytes_above_store_and_params=peak_bytes,
        init_params_s=init_s)
    emit("rag_serve", **result)

    # device time by kernel: a serve with no decode step (retrieval and
    # prefill), then the full serve; the decode steps are the difference
    device = {}
    for label, steps in (("prefill", 0), ("serve", DECODE_TOKENS)):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            server.serve_batch(qs, roles, k=RAG_K, decode_tokens=steps)
            torch.cuda.synchronize()
        by_family = defaultdict(float)
        for e in prof.key_averages():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                by_family[kernel_family(e.key)] += \
                    e.self_device_time_total / 1e3
        assert sum(by_family.values()) > 0, "the profiler saw no device time"
        device[label] = by_family
    decode = {name: (device["serve"][name] - device["prefill"][name])
              / DECODE_TOKENS for name in device["serve"]}
    total = sum(device["serve"].values())
    prefill_total = sum(device["prefill"].values())
    decode_total = sum(decode.values())
    host_ms = result["serve_ms"]
    emit("rag_breakdown", device_ms=total,
         device_ms_by_kernel=dict(device["serve"]),
         host_ms_unprofiled=host_ms, device_busy_share=total / host_ms,
         prefill_device_ms_by_kernel=dict(device["prefill"]),
         prefill_device_ms=prefill_total,
         prefill_device_busy_share=prefill_total / (
             result["retrieval_ms"] + result["prefill_ms"]),
         decode_device_ms_per_token_by_kernel=decode,
         decode_device_ms_per_token=decode_total,
         decode_device_busy_share=decode_total
         / result["decode_ms_per_token"],
         flash_decode_device_ms_per_launch=decode["flash_attention"]
         / cfg.n_layers)
    del server, params
    torch.cuda.empty_cache()
    return result


@contextlib.contextmanager
def plain_attention():
    """Route the model's attention through the plain version, for the
    comparison run of ``f32_check`` only."""
    from repro_torch.kernels.flash_attention import flash_attention_ref, ops
    kernel_fn = ops.flash_attention
    ops.flash_attention = flash_attention_ref
    try:
        yield
    finally:
        ops.flash_attention = kernel_fn


def f32_check(steps=4):
    """SmolLM-360M at full width in f32: prefill a 1,001-token prompt for 16
    requests, then ``steps`` teacher-forced decode steps, once with the
    kernel and once with the plain version.  Logits hold to rtol 1e-3,
    atol 1e-3: both runs share every matmul, and the attention sums differ
    only in order (about 1e-6 relative each), which 32 layers amplify."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.models import decode_fn, init_cache, init_params, \
        prefill_fn
    cfg = dataclasses.replace(get_config(ARCH), dtype="float32")
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(1),
                         "cuda")
    rng = np.random.default_rng(5)
    toks = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (RAG_REQUESTS, PROMPT + steps))).cuda()

    def run():
        cache = init_cache(cfg, RAG_REQUESTS, PROMPT + steps, device="cuda")
        logits, cache = prefill_fn(params, cfg, toks[:, :PROMPT], cache)
        out = [logits]
        for t in range(steps):
            logits, cache = decode_fn(params, cfg,
                                      toks[:, PROMPT + t:PROMPT + t + 1],
                                      cache, PROMPT + t)
            out.append(logits)
        return torch.stack(out)

    before = ops.launches
    kern = run()
    torch.cuda.synchronize()
    assert ops.launches == before + cfg.n_layers * (1 + steps)
    with plain_attention():
        plain = run()
    torch.cuda.synchronize()
    assert ops.launches == before + cfg.n_layers * (1 + steps)
    assert torch.isfinite(kern).all() and kern.dtype == torch.float32
    torch.testing.assert_close(kern, plain, rtol=1e-3, atol=1e-3)
    err = (kern - plain).abs().max().item()
    same_argmax = (kern.argmax(-1) == plain.argmax(-1)).float().mean().item()
    emit("f32_check", arch=ARCH, dtype="float32", requests=RAG_REQUESTS,
         prompt_tokens=PROMPT, decode_steps=steps, ok=True,
         max_abs_err=err, logit_scale=plain.abs().max().item(),
         argmax_agreement=same_argmax, rule="rtol 1e-3, atol 1e-3")
    del params
    torch.cuda.empty_cache()
    return err


# --------------------------------------------------------------- phase 8
def time_flash(rng, label, b, sq, sk, q_offset, kv_len):
    """Kernel, plain-version, SDPA and bound times for one attention call
    at SmolLM-360M's heads in bf16 (``ms`` etc. are device time per call
    from torch.profiler; ``call_ms`` the time between CUDA events)."""
    from repro_torch.kernels.flash_attention import flash_attention_ref, ops
    from repro_torch.kernels.flash_attention.ref import valid_mask
    hq, hkv, hd = 15, 5, 64
    q, k, v = flash_inputs(rng, b, hq, hkv, sq, sk, hd, torch.bfloat16)
    kw = dict(causal=True, q_offset=q_offset, kv_len=kv_len)
    mask = valid_mask(sq, sk, device="cuda", **kw)
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)

    def kern():
        return ops.flash_attention(q, k, v, **kw)

    def plain():
        return flash_attention_ref(q, k, v, **kw)

    def library():
        return torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, enable_gqa=True)
    ref = plain()
    err = (kern() - ref).abs().max().item()
    lib_err = (library().transpose(1, 2).float() - ref).abs().max().item()
    out = dict(batch=b, sq=sq, sk=sk, heads=f"{hq}/{hkv}", hd=hd,
               dtype="bfloat16", q_offset=q_offset, kv_len=kv_len,
               ms=device_ms(kern, 20), plain_ms=device_ms(plain, 3),
               library_ms=device_ms(library, 20),
               call_ms=cuda_ms(kern, 20), max_abs_err=err,
               library_max_abs_err=lib_err)
    out["bound_ms"], out["bound_by"] = flash_bound(
        b, sq, hq, hkv, hd, True, q_offset, kv_len, 2)
    emit("timing_flash", shape=label, **out)
    del q, k, v, qt, kt, vt, mask
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    card = card_line()
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit("device", card=card, torch=torch.__version__,
         cuda=torch.version.cuda, name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), tf32=False)

    build_kernels()
    worst = check_kernel_against_plain(np.random.default_rng(0))
    flash_worst = check_flash_against_plain(np.random.default_rng(1))

    ds, store, queries = build_store(1_000_000, 32, 512, pred=False)
    launches, ms_per_batch = drive(store, queries, ds.vectors, "main_path")
    breakdown(store, queries, ms_per_batch)
    node_t = time_kernel(store, queries, "largest_node")
    shard_t = time_kernel(store, queries, "packed_shard")
    rag = rag_phase(ds, store)
    del ds, store, queries
    torch.cuda.empty_cache()

    f32_err = f32_check()
    rng = np.random.default_rng(2)
    prefill_t = time_flash(rng, "rag_prefill", RAG_REQUESTS, PROMPT,
                           PROMPT + DECODE_TOKENS, 0, PROMPT)
    decode_t = time_flash(rng, "rag_last_decode", RAG_REQUESTS, 1,
                          PROMPT + DECODE_TOKENS, PROMPT + DECODE_TOKENS - 1,
                          PROMPT + DECODE_TOKENS)

    ds, store, queries = build_store(200_000, 64, 256, pred=True)
    launches_filtered, _ = drive(store, queries, ds.vectors,
                                 "filtered_two_word_pass")
    del ds, store, queries

    l2_entry = {
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
        "launches_rag_run": rag["l2_topk_launches"],
        "library_note": "no single PyTorch call computes an authorized, "
                        "bounded top-k",
    }
    flash_entry = {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/csrc/"
                  "flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:79",
        "launches": rag["flash_launches"],
        "max_abs_err": max(flash_worst, prefill_t["max_abs_err"],
                           decode_t["max_abs_err"]),
        "ms": prefill_t["ms"], "plain_ms": prefill_t["plain_ms"],
        "call_ms": prefill_t["call_ms"],
        "bound_ms": prefill_t["bound_ms"], "bound_by": prefill_t["bound_by"],
        "library_ms": prefill_t["library_ms"],
        "shape": "RAG prefill: B=16, Sq=1001 into a 1033-position cache, "
                 "15/5 heads, hd=64, bf16, q_offset=0, kv_len=1001",
        "decode": decode_t,
        "f32_model_max_abs_err": f32_err,
        "library_note": "torch.nn.functional.scaled_dot_product_attention "
                        "with the same boolean mask and enable_gqa",
    }
    emit("done", seconds=time.perf_counter() - t_start)
    print(json.dumps({"kernels": [l2_entry, flash_entry]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
