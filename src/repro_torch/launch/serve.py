"""Access-controlled RAG serving: the reference's ``launch/serve.py``
``RAGServer.serve_batch`` path on the card.

Per batch of requests (role r, query vector):
  1. authorized retrieval: ``store.search`` returns each request's top-k
     passages among those its role may read (the ``l2_topk`` kernel);
  2. the generator LM prefills [passage tokens ++ query sentinel] into a
     KV cache of ``prompt + decode_tokens`` positions and decodes
     ``decode_tokens`` tokens greedily (the flash attention kernel in every
     layer of prefill and decode).

``serve_stream`` (the micro-batch scheduler) and ``warm_batch_shapes`` wait
for the serving slice.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..configs import get_smoke_config
from ..core import (HNSWCostModel, Query, SearchStats, build_effveda,
                    build_vector_storage, exact_factory)
from ..data.pipeline import make_retrieval_dataset
from ..device import DeviceLike, resolve_device
from ..models.config import ModelConfig
from ..models.model import decode_fn, init_cache, init_params, prefill_fn


@dataclasses.dataclass
class RAGServer:
    """``params`` must live on ``device`` (``None`` → ``cuda``, which raises
    without a card)."""
    cfg: ModelConfig
    params: Dict
    store: object                  # repro_torch.core.VectorStore
    passage_tokens: int = 8        # tokens per retrieved passage (stub map)
    device: DeviceLike = None

    def __post_init__(self):
        self.device = resolve_device(self.device)

    # stub detokenizer: passage id → deterministic pseudo tokens
    def _passage_to_tokens(self, pid: int) -> np.ndarray:
        rng = np.random.default_rng(pid + 17)
        return rng.integers(0, self.cfg.vocab_size,
                            self.passage_tokens).astype(np.int32)

    def batched_capable(self) -> bool:
        """Whether retrieval can take the batched engine."""
        return self.store.batched_capable()

    def retrieve_batch(self, queries: np.ndarray, roles: Sequence[int],
                       k: int, efs: int = 50,
                       stats: Optional[SearchStats] = None
                       ) -> List[List[Tuple[float, int]]]:
        """Top-k authorized retrieval for the whole request batch: one
        single-role :class:`Query` per row through ``store.search``."""
        qlist = [Query(vector=q, roles=(int(r),), k=int(k), efs=int(efs))
                 for q, r in zip(np.asarray(queries, np.float32), roles)]
        results = self.store.search(qlist)
        if stats is not None:
            for res in results:
                stats.merge(res.stats)
        return [res.hits for res in results]

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def serve_batch(self, queries: np.ndarray, roles: Sequence[int],
                    k: int = 4, efs: int = 50, decode_tokens: int = 8,
                    stats: Optional[SearchStats] = None) -> Dict:
        """Retrieve, prefill, decode.  Returns the retrieved ids per request,
        the (B, decode_tokens) generated tokens (the first from the prefill
        logits, then one per decode step; the last step's logits go unused,
        as in the reference), and host-clock seconds of retrieval, prefill,
        decode and generation (prefill + decode); the device is synchronised
        after prefill and at the end, so each span holds its own work."""
        t0 = time.perf_counter()
        results = self.retrieve_batch(queries, roles, k, efs=efs, stats=stats)
        retrieved: List[List[int]] = [[vid for _, vid in res]
                                      for res in results]
        t_retrieval = time.perf_counter() - t0
        # build prompts: retrieved passages then a query stub token
        b = len(queries)
        prompt_len = k * self.passage_tokens + 1
        prompts = np.zeros((b, prompt_len), np.int32)
        for i, pids in enumerate(retrieved):
            toks = [self._passage_to_tokens(pid) for pid in pids]
            while len(toks) < k:
                toks.append(np.zeros(self.passage_tokens, np.int32))
            prompts[i, :-1] = np.concatenate(toks)[:prompt_len - 1]
            prompts[i, -1] = 1   # query sentinel
        t0 = time.perf_counter()
        max_seq = prompt_len + decode_tokens
        cache = init_cache(self.cfg, b, max_seq, device=self.device)
        logits, cache = prefill_fn(
            self.params, self.cfg,
            torch.from_numpy(prompts).to(self.device), cache)
        tok = torch.argmax(logits, dim=-1)[:, None]
        self._sync()
        t_prefill = time.perf_counter() - t0
        t0 = time.perf_counter()
        out = []
        for t in range(decode_tokens):
            out.append(tok)
            logits, cache = decode_fn(self.params, self.cfg, tok, cache,
                                      prompt_len + t)
            tok = torch.argmax(logits, dim=-1)[:, None]
        out_tokens = (torch.cat(out, dim=1).to(torch.int32).cpu().numpy()
                      if out else np.zeros((b, 0), np.int32))
        self._sync()
        t_decode = time.perf_counter() - t0
        return {"retrieved": retrieved, "tokens": out_tokens,
                "t_retrieval_s": t_retrieval, "t_prefill_s": t_prefill,
                "t_decode_s": t_decode, "t_generate_s": t_prefill + t_decode}


def build_demo_server(arch: str = "smollm-360m", n_vectors: int = 4000,
                      dim: int = 24, n_roles: int = 8, beta: float = 1.1,
                      seed: int = 0, engine: str = "scorescan",
                      device: DeviceLike = None
                      ) -> Tuple[RAGServer, object]:
    """Small end-to-end server: synthetic corpus + EffVEDA store + smoke LM,
    on ``device`` (``None`` → ``cuda``, which raises without a card).

    ``engine='scorescan'`` (default) builds kernel-backed node indexes on
    the device, so retrieval runs through the batched execution engine;
    ``engine='exact'`` keeps host engines and the per-query path.  The LM's
    weights are random, drawn from a generator seeded with ``seed``.
    """
    dev = resolve_device(device)
    ds = make_retrieval_dataset(n_vectors=n_vectors, dim=dim,
                                n_roles=n_roles, n_permissions=3 * n_roles,
                                seed=seed)
    cm = HNSWCostModel(lam_threshold=400)
    result = build_effveda(ds.policy, cm, beta=beta, k=10)
    scan = engine == "scorescan"
    store = build_vector_storage(
        result, ds.vectors, engine_factory=None if scan else exact_factory(),
        pack_leftovers=scan, device=dev)
    cfg = get_smoke_config(arch)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(seed),
                         dev)
    return RAGServer(cfg=cfg, params=params, store=store, device=dev), ds
