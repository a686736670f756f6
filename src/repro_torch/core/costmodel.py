"""Query-cost model (paper Def. 2.2 and Appendix B).

The paper's deployment-calibrated HNSW latency model is

    C_theta(idx, efs) = a * log2(|idx|) + b * efs + c

(linear in efs — each base-layer expansion is dominated by M*d FLOPs and M
cache-missing fetches, constant in efs).  Role-based query cost (Def. 2.2):

    pure:                      C(|idx|, efs)
    impure, lam*efs <= |idx|:  C(|idx|, ceil(lam*efs))
    impure, lam*efs  > |idx|:  C(|idx|, |idx|)          (degenerates to scan)

Small nodes (< Lambda) are linear-scanned: cost = scan_per_vec * n + scan_c.

The lattice builders (VEDA / EffVEDA) and the selectivity-aware router of
the sequential path read this model.  The scan roofline model that places
shards across devices comes with the multi-GPU slice.
"""
from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class HNSWCostModel:
    """Calibrated latency model; units are arbitrary (microseconds when fit)."""

    a: float = 0.0821     # upper-layer descent coefficient (per log2 |idx|)
    b: float = 0.1159     # base-layer beam coefficient (per efs unit)
    c: float = 2.3110     # fixed per-query overhead
    alpha: int = 5        # efs = alpha * k  (paper: 5..10)
    lam_threshold: int = 2900   # Lambda: below this, linear scan wins (Fig. 2)
    scan_per_vec: float = 0.004  # linear-scan cost per vector
    scan_c: float = 0.5          # linear-scan fixed overhead

    # ------------------------------------------------------------- primitives
    def hnsw_cost(self, n: int, efs: float) -> float:
        n = max(int(n), 2)
        return self.a * math.log2(n) + self.b * float(efs) + self.c

    def scan_cost(self, n: int) -> float:
        return self.scan_per_vec * float(n) + self.scan_c

    # ------------------------------------------------------- Def 2.2 (Cost_H)
    def role_query_cost(self, n: int, n_auth: int, k: int,
                        selectivity: float = 1.0) -> float:
        """Cost of a top-k query by a role authorized for ``n_auth`` of ``n``.

        Applies Def. 2.2 for indexable nodes and the linear-scan model below
        the indexability threshold Lambda.  ``n_auth == 0`` → the node would
        never be in this role's plan; return 0.

        ``selectivity`` (fraction of rows passing an attached predicate,
        1.0 = unfiltered) thins the qualifying population: the beam must be
        inflated by ceil(n / (n_auth * selectivity)) to surface k survivors,
        which is how low-selectivity predicates push indexable nodes back
        below the scan crossover.  Scan cost is selectivity-independent
        (every row is touched either way).
        """
        if n_auth <= 0:
            return 0.0
        if n < self.lam_threshold:
            return self.scan_cost(n)
        efs = self.alpha * k
        sel = min(max(float(selectivity), 1e-9), 1.0)
        eff_auth = n_auth * sel               # rows passing auth AND predicate
        if eff_auth >= n:                     # pure, unfiltered
            return self.hnsw_cost(n, efs)
        lam = math.ceil(n / max(eff_auth, 1e-9))   # Eq. (1), predicate-aware
        inflated = lam * efs
        if inflated <= n:                     # impure, inflate the beam
            return self.hnsw_cost(n, math.ceil(inflated))
        return self.hnsw_cost(n, n)           # degenerate full traversal

    def oracle_cost(self, n_auth: int, k: int) -> float:
        """Cost of the oracle index for a role with |D(r)| = n_auth."""
        if n_auth <= 0:
            return 0.0
        if n_auth < self.lam_threshold:
            return self.scan_cost(n_auth)
        return self.hnsw_cost(n_auth, self.alpha * k)

    def indexable(self, n: int) -> bool:
        """Whether an ``n``-row node clears the indexability threshold Λ.

        The single gate shared by the builders' finalization
        (``_split_small_nodes``), the compactor's fold trigger, and the
        drift-driven split/demote decision: below Λ a linear scan wins
        (Fig. 2) and the rows belong in the leftover pool."""
        return int(n) >= self.lam_threshold


CostModel = HNSWCostModel  # default model type used across core/
