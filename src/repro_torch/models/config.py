"""Model configuration: the reference's ``ModelConfig``, field for field.

The port keeps its own copy (it imports nothing of the reference package).
Only the dense family is served by the port so far (``models/model.py``);
the MoE, SSM and hybrid fields are kept so that configurations carry over
unchanged."""
from __future__ import annotations

import dataclasses
from typing import Optional


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | encoder | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None
    qk_norm: bool = False          # qwen3
    qkv_bias: bool = False         # qwen2
    causal: bool = True
    rope_theta: float = 1e4
    # --- MoE ---
    n_experts: int = 0
    experts_per_token: int = 0
    capacity_factor: float = 1.25
    # --- SSM (mamba2 SSD) ---
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 64
    conv_width: int = 4
    # --- hybrid (zamba2): shared attention block every N ssm layers ---
    attn_every: int = 0
    # --- modality frontend stub: input is precomputed embeddings ---
    frontend: Optional[str] = None        # None | "audio" | "vision"
    # --- numerics / compile ---
    dtype: str = "bfloat16"
    remat: bool = True
    loss_chunk: int = 512                 # seq chunk for vocab-sharded CE
    attn_chunk: int = 1024                # kv chunk for jnp flash attention
    use_pallas: bool = False              # TPU runtime: pallas kernels
    norm_eps: float = 1e-6
    # --- dry-run cost-accounting controls (see launch/dryrun.py) ---
    # XLA cost_analysis counts a while-loop body once, not ×trip-count, so
    # roofline variants unroll the layer scan / inner (attention, loss) scans
    # on small-L models and extrapolate.
    unroll_layers: bool = False
    unroll_inner: bool = False
    # --- §Perf hillclimb flags (default False = paper-faithful baseline) ---
    # bf16 attention compute: keep q/k/v in bf16 and accumulate in f32 via
    # preferred_element_type instead of materializing f32 copies (halves the
    # attention-path HBM bytes; standard TPU practice).
    bf16_attn_compute: bool = False
    # when heads don't divide the model axis (smollm: 15 on 16), keep the
    # sequence dim sharded through attention instead of forcing replication
    # (SP-fallback: avoids whole-activation all-gathers + f32 all-to-alls).
    attn_sp_fallback: bool = False
    # MoE: constrain dispatch groups straight to (pod,data) instead of the
    # all-axes intermediate (skips one re-shard hop of the dispatch tensors)
    moe_direct_groups: bool = False
    # MoE: dispatch/combine via take_along_axis (explicit gather batch dims)
    # instead of advanced integer indexing — SPMD partitions the former per
    # group, while the latter hides the batch dim inside the index array and
    # falls back to replicating the full token tensor.
    moe_batched_gather: bool = False

    # ------------------------------------------------------------- derived
    @property
    def hd(self) -> int:
        if self.head_dim is not None:
            return self.head_dim
        return self.d_model // max(self.n_heads, 1)

    @property
    def padded_vocab(self) -> int:
        return _round_up(self.vocab_size, 256)

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def is_attn_free(self) -> bool:
        return self.family == "ssm"

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def n_super(self) -> int:
        """Hybrid: number of (attn_every ssm layers + shared attn) blocks."""
        if self.attn_every <= 0:
            return 0
        assert self.n_layers % self.attn_every == 0, (
            self.n_layers, self.attn_every)
        return self.n_layers // self.attn_every

    def param_count(self) -> int:
        """Approximate parameter count N (for MODEL_FLOPS = 6*N*D)."""
        d, f, v = self.d_model, self.d_ff, self.padded_vocab
        hd, h, hkv = self.hd, self.n_heads, self.n_kv_heads
        n = 2 * v * d                                   # embed + head
        if self.family == "ssm" or self.family == "hybrid":
            di, st, nh = self.d_inner, self.ssm_state, self.ssm_heads
            per = (d * (2 * di + 2 * st + nh)           # in_proj
                   + di * d + di + nh)                  # out_proj, norm, A
            n += self.n_layers * (per + 2 * d)
            if self.family == "hybrid":
                attn = d * hd * (h + 2 * hkv) + h * hd * d + 2 * d * f + f * d
                n += self.n_super * attn                # shared params
        elif self.is_moe:
            attn = d * hd * (h + 2 * hkv) + h * hd * d
            moe = self.n_experts * (3 * d * f) + d * self.n_experts
            n += self.n_layers * (attn + moe + 2 * d)
        else:
            attn = d * hd * (h + 2 * hkv) + h * hd * d
            mlp = 3 * d * f
            n += self.n_layers * (attn + mlp + 2 * d)
        return int(n)

    def active_param_count(self) -> int:
        """Active parameters per token (MoE: top-k experts only)."""
        if not self.is_moe:
            return self.param_count()
        d, f = self.d_model, self.d_ff
        hd, h, hkv = self.hd, self.n_heads, self.n_kv_heads
        n = 2 * self.padded_vocab * d
        attn = d * hd * (h + 2 * hkv) + h * hd * d
        moe_active = self.experts_per_token * (3 * d * f) + d * self.n_experts
        n += self.n_layers * (attn + moe_active + 2 * d)
        return int(n)
