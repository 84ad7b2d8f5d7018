"""Architecture configuration schema.

Every assigned architecture is an :class:`ArchConfig`; a config fully
determines the model graph (block pattern, mixer kinds, FFN kinds, norms,
positional scheme).  ``reduced()`` derives the small same-family config used
by the CPU smoke tests; the full configs are exercised only through the
dry-run (``ShapeDtypeStruct``, no allocation).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

__all__ = ["ArchConfig", "Block"]


@dataclasses.dataclass(frozen=True)
class Block:
    """One block of the repeating layer pattern.

    mixer: 'attn' | 'ssm' | 'rglru'
    ffn:   'dense' | 'moe' | 'none'   ('none': the mixer is the whole block,
           as in Mamba)
    rope:  apply rotary embedding (attn mixers only; False = NoPE)
    window: sliding-attention window (None = full causal)
    """

    mixer: str = "attn"
    ffn: str = "dense"
    rope: bool = True
    window: Optional[int] = None


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    #: repeating block pattern; (n_layers - len(tail)) must divide evenly.
    pattern: Tuple[Block, ...] = (Block(),)
    #: extra blocks after the scanned groups (unrolled) — lets depths that
    #: are not multiples of the pattern stay faithful (RecurrentGemma: 38 =
    #: 12×(rg, rg, attn) + (rg, rg)).
    tail: Tuple[Block, ...] = ()
    head_dim: Optional[int] = None  # default d_model // n_heads
    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    expert_d_ff: int = 0  # per-expert hidden dim (defaults to d_ff)
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    # --- SSM (mamba-1) ---
    ssm_state: int = 16
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_dt_rank: int = 0  # default ceil(d_model/16)
    # --- RG-LRU ---
    rglru_expand: int = 1
    # --- norms / activations / positions ---
    norm: str = "rmsnorm"  # rmsnorm | layernorm | nonparam_ln
    qk_norm: bool = False
    act: str = "silu"  # silu (SwiGLU) | gelu (GeGLU)
    rope_theta: float = 10_000.0
    tie_embeddings: bool = False
    # --- modality frontend stub ---
    #: None: token ids in.  'embed': the frontend is a stub — inputs are
    #: precomputed patch/frame embeddings of size (B, T, d_model).
    frontend: Optional[str] = None
    #: real vocab size when ``vocab`` has been padded for TP divisibility
    #: (padded logit rows are masked to -inf in forward — exact semantics).
    vocab_real: Optional[int] = None
    #: does the paper's technique apply inside the model (MoE dispatch)?
    geo_plannable: bool = False
    #: long_500k support: sub-quadratic sequence mixing available?
    subquadratic: bool = False

    def __post_init__(self):
        assert (self.n_layers - len(self.tail)) % len(self.pattern) == 0, (
            f"{self.name}: {self.n_layers} layers minus {len(self.tail)} tail "
            f"not divisible by pattern of {len(self.pattern)}"
        )
        if self.n_heads:
            assert self.n_heads % max(self.n_kv_heads, 1) == 0

    # -- derived quantities -------------------------------------------------
    @property
    def head_dim_(self) -> int:
        return self.head_dim or (self.d_model // max(self.n_heads, 1))

    @property
    def n_groups(self) -> int:
        return (self.n_layers - len(self.tail)) // len(self.pattern)

    @property
    def expert_d_ff_(self) -> int:
        return self.expert_d_ff or self.d_ff

    @property
    def ssm_d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_dt_rank_(self) -> int:
        return self.ssm_dt_rank or -(-self.d_model // 16)

    @property
    def rglru_width(self) -> int:
        return self.rglru_expand * self.d_model

    def n_params(self) -> int:
        """Total parameter count (used for 6·N·D roofline MODEL_FLOPS)."""
        return sum(_param_counts(self).values())

    def n_active_params(self) -> int:
        """Parameters touched per token (MoE counts top_k experts only)."""
        counts = _param_counts(self)
        total = sum(counts.values())
        if self.n_experts:
            moe = counts["moe_experts"]
            total -= moe
            total += moe * self.top_k / self.n_experts
        return int(total)

    def reduced(self) -> "ArchConfig":
        """Same-family tiny config for CPU smoke tests."""
        pat = self.pattern
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            n_layers=2 * len(pat) + len(self.tail),
            d_model=64,
            n_heads=4,
            n_kv_heads=max(1, 4 * self.n_kv_heads // max(self.n_heads, 1)),
            head_dim=16,
            d_ff=128,
            expert_d_ff=32 if self.n_experts else 0,
            vocab=256,
            n_experts=min(self.n_experts, 8),
            top_k=min(self.top_k, 2) if self.top_k else 0,
            ssm_state=8,
            ssm_dt_rank=8,
            pattern=tuple(
                dataclasses.replace(b, window=min(b.window, 32) if b.window else None)
                for b in pat
            ),
            tail=tuple(
                dataclasses.replace(b, window=min(b.window, 32) if b.window else None)
                for b in self.tail
            ),
        )


def _param_counts(cfg: ArchConfig) -> dict:
    """Per-component parameter counts (exact for the graphs built in
    models/model.py, excluding biases/norm scales which are negligible)."""
    d, hd = cfg.d_model, cfg.head_dim_
    counts = {"embed": cfg.vocab * d}
    if not cfg.tie_embeddings:
        counts["unembed"] = cfg.vocab * d
    attn = mamba = rglru = dense_ffn = moe_experts = moe_router = 0
    blocks = [(b, cfg.n_groups) for b in cfg.pattern] + [(b, 1) for b in cfg.tail]
    for blk, reps in blocks:
        if blk.mixer == "attn":
            attn += reps * (
                d * cfg.n_heads * hd  # wq
                + 2 * d * cfg.n_kv_heads * hd  # wk, wv
                + cfg.n_heads * hd * d  # wo
            )
        elif blk.mixer == "ssm":
            di, ds, dtr = cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_dt_rank_
            mamba += reps * (
                d * 2 * di  # in_proj (x and gate)
                + di * cfg.ssm_conv  # conv
                + di * (dtr + 2 * ds)  # x_proj
                + dtr * di  # dt_proj
                + di * ds  # A
                + di  # D
                + di * d  # out_proj
            )
        elif blk.mixer == "rglru":
            w = cfg.rglru_width
            rglru += reps * (
                2 * d * w  # in_proj (x and gate branches)
                + w * 4  # conv1d (k=4)
                + 2 * w  # recurrence + input gates (diagonal)
                + w * d  # out_proj
            )
        if blk.ffn == "dense":
            dense_ffn += reps * 3 * d * cfg.d_ff  # gate, up, down
        elif blk.ffn == "moe":
            moe_experts += reps * cfg.n_experts * 3 * d * cfg.expert_d_ff_
            moe_router += reps * d * cfg.n_experts
    counts.update(
        attn=attn, mamba=mamba, rglru=rglru, dense_ffn=dense_ffn,
        moe_experts=moe_experts, moe_router=moe_router,
    )
    return counts
