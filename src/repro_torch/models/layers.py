"""Model layers on torch: norms, RoPE, attention (GQA / qk-norm / sliding
window / NoPE, int8 decode cache), SwiGLU & GeGLU MLPs, the capacity-dropped
MoE FFN, the Mamba-1 block and the RG-LRU block — the parts of
:mod:`repro.models.layers` that the serving slices run.

Layers are functions over parameter dicts with the reference's names and
tensor layouts.  Matrix products follow jax's type promotion: a float32
activation against a bfloat16 weight is computed in float32, as the
reference computes it.  Each ``init_*`` takes a ``torch.Generator`` on the
target device and an optional ``stack`` prefix, the leading group axis of
the stacked parameters.

Attention picks one of three evaluation strategies, as the reference does:

* ``ref`` dense — small shapes and decode steps;
* ``chunked`` — a plain online-softmax loop over (q, kv) blocks, what
  ``use_kernel=False`` takes above ``_DENSE_LOGITS_LIMIT``;
* ``kernel`` — the Hopper flash kernel (:mod:`repro_torch.kernels`).

The MoE FFN scatters its tokens through the Hopper ``moe_dispatch`` kernel
with ``use_kernel=True``, at the reference's own slots.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..kernels import ops as kops
from ..kernels import ref as kref
from .config import ArchConfig, Block
from .sharding import shard

Params = Dict[str, Any]
Stack = Tuple[int, ...]

_INIT_SCALE = 1.0


def _normal(gen: torch.Generator, shape, std: float,
            dtype: torch.dtype) -> torch.Tensor:
    """N(0, std²) drawn in float32 on the generator's device, then cast."""
    w = torch.randn(tuple(shape), generator=gen, device=gen.device)
    return w.mul_(std).to(dtype)


def _dense_init(gen: torch.Generator, shape, in_axis_size: int,
                dtype: torch.dtype) -> torch.Tensor:
    return _normal(gen, shape, _INIT_SCALE / np.sqrt(in_axis_size), dtype)


def _ein(eq: str, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum`` with jax's promotion: both operands in their common type."""
    dt = torch.promote_types(x.dtype, w.dtype)
    return torch.einsum(eq, x.to(dt), w.to(dt))


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def init_norm(cfg: ArchConfig, stack: Stack = (), device=None,
              dtype: torch.dtype = torch.float32) -> Params:
    shape = tuple(stack) + (cfg.d_model,)
    if cfg.norm == "rmsnorm":
        return {"scale": torch.ones(shape, device=device, dtype=dtype)}
    if cfg.norm == "layernorm":
        return {"scale": torch.ones(shape, device=device, dtype=dtype),
                "bias": torch.zeros(shape, device=device, dtype=dtype)}
    if cfg.norm == "nonparam_ln":  # OLMo: LN without learnable params
        return {}
    raise ValueError(cfg.norm)


def apply_norm(cfg: ArchConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    xf = x.float()
    if cfg.norm == "rmsnorm":
        rms = torch.sqrt((xf * xf).mean(dim=-1, keepdim=True) + 1e-6)
        return (xf / rms * p["scale"]).to(x.dtype)
    mean = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, correction=0)  # jnp.var: population
    out = (xf - mean) / torch.sqrt(var + 1e-5)
    if cfg.norm == "layernorm":
        out = out * p["scale"] + p["bias"]
    return out.to(x.dtype)


def _rms_headwise(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    xf = x.float()
    rms = torch.sqrt((xf * xf).mean(dim=-1, keepdim=True) + 1e-6)
    return (xf / rms * scale).to(x.dtype)


# ---------------------------------------------------------------------------
# rotary embedding
# ---------------------------------------------------------------------------

def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (B, H, T, Dh); positions: (B, T) or (T,).  Angles in float32."""
    half = x.shape[-1] // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                          device=x.device) / half))
    if positions.dim() == 1:
        positions = positions[None, :]
    ang = positions[:, None, :, None].float() * freqs  # (B, 1, T, half)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def init_attention(cfg: ArchConfig, gen: torch.Generator, stack: Stack = (),
                   dtype: torch.dtype = torch.float32) -> Params:
    d, H, Hkv, Dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    s = tuple(stack)
    p = {
        "wq": _dense_init(gen, s + (d, H, Dh), d, dtype),
        "wk": _dense_init(gen, s + (d, Hkv, Dh), d, dtype),
        "wv": _dense_init(gen, s + (d, Hkv, Dh), d, dtype),
        "wo": _dense_init(gen, s + (H, Dh, d), H * Dh, dtype),
    }
    if cfg.qk_norm:
        p["q_scale"] = torch.ones(s + (Dh,), device=gen.device, dtype=dtype)
        p["k_scale"] = torch.ones(s + (Dh,), device=gen.device, dtype=dtype)
    return p


def chunked_attention(
    q, k, v, causal: bool, window: Optional[int], q_offset: int,
    block_q: int = 512, block_k: int = 512,
) -> torch.Tensor:
    """Online-softmax attention as a plain loop over (q, kv) blocks;
    temporaries are (B, H, bq, bk).  Matches ``kref.attention_ref``.  Blocks
    that no query of the q block can see are skipped: they would add
    nothing."""
    B, Hq, T, Dh = q.shape
    _, Hkv, S, _ = k.shape
    group = Hq // Hkv
    scale = Dh ** -0.5
    bq, bk = min(block_q, T), min(block_k, S)
    qf = q.float().reshape(B, Hkv, group, T, Dh)
    kf, vf = k.float(), v.float()
    out = torch.empty((B, Hkv, group, T, Dh), dtype=torch.float32,
                      device=q.device)
    for q0 in range(0, T, bq):
        qc = qf[:, :, :, q0:q0 + bq]
        nq = qc.shape[3]
        q_pos = torch.arange(q0, q0 + nq, device=q.device)[:, None] + q_offset
        m = torch.full((B, Hkv, group, nq, 1), float("-inf"), device=q.device)
        l = torch.zeros((B, Hkv, group, nq, 1), device=q.device)
        acc = torch.zeros((B, Hkv, group, nq, Dh), device=q.device)
        for k0 in range(0, S, bk):
            if causal and k0 > q0 + nq - 1 + q_offset:
                break
            nk = min(bk, S - k0)
            if window is not None and k0 + nk - 1 <= q0 + q_offset - window:
                continue
            s = torch.einsum("bkgqd,bksd->bkgqs", qc, kf[:, :, k0:k0 + nk])
            s = s * scale
            k_pos = torch.arange(k0, k0 + nk, device=q.device)[None, :]
            mask = torch.ones((nq, nk), dtype=torch.bool, device=q.device)
            if causal:
                mask &= k_pos <= q_pos
            if window is not None:
                mask &= k_pos > q_pos - window
            s = s.masked_fill(~mask, float("-inf"))
            m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            m_safe = torch.where(torch.isinf(m_new), 0.0, m_new)
            alpha = torch.where(torch.isinf(m), 0.0, torch.exp(m - m_safe))
            p = torch.exp(s - m_safe).masked_fill(~mask, 0.0)
            l = alpha * l + p.sum(dim=-1, keepdim=True)
            acc = acc * alpha + torch.einsum("bkgqs,bksd->bkgqd", p,
                                             vf[:, :, k0:k0 + nk])
            m = m_new
        out[:, :, :, q0:q0 + nq] = acc / torch.where(l == 0.0, 1.0, l)
    return out.reshape(B, Hq, T, Dh).to(q.dtype)


#: attention strategy thresholds (elements of the dense logits tensor)
_DENSE_LOGITS_LIMIT = 1 << 27  # ~134M f32 logits = 512 MB


def attention_fwd(
    cfg: ArchConfig,
    blk: Block,
    p: Params,
    x: torch.Tensor,  # (B, T, d)
    positions: torch.Tensor,  # (B, T)
    cache: Optional[Dict] = None,
    use_kernel: bool = False,
    mode: str = "train",  # train | prefill | decode
    max_cache_len: Optional[int] = None,
) -> Tuple[torch.Tensor, Optional[Dict]]:
    """Attention block.  In ``decode`` mode the new keys and values are
    written into ``cache`` in place (the port updates the shared serving
    cache in place, where the reference returns a new one), and ``cache``
    itself is returned."""
    B, T, d = x.shape
    q = _ein("btd,dhk->bhtk", x, p["wq"])
    k = _ein("btd,dhk->bhtk", x, p["wk"])
    v = _ein("btd,dhk->bhtk", x, p["wv"])
    q = shard(q, "act_batch", "act_heads", "act_seq", None)
    k = shard(k, "act_batch", "act_kv_heads", "act_seq", None)
    v = shard(v, "act_batch", "act_kv_heads", "act_seq", None)
    if cfg.qk_norm:
        q = _rms_headwise(q, p["q_scale"])
        k = _rms_headwise(k, p["k_scale"])
    if blk.rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)

    new_cache = None
    if mode == "decode":
        # per-row write positions: each batch row (serving slot) may sit at
        # a different absolute position — required for continuous batching.
        if cache is None:
            raise ValueError("attention_fwd: decode needs a cache")
        Hkv = k.shape[1]
        b_idx = torch.arange(B, device=x.device)[:, None, None]
        h_idx = torch.arange(Hkv, device=x.device)[None, :, None]
        pos_idx = positions[:, None, :].long()  # (B, 1, T)
        if "k_scale" in cache:
            # int8 KV cache (§Perf): halves the per-token cache sweep.
            kq, ks = _quant_kv(k)
            vq, vs = _quant_kv(v)
            cache["k"][b_idx, h_idx, pos_idx] = kq
            cache["v"][b_idx, h_idx, pos_idx] = vq
            cache["k_scale"][b_idx, h_idx, pos_idx] = ks
            cache["v_scale"][b_idx, h_idx, pos_idx] = vs
            k = _dequant_kv(cache["k"], cache["k_scale"], x.dtype)
            v = _dequant_kv(cache["v"], cache["v_scale"], x.dtype)
        else:
            cache["k"][b_idx, h_idx, pos_idx] = k.to(cache["k"].dtype)
            cache["v"][b_idx, h_idx, pos_idx] = v.to(cache["v"].dtype)
            k, v = cache["k"], cache["v"]
        new_cache = cache
    elif mode == "prefill":
        pad = (max_cache_len or T) - T
        kc = F.pad(k, (0, 0, 0, pad)) if pad else k
        vc = F.pad(v, (0, 0, 0, pad)) if pad else v
        new_cache = {"k": kc, "v": vc}

    S = k.shape[2]
    dense_cost = B * cfg.n_heads * T * S
    if mode == "decode":
        # decode path: T is tiny; dense attention over the cache, masked by
        # each row's absolute positions.
        out = _decode_attention(q, k, v, positions, blk.window)
    elif use_kernel:
        out = kops.attention(q.contiguous(), k.contiguous(), v.contiguous(),
                             causal=True, window=blk.window, q_offset=0)
    elif dense_cost <= _DENSE_LOGITS_LIMIT:
        out = kref.attention_ref(q, k, v, causal=True, window=blk.window)
    else:
        out = chunked_attention(q, k, v, True, blk.window, 0)
    out = shard(out, "act_batch", "act_heads", "act_seq", None)
    y = _ein("bhtk,hkd->btd", out, p["wo"])
    return shard(y, "act_batch", "act_seq", "act_embed"), new_cache


def _quant_kv(x: torch.Tensor):
    """Per-(row, head, position) int8 quantization over the head dim."""
    xf = x.float()
    scale = xf.abs().amax(dim=-1, keepdim=True)
    scale = torch.clamp(scale, min=1e-6) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127)
    return q.to(torch.int8), scale


def _dequant_kv(q: torch.Tensor, scale: torch.Tensor, dtype):
    return (q.float() * scale).to(dtype)


def _decode_attention(q, k, v, positions, window):
    """Dense attention against a (zero-padded) cache, in float32;
    ``positions`` (B, T) are the absolute positions of the queries (per
    serving slot)."""
    B, Hq, Tq, Dh = q.shape
    _, Hkv, S, _ = k.shape
    group = Hq // Hkv
    scale = Dh ** -0.5
    qg = q.reshape(B, Hkv, group, Tq, Dh).float()
    s = torch.einsum("bkgtd,bksd->bkgts", qg, k.float()) * scale
    q_pos = positions[:, :, None]  # (B, T, 1)
    k_pos = torch.arange(S, device=q.device)[None, None, :]
    mask = k_pos <= q_pos  # (B, T, S)
    if window is not None:
        mask = mask & (k_pos > q_pos - window)
    s = s.masked_fill(~mask[:, None, None], float("-inf"))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgts,bksd->bkgtd", p, v.float())
    return out.reshape(B, Hq, Tq, Dh).to(q.dtype)


# ---------------------------------------------------------------------------
# dense MLP (SwiGLU / GeGLU)
# ---------------------------------------------------------------------------

def init_mlp(cfg: ArchConfig, gen: torch.Generator, stack: Stack = (),
             dtype: torch.dtype = torch.float32,
             d_ff: Optional[int] = None) -> Params:
    d, f, s = cfg.d_model, d_ff or cfg.d_ff, tuple(stack)
    return {
        "w_gate": _dense_init(gen, s + (d, f), d, dtype),
        "w_up": _dense_init(gen, s + (d, f), d, dtype),
        "w_down": _dense_init(gen, s + (f, d), f, dtype),
    }


def _gelu(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh form; torch's default is exact erf.
    # In bfloat16 XLA lowers it with bfloat16 constants (sqrt(2/pi) is
    # 0.796875, 0.044715 is 0.044677734375) and rounds after every step;
    # the same steps give the reference's bits, where F.gelu rounds once
    if x.dtype == torch.bfloat16:
        inner = 0.796875 * (x + 0.044677734375 * (x * x * x))
        return x * (0.5 * (1 + torch.tanh(inner)))
    return F.gelu(x, approximate="tanh")


def _sigmoid(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.sigmoid: XLA on the CPU expands a bfloat16 logistic into
    # 1 / (1 + exp(-x)) rounded after every step (see _silu)
    return (torch.exp(-x) + 1).reciprocal()


def _softplus(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.softplus is logaddexp(x, 0), which XLA computes as
    # max(x, 0) + log1p(exp(-|x|)), rounded after every step in bfloat16
    return torch.clamp(x, min=0) + torch.log1p(torch.exp(-x.abs()))


def _silu(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.silu is x * logistic(x), and XLA on the CPU expands a bfloat16
    # logistic into 1 / (1 + exp(-x)) rounded to bfloat16 after every step;
    # the same steps give the reference's bits (F.silu rounds once, and a
    # third of bfloat16 silu(g) * u products then differ by an ulp, enough
    # to flip Granite-MoE's routing downstream).  Out of place: autograd
    # keeps exp's output for its backward
    return x * _sigmoid(x)


def _act(cfg: ArchConfig, x):
    return _silu(x) if cfg.act == "silu" else _gelu(x)


def mlp_fwd(cfg: ArchConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    g = _ein("btd,df->btf", x, p["w_gate"])
    u = _ein("btd,df->btf", x, p["w_up"])
    h = shard(_act(cfg, g) * u, "act_batch", "act_seq", "act_ffn")
    y = _ein("btf,fd->btd", h, p["w_down"])
    return shard(y, "act_batch", "act_seq", "act_embed")


# ---------------------------------------------------------------------------
# MoE (capacity-dropped, optionally geo-planned; one device or expert
# parallel over a mesh)
# ---------------------------------------------------------------------------

def _pad_experts(cfg: ArchConfig, tp: int) -> int:
    """Experts padded up to a multiple of the TP degree (zero router mass)."""
    E = cfg.n_experts
    return -(-E // tp) * tp


def init_moe(cfg: ArchConfig, gen: torch.Generator, stack: Stack = (),
             dtype: torch.dtype = torch.float32, tp: int = 1) -> Params:
    d, f, s = cfg.d_model, cfg.expert_d_ff_, tuple(stack)
    Ep = _pad_experts(cfg, tp)
    live = torch.arange(Ep, device=gen.device) < cfg.n_experts
    return {
        "router": _dense_init(gen, s + (d, Ep), d, dtype),
        "w_gate": _dense_init(gen, s + (Ep, d, f), d, dtype),
        "w_up": _dense_init(gen, s + (Ep, d, f), d, dtype),
        "w_down": _dense_init(gen, s + (Ep, f, d), f, dtype),
        # the planned per-expert router bias and capacity fractions: identity
        # by default; padding experts carry a -1e9 bias and never win
        "plan_bias": torch.where(live, 0.0, -1e9).expand(s + (Ep,))
                          .to(dtype).clone(),
        "plan_capacity": torch.ones(s + (Ep,), device=gen.device, dtype=dtype),
    }


def route(cfg: ArchConfig, p: Params, x2d: torch.Tensor):
    """The router: (float32 gates over all experts (N, E), the top-k gates
    renormalized (N, k), their expert ids (N, k)).  Ties go to the lower
    expert id, as ``jax.lax.top_k`` breaks them: a stable descending sort,
    then the first k (``torch.topk`` promises no order among ties, and in
    bfloat16 the router logits tie often)."""
    logits = _ein("nd,de->ne", x2d, p["router"]) + p["plan_bias"]
    gates_all = torch.softmax(logits.float(), dim=-1)
    ordered, order = torch.sort(gates_all, dim=-1, descending=True, stable=True)
    top_gates, top_ids = ordered[:, :cfg.top_k], order[:, :cfg.top_k]
    top_gates = top_gates / torch.clamp(top_gates.sum(dim=-1, keepdim=True),
                                        min=1e-9)
    return gates_all, top_gates, top_ids


def _moe_local(cfg: ArchConfig, p: Params, x2d: torch.Tensor,
               use_kernel: bool = False):
    """Token dispatch + expert FFN over all experts on one device, line for
    line the reference's.  x2d: (N, d) tokens.  Returns (y (N, d), aux).

    The reference scatters into the expert buffers itself; here the scatter
    is the ``moe_dispatch`` kernel (``use_kernel=True``) or its plain
    version, at slot ``min(slot, C-1)`` for a kept token and slot C, which
    both drop, for a dropped one: the reference's numbers, including a
    planned capacity above C, where kept tokens add into slot C-1."""
    N, d = x2d.shape
    E_here, k = p["w_gate"].shape[0], cfg.top_k
    gates_all, top_gates, top_ids = route(cfg, p, x2d)
    # load-balance aux loss (Switch): E * Σ_e f_e · P_e
    pe = gates_all.mean(dim=0)
    flat_ids = top_ids.reshape(-1)  # (N*k,)
    fe = torch.zeros((E_here,), device=x2d.device).index_add_(
        0, flat_ids, torch.ones((N * k,), device=x2d.device) / (N * k))
    aux = E_here * torch.sum(pe * fe)

    cap = p["plan_capacity"][:E_here]
    C = int(np.ceil(N * k / E_here * cfg.capacity_factor))
    C = max(C, k)
    slots = kops.compute_slots(flat_ids, E_here)
    # planned capacity: expert e accepts plan_capacity[e] * C tokens (in the
    # parameters' dtype, as the reference rounds it)
    cap_e = torch.clamp(torch.round(cap * C), min=1).to(torch.int32)
    keep = slots < cap_e[flat_ids]
    slot_ids = torch.where(keep, torch.clamp(slots, max=C - 1), C).int()
    expert_ids = flat_ids.int()
    tokens = x2d.repeat_interleave(k, dim=0)  # row n*k + j is token n
    buf = kops.dispatch_at_slots(tokens, expert_ids, slot_ids, E_here, C,
                                 use_kernel=use_kernel)
    h = _act(cfg, _ein("ecd,edf->ecf", buf, p["w_gate"]))
    h = h * _ein("ecd,edf->ecf", buf, p["w_up"])
    out = _ein("ecf,efd->ecd", h, p["w_down"])
    back = kops.combine_tokens(out, expert_ids, slot_ids,
                               top_gates.reshape(-1), C).to(x2d.dtype)
    # each token's k gated rows, added in a fixed order in x's dtype (an
    # index_add would add them in atomic order on the card)
    back = back.view(N, k, d)
    y = back[:, 0]
    for j in range(1, k):
        y = y + back[:, j]
    return y, aux


def moe_fwd(cfg: ArchConfig, p: Params, x: torch.Tensor, mesh=None,
            use_kernel: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """MoE FFN → (y (B, T, d), aux_loss).  Without a mesh (or one without a
    ``"model"`` dim): every token dispatched over all experts on one device.

    With a mesh: expert parallel, as the reference's ``shard_map`` over the
    batch axes for tokens and ``"model"`` for experts.  ``x`` is this
    rank's tokens (its shard of the batch over the batch axes) and ``p``
    the full parameters; each rank routes its tokens over all experts and
    dispatches them to its own experts only (``kops.dispatch_at_slots``,
    the ``moe_dispatch`` kernel on a CUDA tensor), and the contributions
    are summed over ``"model"``: deterministic EP without all-to-all.
    ``y`` is this rank's tokens' output, ``aux`` the global-batch loss."""
    if mesh is None or "model" not in mesh.mesh_dim_names:
        B, T, d = x.shape
        y2d, aux = _moe_local(cfg, p, x.reshape(B * T, d),
                              use_kernel=use_kernel)
        return y2d.reshape(B, T, d), aux
    return _moe_expert_parallel(cfg, p, x, mesh, use_kernel)


def _moe_expert_parallel(cfg: ArchConfig, p: Params, x: torch.Tensor, mesh,
                         use_kernel: bool):
    """The reference's expert-parallel ``local`` body on this rank, line for
    line, with its collectives written out (:mod:`.sharding`'s ops carry
    the gradients of the SPMD program)."""
    from . import sharding as S

    Bl, Tl, d = x.shape
    N, k = Bl * Tl, cfg.top_k
    E = p["router"].shape[1]
    M = mesh.size(mesh.mesh_dim_names.index("model"))
    El = E // M
    lo = mesh.get_local_rank("model") * El
    batch = tuple(a for a in ("pod", "data") if a in mesh.mesh_dim_names)
    x2d = x.reshape(N, d)
    # router over *all* experts, dispatch to the local shard only: tokens
    # whose expert lives elsewhere contribute nothing here and are summed
    # in over "model"
    gates_all, top_gates, top_ids = route(cfg, p, x2d)
    pe = gates_all.mean(dim=0)
    fe = torch.zeros((E,), device=x.device).index_add_(
        0, top_ids.reshape(-1),
        torch.ones((N * k,), device=x.device) / (N * k))
    # aggregate the load statistics over the data shards first, so the aux
    # loss equals the single-device (global-batch) definition
    if batch:
        pe = S.mean_over(pe, mesh, batch)
        fe = S.mean_over(fe, mesh, batch)
    aux = E * torch.sum(pe * fe)
    # localize: expert ids relative to this shard; non-local -> dropped.
    # The tokens and gates reach the local experts' part of the sum, whose
    # gradients the other model ranks complete
    x_part = S.grad_sum_over(x2d, mesh, "model")
    gates_part = S.grad_sum_over(top_gates, mesh, "model")
    flat_ids = top_ids.reshape(-1) - lo
    local_mask = (flat_ids >= 0) & (flat_ids < El)
    flat_gates = torch.where(local_mask, gates_part.reshape(-1), 0.0)
    flat_ids = torch.clamp(flat_ids, 0, El - 1)
    C = int(np.ceil(N * k / E * cfg.capacity_factor))
    C = max(C, k)
    capf = p["plan_capacity"][lo:lo + El]
    cap_e = torch.clamp(torch.round(capf * C), min=1).to(torch.int32)
    # slots over the local assignment stream (masked entries get slot C so
    # they never land)
    slots = kops.compute_slots(torch.where(local_mask, flat_ids, El), El + 1)
    keep = local_mask & (slots < cap_e[flat_ids])
    slot_ids = torch.where(keep, torch.clamp(slots, max=C - 1), C).int()
    expert_ids = flat_ids.int()
    tokens = x_part.repeat_interleave(k, dim=0)  # row n*k + j is token n
    buf = kops.dispatch_at_slots(tokens, expert_ids, slot_ids, El, C,
                                 use_kernel=use_kernel)
    wg, wu, wd = (p[name][lo:lo + El] for name in ("w_gate", "w_up", "w_down"))
    h = _act(cfg, _ein("ecd,edf->ecf", buf, wg)) * _ein("ecd,edf->ecf", buf, wu)
    out = _ein("ecf,efd->ecd", h, wd)
    back = kops.combine_tokens(out, expert_ids, slot_ids, flat_gates,
                               C).to(x.dtype).view(N, k, d)
    y = back[:, 0]
    for j in range(1, k):
        y = y + back[:, j]
    y = S.sum_over(y, mesh, "model")
    aux = S.mean_over(aux, mesh, ("model",))  # alike on every shard
    return y.reshape(Bl, Tl, d), aux


# ---------------------------------------------------------------------------
# RG-LRU block (RecurrentGemma recurrent block)
# ---------------------------------------------------------------------------

def init_rglru(cfg: ArchConfig, gen: torch.Generator, stack: Stack = (),
               dtype: torch.dtype = torch.float32) -> Params:
    d, w, s = cfg.d_model, cfg.rglru_width, tuple(stack)
    return {
        "in_x": _dense_init(gen, s + (d, w), d, dtype),
        "in_gate": _dense_init(gen, s + (d, w), d, dtype),
        "conv": _dense_init(gen, s + (4, w), 4, dtype),
        "a_gate_w": _dense_init(gen, s + (w,), 1, dtype),  # diagonal gates
        "a_gate_b": torch.full(s + (w,), 2.0, device=gen.device,
                               dtype=dtype),  # init a ≈ sigmoid(2) ≈ .88
        "x_gate_w": _dense_init(gen, s + (w,), 1, dtype),
        "out_proj": _dense_init(gen, s + (w, d), w, dtype),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 prev: Optional[torch.Tensor]):
    """Depthwise causal conv along time.  x: (B, T, C); w: (K, C);
    prev: (B, K-1, C) carried context (decode) or None (zeros).  A float32
    ``prev`` promotes the output to float32, as in the reference."""
    B, T, C = x.shape
    K = w.shape[0]
    if prev is None:
        prev = torch.zeros((B, K - 1, C), dtype=x.dtype, device=x.device)
    xp = torch.cat([prev, x], dim=1)  # (B, T+K-1, C)
    out = torch.zeros((B, T, C), dtype=x.dtype, device=x.device)
    for i in range(K):  # K is tiny (4): unrolled taps, no conv primitive
        out = out + xp[:, i:i + T] * w[i]
    if K == 1:
        return out, prev
    # the last K-1 rows, as a copy where T > 1 (a prefill): a view would
    # keep the whole (B, T+K-1, C) ``xp`` alive as long as the carried state
    # (a jax slice is a copy).  A decode step's ``xp`` is K rows, and its
    # state is copied into the cache at once.
    new_prev = xp[:, -(K - 1):]
    return out, new_prev.clone() if T > 1 else new_prev


def rglru_fwd(
    cfg: ArchConfig,
    p: Params,
    x: torch.Tensor,  # (B, T, d)
    state: Optional[Dict] = None,
    use_kernel: bool = False,
) -> Tuple[torch.Tensor, Optional[Dict]]:
    xb = _ein("btd,dw->btw", x, p["in_x"])
    gb = _gelu(_ein("btd,dw->btw", x, p["in_gate"]))
    xb = shard(xb, "act_batch", "act_seq", "act_ffn")
    conv_prev = state["conv"] if state is not None else None
    xb, conv_new = _causal_conv(xb, p["conv"], conv_prev)
    # diagonal recurrence and input gates.  The scan casts both inputs to
    # float32, and XLA computes an op whose bfloat16 result is only cast to
    # float32 in float32, unrounded (as the norm reads the residual sum): the
    # sigmoid's last step (the division) and the product x * gate_x reach the
    # scan unrounded, and its output is rounded to x's dtype, as the
    # reference's ``astype`` does
    a = (torch.exp(-(xb * p["a_gate_w"] + p["a_gate_b"])) + 1).float()
    gate_x = _sigmoid(xb * p["x_gate_w"])
    h0 = state["h"] if state is not None else None
    h, hT = kops.gated_linear_recurrence(
        xb.float() * gate_x.float(), a.reciprocal(), h0, use_kernel=use_kernel
    )
    out = _ein("btw,wd->btd", h.to(xb.dtype) * gb, p["out_proj"])
    out = shard(out, "act_batch", "act_seq", "act_embed")
    new_state = {"h": hT, "conv": conv_new} if state is not None else None
    return out, new_state


# ---------------------------------------------------------------------------
# Mamba-1 block
# ---------------------------------------------------------------------------

def init_mamba(cfg: ArchConfig, gen: torch.Generator, stack: Stack = (),
               dtype: torch.dtype = torch.float32) -> Params:
    d, di, ds = cfg.d_model, cfg.ssm_d_inner, cfg.ssm_state
    dtr, s = cfg.ssm_dt_rank_, tuple(stack)
    a_log = torch.log(torch.arange(1, ds + 1, dtype=torch.float32,
                                   device=gen.device))
    return {
        "in_proj": _dense_init(gen, s + (d, 2 * di), d, dtype),
        "conv": _dense_init(gen, s + (cfg.ssm_conv, di), cfg.ssm_conv, dtype),
        "x_proj": _dense_init(gen, s + (di, dtr + 2 * ds), di, dtype),
        "dt_proj": _dense_init(gen, s + (dtr, di), dtr, dtype),
        # softplus^-1(0.01): every channel starts at Δ = 0.01
        "dt_bias": torch.full(s + (di,), float(np.log(np.expm1(0.01))),
                              device=gen.device, dtype=dtype),
        "A_log": a_log.expand(s + (di, ds)).to(dtype).clone(),
        "D": torch.ones(s + (di,), device=gen.device, dtype=dtype),
        "out_proj": _dense_init(gen, s + (di, d), di, dtype),
    }


def mamba_fwd(
    cfg: ArchConfig,
    p: Params,
    x: torch.Tensor,  # (B, T, d)
    state: Optional[Dict] = None,
    use_kernel: bool = False,
) -> Tuple[torch.Tensor, Optional[Dict]]:
    """The Mamba-1 block.  ``Bc`` and ``Cc`` reach the scan as views of the
    ``x_proj`` split (the kernel takes their strides); a float32 ``state``
    promotes everything after the conv to float32, as in the reference."""
    di, ds, dtr = cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_dt_rank_
    xz = _ein("btd,de->bte", x, p["in_proj"])
    xz = shard(xz, "act_batch", "act_seq", "act_ffn")
    xi, z = torch.split(xz, di, dim=-1)
    conv_prev = state["conv"] if state is not None else None
    xi, conv_new = _causal_conv(xi, p["conv"], conv_prev)
    # silu's last step (x times the rounded sigmoid) reaches the scan, which
    # casts its inputs to float32, unrounded: XLA computes an op whose
    # bfloat16 result is only cast to float32 in float32 (see rglru_fwd);
    # x_proj reads it rounded.  The scan then takes every input in float32
    # (the kernel wants one dtype; the rest are exact in it) and its output
    # is rounded to the block's dtype, as the reference's ``astype`` does
    xs = xi.float() * _sigmoid(xi).float()
    xi = xs.to(xi.dtype)
    proj = _ein("bti,ie->bte", xi, p["x_proj"])
    dt, Bc, Cc = torch.split(proj, [dtr, ds, ds], dim=-1)
    delta = _softplus(_ein("btr,ri->bti", dt, p["dt_proj"]) + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    h0 = state["h"] if state is not None else None
    y, hT = kops.ssm_scan(xs, delta.float(), A, Bc.float(), Cc.float(),
                          p["D"], h0, use_kernel=use_kernel)
    y = y.to(xi.dtype) * _silu(z)
    out = _ein("bti,id->btd", y, p["out_proj"])
    out = shard(out, "act_batch", "act_seq", "act_embed")
    new_state = {"h": hT, "conv": conv_new} if state is not None else None
    return out, new_state
