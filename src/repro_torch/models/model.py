"""Decoder LM assembled from the layer zoo, with a loop over layer groups.

The repeating unit is the config's block *pattern* (e.g. RecurrentGemma's
(rglru, rglru, local-attn)); parameters for all ``n_groups`` repetitions
are stacked on a leading axis, as in :mod:`repro.models.model`, and the
reference's ``lax.scan`` over that axis becomes a Python loop that takes
group ``g``'s views.  Blocks after the groups (``cfg.tail``) are kept
unstacked.

Public entry points:

* ``init(cfg, generator, device, dtype)``          → params
* ``cast_params(params, dtype, device)``           → params in the compute dtype
* ``forward(cfg, params, batch, ...)``             → logits, cache, aux
  (aux: the MoE blocks' load-balance losses summed, 0 without MoE)
* ``loss_fn(cfg, params, batch, ...)``             → scalar, metrics
* ``init_cache(cfg, B, max_len, dtype, ...)``      → cache
* ``prefill(cfg, params, batch, max_cache_len, ...)`` → logits, cache, aux
* ``decode_step(cfg, params, batch, cache, ...)``  → logits, cache, aux

Serving computes in the parameters' own dtype: the reference casts every
float32 group parameter and the embedding to ``compute_dtype`` on every
call, the server casts once (:func:`init` with ``dtype=``, or
:func:`cast_params`), which gives the same numbers.  Training keeps
float32 masters and passes ``compute_dtype=`` to :func:`forward`, which
casts as the reference does, inside the autograd graph, so gradients land
on the masters.  ``final_norm`` stays float32, as the reference leaves
it.  Decode updates the cache in place.  MoE FFNs run on one device (no
expert parallelism over a mesh).
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch.utils.checkpoint import checkpoint

from .._device import resolve_device
from . import layers as L
from .config import ArchConfig, Block

Params = Dict[str, Any]


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _init_block(cfg: ArchConfig, blk: Block, gen: torch.Generator, stack,
                dtype: torch.dtype) -> Params:
    p: Params = {"norm1": L.init_norm(cfg, stack, gen.device, dtype)}
    if blk.mixer == "attn":
        p["mixer"] = L.init_attention(cfg, gen, stack, dtype)
    elif blk.mixer == "ssm":
        p["mixer"] = L.init_mamba(cfg, gen, stack, dtype)
    elif blk.mixer == "rglru":
        p["mixer"] = L.init_rglru(cfg, gen, stack, dtype)
    else:
        raise ValueError(blk.mixer)
    if blk.ffn != "none":
        p["norm2"] = L.init_norm(cfg, stack, gen.device, dtype)
        if blk.ffn == "dense":
            p["ffn"] = L.init_mlp(cfg, gen, stack, dtype)
        elif blk.ffn == "moe":
            p["ffn"] = L.init_moe(cfg, gen, stack, dtype)
        else:
            raise ValueError(blk.ffn)
    return p


def init(cfg: ArchConfig, generator: torch.Generator, device=None,
         dtype: torch.dtype = torch.float32) -> Params:
    """Random parameters from ``generator`` (seeded by the caller), built
    on ``device`` (default: the process default, the card) in ``dtype``;
    ``final_norm`` is float32.  The generator is moved to nothing: pass one
    made on the same device."""
    dev = resolve_device(device)
    if generator.device.type != dev.type:
        raise ValueError(f"generator on {generator.device}, parameters on "
                         f"{dev}: make the generator on the same device")
    G = cfg.n_groups
    params: Params = {
        "embed": L._normal(generator, (cfg.vocab, cfg.d_model), 0.02, dtype),
        "groups": {f"blk{i}": _init_block(cfg, blk, generator, (G,), dtype)
                   for i, blk in enumerate(cfg.pattern)},
        "final_norm": L.init_norm(cfg, (), dev, torch.float32),
    }
    if cfg.tail:
        params["tail"] = {f"blk{i}": _init_block(cfg, blk, generator, (), dtype)
                          for i, blk in enumerate(cfg.tail)}
    if not cfg.tie_embeddings:
        params["unembed"] = L._normal(generator, (cfg.vocab, cfg.d_model),
                                      cfg.d_model ** -0.5, dtype)
    return params


def _tree_map(fn, tree, path=()):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, path + (k,)) for k, v in tree.items()}
    return fn(path, tree)


def _cast_f32(tree, dtype: torch.dtype):
    """The reference's per-call cast: float32 leaves to ``dtype``."""
    return _tree_map(lambda _, a: a.to(dtype) if a.dtype == torch.float32
                     else a, tree)


def cast_params(params: Params, dtype: torch.dtype, device=None) -> Params:
    """``params`` with every float leaf but ``final_norm``'s in ``dtype`` on
    ``device``; leaves already there are returned as they are, not copied."""
    dev = None if device is None else torch.device(device)

    def cast(path, a):
        to = a.dtype if path[0] == "final_norm" else dtype
        return a.to(device=dev if dev is not None else a.device, dtype=to)

    return _tree_map(cast, params)


# ---------------------------------------------------------------------------
# caches
# ---------------------------------------------------------------------------

def _ssm_zero_state(cfg, B, dtype, device):
    return {
        "h": torch.zeros((B, cfg.ssm_d_inner, cfg.ssm_state),
                         dtype=torch.float32, device=device),
        "conv": torch.zeros((B, cfg.ssm_conv - 1, cfg.ssm_d_inner),
                            dtype=dtype, device=device),
    }


def _rglru_zero_state(cfg, B, dtype, device):
    return {
        "h": torch.zeros((B, cfg.rglru_width), dtype=torch.float32,
                         device=device),
        "conv": torch.zeros((B, 3, cfg.rglru_width), dtype=dtype,
                            device=device),
    }


def _attn_zero_cache(cfg, B, max_len, dtype, device):
    shape = (B, cfg.n_kv_heads, max_len, cfg.head_dim_)
    if dtype == torch.int8:  # quantized cache (§Perf): int8 values + scales
        return {
            "k": torch.zeros(shape, dtype=torch.int8, device=device),
            "v": torch.zeros(shape, dtype=torch.int8, device=device),
            "k_scale": torch.zeros(shape[:3] + (1,), device=device),
            "v_scale": torch.zeros(shape[:3] + (1,), device=device),
        }
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _zero_cache(cfg, blk: Block, B, max_len, dtype, kv_dtype, device):
    if blk.mixer == "attn":
        return _attn_zero_cache(cfg, B, max_len, kv_dtype, device)
    if blk.mixer == "rglru":
        return _rglru_zero_state(cfg, B, dtype, device)
    if blk.mixer == "ssm":
        return _ssm_zero_state(cfg, B, dtype, device)
    raise ValueError(blk.mixer)


def init_cache(cfg: ArchConfig, B: int, max_len: int,
               dtype: torch.dtype = torch.bfloat16, kv_int8: bool = False,
               device=None):
    """Zeroed decode cache for the whole stack (stacked over groups; the
    tail's leaves unstacked, ``(B, ...)``).

    Windowed-attention blocks still allocate ``max_len`` (correct, not
    minimal: a ring buffer of ``window`` is the memory-optimal layout)."""
    dev = resolve_device(device)
    kv_dtype = torch.int8 if kv_int8 else dtype
    out = {}
    for i, blk in enumerate(cfg.pattern):
        one = _zero_cache(cfg, blk, cfg.n_groups * B, max_len, dtype,
                          kv_dtype, dev)
        out[f"blk{i}"] = {k: v.reshape((cfg.n_groups, B) + v.shape[1:])
                          for k, v in one.items()}
    if cfg.tail:
        out["tail"] = {f"blk{i}": _zero_cache(cfg, blk, B, max_len, dtype,
                                              kv_dtype, dev)
                       for i, blk in enumerate(cfg.tail)}
    return out


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def _block_fwd(cfg, blk: Block, p: Params, x, positions, cache, mode,
               use_kernels, max_cache_len):
    """One block → (x, new cache, the MoE aux loss or ``None``)."""
    h = L.apply_norm(cfg, p["norm1"], x)
    if blk.mixer == "attn":
        y, new_cache = L.attention_fwd(
            cfg, blk, p["mixer"], h, positions, cache=cache,
            use_kernel=use_kernels, mode=mode, max_cache_len=max_cache_len,
        )
    elif blk.mixer == "ssm":
        if mode == "prefill" and cache is None:
            cache = _ssm_zero_state(cfg, x.shape[0], x.dtype, x.device)
        y, new_cache = L.mamba_fwd(
            cfg, p["mixer"], h, state=cache if mode != "train" else None,
            use_kernel=use_kernels,
        )
    elif blk.mixer == "rglru":
        if mode == "prefill" and cache is None:
            cache = _rglru_zero_state(cfg, x.shape[0], x.dtype, x.device)
        y, new_cache = L.rglru_fwd(
            cfg, p["mixer"], h, state=cache if mode != "train" else None,
            use_kernel=use_kernels,
        )
    else:
        raise ValueError(blk.mixer)
    if blk.ffn == "none":
        return x + y, new_cache, None
    # the second norm reads the residual sum before it is rounded to its
    # dtype (jax's promotion of x's and y's), as XLA's fusion of the add
    # into the norm computes it
    dtype = torch.promote_types(x.dtype, y.dtype)
    total = x.float() + y
    h = L.apply_norm(cfg, p["norm2"], total).to(dtype)
    x = total.to(dtype)
    aux = None
    if blk.ffn == "dense":
        x = x + L.mlp_fwd(cfg, p["ffn"], h)
    elif blk.ffn == "moe":
        y, aux = L.moe_fwd(cfg, p["ffn"], h, use_kernel=use_kernels)
        x = x + y
    else:
        raise ValueError(blk.ffn)
    return x, new_cache, aux


def _write_back(dst: Dict, new: Optional[Dict]) -> None:
    """Copy a block's new decode state into its (shared) cache views."""
    for k, v in (new or {}).items():
        if v is not dst[k]:
            dst[k].copy_(v)


def forward(
    cfg: ArchConfig,
    params: Params,
    batch: Dict[str, torch.Tensor],
    mode: str = "train",
    cache=None,
    use_kernels: bool = False,
    compute_dtype: Optional[torch.dtype] = None,
    remat: bool = False,
    max_cache_len: Optional[int] = None,
    last_only: bool = False,
):
    """Run the stack.  ``batch`` carries ``tokens`` (B, T) or — for
    stub-frontend archs — ``embeds`` (B, T, d), and optionally
    ``positions``.  Returns (float32 logits, cache, aux_loss): the new
    cache in ``prefill`` mode, ``cache`` itself updated in place in
    ``decode`` mode, ``None`` in ``train`` mode.

    ``compute_dtype`` (default: the parameters' own) casts the embedding,
    the unembedding and every float32 group and tail parameter to it, as
    the reference does on every call (``final_norm`` stays float32).
    ``remat`` (train mode) runs each group under
    ``torch.utils.checkpoint``: the reference's
    ``jax.checkpoint(nothing_saveable)`` per group, which keeps only the
    residual stream between groups and recomputes each group's insides,
    the attention blocks included, in the backward pass."""
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(mode)
    if mode == "decode" and cache is None:
        raise ValueError("decode needs a cache")
    cd = compute_dtype
    w_embed = params["embed"] if cd is None else params["embed"].to(cd)
    if cfg.frontend == "embed" and "embeds" in batch:
        x = batch["embeds"].to(w_embed.dtype)
    else:
        x = w_embed[batch["tokens"].long()]
    B, T = x.shape[:2]

    positions = batch.get("positions")
    if positions is None:
        positions = torch.arange(T, device=x.device)[None, :]
    positions = positions.to(x.device).expand(B, T)

    # each stacked leaf split once into its groups' views (unbind's backward
    # stacks the groups' gradients in one buffer)
    groups = _tree_map(lambda _, a: a.unbind(0), params["groups"])

    def group_fwd(x, g):
        gp = _tree_map(lambda _, a: a[g], groups)
        if cd is not None:
            gp = _cast_f32(gp, cd)
        aux_g, new = None, {}
        for i, blk in enumerate(cfg.pattern):
            name = f"blk{i}"
            c = None
            if mode == "decode":
                c = {k: v[g] for k, v in cache[name].items()}
            x, nc, aux_b = _block_fwd(cfg, blk, gp[name], x, positions, c,
                                      mode, use_kernels, max_cache_len)
            if aux_b is not None:
                aux_g = aux_b if aux_g is None else aux_g + aux_b
            if mode == "decode":
                _write_back(c, nc)
            elif nc is not None:
                new[name] = nc
        return x, aux_g, new

    stacked: Dict[str, list] = {f"blk{i}": [] for i in range(len(cfg.pattern))}
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for g in range(cfg.n_groups):
        if remat and mode == "train":
            x, aux_g, _ = checkpoint(group_fwd, x, g, use_reentrant=False)
        else:
            x, aux_g, new = group_fwd(x, g)
            for name, nc in new.items():
                stacked[name].append(nc)
        if aux_g is not None:
            aux = aux + aux_g

    new_cache = None
    if mode == "prefill":
        new_cache = {name: {k: torch.stack([nc[k] for nc in ncs])
                            for k in ncs[0]}
                     for name, ncs in stacked.items() if ncs}
    elif mode == "decode":
        new_cache = cache

    if cfg.tail:
        tail = params["tail"] if cd is None else _cast_f32(params["tail"], cd)
        tail_new = {}
        for i, blk in enumerate(cfg.tail):
            name = f"blk{i}"
            c = cache["tail"][name] if mode == "decode" else None
            x, nc, aux_b = _block_fwd(cfg, blk, tail[name], x, positions, c,
                                      mode, use_kernels, max_cache_len)
            if aux_b is not None:
                aux = aux + aux_b
            if mode == "decode":
                _write_back(c, nc)
            elif nc is not None:
                tail_new[name] = nc
        if mode == "prefill" and tail_new:
            new_cache = dict(new_cache, tail=tail_new)

    if last_only:
        # serving prefill: only the last position's logits are consumed
        x = x[:, -1:]
    x = L.apply_norm(cfg, params["final_norm"], x)
    if cfg.tie_embeddings:
        w_out = w_embed
    else:
        w_out = params["unembed"] if cd is None else params["unembed"].to(cd)
    logits = torch.matmul(x.to(w_out.dtype), w_out.t()).float()
    if cfg.vocab_real is not None and cfg.vocab_real < cfg.vocab:
        # TP-padded vocab rows must never win a softmax (exact semantics)
        logits[..., cfg.vocab_real:] = -1e9
    return logits, new_cache, aux


def loss_fn(
    cfg: ArchConfig,
    params: Params,
    batch: Dict[str, torch.Tensor],
    use_kernels: bool = False,
    compute_dtype: Optional[torch.dtype] = None,
    remat: bool = False,
    z_loss: float = 1e-4,
):
    """Next-token cross entropy (+ router aux loss + z-loss).  Labels come
    from ``batch['labels']``; positions where ``labels < 0`` are masked.
    Returns ``(total, {"ce", "z_loss", "aux", "tokens"})``.

    The label's logit is taken with ``gather``; the reference's masked sum
    over the vocabulary (``where(iota == label)``, there so that the
    vocab-sharded logits reduce locally) gives the same value, and would
    cost a (B, T, V) float32 temporary on one card."""
    logits, _, aux = forward(cfg, params, batch, mode="train",
                             use_kernels=use_kernels,
                             compute_dtype=compute_dtype, remat=remat)
    labels = batch["labels"].long()
    valid = (labels >= 0).float()
    logz = torch.logsumexp(logits, dim=-1)
    ll = logits.gather(-1, labels.clamp(min=0)[..., None])[..., 0]
    nll = (logz - ll) * valid
    denom = valid.sum().clamp(min=1.0)
    ce = nll.sum() / denom
    zl = z_loss * ((logz * valid) ** 2).sum() / denom
    total = ce + zl + cfg.router_aux_weight * aux
    return total, {"ce": ce, "z_loss": zl, "aux": aux, "tokens": denom}


def prefill(cfg: ArchConfig, params: Params, batch, max_cache_len: int,
            use_kernels: bool = False, last_only: bool = False):
    return forward(cfg, params, batch, mode="prefill",
                   use_kernels=use_kernels, max_cache_len=max_cache_len,
                   last_only=last_only)


def decode_step(cfg: ArchConfig, params: Params, batch, cache,
                use_kernels: bool = False):
    """One decode step: batch['tokens'] (B, 1) (or (B, k) for speculative
    chunks), batch['positions'] (B, k) absolute positions.  ``cache`` is
    updated in place and returned."""
    return forward(cfg, params, batch, mode="decode", cache=cache,
                   use_kernels=use_kernels)
