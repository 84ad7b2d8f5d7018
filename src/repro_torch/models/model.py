"""Decoder LM assembled from the layer zoo, with a loop over layer groups.

The repeating unit is the config's block *pattern* (e.g. RecurrentGemma's
(rglru, rglru, local-attn)); parameters for all ``n_groups`` repetitions
are stacked on a leading axis, as in :mod:`repro.models.model`, and the
reference's ``lax.scan`` over that axis becomes a Python loop that takes
group ``g``'s views.  Blocks after the groups (``cfg.tail``) are kept
unstacked.

Public entry points:

* ``init(cfg, generator, device, dtype, tp)``      → params
* ``param_shardings(cfg, params)``                 → the spec of each leaf
* ``param_named_shardings(cfg, params, mesh)``     → its placements on a mesh
* ``place_params(cfg, params, mesh)``              → params at rest on a mesh
* ``cast_params(params, dtype, device)``           → params in the compute dtype
* ``forward(cfg, params, batch, ...)``             → logits, cache, aux
  (aux: the MoE blocks' load-balance losses summed, 0 without MoE)
* ``loss_fn(cfg, params, batch, ...)``             → scalar, metrics
* ``init_cache(cfg, B, max_len, dtype, ..., mesh)`` → cache
* ``prefill(cfg, params, batch, max_cache_len, ...)`` → logits, cache, aux
* ``decode_step(cfg, params, batch, cache, ...)``  → logits, cache, aux

Serving computes in the parameters' own dtype: the reference casts every
float32 group parameter and the embedding to ``compute_dtype`` on every
call, the server casts once (:func:`init` with ``dtype=``, or
:func:`cast_params`), which gives the same numbers.  Training keeps
float32 masters and passes ``compute_dtype=`` to :func:`forward`, which
casts as the reference does, inside the autograd graph, so gradients land
on the masters.  ``final_norm`` stays float32, as the reference leaves
it.  Decode updates the cache in place.

With ``mesh=`` (a ``DeviceMesh`` with a ``"model"`` dim) the stack runs in
the reference's layout, the one GSPMD derives from its annotations:

* the batch is this rank's rows (its shard over the batch axes);
* the parameters rest as :func:`place_params` (or the train state) lays
  them out, DTensors sharded by the rules (FSDP over ``"data"``, tensor
  parallel over ``"model"``); each group's parameters (the embedding's,
  the tail's) are all-gathered over the batch axes when the group runs,
  and again in remat's recompute, so the peak holds one group's
  parameters whole along ``"data"``, never the model's.  Their backward
  is the reduce-scatter (:func:`.sharding.gather_param`).  Mamba's
  ``in_proj`` rests as the rules say, contiguous over ``"model"``; its
  gather also regroups it over ``"model"`` into this rank's x and z
  channels (``_PARAM_BLOCKS``);
* every dense layer runs on this rank's ``"model"`` shard
  (:mod:`.layers`), the MoE FFNs expert parallel;
* the embedding is vocab parallel (this rank's rows of the table, zero
  for the other tokens, summed over ``"model"``), and so are the logits:
  :func:`forward` returns this rank's vocab shard of them, and
  :func:`loss_fn` takes the softmax over the shards.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch.utils.checkpoint import checkpoint

from .._device import resolve_device
from . import layers as L
from .config import ArchConfig, Block
from .sharding import shard

Params = Dict[str, Any]


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _init_block(cfg: ArchConfig, blk: Block, gen: torch.Generator, stack,
                dtype: torch.dtype, tp: int) -> Params:
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
            p["ffn"] = L.init_moe(cfg, gen, stack, dtype, tp=tp)
        else:
            raise ValueError(blk.ffn)
    return p


def init(cfg: ArchConfig, generator: torch.Generator, device=None,
         dtype: torch.dtype = torch.float32, tp: int = 1) -> Params:
    """Random parameters from ``generator`` (seeded by the caller), built
    on ``device`` (default: the process default, the card) in ``dtype``;
    ``final_norm`` is float32.  The generator is moved to nothing: pass one
    made on the same device.  ``tp`` — the tensor-parallel degree the MoE
    experts are padded to a multiple of (the padding experts never win)."""
    dev = resolve_device(device)
    if generator.device.type != dev.type:
        raise ValueError(f"generator on {generator.device}, parameters on "
                         f"{dev}: make the generator on the same device")
    G = cfg.n_groups
    params: Params = {
        "embed": L._normal(generator, (cfg.vocab, cfg.d_model), 0.02, dtype),
        "groups": {f"blk{i}": _init_block(cfg, blk, generator, (G,), dtype, tp)
                   for i, blk in enumerate(cfg.pattern)},
        "final_norm": L.init_norm(cfg, (), dev, torch.float32),
    }
    if cfg.tail:
        params["tail"] = {f"blk{i}": _init_block(cfg, blk, generator, (),
                                                 dtype, tp)
                          for i, blk in enumerate(cfg.tail)}
    if not cfg.tie_embeddings:
        params["unembed"] = L._normal(generator, (cfg.vocab, cfg.d_model),
                                      cfg.d_model ** -0.5, dtype)
    return params


def _tree_map(fn, tree, path=()):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, path + (k,)) for k, v in tree.items()}
    return fn(path, tree)


#: leaf-name → logical axes for the value *without* the group-stack axis.
#: Group-stacked leaves (everything under ``groups/``) get a leading None.
_PARAM_RULES = {
    "embed": ("vocab", "embed"),
    "unembed": ("vocab", "embed"),
    "wq": ("qkv_fsdp", "heads", None),
    "wk": ("qkv_fsdp", "kv_heads", None),
    "wv": ("qkv_fsdp", "kv_heads", None),
    "wo": ("heads", None, "qkv_fsdp"),
    "router": (None, None),
    "plan_bias": (None,),
    "plan_capacity": ("experts",),
    "in_proj": ("ssm_fsdp", "ssm_inner"),
    "conv": (None, "ssm_inner"),
    "x_proj": ("ssm_inner", None),
    "dt_proj": (None, "ssm_inner"),
    "dt_bias": ("ssm_inner",),
    "A_log": ("ssm_inner", None),
    "D": ("ssm_inner",),
    "out_proj": ("ssm_inner", "ssm_fsdp"),
    "in_x": ("ssm_fsdp", "ssm_inner"),
    "in_gate": ("ssm_fsdp", "ssm_inner"),
    "a_gate_w": ("ssm_inner",),
    "a_gate_b": ("ssm_inner",),
    "x_gate_w": ("ssm_inner",),
}


#: leaves whose last dim is the concatenation of equal blocks: Mamba's
#: ``in_proj`` is (d, [x | z]), and a rank computes with its x channels and
#: the z channels of the same indices (its group gather regroups them)
_PARAM_BLOCKS = {"in_proj": 2}


def param_shardings(cfg: ArchConfig, params: Params):
    """The spec of every leaf of the parameter tree under the active rules
    (FSDP over 'data', TP/EP over 'model', experts over 'model'): the
    reference's ``PartitionSpec`` entries as tuples."""
    from .sharding import spec_for

    def spec(path, leaf):
        name = path[-1]
        stacked = path[0] == "groups"
        nd = leaf.ndim - (1 if stacked else 0)
        if name in ("w_gate", "w_up", "w_down"):
            if nd == 3:  # MoE experts: (E, d, f)
                names = ("experts", "expert_in", "expert_out")
            elif name == "w_down":
                names = ("ffn", "ffn_fsdp")
            else:
                names = ("ffn_fsdp", "ffn")
        elif name in _PARAM_RULES:
            names = _PARAM_RULES[name]
        else:  # norm scales/biases etc.
            names = (None,) * nd
        if len(names) != nd:  # defensive: replicate anything unexpected
            names = (None,) * nd
        if stacked:
            names = (None,) + tuple(names)
        return spec_for(*names)

    return _tree_map(spec, params)


def param_named_shardings(cfg: ArchConfig, params: Params, mesh):
    """The :class:`~.sharding.NamedSharding` of every leaf on ``mesh``
    under the active rules (:func:`param_shardings`' specs)."""
    from .sharding import NamedSharding

    return _tree_map(lambda _, spec: NamedSharding.of(mesh, spec),
                     param_shardings(cfg, params))


def place_params(cfg: ArchConfig, params: Params, mesh) -> Params:
    """``params`` (whole, alike on every rank) as DTensors at rest on
    ``mesh``: each rank keeps its shard (no communication)."""
    named = param_named_shardings(cfg, params, mesh)
    return _tree_map(lambda path, a: _at(named, path).place(a), params)


def _at(tree, path):
    for key in path:
        tree = tree[key]
    return tree

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

def _ssm_zero_state(cfg, B, dtype, device, tp=1):
    di = cfg.ssm_d_inner // tp
    return {
        "h": torch.zeros((B, di, cfg.ssm_state), dtype=torch.float32,
                         device=device),
        "conv": torch.zeros((B, cfg.ssm_conv - 1, di), dtype=dtype,
                            device=device),
    }


def _rglru_zero_state(cfg, B, dtype, device, tp=1):
    w = cfg.rglru_width // tp
    return {
        "h": torch.zeros((B, w), dtype=torch.float32, device=device),
        "conv": torch.zeros((B, 3, w), dtype=dtype, device=device),
    }


def _attn_zero_cache(cfg, B, max_len, dtype, device, tp=1):
    shape = (B, cfg.n_kv_heads // tp, max_len, cfg.head_dim_)
    if dtype == torch.int8:  # quantized cache (§Perf): int8 values + scales
        return {
            "k": torch.zeros(shape, dtype=torch.int8, device=device),
            "v": torch.zeros(shape, dtype=torch.int8, device=device),
            "k_scale": torch.zeros(shape[:3] + (1,), device=device),
            "v_scale": torch.zeros(shape[:3] + (1,), device=device),
        }
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _zero_cache(cfg, blk: Block, B, max_len, dtype, kv_dtype, device, tp=1):
    if blk.mixer == "attn":
        return _attn_zero_cache(cfg, B, max_len, kv_dtype, device, tp)
    if blk.mixer == "rglru":
        return _rglru_zero_state(cfg, B, dtype, device, tp)
    if blk.mixer == "ssm":
        return _ssm_zero_state(cfg, B, dtype, device, tp)
    raise ValueError(blk.mixer)


def _check_tp(cfg: ArchConfig, tp: int) -> None:
    """Raise unless every width a mesh splits over ``"model"`` divides."""
    mixers = {b.mixer for b in cfg.pattern + cfg.tail}
    widths = {"vocab": cfg.vocab}
    if "attn" in mixers:
        widths.update(n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads)
    if "ssm" in mixers:
        widths["ssm_d_inner"] = cfg.ssm_d_inner
    if "rglru" in mixers:
        widths["rglru_width"] = cfg.rglru_width
    if any(b.ffn == "dense" for b in cfg.pattern + cfg.tail):
        widths["d_ff"] = cfg.d_ff
    bad = {k: v for k, v in widths.items() if v % tp}
    if bad:
        raise ValueError(f"{cfg.name}: {bad} do not split over {tp} 'model' "
                         "ranks (configs.padded_for_tp pads heads and vocab)")


def init_cache(cfg: ArchConfig, B: int, max_len: int,
               dtype: torch.dtype = torch.bfloat16, kv_int8: bool = False,
               device=None, mesh=None):
    """Zeroed decode cache for the whole stack (stacked over groups; the
    tail's leaves unstacked, ``(B, ...)``).  On ``mesh`` it holds this
    rank's kv heads and Mamba/RG-LRU channels (the tensor-parallel
    layers' shares); ``B`` is the rows the caller keeps here.

    Windowed-attention blocks still allocate ``max_len`` (correct, not
    minimal: a ring buffer of ``window`` is the memory-optimal layout)."""
    from .sharding import tp_size

    dev = resolve_device(device)
    tp = tp_size(mesh)
    _check_tp(cfg, tp)
    kv_dtype = torch.int8 if kv_int8 else dtype
    out = {}
    for i, blk in enumerate(cfg.pattern):
        one = _zero_cache(cfg, blk, cfg.n_groups * B, max_len, dtype,
                          kv_dtype, dev, tp)
        out[f"blk{i}"] = {k: v.reshape((cfg.n_groups, B) + v.shape[1:])
                          for k, v in one.items()}
    if cfg.tail:
        out["tail"] = {f"blk{i}": _zero_cache(cfg, blk, B, max_len, dtype,
                                              kv_dtype, dev, tp)
                       for i, blk in enumerate(cfg.tail)}
    return out


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def _block_fwd(cfg, blk: Block, p: Params, x, positions, cache, mode,
               mesh, use_kernels, max_cache_len):
    """One block → (x, new cache, the MoE aux loss or ``None``)."""
    from .sharding import tp_size

    h = L.apply_norm(cfg, p["norm1"], x)
    if blk.mixer == "attn":
        y, new_cache = L.attention_fwd(
            cfg, blk, p["mixer"], h, positions, cache=cache,
            use_kernel=use_kernels, mode=mode, max_cache_len=max_cache_len,
            mesh=mesh,
        )
    elif blk.mixer == "ssm":
        if mode == "prefill" and cache is None:
            cache = _ssm_zero_state(cfg, x.shape[0], x.dtype, x.device,
                                    tp_size(mesh))
        y, new_cache = L.mamba_fwd(
            cfg, p["mixer"], h, state=cache if mode != "train" else None,
            use_kernel=use_kernels, mesh=mesh,
        )
    elif blk.mixer == "rglru":
        if mode == "prefill" and cache is None:
            cache = _rglru_zero_state(cfg, x.shape[0], x.dtype, x.device,
                                      tp_size(mesh))
        y, new_cache = L.rglru_fwd(
            cfg, p["mixer"], h, state=cache if mode != "train" else None,
            use_kernel=use_kernels, mesh=mesh,
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
        x = x + L.mlp_fwd(cfg, p["ffn"], h, mesh=mesh)
    elif blk.ffn == "moe":
        y, aux = L.moe_fwd(cfg, p["ffn"], h, mesh=mesh,
                           use_kernel=use_kernels)
        x = x + y
    else:
        raise ValueError(blk.ffn)
    return x, new_cache, aux


def _write_back(dst: Dict, new: Optional[Dict]) -> None:
    """Copy a block's new decode state into its (shared) cache views."""
    for k, v in (new or {}).items():
        if v is not dst[k]:
            dst[k].copy_(v)


def _at_rest(params: Params, mesh):
    """(this rank's local tensors, each leaf's gather plan): a DTensor leaf
    is unwrapped (``to_local``, through which its gradient comes back in
    its placements), a plain one is taken as this rank's compute layout.
    Without a mesh: the parameters as they are, no plans."""
    if mesh is None:
        def plain(path, a):
            if hasattr(a, "to_local"):
                raise ValueError(f"{'/'.join(path)} is a DTensor: pass the "
                                 "mesh it rests on (mesh=)")
            return a
        return _tree_map(plain, params), None
    from .sharding import gather_plan

    local = _tree_map(lambda _, a: a.to_local() if hasattr(a, "to_local")
                      else a, params)
    plans = _tree_map(lambda path, a: gather_plan(
        a, mesh, -1 if path[0] == "groups" else 0,
        _PARAM_BLOCKS.get(path[-1], 1)), params)
    return local, plans


def _gathered(tree, plans, mesh):
    """``tree``'s leaves (one group's, or the tail's) as its layers compute
    with them: whole along the batch axes, this rank's ``"model"`` shard."""
    if plans is None:
        return tree
    from .sharding import gather_param

    return _tree_map(lambda path, a: gather_param(a, mesh, _at(plans, path)),
                     tree)


def _embed(cfg, w_embed, tokens, mesh):
    """The embedding lookup; on a mesh vocab parallel: this rank's rows of
    the table, zeros for the tokens outside them, summed over
    ``"model"``."""
    from .sharding import expect_local, local_range, row_out, tp_size

    if tp_size(mesh) == 1:
        return w_embed[tokens]
    expect_local(w_embed.shape[0], cfg.vocab, mesh, "vocab rows")
    lo, hi = local_range(w_embed.shape[0], mesh)
    inside = (tokens >= lo) & (tokens < hi)
    rows = w_embed[(tokens - lo).clamp(0, hi - lo - 1)]
    return row_out(torch.where(inside[..., None], rows, 0.0), mesh)


def forward(
    cfg: ArchConfig,
    params: Params,
    batch: Dict[str, torch.Tensor],
    mode: str = "train",
    cache=None,
    mesh=None,
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
    ``decode`` mode, ``None`` in ``train`` mode.  On a mesh the logits are
    this rank's vocab shard.

    ``compute_dtype`` (default: the parameters' own) casts the embedding,
    the unembedding and every float32 group and tail parameter to it, as
    the reference does on every call (``final_norm`` stays float32).
    ``remat`` (train mode) runs each group under
    ``torch.utils.checkpoint``: the reference's
    ``jax.checkpoint(nothing_saveable)`` per group, which keeps only the
    residual stream between groups and recomputes each group's insides,
    the attention blocks and the parameter gathers included, in the
    backward pass."""
    from .sharding import column_in, expect_local, local_range

    if mode not in ("train", "prefill", "decode"):
        raise ValueError(mode)
    if mode == "decode" and cache is None:
        raise ValueError("decode needs a cache")
    cd = compute_dtype
    local, plans = _at_rest(params, mesh)
    sub = (lambda key: None) if plans is None else (lambda key: plans[key])
    w_embed = _gathered(local["embed"], sub("embed"), mesh)
    if cd is not None:
        w_embed = w_embed.to(cd)
    if cfg.frontend == "embed" and "embeds" in batch:
        x = batch["embeds"].to(w_embed.dtype)
    else:
        x = _embed(cfg, w_embed, batch["tokens"].long(), mesh)
    x = shard(x, "act_batch", "act_seq", "act_embed")
    B, T = x.shape[:2]

    positions = batch.get("positions")
    if positions is None:
        positions = torch.arange(T, device=x.device)[None, :]
    positions = positions.to(x.device).expand(B, T)

    # each stacked leaf split once into its groups' views (unbind's backward
    # stacks the groups' gradients in one buffer)
    groups = _tree_map(lambda _, a: a.unbind(0), local["groups"])

    def group_fwd(x, g):
        gp = _gathered(_tree_map(lambda _, a: a[g], groups), sub("groups"),
                       mesh)
        if cd is not None:
            gp = _cast_f32(gp, cd)
        aux_g, new = None, {}
        for i, blk in enumerate(cfg.pattern):
            name = f"blk{i}"
            c = None
            if mode == "decode":
                c = {k: v[g] for k, v in cache[name].items()}
            x, nc, aux_b = _block_fwd(cfg, blk, gp[name], x, positions, c,
                                      mode, mesh, use_kernels, max_cache_len)
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
        tail = _gathered(local["tail"], sub("tail"), mesh)
        if cd is not None:
            tail = _cast_f32(tail, cd)
        tail_new = {}
        for i, blk in enumerate(cfg.tail):
            name = f"blk{i}"
            c = cache["tail"][name] if mode == "decode" else None
            x, nc, aux_b = _block_fwd(cfg, blk, tail[name], x, positions, c,
                                      mode, mesh, use_kernels, max_cache_len)
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
    x = L.apply_norm(cfg, _gathered(local["final_norm"], sub("final_norm"),
                                    mesh), x)
    if cfg.tie_embeddings:
        w_out = w_embed
    else:
        w_out = _gathered(local["unembed"], sub("unembed"), mesh)
        if cd is not None:
            w_out = w_out.to(cd)
    # vocab parallel on a mesh: this rank's rows of the unembedding
    expect_local(w_out.shape[0], cfg.vocab, mesh, "vocab rows")
    logits = torch.matmul(column_in(x, mesh).to(w_out.dtype),
                          w_out.t()).float()
    if cfg.vocab_real is not None and cfg.vocab_real < cfg.vocab:
        # TP-padded vocab rows must never win a softmax (exact semantics),
        # masked at their global indices
        lo, hi = local_range(w_out.shape[0], mesh)
        if cfg.vocab_real < hi:
            logits[..., max(cfg.vocab_real - lo, 0):] = -1e9
    logits = shard(logits, "act_batch", "act_seq", "act_vocab")
    return logits, new_cache, aux


def _cross_entropy_terms(logits, labels, mesh):
    """(logsumexp over the vocabulary, the label's logit) per position.  On
    a mesh the logits are this rank's vocab shard: the maximum and the sum
    of exponentials are reduced over ``"model"``, and the label's logit is
    a masked local gather summed over ``"model"`` (the reference's masked
    sum over the vocabulary is there for this)."""
    from .sharding import local_range, max_over, row_out, tp_size

    safe = labels.clamp(min=0)
    if tp_size(mesh) == 1:
        logz = torch.logsumexp(logits, dim=-1)
        return logz, logits.gather(-1, safe[..., None])[..., 0]
    m = max_over(logits.amax(dim=-1), mesh, "model")
    logz = m + torch.log(row_out(torch.exp(logits - m[..., None]).sum(dim=-1),
                                 mesh))
    lo, hi = local_range(logits.shape[-1], mesh)
    inside = (safe >= lo) & (safe < hi)
    ll = logits.gather(-1, (safe - lo).clamp(0, hi - lo - 1)[..., None])[..., 0]
    return logz, row_out(torch.where(inside, ll, 0.0), mesh)


def loss_fn(
    cfg: ArchConfig,
    params: Params,
    batch: Dict[str, torch.Tensor],
    mesh=None,
    use_kernels: bool = False,
    compute_dtype: Optional[torch.dtype] = None,
    remat: bool = False,
    z_loss: float = 1e-4,
):
    """Next-token cross entropy (+ router aux loss + z-loss).  Labels come
    from ``batch['labels']``; positions where ``labels < 0`` are masked.
    Returns ``(total, {"ce", "z_loss", "aux", "tokens"})``: on a mesh this
    rank's rows' loss (the step averages it over the batch axes).

    The label's logit is taken with ``gather``; the reference's masked sum
    over the vocabulary (``where(iota == label)``, there so that the
    vocab-sharded logits reduce locally) gives the same value, and would
    cost a (B, T, V) float32 temporary on one card.  On a mesh the gather
    is masked to this rank's vocab shard and summed over ``"model"``."""
    logits, _, aux = forward(cfg, params, batch, mode="train", mesh=mesh,
                             use_kernels=use_kernels,
                             compute_dtype=compute_dtype, remat=remat)
    labels = batch["labels"].long()
    valid = (labels >= 0).float()
    logz, ll = _cross_entropy_terms(logits, labels, mesh)
    nll = (logz - ll) * valid
    denom = valid.sum().clamp(min=1.0)
    ce = nll.sum() / denom
    zl = z_loss * ((logz * valid) ** 2).sum() / denom
    total = ce + zl + cfg.router_aux_weight * aux
    return total, {"ce": ce, "z_loss": zl, "aux": aux, "tokens": denom}


def prefill(cfg: ArchConfig, params: Params, batch, max_cache_len: int,
            use_kernels: bool = False, last_only: bool = False, mesh=None):
    return forward(cfg, params, batch, mode="prefill", mesh=mesh,
                   use_kernels=use_kernels, max_cache_len=max_cache_len,
                   last_only=last_only)


def decode_step(cfg: ArchConfig, params: Params, batch, cache,
                use_kernels: bool = False, mesh=None):
    """One decode step: batch['tokens'] (B, 1) (or (B, k) for speculative
    chunks), batch['positions'] (B, k) absolute positions.  ``cache`` is
    updated in place and returned."""
    return forward(cfg, params, batch, mode="decode", cache=cache, mesh=mesh,
                   use_kernels=use_kernels)
