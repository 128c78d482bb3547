"""Decoder LM (PyTorch port of `repro.models.lm`).

Layer layout mirrors the JAX param tree with the scan axis unstacked:

  params = {"embed": (V, D), or (n_codebooks, V, D) for audio,
            "vision": {"proj": (vision_dim, D)} for vision,
            "prefix": [layer, ...],                  # cfg.prefix_pattern
            "blocks": {"p0": [layer] * n_super, ...}, # one list per
                                                      # block_pattern entry
            "final_norm": (D,), "head": (D, V) if untied
                                        ((D, n_codebooks * V) for audio)}

and the decode / paged states follow the same tree. The JAX package's
`lax.scan` over superblocks is a loop over layers here (`_layers`).

Entry points match the JAX module: init_params, cast_params, forward,
train_loss, prefill, init_decode_state, decode_step, prefill_paged,
decode_step_paged, decode_verify_paged and commit_decode_state. Attention layers ("attn",
"attn_local"), MoE layers ("moe": attention, then the routed experts of
`models/moe.py`; grok-1, llama4), RG-LRU layers ("rec", recurrentgemma)
and RWKV6 layers ("rwkv", rwkv6) are ported, on every path. In the paged
state (the serving engine's) attention and MoE layers hold block pools and
recurrent layers slot-indexed state, (num_slots, ...) per leaf. Decode
state (dense caches, paged pools, recurrent state) is updated in place,
and every function that takes a state returns the same object.

The frontends (`models/frontends.py`) run on every dense path, as in the
JAX module: a vision batch carries "vision_emb" (B, n_patches,
vision_dim), projected and prepended to the text as a bidirectional prefix
that every attention layer's flash kernel sees both ways (prefix_len =
n_patches); logits cover the text only, while prefill's cache covers the
whole sequence, so decode continues after it. Audio tokens are (B, S,
n_codebooks), the codebooks' embeddings summed; the logits are (B, S,
n_codebooks, V) and decode_step takes (B, n_codebooks) tokens. The paged
paths refuse a frontend, as the JAX engine never reaches them.

MoE capacity follows the tokens a call routes in each batch row, as in
the JAX module: a paged prefill routes the row's suffix at its bucket
length and a verify its chain, while decode routes one token (capacity 1,
no drops). So where a prefill drops tokens the engine does not equal
generate(), which primes its cache a token at a time; it equals the JAX
engine.

One difference from the JAX module: decode_step_paged takes `active`, the
lanes the scheduler put in the step. The JAX step advances every slot's
recurrent state, so a lane that sits the step out in the middle of a
chunked prefill (token 0 at position 0) has its carried state overwritten
before its next chunk resumes from it; here such a lane keeps its state.
"""
from __future__ import annotations

from typing import Iterator, List, Tuple

import torch
import torch.utils.checkpoint

from repro_torch import prng
from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import attention, frontends, moe, recurrent
from repro_torch.models.layers import (init_embed, init_mlp, mlp, rms_norm,
                                       softmax_xent)

ATTN_KINDS = ("attn", "attn_local", "moe")
RECURRENT_KINDS = ("rec", "rwkv")


def _check_supported(cfg: ModelConfig) -> None:
    if cfg.frontend not in ("none", "vision", "audio"):
        raise ValueError(cfg.frontend)
    for kind in cfg.prefix_pattern + cfg.block_pattern:
        if kind not in ATTN_KINDS + RECURRENT_KINDS:
            raise ValueError(kind)


def _check_paged(cfg: ModelConfig) -> None:
    """The paged (serving engine) paths take text LMs only: the JAX engine
    refuses the frontends (`ServingEngine`), so its paged functions never
    see them."""
    _check_supported(cfg)
    if cfg.frontend != "none":
        raise NotImplementedError(
            f"{cfg.name}: the paged paths serve text LMs only, as the "
            f"serving engine does (the {cfg.frontend} frontend runs on the "
            f"dense paths and generate())")


def _layers(tree, cfg: ModelConfig) -> Iterator[Tuple[str, dict]]:
    """(kind, entry) for every layer of a params or state tree, in
    execution order: prefix layers, then superblocks."""
    for kind, entry in zip(cfg.prefix_pattern, tree["prefix"]):
        yield kind, entry
    for s in range(cfg.n_super):
        for pi, kind in enumerate(cfg.block_pattern):
            yield kind, tree["blocks"][f"p{pi}"][s]


def layer_kinds(cfg: ModelConfig) -> List[str]:
    """Every layer's kind, in execution order."""
    return list(cfg.prefix_pattern) + list(cfg.block_pattern) * cfg.n_super


def _window(cfg: ModelConfig, kind: str) -> int:
    return cfg.window if kind == "attn_local" else 0


# ----------------------------------------------------------------------------
# Model init
# ----------------------------------------------------------------------------

def _init_block(key, cfg: ModelConfig, kind: str):
    k1, k2 = prng.split(key)
    D, dt = cfg.d_model, cfg.p_dtype
    norms = {"norm1": torch.zeros(D, dtype=dt, device=key.device),
             "norm2": torch.zeros(D, dtype=dt, device=key.device)}
    if kind == "rec":
        return {**norms,
                "rec": recurrent.init_rglru_block(k1, D, cfg.rnn_width,
                                                  cfg.conv_width, dt),
                "mlp": init_mlp(k2, D, cfg.d_ff, dt, cfg.mlp_kind)}
    if kind == "rwkv":
        return {**norms,
                "tmix": recurrent.init_rwkv(k1, D, cfg.n_heads,
                                            cfg.head_dim, dt),
                "cmix": recurrent.init_rwkv_channel_mix(k2, D, cfg.d_ff,
                                                        dt)}
    attn = attention.init_attention(k1, D, cfg.n_heads, cfg.n_kv_heads,
                                    cfg.head_dim, dt)
    if kind == "moe":
        return {**norms, "attn": attn,
                "moe": moe.init_moe(k2, D, cfg.d_ff, cfg.n_experts, dt,
                                    cfg.mlp_kind)}
    return {**norms, "attn": attn,
            "mlp": init_mlp(k2, D, cfg.d_ff, dt, cfg.mlp_kind)}


def init_params(seed: int, cfg: ModelConfig, *, device=None):
    """Random params in the JAX tree layout (unstacked), drawn on `device`
    (default CUDA; raises without a GPU unless device="cpu" is given) from
    JAX's key `PRNGKey(seed)` in JAX's key order (`repro/models/lm.py:
    init_params`): its split into 8, the embedding from the first, prefix
    layer i from fold_in(keys[2], i), superblock n of pattern position pi
    from split(fold_in(keys[3], pi), n_super)[n], the head from keys[4]
    ((D, n_codebooks * V) for audio); audio's codebook tables from
    keys[0], the vision projection from keys[1]. So a seed gives the JAX
    package's weights (`prng.normal`: up to erf_inv's last place)."""
    _check_supported(cfg)
    dev = resolve_device(device)
    keys = prng.split(prng.PRNGKey(seed, device=dev), 8)
    D, V, dt = cfg.d_model, cfg.vocab_size, cfg.p_dtype
    if cfg.frontend == "audio":
        params = {"embed": frontends.init_audio_embed(
            keys[0], cfg.n_codebooks, V, D, dt)}
    else:
        params = {"embed": init_embed(keys[0], V, D, dt)}
    if cfg.frontend == "vision":
        params["vision"] = frontends.init_vision_frontend(
            keys[1], cfg.vision_dim, D, dt)
    params["prefix"] = [_init_block(prng.fold_in(keys[2], i), cfg, kind)
                        for i, kind in enumerate(cfg.prefix_pattern)]
    blocks = {}
    for pi, kind in enumerate(cfg.block_pattern):
        layer_keys = prng.split(prng.fold_in(keys[3], pi), cfg.n_super)
        blocks[f"p{pi}"] = [_init_block(k, cfg, kind) for k in layer_keys]
    params["blocks"] = blocks
    params["final_norm"] = torch.zeros(D, dtype=dt, device=dev)
    if not cfg.tie_embeddings:
        n_out = V * (cfg.n_codebooks if cfg.frontend == "audio" else 1)
        params["head"] = (prng.normal(keys[4], (D, n_out))
                          * D ** -0.5).to(dt)
    return params


def cast_params(params, cfg: ModelConfig):
    """Float params in the compute dtype. A tensor already in it is
    returned as it is, so casting once up front makes later calls free."""
    dt = cfg.act_dtype

    def cast(p):
        if isinstance(p, dict):
            return {k: cast(v) for k, v in p.items()}
        if isinstance(p, list):
            return [cast(v) for v in p]
        return p.to(dt) if p.is_floating_point() else p

    return cast(params)


def _embed(params, cfg: ModelConfig, tokens):
    """Token embeddings in the activation dtype: tokens (B, S), or (B, S,
    n_codebooks) for audio (the codebooks' embeddings summed)."""
    if cfg.frontend == "audio":
        return frontends.audio_embed(params["embed"],
                                     tokens).to(cfg.act_dtype)
    return params["embed"][tokens.long()].to(cfg.act_dtype)


def _embed_inputs(params, cfg: ModelConfig, batch):
    """(h (B, S, D), positions (B, S), prefix_len): a vision batch's
    projected "vision_emb" (cast to the activation dtype before the
    projection, as the JAX module casts it) prepended to its text tokens,
    prefix_len = n_patches; otherwise the tokens' embeddings and 0."""
    h = _embed(params, cfg, batch["tokens"])
    prefix_len = 0
    if cfg.frontend == "vision":
        vis = frontends.vision_embed(
            params["vision"], batch["vision_emb"].to(cfg.act_dtype))
        h = torch.cat([vis.to(cfg.act_dtype), h], dim=1)
        prefix_len = vis.shape[1]
    return h, _positions(h.shape[0], h.shape[1], h.device), prefix_len


def _head(params, cfg: ModelConfig, h):
    """Logits (..., V) of h (..., D); for audio (B, S, n_codebooks, V) of
    h (B, S, D)."""
    if cfg.frontend == "audio":
        if cfg.tie_embeddings:
            return torch.einsum("bsd,cvd->bscv", h, params["embed"])
        B, S, _ = h.shape
        return (h @ params["head"]).reshape(B, S, cfg.n_codebooks,
                                            cfg.vocab_size)
    if cfg.tie_embeddings:
        return h @ params["embed"].T
    return h @ params["head"]


def _mlp_residual(p, x, cfg: ModelConfig):
    return x + mlp(p["mlp"], rms_norm(x, p["norm2"], cfg.norm_eps),
                   cfg.mlp_kind)


def _ffn_residual(kind: str, p, x, cfg: ModelConfig, n_valid=None):
    """The second half of an attention or MoE layer, residual included:
    the MLP, or the routed experts. Returns (x, the MoE aux dict, or None
    for an MLP). n_valid: (B,) each row's real tokens (moe.tally reads
    it)."""
    if kind != "moe":
        return _mlp_residual(p, x, cfg), None
    y, aux = moe.moe_block(p["moe"], rms_norm(x, p["norm2"], cfg.norm_eps),
                           cfg, kind=cfg.mlp_kind, n_valid=n_valid)
    return x + y, aux


def _recurrent_layer(kind: str, p, h, cfg: ModelConfig, state=None,
                     lengths=None, return_states: bool = False):
    """One recurrent layer in sequence form, residuals included: RWKV6
    (time mix, then channel mix) or RG-LRU (the recurrent block, then the
    MLP). state: the layer's {"tmix": {"shift", "S"}, "cmix"} or {"rec":
    {"h", "conv"}}, or None (zeros). Returns (h, new state), and with
    return_states also the (S+1, B, ...) snapshots in the state's tree."""
    def sub(st, key):
        return None if st is None else st[key]

    if kind == "rwkv":
        t = recurrent.rwkv_seq(
            p["tmix"], rms_norm(h, p["norm1"], cfg.norm_eps), cfg,
            sub(state, "tmix"), lengths=lengths, return_states=return_states)
        h = h + t[0]
        c = recurrent.rwkv_channel_mix(
            p["cmix"], rms_norm(h, p["norm2"], cfg.norm_eps),
            sub(state, "cmix"), lengths=lengths, return_states=return_states)
        out = (h + c[0], {"tmix": t[1], "cmix": c[1]})
        return out + ({"tmix": t[2], "cmix": c[2]},) if return_states \
            else out
    r = recurrent.rglru_block_seq(
        p["rec"], rms_norm(h, p["norm1"], cfg.norm_eps), cfg,
        sub(state, "rec"), lengths=lengths, return_states=return_states)
    out = (_mlp_residual(p, h + r[0], cfg), {"rec": r[1]})
    return out + ({"rec": r[2]},) if return_states else out


def _map(fn, tree, *rest):
    """fn over the leaves of nested dicts of tensors (and of `rest`, trees
    of the same structure)."""
    if isinstance(tree, dict):
        return {k: _map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def _leaves(tree):
    """The tensors of nested dicts, depth first."""
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def _write_state(st, new, active=None):
    """Copy a recurrent layer's new state into its state `st` in place;
    with `active` ((B,) bool), only the lanes where it is true."""
    def put(s, n):
        if active is not None:
            m = active.reshape((-1,) + (1,) * (s.dim() - 1))
            n = torch.where(m, n.to(s.dtype), s)
        s.copy_(n)

    _map(put, st, new)


# ----------------------------------------------------------------------------
# Sequence forward (train / prefill)
# ----------------------------------------------------------------------------

def _seq_layer(kind: str, p, h, cfg: ModelConfig, positions,
               collect_kv: bool = False, lengths=None, prefix_len: int = 0):
    """One layer over a full sequence: (h, its state when collect_kv, the
    MoE aux dict or None). prefix_len: the bidirectional prefix every
    attention layer sees both ways."""
    if kind in RECURRENT_KINDS:
        return _recurrent_layer(kind, p, h, cfg, lengths=lengths) + (None,)
    o = attention.attention_block(
        p["attn"], rms_norm(h, p["norm1"], cfg.norm_eps), positions, cfg,
        window=_window(cfg, kind), prefix_len=prefix_len,
        return_kv=collect_kv)
    kv = None
    if collect_kv:
        o, (k, v) = o
        kv = {"k": k, "v": v}
    h, aux = _ffn_residual(kind, p, h + o, cfg, lengths)
    return h, kv, aux


def _add_aux(acc, aux):
    """acc (moe_aux, moe_zloss) plus a layer's aux dict (None: nothing)."""
    if aux is None:
        return acc
    return acc[0] + aux["moe_aux"], acc[1] + aux["moe_zloss"]


def _run_blocks_seq(params, cfg: ModelConfig, h, positions,
                    collect_kv: bool = False, lengths=None,
                    remat: bool = False, prefix_len: int = 0):
    """All layers over a full sequence. Returns (h, per-layer states when
    collect_kv else None, aux): states {"k", "v"} for attention and MoE
    layers, {"rec": {"h", "conv"}} for RG-LRU layers, {"tmix": {"shift",
    "S"}, "cmix"} for RWKV6 layers; aux {"moe_aux", "moe_zloss"}, float32
    scalars summed over the MoE layers as the JAX path sums them (prefix
    layers one by one, then each superblock's own sum). `lengths` freezes
    recurrent layers past each row's true length (attention needs no mask:
    trailing pads are causally invisible; MoE routes them after the row's
    tokens, which they cannot displace). remat=True recomputes each
    superblock in the backward pass (torch.utils.checkpoint,
    non-reentrant), as the JAX path wraps each in jax.checkpoint; prefix
    layers run as they are, as there. prefix_len: the bidirectional
    (vision) prefix of every attention layer."""
    zero = torch.zeros((), dtype=torch.float32, device=h.device)
    kvs: List = []

    def layer(kind, p, h, acc):
        h, st, aux = _seq_layer(kind, p, h, cfg, positions, collect_kv,
                                lengths, prefix_len)
        if collect_kv:
            kvs.append(st)
        return h, _add_aux(acc, aux)

    acc = (zero, zero)
    for kind, p in zip(cfg.prefix_pattern, params["prefix"]):
        h, acc = layer(kind, p, h, acc)

    def superblock(h, s):
        sub = (zero, zero)
        for pi, kind in enumerate(cfg.block_pattern):
            h, sub = layer(kind, params["blocks"][f"p{pi}"][s], h, sub)
        return (h,) + sub

    per_super = []
    for s in range(cfg.n_super):
        out = (torch.utils.checkpoint.checkpoint(superblock, h, s,
                                                 use_reentrant=False)
               if remat else superblock(h, s))
        h = out[0]
        per_super.append(out[1:])
    if per_super:
        acc = tuple(a + torch.stack(t).sum()
                    for a, t in zip(acc, zip(*per_super)))
    aux = {"moe_aux": acc[0], "moe_zloss": acc[1]}
    return h, (kvs if collect_kv else None), aux


def _positions(B: int, S: int, device):
    return torch.arange(S, dtype=torch.int32, device=device).expand(B, S)


def forward(params, cfg: ModelConfig, batch, remat: bool = False):
    """Full-sequence logits. batch: {"tokens": (B, S) int} ((B, S,
    n_codebooks) for audio; a vision batch also has "vision_emb" (B,
    n_patches, vision_dim)). Returns (logits (B, S, V) (audio: (B, S,
    n_codebooks, V); vision: the text's S only), aux): aux {"moe_aux",
    "moe_zloss"}, the MoE layers' load-balancing and router z-losses
    summed over layers (float32 zeros for a model without them). remat:
    recompute each superblock in the backward pass."""
    _check_supported(cfg)
    params = cast_params(params, cfg)
    h, positions, prefix_len = _embed_inputs(params, cfg, batch)
    h, _, aux = _run_blocks_seq(params, cfg, h, positions, remat=remat,
                                prefix_len=prefix_len)
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    return _head(params, cfg, h[:, prefix_len:]), aux


def train_loss(params, cfg: ModelConfig, batch, remat: bool = True):
    """Mean next-token cross-entropy of batch {"tokens", "targets"} (both
    (B, S) int; (B, S, n_codebooks) for audio; a vision batch's targets
    cover its text) plus the MoE terms, as the JAX train_loss: total = xent
    + 0.01 moe_aux + 1e-4 moe_zloss. Returns (total, {"xent", "moe_aux",
    "moe_zloss"}). Differentiable through the flash kernel (its backward is
    a kernel too) and the MoE layers' products."""
    for kind in cfg.prefix_pattern + cfg.block_pattern:
        if kind in RECURRENT_KINDS:
            raise NotImplementedError(
                f"{cfg.name}: training {kind!r} layers needs backward "
                f"kernels for the recurrent scans (ROADMAP queue 1, "
                f"'Recurrent training')")
    logits, aux = forward(params, cfg, batch, remat=remat)
    loss = softmax_xent(logits, batch["targets"]).mean()
    total = loss + 0.01 * aux["moe_aux"] + 1e-4 * aux["moe_zloss"]
    return total, {"xent": loss, **aux}


def _to_tree(cfg: ModelConfig, per_layer: List):
    """Per-layer list (execution order, as layer_kinds) -> the
    {"prefix", "blocks"} tree."""
    n_pre = len(cfg.prefix_pattern)
    P = cfg.pattern_len
    return {"prefix": per_layer[:n_pre],
            "blocks": {f"p{pi}": per_layer[n_pre + pi::P]
                       for pi in range(P)}}


def prefill(params, cfg: ModelConfig, batch):
    """Single-shot prefill: (logits (B, S, V), cache) where cache mirrors
    init_decode_state's tree with each attention layer's rope'd
    {"k", "v"} of shape (B, S, KV, hd) (MoE layers too), each RG-LRU
    layer's final {"rec": {"h", "conv"}} and each RWKV6 layer's final
    {"tmix": {"shift", "S"}, "cmix"}. A "lengths" entry in batch ((B,) true
    lengths of right-padded rows) freezes the recurrent layers past each
    row's length; attention needs no mask. MoE routes all S positions of a
    row with capacity at S. A vision batch's cache covers its
    n_patches + S positions and its logits the text's S; audio's logits
    are (B, S, n_codebooks, V)."""
    _check_supported(cfg)
    params = cast_params(params, cfg)
    h, positions, prefix_len = _embed_inputs(params, cfg, batch)
    h, kvs, _ = _run_blocks_seq(params, cfg, h, positions, collect_kv=True,
                                lengths=batch.get("lengths"),
                                prefix_len=prefix_len)
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    return _head(params, cfg, h[:, prefix_len:]), _to_tree(cfg, kvs)


# ----------------------------------------------------------------------------
# Decode (single-token step with per-layer state)
# ----------------------------------------------------------------------------

def init_decode_state(cfg: ModelConfig, batch: int, max_len: int, *,
                      device):
    """Dense per-layer KV caches (B, S, KV, hd) in the activation dtype;
    local-attention layers keep a rolling buffer of min(window, max_len).
    RG-LRU layers hold {"rec": {"h": (B, rnn_width) float32, "conv":
    (B, conv_width - 1, rnn_width)}}, RWKV6 layers {"tmix": {"shift": (B, D),
    "S": (B, H, hd, hd) float32}, "cmix": (B, D)}."""
    _check_supported(cfg)
    dev = torch.device(device)

    def one(kind):
        if kind in RECURRENT_KINDS:
            return recurrent_state(cfg, kind, batch, dev)
        n = min(cfg.window, max_len) if kind == "attn_local" else max_len
        return attention.init_kv_cache(batch, n, cfg.n_kv_heads,
                                       cfg.head_dim, cfg.act_dtype, dev)

    return _to_tree(cfg, [one(kind) for kind in layer_kinds(cfg)])


def recurrent_state(cfg: ModelConfig, kind: str, batch: int, device):
    """A recurrent layer's zero state for `batch` rows (decode rows, or
    the engine's slots): RWKV6 {"tmix": {"shift": (B, D), "S": (B, H, hd,
    hd) float32}, "cmix": (B, D)}, RG-LRU {"rec": {"h": (B, rnn_width)
    float32, "conv": (B, conv_width - 1, rnn_width)}}, the rest in the
    activation dtype."""
    def z(*shape, dtype=cfg.act_dtype):
        return torch.zeros(*shape, dtype=dtype, device=device)

    if kind == "rwkv":
        hd = cfg.head_dim
        return {"tmix": {"shift": z(batch, cfg.d_model),
                         "S": z(batch, cfg.n_heads, hd, hd,
                                dtype=torch.float32)},
                "cmix": z(batch, cfg.d_model)}
    if kind == "rec":
        return {"rec": {"h": z(batch, cfg.rnn_width, dtype=torch.float32),
                        "conv": z(batch, cfg.conv_width - 1,
                                  cfg.rnn_width)}}
    raise ValueError(kind)


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree.clone()


def decode_state_from_prefill(cfg: ModelConfig, cache, max_len: int):
    """init_decode_state's tree holding a `prefill` cache of S tokens, so
    decode_step continues at pos = S: attention K/V at slots 0..S-1 (a
    local-attention layer's rolling buffer keeps the last min(window,
    max_len) positions p at slot p % window), recurrent state as it is."""
    ref_t = next(c for _, c in _layers(cache, cfg))
    while isinstance(ref_t, dict):           # any tensor of the first layer
        ref_t = next(iter(ref_t.values()))
    state = init_decode_state(cfg, ref_t.shape[0], max_len,
                              device=ref_t.device)
    for (kind, st), (_, c) in zip(_layers(state, cfg), _layers(cache, cfg)):
        if kind in RECURRENT_KINDS:
            st.update(_clone(c))
            continue
        S, n = c["k"].shape[1], st["k"].shape[1]
        p = torch.arange(max(0, S - n), S, device=ref_t.device)
        slot = p % cfg.window if kind == "attn_local" else p
        st["k"][:, slot] = c["k"][:, p]
        st["v"][:, slot] = c["v"][:, p]
    return state


def decode_step(params, cfg: ModelConfig, state, tokens, pos: int):
    """tokens: (B,) int ((B, n_codebooks) for audio); pos: the position
    being fed (an int). Returns (logits (B, V) ((B, n_codebooks, V) for
    audio), state) — the caches are updated in place, and each recurrent
    layer's entries are replaced by its new state (the blocks run with
    S = 1)."""
    params = cast_params(params, cfg)
    h = _embed(params, cfg, tokens[:, None])
    for (kind, p), (_, st) in zip(_layers(params, cfg), _layers(state, cfg)):
        if kind in RECURRENT_KINDS:
            h, new = _recurrent_layer(kind, p, h, cfg, st)
            st.update(new)
            continue
        o, _ = attention.decode_attention_block(
            p["attn"], rms_norm(h, p["norm1"], cfg.norm_eps), st, pos, cfg,
            window=_window(cfg, kind))
        h, _ = _ffn_residual(kind, p, h + o, cfg)
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    return _head(params, cfg, h)[:, 0], state


# ----------------------------------------------------------------------------
# Paged paths (continuous-batching serving)
# ----------------------------------------------------------------------------

def _attn_layer_paged(p, kind, h, st, cfg: ModelConfig, positions,
                      block_tables, starts, lengths, cached_lens):
    """One attention or MoE layer of a suffix prefill or verify, residuals
    included: attends to the cached prefix through the block table and
    scatters the suffix K/V into the pools. A MoE layer routes each row's
    Ls positions (its lengths - starts real tokens, then padding) with
    capacity at Ls."""
    o, _ = attention.paged_prefill_attention_block(
        p["attn"], rms_norm(h, p["norm1"], cfg.norm_eps), st, positions,
        block_tables, starts, lengths, cached_lens, cfg,
        window=_window(cfg, kind))
    h, _ = _ffn_residual(kind, p, h + o, cfg, lengths - starts)
    return h


def prefill_paged(params, cfg: ModelConfig, state, tokens, lengths,
                  cached_lens, block_tables, slots, resume: bool = False):
    """Bucketed batched prefill straight into the paged state.

    tokens: (N, Ls) — row n holds the prompt SUFFIX from
    min(cached_lens[n], lengths[n] - 1), right-padded; lengths /
    cached_lens: (N,) int32; block_tables: (N, max_blocks) int32; slots:
    (N,) decode slot per row. Attention layers attend to the cached prefix
    and scatter the suffix K/V into the pools. Recurrent layers run the
    length-masked sequence form over the suffix and scatter each row's
    final state to its slot (a slot >= num_slots, a padding row's, drops);
    from zeros, or with resume=True (a chunked prefill's later chunk) from
    the state the row's slot holds. Returns (last-token logits (N, V),
    state)."""
    _check_paged(cfg)
    params = cast_params(params, cfg)
    N, Ls = tokens.shape
    starts = torch.minimum(cached_lens, (lengths - 1).clamp_min(0))
    positions = (starts[:, None]
                 + torch.arange(Ls, dtype=torch.int32,
                                device=tokens.device)[None, :])
    h = _embed(params, cfg, tokens)
    rec = [st for kind, st in _layers(state, cfg) if kind in RECURRENT_KINDS]
    if rec:
        # rows whose slot is a real one (once for all layers: the boolean
        # index syncs with the device)
        num_slots = next(_leaves(rec[0])).shape[0]
        keep = slots < num_slots
        src, dst = keep.nonzero()[:, 0], slots[keep].long()
        gather = slots.clamp(0, num_slots - 1).long()
    for (kind, p), (_, st) in zip(_layers(params, cfg), _layers(state, cfg)):
        if kind not in RECURRENT_KINDS:
            h = _attn_layer_paged(p, kind, h, st, cfg, positions,
                                  block_tables, starts, lengths, cached_lens)
            continue
        init = _map(lambda s: s[gather], st) if resume else None
        h, fin = _recurrent_layer(kind, p, h, cfg, init,
                                  lengths=lengths - starts)
        _map(lambda s, f: s.index_put_((dst,), f[src].to(s.dtype)), st, fin)
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    idx = (lengths - 1 - starts).clamp(0, Ls - 1).long()
    last = h[torch.arange(N, device=h.device), idx]
    return _head(params, cfg, last), state


def decode_verify_paged(params, cfg: ModelConfig, state, tokens, positions,
                        counts, block_tables):
    """Batched K-token verify forward through the paged cache. tokens:
    (B, T) draft chains right-padded; positions: (B,) position of each
    chain's first token; counts: (B,) true chain lengths (0 = the lane
    sits out). Attention reuses the suffix-prefill path (starts = cached
    = positions, lengths = positions + counts) and scatters the chain's
    K/V. Recurrent layers run from the live slot state, frozen past
    counts, and do not advance it. Returns (logits (B, T, V), state,
    snapshots): snapshots mirror the state tree with None for attention
    layers and, for recurrent ones, (T+1, B, ...) stacks whose index t is
    the state after t chain tokens (commit_decode_state takes them)."""
    _check_paged(cfg)
    params = cast_params(params, cfg)
    B, T = tokens.shape
    pos_grid = (positions[:, None]
                + torch.arange(T, dtype=torch.int32,
                               device=tokens.device)[None, :])
    h = _embed(params, cfg, tokens)
    snaps = []
    for (kind, p), (_, st) in zip(_layers(params, cfg), _layers(state, cfg)):
        if kind not in RECURRENT_KINDS:
            h = _attn_layer_paged(p, kind, h, st, cfg, pos_grid,
                                  block_tables, positions,
                                  positions + counts, positions)
            snaps.append(None)
            continue
        h, _, snap = _recurrent_layer(kind, p, h, cfg, st, lengths=counts,
                                      return_states=True)
        snaps.append(snap)
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    return _head(params, cfg, h), state, _to_tree(cfg, snaps)


def commit_decode_state(cfg: ModelConfig, state, snapshots, idx):
    """Commit recurrent slot state after a verify step: lane b takes
    snapshot idx[b] (a + 1 for an accepted draft prefix of a tokens, 0 to
    keep the pre-verify state, as for lanes that sat the verify out).
    Attention state needs no commit (positions are the rollback). Updates
    `state` in place and returns it."""
    _check_paged(cfg)
    for (_, st), (_, snap) in zip(_layers(state, cfg),
                                  _layers(snapshots, cfg)):
        if snap is None:
            continue
        i = idx.long().to(next(iter(_leaves(snap))).device)
        lanes = torch.arange(i.shape[0], device=i.device)
        _map(lambda s, sn: s.copy_(sn[i, lanes]), st, snap)
    return state


def decode_step_paged(params, cfg: ModelConfig, state, tokens, positions,
                      block_tables, active=None):
    """One decode iteration for a slot batch. tokens / positions: (B,)
    int32; block_tables: (B, max_blocks) int32; active: (B,) bool, the
    lanes in the step, or None (all). Attention layers decode through the
    pools (a lane that sits out writes to the null block its table row
    points at); recurrent layers take the dense one-token step, and write
    their new state only where `active` is true, so a lane that sits out
    keeps its state. MoE layers route each lane's token alone (capacity
    1). Returns (logits (B, V), state)."""
    _check_paged(cfg)
    params = cast_params(params, cfg)
    h = _embed(params, cfg, tokens[:, None])
    for (kind, p), (_, st) in zip(_layers(params, cfg), _layers(state, cfg)):
        if kind in RECURRENT_KINDS:
            h, new = _recurrent_layer(kind, p, h, cfg, st)
            _write_state(st, new, active)
            continue
        o, _ = attention.paged_decode_attention_block(
            p["attn"], rms_norm(h, p["norm1"], cfg.norm_eps), st, positions,
            block_tables, cfg, window=_window(cfg, kind))
        h, _ = _ffn_residual(kind, p, h + o, cfg, active)
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    return _head(params, cfg, h)[:, 0], state
