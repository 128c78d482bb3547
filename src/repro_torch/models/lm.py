"""Decoder LM (PyTorch port of `repro.models.lm`).

Layer layout mirrors the JAX param tree with the scan axis unstacked:

  params = {"embed": (V, D),
            "prefix": [layer, ...],                  # cfg.prefix_pattern
            "blocks": {"p0": [layer] * n_super, ...}, # one list per
                                                      # block_pattern entry
            "final_norm": (D,), "head": (D, V) if untied}

and the decode / paged states follow the same tree. The JAX package's
`lax.scan` over superblocks is a loop over layers here (`_layers`).

Entry points match the JAX module: init_params, cast_params, forward,
prefill, init_decode_state, decode_step, prefill_paged, decode_step_paged,
decode_verify_paged and commit_decode_state. Attention layers ("attn",
"attn_local"), RG-LRU layers ("rec", recurrentgemma) and RWKV6 layers
("rwkv", rwkv6) are ported; the paged entry points (the serving engine)
take attention-only patterns, and "rec" / "rwkv" there raise until the
hybrid engine slice. "moe" blocks and the vision / audio frontends raise
NotImplementedError until their slice. Decode state (dense caches, paged
pools, recurrent state) is updated in place, and every function that takes
a state returns the same object.
"""
from __future__ import annotations

from typing import Iterator, List, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import attention, recurrent
from repro_torch.models.layers import init_embed, init_mlp, mlp, rms_norm

ATTN_KINDS = ("attn", "attn_local")
RECURRENT_KINDS = ("rec", "rwkv")


def _check_supported(cfg: ModelConfig) -> None:
    if cfg.frontend != "none":
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.frontend} frontend is not ported yet "
            f"(the MoE-and-frontends slice)")
    for kind in cfg.prefix_pattern + cfg.block_pattern:
        if kind == "moe":
            raise NotImplementedError(
                f"{cfg.name}: MoE blocks are not ported yet (the "
                f"MoE-and-frontends slice)")
        if kind not in ATTN_KINDS + RECURRENT_KINDS:
            raise ValueError(kind)


def _check_paged(cfg: ModelConfig) -> None:
    """The paged entry points take attention-only patterns: recurrent slot
    state in the runner and the verify snapshots come with the hybrid
    engine slice."""
    _check_supported(cfg)
    rec = set(RECURRENT_KINDS) & set(cfg.prefix_pattern + cfg.block_pattern)
    if rec:
        raise NotImplementedError(
            f"{cfg.name}: the paged serving path (engine) for recurrent "
            f"{sorted(rec)} blocks is not ported yet (the hybrid engine "
            f"slice: recurrent slot state in the runner, return_states "
            f"snapshots); "
            f"use lm.decode_step / generate()")


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

def _init_block(gen, cfg: ModelConfig, kind: str):
    D, dt = cfg.d_model, cfg.p_dtype
    norms = {"norm1": torch.zeros(D, dtype=dt, device=gen.device),
             "norm2": torch.zeros(D, dtype=dt, device=gen.device)}
    if kind == "rec":
        return {**norms,
                "rec": recurrent.init_rglru_block(gen, D, cfg.rnn_width,
                                                  cfg.conv_width, dt),
                "mlp": init_mlp(gen, D, cfg.d_ff, dt, cfg.mlp_kind)}
    if kind == "rwkv":
        return {**norms,
                "tmix": recurrent.init_rwkv(gen, D, cfg.n_heads,
                                            cfg.head_dim, dt),
                "cmix": recurrent.init_rwkv_channel_mix(gen, D, cfg.d_ff,
                                                        dt)}
    return {**norms,
            "attn": attention.init_attention(gen, D, cfg.n_heads,
                                             cfg.n_kv_heads, cfg.head_dim,
                                             dt),
            "mlp": init_mlp(gen, D, cfg.d_ff, dt, cfg.mlp_kind)}


def init_params(seed: int, cfg: ModelConfig, *, device=None):
    """Random params in the JAX tree layout (unstacked), drawn from a
    `torch.Generator` seeded with `seed` on `device` (default CUDA; raises
    without a GPU unless device="cpu" is given)."""
    _check_supported(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    D, V, dt = cfg.d_model, cfg.vocab_size, cfg.p_dtype
    params = {"embed": init_embed(gen, V, D, dt)}
    params["prefix"] = [_init_block(gen, cfg, kind)
                        for kind in cfg.prefix_pattern]
    params["blocks"] = {
        f"p{pi}": [_init_block(gen, cfg, kind) for _ in range(cfg.n_super)]
        for pi, kind in enumerate(cfg.block_pattern)}
    params["final_norm"] = torch.zeros(D, dtype=dt, device=dev)
    if not cfg.tie_embeddings:
        params["head"] = (torch.randn(D, V, generator=gen, device=dev)
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
    return params["embed"][tokens.long()].to(cfg.act_dtype)


def _head(params, cfg: ModelConfig, h):
    if cfg.tie_embeddings:
        return h @ params["embed"].T
    return h @ params["head"]


def _mlp_residual(p, x, cfg: ModelConfig):
    return x + mlp(p["mlp"], rms_norm(x, p["norm2"], cfg.norm_eps),
                   cfg.mlp_kind)


def _rwkv_layer(p, h, cfg: ModelConfig, state=None, lengths=None):
    """One RWKV6 layer (time mix, then channel mix, each residual). state:
    {"tmix": {"shift", "S"}, "cmix": shift} or None (zeros). Returns (h,
    new state)."""
    o, st_t = recurrent.rwkv_seq(
        p["tmix"], rms_norm(h, p["norm1"], cfg.norm_eps), cfg,
        None if state is None else state["tmix"], lengths=lengths)
    h = h + o
    o, shift = recurrent.rwkv_channel_mix(
        p["cmix"], rms_norm(h, p["norm2"], cfg.norm_eps),
        None if state is None else state["cmix"], lengths=lengths)
    return h + o, {"tmix": st_t, "cmix": shift}


# ----------------------------------------------------------------------------
# Sequence forward (train / prefill)
# ----------------------------------------------------------------------------

def _run_blocks_seq(params, cfg: ModelConfig, h, positions,
                    collect_kv: bool = False, lengths=None):
    """All layers over a full sequence. Returns (h, per-layer states when
    collect_kv else None): {"k", "v"} for attention layers, {"rec": {"h",
    "conv"}} for RG-LRU layers, {"tmix": {"shift", "S"}, "cmix"} for RWKV6
    layers. `lengths` freezes recurrent layers past each row's true length
    (attention needs no mask: trailing pads are causally invisible)."""
    kvs: List = []
    for kind, p in _layers(params, cfg):
        if kind == "rwkv":
            h, st = _rwkv_layer(p, h, cfg, lengths=lengths)
            if collect_kv:
                kvs.append(st)
            continue
        if kind == "rec":
            o, st = recurrent.rglru_block_seq(
                p["rec"], rms_norm(h, p["norm1"], cfg.norm_eps), cfg,
                lengths=lengths)
            if collect_kv:
                kvs.append({"rec": st})
            h = _mlp_residual(p, h + o, cfg)
            continue
        o = attention.attention_block(
            p["attn"], rms_norm(h, p["norm1"], cfg.norm_eps), positions, cfg,
            window=_window(cfg, kind), return_kv=collect_kv)
        if collect_kv:
            o, kv = o
            kvs.append({"k": kv[0], "v": kv[1]})
        h = _mlp_residual(p, h + o, cfg)
    return h, (kvs if collect_kv else None)


def _positions(B: int, S: int, device):
    return torch.arange(S, dtype=torch.int32, device=device).expand(B, S)


def forward(params, cfg: ModelConfig, batch):
    """Full-sequence logits. batch: {"tokens": (B, S) int}. Returns
    (logits (B, S, V), aux) — aux carries the JAX path's (zero) MoE
    losses."""
    _check_supported(cfg)
    params = cast_params(params, cfg)
    tokens = batch["tokens"]
    h = _embed(params, cfg, tokens)
    h, _ = _run_blocks_seq(params, cfg, h,
                           _positions(*tokens.shape, tokens.device))
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    return _head(params, cfg, h), {"moe_aux": 0.0, "moe_zloss": 0.0}


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
    {"k", "v"} of shape (B, S, KV, hd), each RG-LRU layer's final
    {"rec": {"h", "conv"}} and each RWKV6 layer's final {"tmix": {"shift",
    "S"}, "cmix"}. A "lengths" entry in batch ((B,) true lengths of
    right-padded rows) freezes the recurrent layers past each row's length;
    attention needs no mask."""
    _check_supported(cfg)
    params = cast_params(params, cfg)
    tokens = batch["tokens"]
    h = _embed(params, cfg, tokens)
    h, kvs = _run_blocks_seq(params, cfg, h,
                             _positions(*tokens.shape, tokens.device),
                             collect_kv=True, lengths=batch.get("lengths"))
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    return _head(params, cfg, h), _to_tree(cfg, kvs)


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
        if kind == "rwkv":
            hd = cfg.head_dim
            return {"tmix": {"shift": torch.zeros(batch, cfg.d_model,
                                                  dtype=cfg.act_dtype,
                                                  device=dev),
                             "S": torch.zeros(batch, cfg.n_heads, hd, hd,
                                              dtype=torch.float32,
                                              device=dev)},
                    "cmix": torch.zeros(batch, cfg.d_model,
                                        dtype=cfg.act_dtype, device=dev)}
        if kind == "rec":
            return {"rec": {
                "h": torch.zeros(batch, cfg.rnn_width, dtype=torch.float32,
                                 device=dev),
                "conv": torch.zeros(batch, cfg.conv_width - 1, cfg.rnn_width,
                                    dtype=cfg.act_dtype, device=dev)}}
        n = min(cfg.window, max_len) if kind == "attn_local" else max_len
        return attention.init_kv_cache(batch, n, cfg.n_kv_heads,
                                       cfg.head_dim, cfg.act_dtype, dev)

    return _to_tree(cfg, [one(kind) for kind in layer_kinds(cfg)])


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
    """tokens: (B,) int; pos: the position being fed (an int). Returns
    (logits (B, V), state) — the caches are updated in place, and each
    recurrent layer's entries are replaced by its new state (the blocks run
    with S = 1)."""
    params = cast_params(params, cfg)
    h = _embed(params, cfg, tokens[:, None])
    for (kind, p), (_, st) in zip(_layers(params, cfg), _layers(state, cfg)):
        if kind == "rwkv":
            h, new = _rwkv_layer(p, h, cfg, st)
            st.update(new)
            continue
        if kind == "rec":
            o, st["rec"] = recurrent.rglru_block_seq(
                p["rec"], rms_norm(h, p["norm1"], cfg.norm_eps), cfg,
                st["rec"])
            h = _mlp_residual(p, h + o, cfg)
            continue
        o, _ = attention.decode_attention_block(
            p["attn"], rms_norm(h, p["norm1"], cfg.norm_eps), st, pos, cfg,
            window=_window(cfg, kind))
        h = _mlp_residual(p, h + o, cfg)
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    return _head(params, cfg, h)[:, 0], state


# ----------------------------------------------------------------------------
# Paged paths (continuous-batching serving)
# ----------------------------------------------------------------------------

def _prefill_layers(params, cfg: ModelConfig, state, h, positions,
                    block_tables, starts, lengths, cached_lens):
    for (kind, p), (_, st) in zip(_layers(params, cfg), _layers(state, cfg)):
        o, _ = attention.paged_prefill_attention_block(
            p["attn"], rms_norm(h, p["norm1"], cfg.norm_eps), st, positions,
            block_tables, starts, lengths, cached_lens, cfg,
            window=_window(cfg, kind))
        h = _mlp_residual(p, h + o, cfg)
    return rms_norm(h, params["final_norm"], cfg.norm_eps)


def prefill_paged(params, cfg: ModelConfig, state, tokens, lengths,
                  cached_lens, block_tables, slots, resume: bool = False):
    """Bucketed batched prefill straight into the paged state.

    tokens: (N, Ls) — row n holds the prompt SUFFIX from
    min(cached_lens[n], lengths[n] - 1), right-padded; lengths /
    cached_lens: (N,) int32; block_tables: (N, max_blocks) int32; slots:
    (N,) decode-slot per row (used by recurrent layers only, so unused
    here, as is `resume`). Returns (last-token logits (N, V), state)."""
    _check_paged(cfg)
    params = cast_params(params, cfg)
    N, Ls = tokens.shape
    starts = torch.minimum(cached_lens, (lengths - 1).clamp_min(0))
    positions = (starts[:, None]
                 + torch.arange(Ls, dtype=torch.int32,
                                device=tokens.device)[None, :])
    h = _prefill_layers(params, cfg, state, _embed(params, cfg, tokens),
                        positions, block_tables, starts, lengths,
                        cached_lens)
    idx = (lengths - 1 - starts).clamp(0, Ls - 1).long()
    last = h[torch.arange(N, device=h.device), idx]
    return _head(params, cfg, last), state


def decode_verify_paged(params, cfg: ModelConfig, state, tokens, positions,
                        counts, block_tables):
    """Batched K-token verify forward through the paged cache. tokens:
    (B, T) draft chains right-padded; positions: (B,) position of each
    chain's first token; counts: (B,) true chain lengths (0 = the lane
    sits out). Attention reuses the suffix-prefill path (starts =
    cached = positions, lengths = positions + counts). Returns (logits
    (B, T, V), state, snapshots) — snapshots mirror the state tree with
    None for every (attention) layer."""
    _check_paged(cfg)
    params = cast_params(params, cfg)
    B, T = tokens.shape
    pos_grid = (positions[:, None]
                + torch.arange(T, dtype=torch.int32,
                               device=tokens.device)[None, :])
    h = _prefill_layers(params, cfg, state, _embed(params, cfg, tokens),
                        pos_grid, block_tables, positions,
                        positions + counts, positions)
    snaps = {"prefix": [None] * len(cfg.prefix_pattern),
             "blocks": {f"p{pi}": None
                        for pi in range(cfg.pattern_len)}}
    return _head(params, cfg, h), state, snaps


def commit_decode_state(cfg: ModelConfig, state, snapshots, idx):
    """Commit recurrent slot state after a verify step. Attention state
    needs no commit (positions are the rollback), so with attention-only
    layers this returns `state` unchanged."""
    _check_paged(cfg)
    return state


def decode_step_paged(params, cfg: ModelConfig, state, tokens, positions,
                      block_tables):
    """One decode iteration for a slot batch. tokens / positions: (B,)
    int32; block_tables: (B, max_blocks) int32. Returns (logits (B, V),
    state)."""
    _check_paged(cfg)
    params = cast_params(params, cfg)
    h = _embed(params, cfg, tokens[:, None])
    for (kind, p), (_, st) in zip(_layers(params, cfg), _layers(state, cfg)):
        o, _ = attention.paged_decode_attention_block(
            p["attn"], rms_norm(h, p["norm1"], cfg.norm_eps), st, positions,
            block_tables, cfg, window=_window(cfg, kind))
        h = _mlp_residual(p, h + o, cfg)
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    return _head(params, cfg, h)[:, 0], state
