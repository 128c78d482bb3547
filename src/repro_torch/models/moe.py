"""Top-k routed Mixture-of-Experts with static capacity dispatch (PyTorch
port of `repro.models.moe`).

Routing is the JAX module's, step for step (`_route_topk`): k rounds of
argmax over the router's softmax (the first expert on ties), each round
masking its pick; slots assigned token-major over the k rounds, so a
token's slots depend only on the tokens before it (causal); a token past
an expert's capacity takes the overflow slot E * C, is dropped, and its
gate is zeroed. Capacity is max(1, int(chunk * k * capacity_factor / E))
per batch row (a GShard group) per sequence chunk of min(moe_chunk, S)
tokens, the tail zero-padded.

The JAX module moves tokens with one-hot dispatch / combine einsums. Here
an index gather fills the (G, E, C, D) slot tensor and an index gather
reads it back: a slot holds at most one token and the overflow slot reads
as zeros, so both compute what the one-hot products compute. The experts
are batched matrix products over the expert axis (torch.bmm), large GEMMs
that JAX also computes outside any Pallas kernel.

Two properties of the reference are kept, and callers should know them:
  * capacity follows the length a call routes, so a bucketed or suffix
    prefill and a speculative verify may drop tokens that token-by-token
    decode (one token a call, capacity 1, never a drop) would route;
  * the gated experts apply silu whenever a gate exists, for
    mlp_kind="geglu" (grok-1) as for "swiglu" (`repro/models/moe.py:
    131-134`); the ungated ones apply tanh-approximate gelu.

The JAX module's sharding hooks (`dctx.get_moe_gather_specs`,
`get_moe_xe_spec`) are None on one device and have no counterpart.
"""
from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

from repro_torch import prng
from repro_torch.models.layers import init_dense


def _expert_stack(key, shape, scale, dtype):
    """JAX's (normal(key, shape) * scale).astype(dtype): the draw and the
    product in float32, then the cast. Scaled in place, so a full-width
    stack holds one float32 copy while it is made."""
    return prng.normal(key, shape).mul_(scale).to(dtype)


def init_moe(key, d_model, d_ff, n_experts, dtype, kind: str = "swiglu"):
    kr, k1, k2, k3 = prng.split(key, 4)
    E = n_experts
    p = {"router": init_dense(kr, d_model, E, torch.float32),
         "w_up": _expert_stack(k2, (E, d_model, d_ff), d_model ** -0.5,
                               dtype),
         "w_down": _expert_stack(k3, (E, d_ff, d_model), d_ff ** -0.5,
                                 dtype)}
    if kind in ("swiglu", "geglu"):
        p["w_gate"] = _expert_stack(k1, (E, d_model, d_ff), d_model ** -0.5,
                                    dtype)
    return p


def _route_topk(probs, k: int, capacity: int):
    """probs: (..., N, E), leading dims the groups. Returns (slots (..., k,
    N) int64 in [0, E*C], where E*C is the overflow slot; gates (..., k,
    N) in probs' dtype, zero on overflow; the routed fraction of each
    expert (..., E) float32, divided by N)."""
    N, E = probs.shape[-2:]
    lead = probs.shape[:-2]
    g = probs
    idxs, gate_list = [], []
    for _ in range(k):
        idx = g.argmax(-1)                                 # (..., N)
        gate_list.append(g.gather(-1, idx[..., None])[..., 0])
        idxs.append(idx)
        g = g * (1 - F.one_hot(idx, E).to(g.dtype))        # mask the pick
    # token-major interleaving of the k rounds: the slot a token gets
    # depends only on the tokens before it
    idx_tok_major = torch.stack(idxs, -1).reshape(*lead, N * k)
    oh_all = F.one_hot(idx_tok_major, E)                   # (..., N*k, E)
    pos_all = oh_all.cumsum(-2) - 1
    pos = pos_all.gather(-1, idx_tok_major[..., None])[..., 0]
    ok_all = pos < capacity
    slot_all = torch.where(ok_all, idx_tok_major * capacity + pos,
                           E * capacity)
    slots = slot_all.reshape(*lead, N, k).transpose(-1, -2)
    ok = ok_all.reshape(*lead, N, k).transpose(-1, -2)
    gates = torch.stack(gate_list, -2) * ok.to(probs.dtype)
    routed = (oh_all * ok_all[..., None]).sum(-2).float()
    return slots, gates, routed / N


class RoutingTally:
    """Token-expert assignments that moe_block routed, and how many of them
    it dropped past capacity, summed over the calls made while the tally
    is active (`with moe.tally() as t:`). Only tokens marked valid count
    (a prefill's bucket padding does not). The sums stay on the device
    until read. With margins=True it also keeps, for each call, each
    group's (batch row's) smallest routing margin over its valid tokens:
    the k-th largest router probability minus the (k+1)-th, how far the
    choice of experts is from a tie (+inf for a row with no valid token)."""

    def __init__(self, margins: bool = False):
        self.assigned = 0
        self.dropped = 0
        self.row_margins = [] if margins else None

    def add(self, slots, overflow: int, valid, probs):
        """slots: (G, k, n); valid: (G, n) bool; probs: (G, n, E)."""
        v = valid[:, None, :].expand_as(slots)
        self.assigned = self.assigned + v.sum()
        self.dropped = self.dropped + ((slots == overflow) & v).sum()
        if self.row_margins is not None:
            k = slots.shape[1]
            top = probs.topk(k + 1, dim=-1).values
            gap = (top[..., k - 1] - top[..., k]).masked_fill(~valid,
                                                                math.inf)
            self.row_margins.append(gap.amin(-1))

    def read(self):
        """(assigned, dropped) as ints."""
        return int(self.assigned), int(self.dropped)


_TALLY = None


@contextlib.contextmanager
def tally(margins: bool = False):
    """Count moe_block's routed and dropped assignments while active (and
    with margins=True each call's routing margins by row)."""
    global _TALLY
    prev, _TALLY = _TALLY, RoutingTally(margins)
    try:
        yield _TALLY
    finally:
        _TALLY = prev


def _experts(params, xe):
    """xe: (E, T, D) tokens per expert -> (E, T, D)."""
    if "w_gate" in params:
        # silu for every gated kind, geglu included: the reference's choice
        h = F.silu(torch.bmm(xe, params["w_gate"])) \
            * torch.bmm(xe, params["w_up"])
    else:
        h = F.gelu(torch.bmm(xe, params["w_up"]), approximate="tanh")
    return torch.bmm(h, params["w_down"])


def _one_chunk(params, xi, E: int, k: int, C: int, valid):
    """xi: (G, n, D), the group dim the batch rows. Returns (y (G, n, D),
    aux, zloss)."""
    G, n, D = xi.shape
    logits = xi.float() @ params["router"].float()            # (G, n, E)
    probs = torch.softmax(logits, -1)
    slots, gates, routed = _route_topk(probs, k, C)
    aux = E * (routed.mean(0) * probs.mean((0, 1))).sum()
    zloss = (torch.logsumexp(logits, -1) ** 2).mean()
    if _TALLY is not None:
        _TALLY.add(slots, E * C, valid, probs)
    rows = torch.arange(G, device=xi.device)
    # dispatch: the token in each slot (n, a zero row, for an empty one);
    # overflow picks land in column E*C, which no expert reads
    src = torch.full((G, E * C + 1), n, dtype=torch.long, device=xi.device)
    tok = torch.arange(n, device=xi.device).expand(G, k, n)
    src[rows[:, None, None].expand(G, k, n), slots] = tok
    x_ext = torch.cat([xi, xi.new_zeros(G, 1, D)], 1)        # (G, n+1, D)
    xe = x_ext[rows[:, None], src[:, :E * C]]                # (G, E*C, D)
    xe = xe.reshape(G, E, C, D).transpose(0, 1).reshape(E, G * C, D)
    ye = _experts(params, xe)
    ye = ye.reshape(E, G, C, D).transpose(0, 1).reshape(G, E * C, D)
    ye = torch.cat([ye, ye.new_zeros(G, 1, D)], 1)           # overflow: 0
    # combine: each token's k slots weighted by its gates, cast to x's
    # dtype as the reference casts them, summed in float32, rounded once
    picked = ye[rows[:, None, None], slots]                  # (G, k, n, D)
    y = (gates.to(xi.dtype).float()[..., None] * picked.float()).sum(1)
    return y.to(xi.dtype), aux, zloss


def moe_block(params, x, cfg, *, kind: str = "swiglu", n_valid=None):
    """x: (B, S, D) -> ((B, S, D), {"moe_aux", "moe_zloss"}), chunked over
    S. `kind` is the config's mlp_kind, which the reference takes and does
    not read (the params' keys choose the expert MLP). n_valid: (B,) the
    real tokens of each row (its first n_valid[b]; None: all S), read only
    by an active tally()."""
    del kind
    B, S, D = x.shape
    E, k = cfg.n_experts, cfg.experts_per_token
    chunk = min(cfg.moe_chunk, S)
    n_chunks = -(-S // chunk)
    pad = n_chunks * chunk - S
    valid = None
    if _TALLY is not None:
        pos = torch.arange(n_chunks * chunk, device=x.device)
        valid = pos[None, :] < (torch.full((B,), S, device=x.device)
                                if n_valid is None else n_valid)[:, None]
    if pad:
        x = F.pad(x, (0, 0, 0, pad))
    capacity = max(1, int(chunk * k * cfg.capacity_factor / E))
    ys, auxs, zs = [], [], []
    for c in range(n_chunks):
        sl = slice(c * chunk, (c + 1) * chunk)
        y, aux, z = _one_chunk(params, x[:, sl], E, k, capacity,
                               None if valid is None else valid[:, sl])
        ys.append(y)
        auxs.append(aux)
        zs.append(z)
    y = torch.cat(ys, 1)[:, :S]
    return y, {"moe_aux": torch.stack(auxs).mean(),
               "moe_zloss": torch.stack(zs).mean()}
