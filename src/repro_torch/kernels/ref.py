"""Plain PyTorch twins of the port's CUDA kernels.

Each `*_ref` computes exactly what its kernel computes (float32 math,
output in the dtype of q or x). A wrapper takes its twin for a tensor on the CPU;
`chip_smoke.py` and the CUDA-marked tests hold each kernel to its twin on
the card; the CPU tests hold each twin to the JAX package's oracles and
Pallas kernels (run in interpret mode).

Masked keys are selected out, never multiplied by zero: their K/V may hold
stale or non-finite values (a slot's partial last block, the null block)
and must add nothing. A query row with no valid key returns zeros.
"""
from __future__ import annotations

import torch


def _masked_attention(q, k, v, valid, scale):
    """q: (..., Sq, hd) f32; k/v: (..., Sk, hd) f32; valid: bool,
    broadcastable to (..., Sq, Sk). Softmax over valid keys only."""
    s = torch.einsum("...qh,...sh->...qs", q, k) * scale
    s = torch.where(valid, s, torch.full_like(s, -1e30))
    m = s.amax(-1, keepdim=True)
    p = torch.where(valid, torch.exp(s - m), torch.zeros_like(s))
    l = p.sum(-1, keepdim=True)
    v = torch.where(valid.any(-2)[..., None], v, torch.zeros_like(v))
    return torch.einsum("...qs,...sh->...qh", p, v) / l.clamp_min(1e-30)


def _gather_pool(pool, scale, tables):
    """(P, bs, KV, hd) pool through (B, M) tables -> (B, KV, M*bs, hd) f32,
    dequantized with the (P, bs, KV) scale table when one is given."""
    B = tables.shape[0]
    KV, hd = pool.shape[2:]
    x = pool[tables.long()].float().reshape(B, -1, KV, hd)
    if scale is not None:
        x = x * scale[tables.long()].reshape(B, -1, KV)[..., None]
    return x.transpose(1, 2)


def paged_attention_ref(q, k_pool, v_pool, block_tables, ctx_lens,
                        k_scale=None, v_scale=None):
    """Single-token GQA decode through a paged KV cache.

    q: (B, H, hd); k_pool/v_pool: (N, bs, KV, hd); block_tables: (B, M)
    int32; ctx_lens: (B,) int32 valid tokens (0 => zeros); k_scale /
    v_scale (optional): (N, bs, KV) float32 tables of a quantized pool.
    Returns (B, H, hd) in q's dtype."""
    B, H, hd = q.shape
    KV = k_pool.shape[2]
    k = _gather_pool(k_pool, k_scale, block_tables)      # (B, KV, S, hd)
    v = _gather_pool(v_pool, v_scale, block_tables)
    qf = q.float().reshape(B, KV, H // KV, hd)
    valid = (torch.arange(k.shape[2], device=q.device)[None, :]
             < ctx_lens[:, None])[:, None, None, :]       # (B, 1, 1, S)
    o = _masked_attention(qf, k, v, valid, hd ** -0.5)
    return o.reshape(B, H, hd).to(q.dtype)


def paged_prefill_ref(q, k_suf, v_suf, k_pool, v_pool, block_tables, starts,
                      lengths, k_scale=None, v_scale=None, window: int = 0):
    """Suffix-prefill attention over a paged cache.

    q: (N, Ls, H, hd) queries at absolute positions starts[n] + i;
    k_suf/v_suf: (N, Ls, KV, hd) fresh suffix K/V; pools (P, bs, KV, hd);
    block_tables (N, M); starts/lengths (N,). Queries attend to pool
    positions < starts and causally to suffix index < lengths - starts,
    within `window` when > 0. Returns (N, Ls, H, hd) in q's dtype."""
    N, Ls, H, hd = q.shape
    KV = k_suf.shape[2]
    dev = q.device
    kp = _gather_pool(k_pool, k_scale, block_tables)     # (N, KV, S, hd)
    vp = _gather_pool(v_pool, v_scale, block_tables)
    k = torch.cat([kp, k_suf.float().transpose(1, 2)], dim=2)
    v = torch.cat([vp, v_suf.float().transpose(1, 2)], dim=2)
    S = kp.shape[2]
    i = torch.arange(Ls, device=dev)
    qpos = starts[:, None] + i[None, :]                  # (N, Ls)
    t = torch.arange(S, device=dev)
    pool_ok = (t[None, None, :] < starts[:, None, None]).expand(N, Ls, S)
    suf_ok = ((i[None, :] <= i[:, None])[None]
              & (i[None, None, :] < (lengths - starts)[:, None, None]))
    kpos = torch.cat([t[None].expand(N, S), qpos], dim=1)  # (N, S + Ls)
    valid = torch.cat([pool_ok, suf_ok], dim=2)          # (N, Ls, S + Ls)
    if window > 0:
        valid = valid & (kpos[:, None, :] > qpos[:, :, None] - window)
    qf = q.float().reshape(N, Ls, KV, H // KV, hd).permute(0, 2, 3, 1, 4)
    o = _masked_attention(qf, k[:, :, None], v[:, :, None],
                          valid[:, None, None], hd ** -0.5)
    return o.permute(0, 3, 1, 2, 4).reshape(N, Ls, H, hd).to(q.dtype)


def flash_attention_ref(q, k, v, *, causal: bool = True):
    """q: (B, H, Sq, hd); k/v: (B, KV, Sk, hd); KV head h // (H / KV).
    Returns (B, H, Sq, hd) in q's dtype."""
    B, H, Sq, hd = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    qf = q.float().reshape(B, KV, H // KV, Sq, hd)
    kf = k.float()[:, :, None]
    vf = v.float()[:, :, None]
    if causal:
        valid = (torch.arange(Sk, device=q.device)[None, :]
                 <= torch.arange(Sq, device=q.device)[:, None])
    else:
        valid = torch.ones(Sq, Sk, dtype=torch.bool, device=q.device)
    o = _masked_attention(qf, kf, vf, valid, hd ** -0.5)
    return o.reshape(B, H, Sq, hd).to(q.dtype)


def svrg_update_ref(x, g_x, g_z, mu, w_anchor, eta: float, gamma: float):
    """One fused variance-reduced prox step (paper Alg. 1 step 2):

        x <- x - eta * (g_x - g_z + mu + gamma * (x - w_anchor))

    on 1-D vectors of one length, in float32 and in this order, rounded
    once to x's dtype; eta and gamma are Python floats."""
    xf, gx, gz, m, w = (t.float() for t in (x, g_x, g_z, mu, w_anchor))
    return (xf - eta * (gx - gz + m + gamma * (xf - w))).to(x.dtype)
