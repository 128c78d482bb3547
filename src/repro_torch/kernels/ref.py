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
                        k_scale=None, v_scale=None, window: int = 0):
    """Single-token GQA decode through a paged KV cache.

    q: (B, H, hd); k_pool/v_pool: (N, bs, KV, hd); block_tables: (B, M)
    int32; ctx_lens: (B,) int32 valid tokens (0 => zeros); k_scale /
    v_scale (optional): (N, bs, KV) float32 tables of a quantized pool;
    window > 0 keeps row b's tokens ctx_b - window .. ctx_b - 1 only.
    Returns (B, H, hd) in q's dtype."""
    B, H, hd = q.shape
    KV = k_pool.shape[2]
    k = _gather_pool(k_pool, k_scale, block_tables)      # (B, KV, S, hd)
    v = _gather_pool(v_pool, v_scale, block_tables)
    qf = q.float().reshape(B, KV, H // KV, hd)
    t = torch.arange(k.shape[2], device=q.device)[None, :]
    valid = t < ctx_lens[:, None]
    if window > 0:
        valid = valid & (t >= ctx_lens[:, None] - window)
    o = _masked_attention(qf, k, v, valid[:, None, None, :], hd ** -0.5)
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


def flash_visible(qpos, kpos, causal: bool, window: int, prefix_len: int):
    """The flash kernels' mask: key u is visible to query i when u <= i or,
    for a bidirectional prefix, both lie in it (i < prefix_len and u <
    prefix_len) (causal; every key otherwise), and, for window > 0, when
    u > i - window: the JAX model's chunked_causal_attention mask.
    qpos: (Sq, 1), kpos: (1, Sk) positions; returns (Sq, Sk) bool."""
    if causal:
        valid = kpos <= qpos
        if prefix_len > 0:
            valid = valid | ((qpos < prefix_len) & (kpos < prefix_len))
    else:
        valid = torch.ones(qpos.shape[0], kpos.shape[1], dtype=torch.bool,
                           device=qpos.device)
    if window > 0:
        valid = valid & (kpos > qpos - window)
    return valid


def flash_attention_ref(q, k, v, *, causal: bool = True, window: int = 0,
                        prefix_len: int = 0):
    """q: (B, H, Sq, hd); k/v: (B, KV, Sk, hd); KV head h // (H / KV).
    Key u is visible to query i as `flash_visible` says: u <= i (causal),
    or both in the first prefix_len positions (a bidirectional prefix),
    and, for window > 0, u > i - window (the JAX path's local-attention
    mask). Returns (B, H, Sq, hd) in q's dtype."""
    B, H, Sq, hd = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    qf = q.float().reshape(B, KV, H // KV, Sq, hd)
    kf = k.float()[:, :, None]
    vf = v.float()[:, :, None]
    kpos = torch.arange(Sk, device=q.device)[None, :]
    qpos = torch.arange(Sq, device=q.device)[:, None]
    valid = flash_visible(qpos, kpos, causal, window, prefix_len)
    o = _masked_attention(qf, kf, vf, valid, hd ** -0.5)
    return o.reshape(B, H, Sq, hd).to(q.dtype)


def flash_attention_bwd_ref(q, k, v, o, do, *, causal: bool = True,
                            window: int = 0, prefix_len: int = 0,
                            chunk: int = 256):
    """The gradient of flash_attention_ref, by the explicit flash-backward
    formulas, one chunk of `chunk` query rows at a time in float32: P
    recomputed from the scores and each row's log-sum-exp, D = rowsum(dO *
    O), dV = P^T dO, dS = P * (dO V^T - D), dQ = dS K * scale, dK = dS^T Q
    * scale, dK and dV summed over each KV head's group of query heads.
    q, o, do: (B, H, Sq, hd); k/v: (B, KV, Sk, hd); o is the forward's
    output; the mask is flash_attention_ref's. Returns (dq, dk, dv) in the
    inputs' dtype."""
    return _flash_bwd(q, k, v, o, do, causal, window, prefix_len, chunk,
                      None)


def _flash_bwd(q, k, v, o, do, causal, window, prefix_len, chunk, rnd):
    """flash_attention_bwd_ref's math; rnd, where given, rounds P and dS
    before the products that take them (the tests' emulation)."""
    B, H, Sq, hd = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    G, scale = H // KV, hd ** -0.5
    kf = k.float()[:, :, None]                      # (B, KV, 1, Sk, hd)
    vf = v.float()[:, :, None]
    kpos = torch.arange(Sk, device=q.device)[None, :]
    dq = torch.empty(B, H, Sq, hd, dtype=torch.float32, device=q.device)
    dk = torch.zeros(B, KV, Sk, hd, dtype=torch.float32, device=q.device)
    dv = torch.zeros_like(dk)
    for c0 in range(0, Sq, chunk):
        rows = slice(c0, min(c0 + chunk, Sq))
        qf, of, dof = (t[:, :, rows].float().reshape(B, KV, G, -1, hd)
                       for t in (q, o, do))
        qpos = torch.arange(rows.start, rows.stop, device=q.device)[:, None]
        valid = flash_visible(qpos, kpos, causal, window, prefix_len)
        s = torch.einsum("bkgqh,bkgsh->bkgqs", qf, kf) * scale
        s = torch.where(valid, s, torch.full_like(s, -1e30))
        m = s.amax(-1, keepdim=True)
        lse = m + torch.log(torch.where(valid, torch.exp(s - m),
                                        torch.zeros_like(s)).sum(-1, True))
        p = torch.where(valid, torch.exp(s - lse), torch.zeros_like(s))
        d = (dof * of).sum(-1, keepdim=True)
        ds = p * (torch.einsum("bkgqh,bkgsh->bkgqs", dof, vf) - d)
        if rnd is not None:
            p, ds = rnd(p), rnd(ds)
        dq[:, :, rows] = (torch.einsum("bkgqs,bkgsh->bkgqh", ds, kf)
                          * scale).reshape(B, H, -1, hd)
        dk += torch.einsum("bkgqs,bkgqh->bksh", ds, qf) * scale
        dv += torch.einsum("bkgqs,bkgqh->bksh", p, dof)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# ----------------------------------------------------------------------------
# Emulations of the attention kernels' orders of work, for the tests only:
# they fix on the CPU what the kernels' designs do to the numbers (how the
# token axis is split and merged, where P is rounded), not what the kernels
# compute, which the twins above state.
# ----------------------------------------------------------------------------

def paged_attention_split_ref(q, k_pool, v_pool, block_tables, ctx_lens,
                              k_scale=None, v_scale=None, *, chunk: int,
                              window: int = 0):
    """paged_attention as csrc/paged_attention.cu splits it: each row's
    first ctx tokens in chunks of `chunk`, each chunk's unnormalised
    (m, l, acc) on its own, merged in split order; a row with one chunk
    is acc / l. With window > 0 the chunks stay aligned to token 0, those
    that end at or below ctx - window are left out, and the first live
    one starts at ctx - window. Rows are computed one by one on shapes
    fixed by their own ctx, so a row's bits cannot depend on the rest of
    the batch. Float32 math; returns (B, H, hd) in q's dtype."""
    B, H, hd = q.shape
    KV = k_pool.shape[2]
    k = _gather_pool(k_pool, k_scale, block_tables)      # (B, KV, S, hd)
    v = _gather_pool(v_pool, v_scale, block_tables)
    qf = q.float().reshape(B, KV, H // KV, hd)
    out = torch.zeros(B, KV, H // KV, hd, device=q.device)
    for b in range(B):
        ctx = min(int(ctx_lens[b]), k.shape[2])
        lo = max(0, ctx - window) if window > 0 else 0
        parts = []
        for c0 in range(0, ctx, chunk):
            if c0 + chunk <= lo:
                continue
            a, e = max(c0, lo), min(c0 + chunk, ctx)
            kc, vc = k[b, :, a:e], v[b, :, a:e]
            s = torch.einsum("kgh,ksh->kgs", qf[b], kc) * hd ** -0.5
            m = s.amax(-1, keepdim=True)
            p = torch.exp(s - m)
            parts.append((m, p.sum(-1, keepdim=True),
                          torch.einsum("kgs,ksh->kgh", p, vc)))
        if len(parts) == 1:
            m, l, acc = parts[0]
            out[b] = acc / l.clamp_min(1e-30)
        elif parts:
            mx = parts[0][0]
            for m, _, _ in parts[1:]:
                mx = torch.maximum(mx, m)
            L, A = torch.zeros_like(mx), torch.zeros_like(out[b])
            for m, l, acc in parts:
                a = torch.exp(m - mx)
                L = L + a * l
                A = A + a * acc
            out[b] = A / L.clamp_min(1e-30)
    return out.reshape(B, H, hd).to(q.dtype)


def flash_attention_tiled_ref(q, k, v, *, causal: bool = True,
                              window: int = 0, prefix_len: int = 0,
                              key_tile: int, p_split: bool):
    """flash_attention as the 16-bit tensor-core kernel orders it: keys in
    tiles of `key_tile`, an online softmax across tiles in float32, and P
    rounded to q's dtype before P.V, either once (p_split=False) or as a
    hi + lo pair of two roundings whose sum carries P to ~16 bits
    (p_split=True, what the kernel does). Returns (B, H, Sq, hd) in q's
    dtype."""
    B, H, Sq, hd = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    dt = q.dtype
    qf = q.float().reshape(B, KV, H // KV, Sq, hd)
    qpos = torch.arange(Sq, device=q.device)[:, None]
    m = torch.full((B, KV, H // KV, Sq, 1), -1e30, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros_like(qf)
    for u0 in range(0, Sk, key_tile):
        kt = k[:, :, u0:u0 + key_tile].float()[:, :, None]
        vt = v[:, :, u0:u0 + key_tile].float()[:, :, None]
        kpos = torch.arange(u0, u0 + kt.shape[-2], device=q.device)[None, :]
        valid = flash_visible(qpos, kpos, causal, window, prefix_len)
        s = torch.einsum("...qh,...sh->...qs", qf, kt) * hd ** -0.5
        s = torch.where(valid, s, torch.full_like(s, -1e30))
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.where(valid, torch.exp(s - m_new), torch.zeros_like(s))
        l = l * alpha + p.sum(-1, keepdim=True)
        hi = p.to(dt).float()
        pr = hi + (p - hi).to(dt).float() if p_split else hi
        acc = acc * alpha + torch.einsum("...qs,...sh->...qh", pr, vt)
        m = m_new
    o = acc / l.clamp_min(1e-30)
    return o.reshape(B, H, Sq, hd).to(dt)


def flash_attention_bwd_split_ref(q, k, v, o, do, *, causal: bool = True,
                                  window: int = 0, prefix_len: int = 0,
                                  p_split: bool):
    """flash_attention_bwd_ref with the roundings of the 16-bit tensor-core
    backward (csrc/flash_attention_bwd.cu): Q, K, V and dO go to the
    tensor cores exact, and P (for dV = P^T dO) and dS (for dQ = dS K and
    dK = dS^T Q) are rounded to q's dtype first, either once
    (p_split=False) or as a hi + lo pair of two roundings (p_split=True,
    what the kernel does); products and sums in float32. Returns (dq, dk,
    dv) in the inputs' dtype."""
    dt = q.dtype

    def rnd(x):
        hi = x.to(dt).float()
        return hi + (x - hi).to(dt).float() if p_split else hi

    return _flash_bwd(q, k, v, o, do, causal, window, prefix_len, 256, rnd)


def paged_prefill_tiled_ref(q, k_suf, v_suf, k_pool, v_pool, block_tables,
                            starts, lengths, k_scale=None, v_scale=None,
                            window: int = 0, *, key_tile: int,
                            p_split: bool):
    """paged_prefill as the 16-bit tensor-core kernel orders it: the pool
    positions in tiles of `key_tile`, then the suffix in tiles of
    `key_tile`, an online softmax across tiles in float32, and P rounded
    to q's dtype before P.V, once (p_split=False) or as a hi + lo pair
    (p_split=True, what the kernel does). V rows no query of the row may
    see are zeroed, as the kernel zeroes them in shared memory. Over an
    int8 / fp8 pool the codes enter the products as they are (exact in
    q's dtype), each score column of a pool tile is multiplied by its k
    scale before the softmax, and each column of P by its v scale before
    the rounding (the sum l takes P unscaled), as the kernel does; the
    scales of V rows no query may see are zeroed with them. Returns (N,
    Ls, H, hd) in q's dtype."""
    N, Ls, H, hd = q.shape
    KV = k_suf.shape[2]
    dt, dev = q.dtype, q.device
    kp = _gather_pool(k_pool, None, block_tables)        # (N, KV, S, hd)
    vp = _gather_pool(v_pool, None, block_tables)
    S = kp.shape[2]
    if k_scale is not None:                              # (N, KV, S)
        ksc, vsc = (t[block_tables.long()].reshape(N, S, KV).transpose(1, 2)
                    for t in (k_scale, v_scale))
    ks, vs = k_suf.float().transpose(1, 2), v_suf.float().transpose(1, 2)
    qf = q.float().reshape(N, Ls, KV, H // KV, hd).permute(0, 2, 3, 1, 4)
    i = torch.arange(Ls, device=dev)
    qpos = starts[:, None] + i[None, :]                  # (N, Ls)
    m = torch.full((N, KV, H // KV, Ls, 1), -1e30, device=dev)
    l = torch.zeros_like(m)
    acc = torch.zeros_like(qf)
    tiles = []
    # pool tiles past every row's starts are skipped, as the kernel skips
    # them: a tile with no valid key leaves m, l and acc bit for bit as
    # they were
    s_end = min(S, int(starts.max())) if N else 0
    for t0 in range(0, s_end, key_tile):
        t = torch.arange(t0, min(t0 + key_tile, S), device=dev)
        ok = (t[None, None, :] < starts[:, None, None]).expand(N, Ls, -1)
        if window > 0:
            ok = ok & (t[None, None, :] > qpos[:, :, None] - window)
        sc = None if k_scale is None else (ksc[:, :, t], vsc[:, :, t])
        tiles.append((kp[:, :, t], vp[:, :, t], sc, ok))
    for u0 in range(0, Ls, key_tile):
        u = torch.arange(u0, min(u0 + key_tile, Ls), device=dev)
        ok = ((u[None, None, :] <= i[None, :, None])
              & (u[None, None, :] < (lengths - starts)[:, None, None]))
        if window > 0:
            ok = ok & (u[None, None, :] > i[None, :, None] - window)
        tiles.append((ks[:, :, u], vs[:, :, u], None, ok))
    for kt, vt, sc, ok in tiles:
        valid = ok[:, None, None]                        # (N, 1, 1, Ls, n)
        seen = ok.any(1)[:, None, :]                     # (N, 1, n)
        vt = torch.where(seen[..., None], vt, torch.zeros_like(vt))
        s = torch.einsum("nkgqh,nksh->nkgqs", qf, kt)
        if sc is not None:
            s = s * sc[0][:, :, None, None, :]
        s = s * hd ** -0.5
        s = torch.where(valid, s, torch.full_like(s, -1e30))
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.where(valid, torch.exp(s - m_new), torch.zeros_like(s))
        l = l * alpha + p.sum(-1, keepdim=True)
        if sc is not None:
            t_v = torch.where(seen, sc[1], torch.zeros_like(sc[1]))
            p = p * t_v[:, :, None, None, :]
        hi = p.to(dt).float()
        pr = hi + (p - hi).to(dt).float() if p_split else hi
        acc = acc * alpha + torch.einsum("nkgqs,nksh->nkgqh", pr, vt)
        m = m_new
    o = (acc / l.clamp_min(1e-30)).permute(0, 3, 1, 2, 4)
    return o.reshape(N, Ls, H, hd).to(dt)


def rwkv6_scan_split_ref(r, k, v, w, u, s0=None):
    """rwkv6_scan as csrc/rwkv6_scan.cu orders it: the kernel splits each
    value column's key rows over lanes but sums y over them in one serial
    chain, so here y_j of a step adds its terms r_i (S_ij + u_i k_i v_j) one
    by one in float32, i = 0 .. N - 1. The state is updated exactly as in
    rwkv6_scan_ref. Returns (y (B, H, T, N) in r's dtype, S_T (B, H, N, N)
    float32)."""
    B, H, T, N = r.shape
    S = (torch.zeros(B, H, N, N, dtype=torch.float32, device=r.device)
         if s0 is None else s0.float())
    rf, kf, vf, wf = (t.float() for t in (r, k, v, w))
    uf = u.float()[None, :, :, None]
    ys = []
    for t in range(T):
        kv = kf[:, :, t, :, None] * vf[:, :, t, None, :]
        term = rf[:, :, t, :, None] * (S + uf * kv)     # (B, H, N, N)
        acc = torch.zeros(B, H, N, device=r.device)
        for i in range(N):
            acc = acc + term[:, :, i]
        ys.append(acc)
        S = wf[:, :, t, :, None] * S + kv
    y = (torch.stack(ys, dim=2) if ys
         else torch.empty(B, H, 0, N, device=r.device))
    return y.to(r.dtype), S


def svrg_update_ref(x, g_x, g_z, mu, w_anchor, eta: float, gamma: float):
    """One fused variance-reduced prox step (paper Alg. 1 step 2):

        x <- x - eta * (g_x - g_z + mu + gamma * (x - w_anchor))

    on 1-D vectors of one length, in float32 and in this order, rounded
    once to x's dtype; eta and gamma are Python floats."""
    xf, gx, gz, m, w = (t.float() for t in (x, g_x, g_z, mu, w_anchor))
    return (xf - eta * (gx - gz + m + gamma * (xf - w))).to(x.dtype)


def rglru_scan_ref(a, x, h0=None):
    """Gated linear recurrence h_t = a_t * h_{t-1} + x_t per channel.

    a, x: (B, T, C) of one float dtype; h0: (B, C) float32 or None (zeros).
    The state is float32; each step is a float32 multiply then a float32
    add, each rounded on its own (no fused multiply-add), as the kernel
    does them. Returns (h_seq (B, T, C) in x's dtype, h_T (B, C) float32)."""
    B, T, C = a.shape
    h = (torch.zeros(B, C, dtype=torch.float32, device=a.device)
         if h0 is None else h0.float())
    af, xf = a.float(), x.float()
    hs = []
    for t in range(T):
        h = af[:, t] * h + xf[:, t]
        hs.append(h)
    h_seq = (torch.stack(hs, dim=1) if hs
             else torch.empty(B, 0, C, device=a.device))
    return h_seq.to(x.dtype), h


def rwkv6_scan_ref(r, k, v, w, u, s0=None, return_states=False):
    """RWKV6 recurrence with a float32 (N, N) state per (batch, head):

        y_t = r_t (S_{t-1} + diag(u) k_t^T v_t),  S_t = diag(w_t) S_{t-1}
                                                        + k_t^T v_t

    r, k, v: (B, H, T, N) of one float dtype; w: (B, H, T, N) float32 decays;
    u: (H, N) float32 bonus; s0: (B, H, N, N) float32 or None (zeros). In
    float32, each step in this order, as the kernel computes it. Returns (y
    (B, H, T, N) in r's dtype, S_T (B, H, N, N) float32), and with
    return_states also S_steps (B, H, T, N, N) float32, the state after
    each step (S_steps[:, :, t] = S_t)."""
    B, H, T, N = r.shape
    S = (torch.zeros(B, H, N, N, dtype=torch.float32, device=r.device)
         if s0 is None else s0.float())
    rf, kf, vf, wf = (t.float() for t in (r, k, v, w))
    uf = u.float()[None, :, :, None]
    ys, states = [], []
    for t in range(T):
        kv = kf[:, :, t, :, None] * vf[:, :, t, None, :]
        ys.append(torch.einsum("bhk,bhkv->bhv", rf[:, :, t], S + uf * kv))
        S = wf[:, :, t, :, None] * S + kv
        states.append(S)
    y = (torch.stack(ys, dim=2) if ys
         else torch.empty(B, H, 0, N, device=r.device))
    if return_states:
        steps = (torch.stack(states, dim=2) if states
                 else torch.empty(B, H, 0, N, N, device=r.device))
        return y.to(r.dtype), S, steps
    return y.to(r.dtype), S


def rglru_scan_bwd_ref(a, h_seq, h0, dh_seq, dh_T):
    """The gradient of rglru_scan, a reverse scan in float32. The forward
    h_t = a_t h_{t-1} + x_t (h_{-1} = h0, zeros if None) gives, with g_t =
    dL/dh_t in total and g_T = 0 past the end,

        g_t   = dh_seq_t + a_{t+1} g_{t+1}     (g_{T-1} = dh_seq_{T-1} + dh_T)
        dx_t  = g_t
        da_t  = g_t h_{t-1}
        dh0   = a_0 g_0                        (dh_T when T = 0)

    a: (B, T, C); h_seq: the forward's (B, T, C) output; h0 / dh_T: (B, C)
    float32 or None (zeros); dh_seq: (B, T, C). Each step is a float32 add
    then two float32 multiplies, each rounded on its own, as the kernel
    does them. Returns (da in a's dtype, dx in h_seq's dtype, dh0 (B, C)
    float32)."""
    B, T, C = a.shape
    af, hf, dhf = a.float(), h_seq.float(), dh_seq.float()
    carry = (torch.zeros(B, C, dtype=torch.float32, device=a.device)
             if dh_T is None else dh_T.float())
    hprev0 = (torch.zeros(B, C, dtype=torch.float32, device=a.device)
              if h0 is None else h0.float())
    da = torch.empty(B, T, C, dtype=torch.float32, device=a.device)
    dx = torch.empty_like(da)
    for t in range(T - 1, -1, -1):
        g = dhf[:, t] + carry
        dx[:, t] = g
        da[:, t] = g * (hf[:, t - 1] if t > 0 else hprev0)
        carry = af[:, t] * g
    return da.to(a.dtype), dx.to(h_seq.dtype), carry


def rwkv6_scan_bwd_ref(r, k, v, w, u, s0, dy, dS_T):
    """The gradient of rwkv6_scan in float32, in explicit formulas. With
    S_{t-1} the state before step t (S_{-1} = s0, zeros if None) and G_t
    = dL/dS_t in total, starting from G_{T-1} = dS_T (zeros if None), the
    walk t = T - 1 .. 0 takes

        dr_t = (S_{t-1} + diag(u) k_t^T v_t) dy_t
        dk_t = r_t * u * (v_t . dy_t) + G_t v_t
        dv_t = (sum_i r_ti u_i k_ti) dy_t + k_t G_t
        du  += r_t * k_t * (v_t . dy_t)          (summed over B and T)
        dw_t = rowsum(G_t * S_{t-1})
        G_{t-1} = diag(w_t) G_t + r_t^T dy_t

    and ds0 = G_{-1}. The states S_{t-1} are the forward's, recomputed
    from s0 (rwkv6_scan_ref's per-step states), never recovered by
    dividing by w. r, k, v, dy: (B, H, T, N) of one float dtype; w: (B,
    H, T, N) float32; u: (H, N) float32; s0 / dS_T: (B, H, N, N) float32
    or None. Returns (dr, dk, dv in r's dtype, dw (B, H, T, N), du (H, N),
    ds0 (B, H, N, N) float32)."""
    B, H, T, N = r.shape
    dev = r.device
    s_in = (torch.zeros(B, H, N, N, dtype=torch.float32, device=dev)
            if s0 is None else s0.float())
    _, _, steps = rwkv6_scan_ref(r, k, v, w, u, s0, return_states=True)
    rf, kf, vf, wf, dyf = (t.float() for t in (r, k, v, w, dy))
    uf = u.float()[None]                                  # (1, H, N)
    G = (torch.zeros(B, H, N, N, dtype=torch.float32, device=dev)
         if dS_T is None else dS_T.float().clone())
    dr, dk, dv, dw = (torch.empty(B, H, T, N, dtype=torch.float32,
                                  device=dev) for _ in range(4))
    du = torch.zeros(B, H, N, dtype=torch.float32, device=dev)
    for t in range(T - 1, -1, -1):
        rt, kt, vt, wt, dyt = (x[:, :, t] for x in (rf, kf, vf, wf, dyf))
        S_prev = steps[:, :, t - 1] if t > 0 else s_in
        vd = (vt * dyt).sum(-1, keepdim=True)             # (B, H, 1)
        bonus = (uf * kt)[..., :, None] * vt[..., None, :]
        dr[:, :, t] = torch.einsum("bhij,bhj->bhi", S_prev + bonus, dyt)
        dk[:, :, t] = rt * uf * vd + torch.einsum("bhij,bhj->bhi", G, vt)
        dv[:, :, t] = ((rt * uf * kt).sum(-1, keepdim=True) * dyt
                       + torch.einsum("bhi,bhij->bhj", kt, G))
        du = du + rt * kt * vd
        dw[:, :, t] = (G * S_prev).sum(-1)
        G = wt[..., :, None] * G + rt[..., :, None] * dyt[..., None, :]
    return (dr.to(r.dtype), dk.to(r.dtype), dv.to(r.dtype), dw, du.sum(0),
            G)
