"""Recurrent token mixers (PyTorch port of `repro.models.recurrent`):
RWKV6 ("Finch") and RG-LRU (RecurrentGemma).

Both run in sequence form: lm.forward and lm.prefill run them over the
prompt, and each decode step runs them with S = 1 from the carried state.
The serving engine's speculative verify runs them over a draft chain with
return_states=True, which also returns the state after every step (index
0 the input state), the snapshots a rejected draft rolls back to.
The RWKV6 time mix's recurrence goes through the `rwkv6_scan` kernel
wrapper and the RG-LRU block's through `rglru_scan` (each the CUDA kernel on
CUDA tensors, its plain twin on CPU tensors).

The casts follow the JAX module one for one. RWKV6: r, k, v and g stay in
the activation dtype, the decay adds in float32 and w = exp(-exp(d)) is
float32, the (H, hd, hd) state is float32, the group norm runs in float32
and is cast back. RWKV6 fidelity notes as in the JAX module: data-dependent
decay through a LoRA on the token-shifted input and the per-head bonus u;
one learned static token-shift mix per projection.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch import prng
from repro_torch.kernels import rglru_scan, rwkv6_scan
from repro_torch.models.layers import init_dense

_RG_C = 8.0


# ----------------------------------------------------------------------------
# RWKV6 time mix
# ----------------------------------------------------------------------------

def init_rwkv(key, d_model, n_heads, head_dim, dtype, lora_rank: int = 32):
    """The JAX time mix's params, drawn from `key` as JAX draws them."""
    ks = prng.split(key, 10)
    dh = n_heads * head_dim
    dev = key.device
    return {
        "w_r": init_dense(ks[0], d_model, dh, dtype),
        "w_k": init_dense(ks[1], d_model, dh, dtype),
        "w_v": init_dense(ks[2], d_model, dh, dtype),
        "w_g": init_dense(ks[3], d_model, dh, dtype),
        "w_o": init_dense(ks[4], dh, d_model, dtype),
        # static token-shift mixes (one per projection r, k, v, g, w)
        "mix": (prng.uniform(ks[5], (5, d_model)) * 0.5).to(dtype),
        # data-dependent decay: w_t = exp(-exp(decay_base + lora))
        "decay_base": torch.zeros(dh, dtype=dtype, device=dev),
        "decay_A": init_dense(ks[6], d_model, lora_rank, dtype),
        "decay_B": init_dense(ks[7], lora_rank, dh, dtype, scale=0.01),
        "bonus_u": (prng.normal(ks[8], (n_heads, head_dim)) * 0.1).to(dtype),
        "ln_scale": torch.ones(dh, dtype=dtype, device=dev),
    }


def _shift_mix(x, x_prev, mix):
    return x + (x_prev - x) * mix


def _rwkv_projections(params, x, x_prev, n_heads, head_dim):
    """x, x_prev: (B, S, D), x_prev the token-shifted input. Returns r, k,
    v (B, S, H, hd) and g (B, S, H * hd) in x's dtype, w (B, S, H, hd)
    float32."""
    mix = params["mix"].to(x.dtype)
    B, S, _ = x.shape
    shp = (B, S, n_heads, head_dim)
    r = (_shift_mix(x, x_prev, mix[0]) @ params["w_r"]).reshape(shp)
    k = (_shift_mix(x, x_prev, mix[1]) @ params["w_k"]).reshape(shp)
    v = (_shift_mix(x, x_prev, mix[2]) @ params["w_v"]).reshape(shp)
    g = F.silu(_shift_mix(x, x_prev, mix[3]) @ params["w_g"])
    lora = torch.tanh(_shift_mix(x, x_prev, mix[4]) @ params["decay_A"]) \
        @ params["decay_B"]
    d = params["decay_base"].float() + lora.float()
    w = torch.exp(-torch.exp(d)).reshape(shp)           # in (0, 1), fp32
    return r, k, v, g, w


def _rwkv_group_norm(y, scale, n_heads, head_dim, eps=1e-5):
    B, S = y.shape[:2]
    yf = y.reshape(B, S, n_heads, head_dim).float()
    mean = yf.mean(-1, keepdim=True)
    var = yf.var(-1, unbiased=False, keepdim=True)
    yf = (yf - mean) * torch.rsqrt(var + eps)
    return (yf.reshape(B, S, -1) * scale.float()).to(y.dtype)


def _token_shift(x, shift):
    """[shift, x_0, ..., x_{S-2}]: each token's predecessor, (B, S, D)."""
    return torch.cat([shift[:, None].to(x.dtype), x[:, :-1]], dim=1)


def _last_valid(x, lengths):
    """x: (B, S, D) -> (B, D) rows gathered at lengths - 1 (clipped)."""
    idx = (lengths.long() - 1).clamp(0, x.shape[1] - 1)
    return x[torch.arange(x.shape[0], device=x.device), idx]


def _valid(lengths, S, device):
    return torch.arange(S, device=device)[None, :] < lengths[:, None]


def _shift_snapshots(shift, x):
    """(S + 1, B, D): the token-shift state after t tokens, t = 0 .. S (the
    input state, then each token)."""
    return torch.cat([shift[None].to(x.dtype), x.transpose(0, 1)], dim=0)


def rwkv_seq(params, x, cfg, state=None, lengths=None,
             return_states=False):
    """RWKV6 time mix, sequence form. x: (B, S, D); state: {"shift": (B, D)
    last token, "S": (B, H, hd, hd) float32} or None (zeros). Returns
    (out (B, S, D), new state).

    lengths: optional (B,) true lengths of right-padded rows: padded steps
    leave the recurrence untouched (k zeroed, decay 1) and the shift state
    is each row's true last token, so the final state equals an unpadded
    per-row run's.

    return_states=True also returns snapshots {"shift": (S+1, B, D), "S":
    (S+1, B, H, hd, hd) float32}, index t the state after t tokens (0: the
    input state), as the JAX module's; the S steps come from the scan
    kernel's per-step output. Entries past a row's length are not a state
    of that row."""
    B, S, D = x.shape
    H, hd = cfg.n_heads, cfg.head_dim
    if state is None:
        state = {"shift": torch.zeros(B, D, dtype=x.dtype, device=x.device),
                 "S": torch.zeros(B, H, hd, hd, dtype=torch.float32,
                                  device=x.device)}
    r, k, v, g, w = _rwkv_projections(params, x, _token_shift(
        x, state["shift"]), H, hd)
    if lengths is not None:
        valid = _valid(lengths, S, x.device)[..., None, None]
        k = k * valid.to(k.dtype)
        w = torch.where(valid, w, torch.ones_like(w))
    s0 = state["S"].float().contiguous()
    args = tuple(t.transpose(1, 2).contiguous() for t in (r, k, v, w)) + (
        params["bonus_u"].float().contiguous(), s0)
    if return_states:
        y, S_fin, steps = rwkv6_scan(*args, return_states=True)
    else:
        y, S_fin = rwkv6_scan(*args)
    y = y.transpose(1, 2).reshape(B, S, H * hd)
    y = _rwkv_group_norm(y, params["ln_scale"], H, hd) * g
    out = y @ params["w_o"]
    shift = x[:, -1] if lengths is None else _last_valid(x, lengths)
    new_state = {"shift": shift, "S": S_fin}
    if return_states:
        snaps = {"shift": _shift_snapshots(state["shift"], x),
                 "S": torch.cat([s0[None], steps.permute(2, 0, 1, 3, 4)],
                                dim=0)}
        return out, new_state, snaps
    return out, new_state


def rwkv_step(params, x, cfg, state):
    """Single-token decode. x: (B, 1, D)."""
    return rwkv_seq(params, x, cfg, state=state)


def init_rwkv_channel_mix(key, d_model, d_ff, dtype):
    """The JAX channel mix's params, drawn from `key` as JAX draws them."""
    k1, k2, k3, k4 = prng.split(key, 4)
    return {"w_k": init_dense(k1, d_model, d_ff, dtype),
            "w_v": init_dense(k2, d_ff, d_model, dtype),
            "w_r": init_dense(k3, d_model, d_model, dtype),
            "mix": (prng.uniform(k4, (2, d_model)) * 0.5).to(dtype)}


def rwkv_channel_mix(params, x, shift_state=None, lengths=None,
                     return_states=False):
    """RWKV channel mix (relu^2). x: (B, S, D); shift_state: (B, D) or None
    (zeros). Returns (y, last token); with `lengths` the shift state is
    each row's true last token. return_states=True also returns the
    (S+1, B, D) shift snapshots (index t: the state after t tokens)."""
    B, S, D = x.shape
    if shift_state is None:
        shift_state = torch.zeros(B, D, dtype=x.dtype, device=x.device)
    x_prev = _token_shift(x, shift_state)
    mix = params["mix"].to(x.dtype)
    k = torch.square(F.relu(_shift_mix(x, x_prev, mix[0]) @ params["w_k"]))
    y = torch.sigmoid(_shift_mix(x, x_prev, mix[1]) @ params["w_r"]) \
        * (k @ params["w_v"])
    shift = x[:, -1] if lengths is None else _last_valid(x, lengths)
    if return_states:
        return y, shift, _shift_snapshots(shift_state, x)
    return y, shift


# ----------------------------------------------------------------------------
# RG-LRU (Griffin / RecurrentGemma recurrent block)
# ----------------------------------------------------------------------------

def init_rglru_block(key, d_model, rnn_width, conv_width, dtype):
    """The JAX block's params, drawn from `key` as JAX draws them
    (log_lambda is float32 and deterministic: a_t in [0.9, 0.999] at init,
    as in Griffin)."""
    ks = prng.split(key, 7)
    rd = rnn_width
    dev = key.device
    return {
        "w_in_rec": init_dense(ks[0], d_model, rd, dtype),
        "w_in_gate": init_dense(ks[1], d_model, rd, dtype),
        "conv_w": (prng.normal(ks[2], (conv_width, rd))
                   * conv_width ** -0.5).to(dtype),
        "conv_b": torch.zeros(rd, dtype=dtype, device=dev),
        "w_a": init_dense(ks[3], rd, rd, dtype, scale=rd ** -0.5),
        "b_a": torch.zeros(rd, dtype=dtype, device=dev),
        "w_x": init_dense(ks[4], rd, rd, dtype, scale=rd ** -0.5),
        "b_x": torch.zeros(rd, dtype=dtype, device=dev),
        "log_lambda": torch.linspace(-4.323, -9.0, rd, dtype=torch.float32,
                                     device=dev),
        "w_out": init_dense(ks[5], rd, d_model, dtype),
    }


def _rglru_gates(params, x):
    """(a, gated_x), both float32, from the conv output x (B, S, rd).

    The order of casts follows the JAX block: log_lambda arrives in the
    activation dtype (cast_params casts every float leaf), softplus and the
    -8 scale run in that dtype, and the product with the float32 r
    promotes to float32."""
    r = torch.sigmoid(x @ params["w_a"] + params["b_a"]).float()
    i = torch.sigmoid(x @ params["w_x"] + params["b_x"]).float()
    log_a = -_RG_C * F.softplus(params["log_lambda"]) * r
    a = torch.exp(log_a)
    gated_x = (i * x.float()) * torch.sqrt(
        torch.clamp_min(1.0 - a * a, 1e-12))
    return a, gated_x


def _causal_conv1d(x, w, b, state=None, lengths=None,
                   return_history=False):
    """Depthwise causal conv. x: (B, S, C); w: (W, C); state: (B, W-1, C)
    history. Returns (out, new history); with `lengths` the history ends
    at each row's true last input instead of the padded end.
    return_history=True also returns the [state | x] stream."""
    W = w.shape[0]
    S = x.shape[1]
    if state is None:
        state = torch.zeros(x.shape[0], W - 1, x.shape[2], dtype=x.dtype,
                            device=x.device)
    xp = torch.cat([state, x], dim=1)
    out = sum(xp[:, i:i + S] * w[i] for i in range(W))
    if lengths is None:
        new_state = xp[:, S:]
    else:
        # history = inputs at stream positions [len, len + W - 2]
        idx = (lengths.long()[:, None]
               + torch.arange(W - 1, device=x.device)[None, :])
        new_state = torch.gather(
            xp, 1, idx[..., None].expand(-1, -1, xp.shape[2]))
    if return_history:
        return out + b, new_state, xp
    return out + b, new_state


def rglru_block_seq(params, x, cfg, state=None, lengths=None,
                    return_states=False):
    """Griffin recurrent block, sequence form. x: (B, S, D); state:
    {"h": (B, rd) float32, "conv": (B, W-1, rd)} or None (zeros).

    lengths: optional (B,) true lengths of right-padded rows: padded steps
    freeze the recurrence (a = 1, gated input 0) so the final state equals
    an unpadded per-row run's. Returns (out (B, S, D), new state).

    return_states=True also returns snapshots {"h": (S+1, B, rd) float32,
    "conv": (S+1, B, W-1, rd)}, index t the state after t tokens (0: the
    input state), as the JAX module's: h from the scan's float32 per-step
    output, conv the W - 1 inputs ending at token t of the [state | x]
    stream. Entries past a row's length are not a state of that row."""
    B, S, D = x.shape
    rd = params["w_in_rec"].shape[1]
    W = params["conv_w"].shape[0]
    if state is None:
        state = {"h": torch.zeros(B, rd, dtype=torch.float32,
                                  device=x.device),
                 "conv": torch.zeros(B, W - 1, rd, dtype=x.dtype,
                                     device=x.device)}
    branch = x @ params["w_in_rec"]
    gate = F.gelu(x @ params["w_in_gate"], approximate="tanh")
    branch, conv_state, conv_xp = _causal_conv1d(
        branch, params["conv_w"], params["conv_b"], state["conv"],
        lengths=lengths, return_history=True)
    a, gx = _rglru_gates(params, branch)
    if lengths is not None:
        valid = _valid(lengths, S, x.device)[..., None]
        a = torch.where(valid, a, torch.ones_like(a))
        gx = torch.where(valid, gx, torch.zeros_like(gx))
    h0 = state["h"].float().contiguous()
    hs, h_fin = rglru_scan(a.contiguous(), gx.contiguous(), h0)
    y = hs.to(x.dtype) * gate
    out = y @ params["w_out"]
    new_state = {"h": h_fin, "conv": conv_state}
    if return_states:
        # a and gx are float32, so hs is the scan's float32 h of each step
        snaps = {"h": torch.cat([h0[None], hs.transpose(0, 1)], dim=0),
                 "conv": conv_xp.unfold(1, W - 1, 1).permute(1, 0, 3, 2)}
        return out, new_state, snaps
    return out, new_state
