"""Recurrent token mixers (PyTorch port of `repro.models.recurrent`),
RG-LRU half.

The Griffin / RecurrentGemma recurrent block in sequence form: lm.forward
and lm.prefill run it over the prompt, and each decode step runs it with
S = 1 from the carried state {"h": (B, rd) float32, "conv": (B, W-1, rd)}.
Its scan goes through the `rglru_scan` kernel wrapper (the CUDA kernel on
CUDA tensors, its plain twin on CPU tensors).

Not ported yet: the RWKV6 mixers (`rwkv_seq`, `rwkv_channel_mix`, with the
rwkv6_scan kernel) and the per-step `return_states` snapshots that the
engine's speculative verify rolls back to (the hybrid engine slice).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import rglru_scan
from repro_torch.models.layers import init_dense

_RG_C = 8.0


def _not_ported(what: str, slice_name: str):
    raise NotImplementedError(f"{what} is not ported to PyTorch yet (the "
                              f"{slice_name} slice)")


def rwkv_seq(*args, **kwargs):
    _not_ported("the RWKV6 time mix", "rwkv6_scan")


def rwkv_channel_mix(*args, **kwargs):
    _not_ported("the RWKV6 channel mix", "rwkv6_scan")


def init_rglru_block(gen, d_model, rnn_width, conv_width, dtype):
    """The JAX block's params, drawn from `gen` (log_lambda is float32 and
    deterministic: a_t in [0.9, 0.999] at init, as in Griffin)."""
    rd = rnn_width
    dev = gen.device
    return {
        "w_in_rec": init_dense(gen, d_model, rd, dtype),
        "w_in_gate": init_dense(gen, d_model, rd, dtype),
        "conv_w": (torch.randn(conv_width, rd, generator=gen, device=dev)
                   * conv_width ** -0.5).to(dtype),
        "conv_b": torch.zeros(rd, dtype=dtype, device=dev),
        "w_a": init_dense(gen, rd, rd, dtype, scale=rd ** -0.5),
        "b_a": torch.zeros(rd, dtype=dtype, device=dev),
        "w_x": init_dense(gen, rd, rd, dtype, scale=rd ** -0.5),
        "b_x": torch.zeros(rd, dtype=dtype, device=dev),
        "log_lambda": torch.linspace(-4.323, -9.0, rd, dtype=torch.float32,
                                     device=dev),
        "w_out": init_dense(gen, rd, d_model, dtype),
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
    an unpadded per-row run's. Returns (out (B, S, D), new state)."""
    if return_states:
        _not_ported("rglru_block_seq(return_states=True), the per-step "
                    "snapshots of speculative verify,", "hybrid engine")
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
    branch, conv_state = _causal_conv1d(branch, params["conv_w"],
                                        params["conv_b"], state["conv"],
                                        lengths=lengths)
    a, gx = _rglru_gates(params, branch)
    if lengths is not None:
        valid = (torch.arange(S, device=x.device)[None, :]
                 < lengths[:, None])[..., None]
        a = torch.where(valid, a, torch.ones_like(a))
        gx = torch.where(valid, gx, torch.zeros_like(gx))
    hs, h_fin = rglru_scan(a.contiguous(), gx.contiguous(),
                           state["h"].float().contiguous())
    y = hs.to(x.dtype) * gate
    out = y @ params["w_out"]
    return out, {"h": h_fin, "conv": conv_state}
