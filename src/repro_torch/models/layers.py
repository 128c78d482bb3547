"""Shared neural-net building blocks (PyTorch port of `repro.models.layers`).

Conventions, as in the JAX package:
  * params are plain dicts of tensors;
  * activations run in cfg.dtype (bf16 by default), softmax/norms in fp32.

Initialisers draw from an explicit `torch.Generator` (on the device the
tensors are made on); the numbers differ from `jax.random`'s, so parity
tests share weights through `repro_torch.convert` instead.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def rms_norm(x, scale, eps: float = 1e-6):
    """RMS norm in fp32 with a (1 + scale) gain; returns x's dtype."""
    dt = x.dtype
    x = x.float()
    var = (x * x).mean(-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * (1.0 + scale.float())).to(dt)


def init_dense(gen, d_in, d_out, dtype, scale=None):
    scale = scale if scale is not None else d_in ** -0.5
    return (torch.randn(d_in, d_out, generator=gen, device=gen.device)
            * scale).to(dtype)


# ----------------------------------------------------------------------------
# Rotary position embeddings
# ----------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float = 10000.0, device=None):
    return theta ** (-torch.arange(0, head_dim, 2, dtype=torch.float32,
                                   device=device) / head_dim)


def apply_rope(x, positions, theta: float = 10000.0):
    """x: (..., S, H, hd); positions: (..., S) int. Rotate-half halves (not
    interleaved) with fp32 angles."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                  # (hd/2,)
    angles = positions[..., None].float() * freqs            # (..., S, hd/2)
    angles = angles[..., None, :]                            # (..., S, 1, hd/2)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ----------------------------------------------------------------------------
# MLPs
# ----------------------------------------------------------------------------

def init_mlp(gen, d_model, d_ff, dtype, kind: str = "swiglu"):
    if kind in ("swiglu", "geglu"):
        return {"w_gate": init_dense(gen, d_model, d_ff, dtype),
                "w_up": init_dense(gen, d_model, d_ff, dtype),
                "w_down": init_dense(gen, d_ff, d_model, dtype)}
    if kind == "gelu":
        return {"w_up": init_dense(gen, d_model, d_ff, dtype),
                "w_down": init_dense(gen, d_ff, d_model, dtype)}
    raise ValueError(kind)


def mlp(params, x, kind: str = "swiglu"):
    # jax.nn.gelu defaults to the tanh approximation
    if kind == "swiglu":
        h = F.silu(x @ params["w_gate"]) * (x @ params["w_up"])
    elif kind == "geglu":
        h = F.gelu(x @ params["w_gate"], approximate="tanh") \
            * (x @ params["w_up"])
    elif kind == "gelu":
        h = F.gelu(x @ params["w_up"], approximate="tanh")
    else:
        raise ValueError(kind)
    return h @ params["w_down"]


# ----------------------------------------------------------------------------
# Embedding / unembedding
# ----------------------------------------------------------------------------

def init_embed(gen, vocab, d_model, dtype):
    return (torch.randn(vocab, d_model, generator=gen, device=gen.device)
            * 0.02).to(dtype)


def softmax_xent(logits, targets, z_loss: float = 0.0):
    """Stable cross-entropy in fp32. logits (..., V), targets (...) int."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets[..., None].long())[..., 0]
    loss = lse - gold
    if z_loss > 0.0:
        loss = loss + z_loss * lse ** 2
    return loss
