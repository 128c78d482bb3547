"""Gradient compression for the MBProx sync points (the port of
`repro/optim/compression.py`).

The paper's communication unit is "vectors averaged across machines", so
the two MBProx sync points (anchor-gradient average, solution average)
support:

  * int8 quantization with per-block scales + ERROR FEEDBACK (the residual
    is carried and added to the next round — keeps MBProx's inexactness
    theory applicable: compression error folds into eta_t of Thm 7),
  * top-k sparsification with error feedback.

Both operate leaf-wise on trees and compose with any reduction:
    compressed, state = compress(tree, state)
    averaged = pmean(decompress(compressed))

The payloads equal JAX's: int8 rounding is half to even (torch.round, as
jnp.round), and top-k keeps the lowest index among equal magnitudes (a
stable descending sort, as lax.top_k; torch.topk does not promise it).
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.tree import tree_leaves, tree_map

BLOCK = 256


class EFState(NamedTuple):
    residual: dict  # tree like the grads


def init_ef(tree) -> EFState:
    return EFState(tree_map(
        lambda x: torch.zeros_like(x, dtype=torch.float32), tree))


# ----------------------------------------------------------------------------
# int8 with per-block scale
# ----------------------------------------------------------------------------

def _quant_leaf(x):
    flat = x.float().reshape(-1)
    flat = F.pad(flat, (0, (-flat.numel()) % BLOCK)).reshape(-1, BLOCK)
    scale = flat.abs().amax(dim=1, keepdim=True) / 127.0
    q = torch.clamp(torch.round(flat / torch.clamp(scale, min=1e-12)),
                    -127, 127).to(torch.int8)
    return q, scale


def _dequant_leaf(q, scale, shape):
    n = 1
    for d in shape:
        n *= d
    return (q.float() * scale).reshape(-1)[:n].reshape(shape)


def quantize_int8(tree, ef: EFState):
    """Returns ((q_tree, scale_tree, shapes), new_ef)."""
    def per_leaf(x, r):
        xe = x.float() + r
        q, s = _quant_leaf(xe)
        return q, s, xe - _dequant_leaf(q, s, tuple(x.shape))

    outs = tree_map(lambda x, r: per_leaf(x, r), tree, ef.residual)
    pick = lambda i: tree_map(lambda x, o: o[i], tree, outs)  # noqa: E731
    shapes = tree_map(lambda x: tuple(x.shape), tree)
    return (pick(0), pick(1), shapes), EFState(pick(2))


def dequantize_int8(compressed):
    q_tree, s_tree, shapes = compressed
    return tree_map(_dequant_leaf, q_tree, s_tree, shapes)


def compressed_bytes_int8(tree) -> int:
    """Wire bytes after int8 compression (payload + scales)."""
    total = 0
    for leaf in tree_leaves(tree):
        n = leaf.numel()
        blocks = -(-n // BLOCK)
        total += n + 4 * blocks
    return total


# ----------------------------------------------------------------------------
# top-k with error feedback
# ----------------------------------------------------------------------------

def topk_sparsify(tree, ef: EFState, frac: float = 0.01):
    """Keep the top `frac` entries by magnitude per leaf; returns
    ((values, indices, shapes), new_ef)."""
    def per_leaf(x, r):
        xe = x.float().reshape(-1) + r.reshape(-1)
        k = max(1, int(xe.numel() * frac))
        idx = torch.sort(xe.abs(), descending=True, stable=True).indices[:k]
        kept = xe[idx]
        dense = torch.zeros_like(xe).index_put_((idx,), kept)
        return kept, idx, (xe - dense).reshape(x.shape)

    outs = tree_map(lambda x, r: per_leaf(x, r), tree, ef.residual)
    pick = lambda i: tree_map(lambda x, o: o[i], tree, outs)  # noqa: E731
    shapes = tree_map(lambda x: tuple(x.shape), tree)
    return (pick(0), pick(1), shapes), EFState(pick(2))


def topk_densify(compressed):
    vals, idxs, shapes = compressed

    def per_leaf(v, i, shape):
        n = 1
        for d in shape:
            n *= d
        return torch.zeros(n, dtype=v.dtype, device=v.device).index_put_(
            (i,), v).reshape(shape)

    return tree_map(per_leaf, vals, idxs, shapes)
