"""Modality frontends (PyTorch port of `repro.models.frontends`).

As in the JAX package these are stubs that map precomputed frontend
outputs into the backbone's embedding space:

  * vision (paligemma): precomputed SigLIP patch embeddings
    (B, n_patches, vision_dim) are projected to d_model; the model
    prepends them to the text as a bidirectional prefix
    (`lm._embed_inputs`). The SigLIP tower itself is not implemented.
  * audio (musicgen): EnCodec codebook token ids (B, S, n_codebooks) are
    embedded by one table per codebook and summed (the delay pattern is
    treated as preapplied by the tokenizer stub).

Plain functions on tensors; the initialisers draw JAX's values from JAX's
keys (`prng`).
"""
from __future__ import annotations

import torch

from repro_torch import prng
from repro_torch.models.layers import init_dense, init_embed


def init_vision_frontend(key, vision_dim, d_model, dtype):
    return {"proj": init_dense(key, vision_dim, d_model, dtype)}


def vision_embed(params, vision_emb):
    """(B, n_patches, vision_dim) -> (B, n_patches, d_model)."""
    return vision_emb @ params["proj"]


def init_audio_embed(key, n_codebooks, vocab, d_model, dtype):
    """(n_codebooks, vocab, d_model): codebook c's table from
    split(key, n_codebooks)[c]."""
    return torch.stack([init_embed(k, vocab, d_model, dtype)
                        for k in prng.split(key, n_codebooks)])


def audio_embed(codebook_embeds, tokens):
    """codebook_embeds: (n_cb, Vc, D); tokens: (B, S, n_cb) -> (B, S, D),
    the codebooks' embeddings summed in the tables' dtype."""
    n_cb = codebook_embeds.shape[0]
    return torch.stack([codebook_embeds[c][tokens[..., c].long()]
                        for c in range(n_cb)]).sum(0)
