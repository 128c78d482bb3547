"""Per-request sampling: `SamplingParams` and the batched samplers.

The serving analog of the paper's minibatch-composition independence:
every request carries its own decoding configuration (`SamplingParams`)
and its realization must not depend on which other requests share its
batch. Two design rules make that hold:

  * configs are DATA, not code — temperature / top-k / top-p / seed
    ride through the jitted dispatches as (B,) arrays, so one compiled
    sampler serves every mix of configs (compile count stays bounded by
    the runner's shape buckets, not by distinct configs), and

  * randomness is position-keyed — the token emitted after consuming
    sequence position p draws from fold_in(PRNGKey(seed), p) (plus a
    draw-kind tag), never from engine-global sampler state, so a
    request's stream is a pure function of (its seed, its positions):
    bit-identical whether it runs alone or batched with anything else.

`verify_tokens` is the sampling half of speculative decoding
(Leviathan et al., 2023 accept/reject, specialized to deterministic
draft proposers such as n-gram lookup): draft token d at position p is
accepted with probability q(d) — the target (warped) distribution's
mass on it — and on rejection the correction token is resampled from
q with d masked out, which preserves the target marginal exactly:

    P(emit x) = q(d)·1[x=d] + (1-q(d)) · q(x)·1[x≠d]/(1-q(d)) = q(x).

Greedy lanes (temperature == 0) bypass all of this with a plain argmax
compare, so greedy output under speculation stays bit-identical to
`generate()` — the existing gate.

PyTorch port: `SamplingParams`, `resolve` and the greedy helpers are
ported. The sampled draws (`sample_tokens`, `verify_tokens`) key every
draw with JAX's threefry `fold_in`; until a later slice ports those bits
they raise NotImplementedError rather than fall back to greedy.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

# draw-kind tags folded into the position key so the accept/reject
# uniform and the (re)sampling categorical at the same position are
# independent draws (reusing one key would correlate the rejection
# event with the correction sample and skew the residual distribution)
TAG_SAMPLE = 0
TAG_ACCEPT = 1


def _normalize_stop(stop) -> Tuple[Tuple[int, ...], ...]:
    if stop is None:
        return ()
    if isinstance(stop, (int,)):
        return ((int(stop),),)
    out = []
    for s in stop:
        if isinstance(s, int):
            out.append((int(s),))
        else:
            seq = tuple(int(t) for t in s)
            if not seq:
                raise ValueError("empty stop sequence")
            out.append(seq)
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request decoding configuration.

    temperature     0 = greedy (argmax); > 0 samples from the softmax
    top_k           keep only the k highest logits (0 = disabled)
    top_p           nucleus sampling: keep the smallest set of tokens
                    with cumulative probability >= top_p (1.0 = off)
    seed            per-request PRNG stream; the realization is a pure
                    function of (seed, position) — batch-independent
    max_new_tokens  generation cap (the first token comes from prefill)
    stop            stop token sequences: generation ends when the
                    OUTPUT ends with any of them (the sequence itself
                    is kept, like an eos token; matching never spans
                    into the prompt). An int or a flat int sequence is
                    treated as a single one-token / one-sequence stop.
    logprobs        0 (off) or k >= 1: record the chosen token's
                    log-probability in Completion.logprobs AND the top-k
                    alternative tokens' (ids, logprobs) per emitted
                    position in Completion.top_ids / top_logprobs — all
                    under the RAW model distribution (pre temperature /
                    top-k / top-p), through the decode AND the
                    speculative verify path. True is accepted as 1
                    (back-compat). k is capped by the runner's
                    max_logprobs (the static top-k width it compiles).
    deadline_ms     optional soft TTFT deadline, milliseconds after the
                    request's arrival. Decoding behavior is UNCHANGED;
                    the deadline only matters to a scheduler running
                    with SLO shedding enabled (slo_shed=True), which
                    may shed a queued request it estimates cannot reach
                    its first token in time (finish_reason "shed") and
                    orders admission by deadline slack. With shedding
                    off (the default) it is purely informational.
    """
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    seed: int = 0
    max_new_tokens: int = 16
    stop: Tuple[Tuple[int, ...], ...] = ()
    logprobs: int = 0
    deadline_ms: Optional[float] = None

    def __post_init__(self):
        object.__setattr__(self, "stop", _normalize_stop(self.stop))
        object.__setattr__(self, "logprobs", int(self.logprobs))
        if self.logprobs < 0:
            raise ValueError(f"logprobs must be >= 0, got {self.logprobs}")
        if self.temperature < 0:
            raise ValueError(f"temperature must be >= 0, "
                             f"got {self.temperature}")
        if self.top_k < 0:
            raise ValueError(f"top_k must be >= 0, got {self.top_k}")
        if not 0.0 < self.top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got {self.top_p}")
        if self.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1 (the first "
                             "token is sampled from the prefill logits)")
        if self.deadline_ms is not None and self.deadline_ms <= 0:
            raise ValueError(f"deadline_ms must be > 0, "
                             f"got {self.deadline_ms}")

    @property
    def greedy(self) -> bool:
        return self.temperature <= 0.0

    def with_seed(self, seed: int) -> "SamplingParams":
        return dataclasses.replace(self, seed=int(seed))


GREEDY = SamplingParams()


def seed32(seed: int) -> int:
    """Fold an arbitrary Python int seed into the int32 range the
    (num_slots,) device seed arrays carry (reinterpreted bits, so
    distinct 32-bit seeds stay distinct)."""
    return int(np.uint32(seed & 0xFFFFFFFF).view(np.int32))


def resolve(sampling: Optional[SamplingParams],
            default: Optional[SamplingParams],
            max_new_tokens: Optional[int] = None,
            eos_id: Optional[int] = None,
            rid: int = 0) -> SamplingParams:
    """Merge a request's SamplingParams with the engine default and the
    legacy per-request fields (max_new_tokens / eos_id). Explicit
    request sampling wins over the engine default; legacy max_new_tokens
    wins over the sampling's cap (old call sites keep their meaning);
    eos_id becomes one more single-token stop sequence.

    A request that carries NO sampling of its own and falls back to a
    sampled engine default gets a per-request stream (default.seed +
    rid) — otherwise every defaulted request would share one seed and
    identical prompts would sample identical outputs (the old engine-
    global-key behavior gave them distinct draws; best-of-n over a
    shared prompt must not collapse to n copies). An EXPLICIT seed is
    never perturbed: reproducing a specific stream stays possible."""
    sp = sampling if sampling is not None else (default or GREEDY)
    changes = {}
    if sampling is None and not sp.greedy:
        changes["seed"] = sp.seed + int(rid)
    if max_new_tokens is not None:
        changes["max_new_tokens"] = int(max_new_tokens)
    if eos_id is not None:
        eos_stop = (int(eos_id),)
        if eos_stop not in sp.stop:
            changes["stop"] = sp.stop + (eos_stop,)
    return dataclasses.replace(sp, **changes) if changes else sp


# ----------------------------------------------------------------------------
# torch samplers (batched, config-as-data)
# ----------------------------------------------------------------------------

def _chosen_logprob(logits, tokens):
    """Log-probability of `tokens` under the RAW model distribution."""
    lp = torch.log_softmax(logits.float(), dim=-1)
    return torch.gather(lp, -1, tokens[..., None].long())[..., 0]


def greedy_tokens(logits):
    """Argmax fast path: (tokens, chosen logprobs) for (..., V) logits."""
    tok = torch.argmax(logits, dim=-1).to(torch.int32)
    return tok, _chosen_logprob(logits, tok)


def top_alternatives(logits, k: int):
    """Top-k alternative tokens per position under the RAW model
    distribution: ((..., k) int32 ids, (..., k) float32 logprobs),
    descending."""
    lp = torch.log_softmax(logits.float(), dim=-1)
    vals, ids = torch.topk(lp, k, dim=-1)
    return ids.to(torch.int32), vals


def _shift_draft(chain):
    """Align the chain with its logits: the draft checked at logits
    index t is chain token t+1 (the pad column is never a real draft)."""
    return torch.cat([chain[:, 1:], torch.zeros_like(chain[:, :1])], dim=1)


def _lead_accepts(acc, counts):
    """Number of leading accepted drafts per lane: only the first
    counts-1 chain positions carry real drafts, and the run stops at
    the first rejection."""
    T = acc.shape[1]
    valid = (torch.arange(T, device=acc.device)[None, :]
             < counts[:, None] - 1)
    return torch.cumprod((acc & valid).to(torch.int32),
                         dim=1).sum(dim=1).to(torch.int32)


def greedy_verify_tokens(logits, chain, counts):
    """The argmax accept rule for a whole verify dispatch: emit the model
    argmax at every position and accept the longest draft prefix agreeing
    with it. Returns (emit (B, T) int32, accept (B,) int32, chosen
    logprobs (B, T) float32)."""
    model_tok, lp = greedy_tokens(logits)
    accept = _lead_accepts(model_tok == _shift_draft(chain), counts)
    return model_tok, accept, lp


def sample_tokens(logits, positions, temperature, top_k, top_p, seeds):
    """Sampled next-token draws: keyed by JAX's threefry fold_in, which
    the port does not have yet. Raises rather than fall back to greedy."""
    raise NotImplementedError(
        "sampled decoding (temperature > 0) needs the threefry fold_in "
        "draws of repro.serving.sampling, ported in a later slice")


def verify_tokens(logits, chain, counts, positions, temperature, top_k,
                  top_p, seeds):
    """Sampled speculative accept/reject: see sample_tokens."""
    raise NotImplementedError(
        "sampled speculative verify (temperature > 0) needs the threefry "
        "fold_in draws of repro.serving.sampling, ported in a later slice")
