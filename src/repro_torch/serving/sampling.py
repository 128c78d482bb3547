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

PyTorch port: every draw is keyed by `repro_torch.prng`, JAX's
threefry bit for bit (keys and uniforms), so a request's stream is the
JAX engine's. The Gumbel noise takes torch's `log`, which may differ
from XLA's in the last ulp: a token can differ from JAX's only where two
candidates' warped-logit-plus-noise values tie to within that ulp. All
helpers are eager torch ops on the logits' device.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch import prng

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

def position_key(seed, pos, tag):
    """The key for one draw: fold the absolute sequence position and the
    draw-kind tag into the request's stream. Pure in (seed, pos, tag);
    integer tensors of seeds and positions give a stack of keys."""
    return prng.fold_in(prng.fold_in(prng.PRNGKey(seed), pos), tag)


def _keys(seeds, positions, tag):
    """Batched position keys; seeds/positions may be (B,) or (B, T).
    Returns (*positions.shape, 2)."""
    seeds = torch.broadcast_to(seeds, positions.shape)
    return position_key(seeds, positions, tag)


def warp_logits(logits, temperature, top_k, top_p):
    """Apply temperature / top-k / top-p to logits (..., V); the scalar
    params broadcast over the leading dims ((...,)-shaped tensors).
    softmax(warped) is the target sampling distribution. Masked tokens
    go to -inf. Greedy rows (temperature 0) are scaled by 1 — callers
    select argmax for them, the warp result is unused.

    The reference's rules, kept exactly: the k-th value of the descending
    sort is a threshold `x >= thr`, so ties at it are kept; the nucleus is
    a prefix of the same sort, the tokens whose cumulative mass before
    them is < top_p."""
    V = logits.shape[-1]
    t = torch.where(temperature > 0, temperature,
                    torch.ones_like(temperature))[..., None]
    x = logits / t
    xs = -torch.sort(-x, dim=-1).values                 # descending
    k = torch.clamp(torch.where(top_k <= 0, torch.full_like(top_k, V),
                                top_k), 1, V)
    k = torch.broadcast_to(k, xs.shape[:-1])
    kth = torch.gather(xs, -1, (k - 1).long()[..., None])
    ps = torch.softmax(xs, dim=-1)
    keep = (torch.cumsum(ps, dim=-1) - ps) < top_p[..., None]
    inf = torch.tensor(float("inf"), dtype=xs.dtype, device=xs.device)
    pth = torch.where(keep, xs, inf).amin(dim=-1, keepdim=True)
    pth = torch.where((top_p >= 1.0)[..., None], -inf, pth)
    thr = torch.maximum(kth, pth)
    return torch.where(x >= thr, x, -inf)



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
    """One batched next-token draw with per-lane configs.

    logits (B, V); positions (B,) absolute position of the token each
    lane just consumed (the key for this draw); temperature/top_p (B,)
    float, top_k/seeds (B,) int. Greedy lanes take the argmax; sampled
    lanes draw categorical(fold_in(PRNGKey(seed), pos)) over the warped
    logits. Returns ((B,) int32 tokens, (B,) float32 chosen logprobs)."""
    warped = warp_logits(logits, temperature, top_k, top_p)
    sampled = prng.categorical(_keys(seeds, positions, TAG_SAMPLE), warped)
    tok = torch.where(temperature > 0, sampled,
                      torch.argmax(logits, dim=-1)).to(torch.int32)
    return tok, _chosen_logprob(logits, tok)


def verify_tokens(logits, chain, counts, positions, temperature, top_k,
                  top_p, seeds):
    """Accept/reject + emission for one verify dispatch (the sampling
    half of speculative decoding, deterministic-draft specialization).

    logits (B, T, V): next-token logits after consuming chain token t;
    chain (B, T): [pending, d_1 .. d_k] right-padded; counts (B,) true
    chain lengths (0 = lane sits out); positions (B,) absolute position
    of each chain's first token; temperature/top_k/top_p/seeds (B,).

    Per lane, draft d_{t+1} (checked against logits index t) is:
      greedy lane   accepted iff argmax(logits[t]) == d_{t+1}
      sampled lane  accepted with probability q_t(d_{t+1}) where q_t =
                    softmax(warp(logits[t])) — the Leviathan rule with a
                    deterministic (probability-one) proposal
    `accept` is the number of leading accepted drafts; the emitted run
    is the accepted drafts plus ONE more token at index `accept`:
      greedy         the model argmax (correction == bonus)
      sampled, a<k   resampled from q_a with the rejected draft masked
                     out (the residual distribution)
      sampled, a==k  the bonus token, a plain draw from q_k
    Accept uniforms and (re)samples use different key tags. The residual
    resample and the bonus draw share their key (TAG_SAMPLE at the
    position), so one Gumbel draw serves both, as the same key gives the
    same noise in the reference. Where the draft holds all of q's mass
    the residual is all -inf and its argmax is index 0, as jnp.argmax's;
    it is never emitted (u < 1 accepts the draft).

    Returns (emit (B, T) int32 — valid at indices 0..accept —,
    accept (B,) int32, chosen logprobs (B, T) float32)."""
    B, T = chain.shape
    tidx = torch.arange(T, dtype=torch.int32, device=chain.device)[None, :]
    pos = positions[:, None] + tidx                         # (B, T)
    model_tok = torch.argmax(logits, dim=-1).to(torch.int32)
    draft = _shift_draft(chain)
    warped = warp_logits(logits, temperature[:, None], top_k[:, None],
                         top_p[:, None])
    q_draft = torch.exp(torch.gather(
        torch.log_softmax(warped, dim=-1), -1,
        draft.long()[..., None])[..., 0])
    u = prng.uniform(_keys(seeds[:, None], pos, TAG_ACCEPT))
    sampled_lane = (temperature > 0)[:, None]
    accept = _lead_accepts(
        torch.where(sampled_lane, u < q_draft, model_tok == draft), counts)
    noise = prng.gumbel(_keys(seeds[:, None], pos, TAG_SAMPLE),
                        (logits.shape[-1],), warped.dtype)
    residual = warped.scatter(-1, draft.long()[..., None], float("-inf"))
    resample = torch.argmax(noise + residual, dim=-1)   # the correction
    bonus = torch.argmax(noise + warped, dim=-1)        # full-accept bonus
    full = (accept >= torch.clamp(counts, min=1) - 1)[:, None]
    emit_sampled = torch.where(tidx < accept[:, None], draft,
                               torch.where(full, bonus, resample)
                               .to(torch.int32))
    emit = torch.where(sampled_lane, emit_sampled,
                       model_tok).to(torch.int32)
    return emit, accept, _chosen_logprob(logits, emit)
