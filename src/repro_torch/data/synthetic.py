"""Seeded synthetic data streams.

The port of `repro/data/synthetic.py` (`LeastSquaresStream`,
`TokenStream`). The paper's setting is *stochastic*
optimization: examples arrive from an unknown distribution D one at a time
("a button generating examples"). The stream is modelled by seeded
generators so that (a) any machine can draw its own minibatch
independently, (b) restarts regenerate identical streams, and (c) no
dataset ever needs to be stored (the paper's memory model).

Least-squares examples are drawn from an explicit `torch.Generator` and
land on its device. The two packages' generators differ (and so do torch's CPU and
CUDA ones), so the same seed gives other numbers than the JAX stream; the
feature scales (`_spectrum`) are equal to the bit, and `w_star` is one
vector on every device. `TokenStream` draws from the port's threefry keys
(`prng.py`) instead, and gives JAX's batches bit for bit.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch import prng

# elements per chunk of a population estimate (64 MiB of float32 rows), so
# a large `dim` never allocates n_eval x dim at once
EVAL_CHUNK_ELEMS = 1 << 24


@dataclasses.dataclass(frozen=True)
class LeastSquaresStream:
    """y = x . w_star + noise, x ~ N(0, Sigma) with decaying spectrum.

    Conditioning is controlled by `decay`: eigenvalues lam_j ~ j^{-decay}.
    Feature norm is scaled so beta = max ||x||^2 = O(1).
    """

    dim: int
    noise: float = 0.1
    decay: float = 0.5
    seed: int = 0

    def _spectrum(self, device=None):
        j = np.arange(1, self.dim + 1, dtype=np.float64)
        lam = j ** (-self.decay)
        lam = lam / lam.sum() * self.dim  # trace = d
        return torch.tensor(np.sqrt(lam), dtype=torch.float32, device=device)

    def w_star(self, device=None):
        """The unit-norm optimum, drawn on the CPU from `seed` (so it is the
        same vector on every device) and moved to `device`."""
        g = torch.Generator().manual_seed(self.seed)
        w = torch.randn(self.dim, generator=g)
        return (w / torch.linalg.vector_norm(w)).to(device)

    def _draw(self, generator, n, w_star):
        dev = generator.device
        X = torch.randn(n, self.dim, generator=generator, device=dev)
        X.mul_(self._spectrum(dev) / math.sqrt(self.dim))
        y = X @ w_star
        y.add_(torch.randn(n, generator=generator, device=dev),
               alpha=self.noise)
        return X, y

    def sample(self, generator: torch.Generator, n: int):
        """Draw n fresh examples on the generator's device.
        Returns X: (n, d), y: (n,)."""
        return self._draw(generator, n, self.w_star(generator.device))

    def sample_distributed(self, generator: torch.Generator, m: int, b: int):
        """Each of m machines draws b examples: X (m, b, d), y (m, b)."""
        X, y = self.sample(generator, m * b)
        return X.reshape(m, b, self.dim), y.reshape(m, b)

    def _eval_sums(self, w, n_eval: int, seed: int):
        """Sums over a fresh evaluation sample, drawn in chunks: of the
        squared residuals at w and at w_star."""
        g = torch.Generator(device=w.device).manual_seed(seed)
        w_star = self.w_star(w.device)
        rows = max(1, EVAL_CHUNK_ELEMS // self.dim)
        s = s_star = 0.0
        for start in range(0, n_eval, rows):
            X, y = self._draw(g, min(rows, n_eval - start), w_star)
            r, r_star = X @ w - y, X @ w_star - y
            s = s + torch.sum(r * r)
            s_star = s_star + torch.sum(r_star * r_star)
        return s, s_star

    def population_objective(self, w, n_eval: int = 65536,
                             seed: int = 10**6):
        """Monte-Carlo estimate of phi(w) on a fresh evaluation sample."""
        s, _ = self._eval_sums(w, n_eval, seed)
        return 0.5 * s / n_eval

    def population_suboptimality(self, w, n_eval: int = 65536):
        """phi(w) - phi(w_star) with a shared eval set (variance-reduced);
        the population optimum of the noisy model is w_star itself."""
        s, s_star = self._eval_sums(w, n_eval, 10**6)
        return 0.5 * s / n_eval - 0.5 * s_star / n_eval

    def expected_suboptimality(self, w):
        """phi(w) - phi(w_star) in closed form: x has independent
        coordinates of variance scale_j^2 / d, so the excess is
        0.5 sum_j (scale_j^2 / d) (w_j - w_star_j)^2. Summed in float64."""
        dev = w.device
        var = self._spectrum(dev).double() ** 2 / self.dim
        diff = w.double() - self.w_star(dev).double()
        return 0.5 * torch.sum(var * diff * diff)


@dataclasses.dataclass(frozen=True)
class TokenStream:
    """Deterministic synthetic token stream for LM training/serving tests.

    Produces (tokens, targets) with a learnable structure: targets are a fixed
    permutation-shift of tokens so tiny models can overfit it, which the smoke
    and integration tests use to check that training reduces loss.
    """

    vocab_size: int
    seq_len: int
    seed: int = 0

    def batch(self, key, batch_size: int):
        """(inputs, targets), each (batch_size, seq_len) int64 on the key's
        device, equal to the JAX stream's under the same key: the tokens
        are `jax.random.randint`'s, the mix `jax.random.bernoulli(
        fold_in(key, 1), 0.5)`, which is uniform(...) < 0.5."""
        toks = prng.randint(key, (batch_size, self.seq_len + 1), 0,
                            self.vocab_size)
        # next-token structure: x_{t+1} = (x_t * 31 + 7) % V on half of
        # the positions
        det = (toks[:, :-1] * 31 + 7) % self.vocab_size
        mix = prng.uniform(prng.fold_in(key, 1), tuple(det.shape)) < 0.5
        inputs = toks[:, :-1]
        targets = torch.where(mix, det, toks[:, 1:])
        return inputs, targets
