"""paper-lsq — the paper's own workload: distributed stochastic least squares.

Not a transformer; `CONFIG` carries the convex-problem description consumed by
benchmarks and the quickstart example (d = feature dimension).
"""
import dataclasses


@dataclasses.dataclass(frozen=True)
class LsqConfig:
    name: str = "paper-lsq"
    family: str = "convex"
    dim: int = 64
    noise: float = 0.1
    decay: float = 0.5
    radius: float = 1.0


CONFIG = LsqConfig()
