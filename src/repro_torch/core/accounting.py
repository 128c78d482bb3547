"""Resource accounting: communication, memory, computation.

A copy of `repro/core/accounting.py` (the port imports nothing of the JAX
package).

The paper measures (Table 1):
  - communication: number of vectors averaged-and-redistributed per machine
  - memory: number of vectors stored per machine (samples count as vectors)
  - computation: vector operations per machine

Algorithms in repro_torch.core thread a `Ledger` through their loops;
benchmarks compare the measured numbers against
`theory.table1_resources`.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class Ledger:
    comm_rounds: int = 0          # averaging/broadcast rounds
    comm_vectors: int = 0         # vectors communicated per machine
    vector_ops: int = 0           # per-machine vector operations
    peak_memory_vectors: int = 0  # max vectors simultaneously held per machine

    def communicate(self, vectors: int = 1, rounds: int = 1):
        self.comm_rounds += rounds
        self.comm_vectors += vectors

    def compute(self, ops: int):
        self.vector_ops += ops

    def hold(self, vectors: int):
        self.peak_memory_vectors = max(self.peak_memory_vectors, vectors)

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)

    def __add__(self, other: "Ledger") -> "Ledger":
        return Ledger(
            comm_rounds=self.comm_rounds + other.comm_rounds,
            comm_vectors=self.comm_vectors + other.comm_vectors,
            vector_ops=self.vector_ops + other.vector_ops,
            peak_memory_vectors=max(self.peak_memory_vectors,
                                    other.peak_memory_vectors),
        )
