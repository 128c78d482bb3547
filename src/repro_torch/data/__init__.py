"""Seeded synthetic data streams of the port (`LeastSquaresStream`,
`TokenStream`) and the sharded, prefetching batch pipeline."""
from repro_torch.data.synthetic import (  # noqa: F401
    LeastSquaresStream, TokenStream)
