"""Seeded synthetic data streams of the port (`LeastSquaresStream`)."""
from repro_torch.data.synthetic import LeastSquaresStream  # noqa: F401
