"""srmeetsps_cuda_tpu — depth super-resolution meets uncalibrated
photometric stereo, in JAX.

A ground-up matrix-free JAX/XLA re-architecture of the capabilities of
nihalsid/SRmeetsPS-CUDA (single-GPU CUDA/cuSPARSE): joint estimation of
high-resolution depth, per-channel albedo and per-image spherical-harmonic
lighting from multi-illumination RGB images plus low-resolution depth, via
alternating masked least squares with matrix-free conjugate gradient.

See SURVEY.md for the reference layer map this framework covers.
"""

__version__ = "0.1.0"

from .config import Preferences, RuntimeConfig, SolverConfig  # noqa: F401
