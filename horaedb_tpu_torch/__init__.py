"""horaedb_tpu_torch: the PyTorch/CUDA port of horaedb_tpu for one NVIDIA H100.

The JAX package `horaedb_tpu` stays as the reference; this package grows
beside it slice by slice and imports nothing of it. Its device kernels are
written by hand for Hopper (`ops/csrc/*.cu`), built at first use, and
counted per launch under the JAX package's catalog names.
"""

from horaedb_tpu_torch.ops._build import KERNELS, launch_counts, reset_launch_counts

__all__ = ["KERNELS", "launch_counts", "reset_launch_counts"]
