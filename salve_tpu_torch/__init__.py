"""salve_tpu_torch — the PyTorch/CUDA port of salve_tpu.

Module paths mirror `salve_tpu` so each port has an obvious counterpart.
This package imports torch and never jax, flax, optax or any `salve_tpu`
module: importing `salve_tpu` runs its jax-importing `__init__`.

Entry points take `device=None`, which means the CUDA card; without a card
they raise unless the caller asks for `device="cpu"` (see `device.py`).
The hand-written Hopper kernels live in `csrc/` and are built on first use
by `ops/kernels.py`.
"""

__version__ = "0.1.0"
