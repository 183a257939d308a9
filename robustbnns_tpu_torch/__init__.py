"""robustbnns_tpu_torch — the PyTorch/CUDA port of ``robustbnns_tpu`` for an NVIDIA H100.

It keeps the JAX package's layout and names, so each module's counterpart is
found at the same relative path, and imports torch, numpy and the standard
library only. The TPU's Pallas kernels become CUDA C++ kernels for ``sm_90a``
under ``csrc/``, built with ``nvcc`` at first use (:mod:`.ops.build`).

It carries SVI training of the ``fc``/``fc2`` models and the Bayesian
FGSM/PGD attack path on them: :mod:`.config`, :mod:`.data`, :mod:`.models`
(architectures and the SVI BNN), :mod:`.inference.svi` (the ELBO and the
trainer), :mod:`.predict`, :mod:`.ops` (the six sampled-dense kernels, the
op's full backward and the fused predictive), :mod:`.attacks`,
:mod:`.cli.train_bnn` and :mod:`.cli.attacks`. Entry points run on ``cuda``
unless asked for ``cpu``.
"""

__version__ = "0.1.0"
