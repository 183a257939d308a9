"""robustbnns_tpu_torch — the PyTorch/CUDA port of ``robustbnns_tpu`` for an NVIDIA H100.

It keeps the JAX package's layout and names, so each module's counterpart is
found at the same relative path, and imports torch, numpy and the standard
library only. The TPU's Pallas kernels become CUDA C++ kernels for ``sm_90a``
under ``csrc/``, built with ``nvcc`` at first use (:mod:`.ops.build`).

It carries every model of the zoo (SVI, HMC and NUTS BNNs, deterministic
NNs and ensembles: :mod:`.models`, :mod:`.inference`), the posterior
predictive (:mod:`.predict`, and the six sampled-dense kernels under
:mod:`.ops`), the Bayesian FGSM/PGD attacks (:mod:`.attacks`), the expected
loss gradients (:mod:`.analysis`), the paper's experiments
(:mod:`.experiments`) and their CLIs (:mod:`.cli`), and the parallelism of
:mod:`.parallel`: ``(data, sample)`` meshes over a ``torch.distributed``
group, one process per card (``torchrun``), behind every ``mesh=`` argument
and ``--mesh``. Entry points run on ``cuda`` unless asked for ``cpu``.
"""

__version__ = "0.1.0"
