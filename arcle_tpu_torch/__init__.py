"""arcle-tpu-torch: the ARC Learning Environment engine on PyTorch and CUDA.

A port of :mod:`arcle_tpu` (JAX on a TPU) to PyTorch on an NVIDIA H100.
It steps thousands of O2ARCv2 / ARC / Raw environments in lockstep; the
whole transition runs in one hand-written CUDA kernel
(``csrc/step_kernel.cu``) on the GPU, and in plain PyTorch on the CPU.
PPO and E-MAML learners train the MLP or the GPT policy on them.  It
imports ``torch`` and ``numpy``, never ``jax``.

Layout (mirrors ``arcle_tpu``)
------------------------------
- ``arcle_tpu_torch.core``    : batched state dataclasses, geometry, flood fill
- ``arcle_tpu_torch.loaders`` : dataset loaders -> task banks of tensors
- ``arcle_tpu_torch.ops``     : op tables, the plain transition, the step kernel
- ``arcle_tpu_torch.envs``    : the batched engine, augmentation, the
                                random-action rollout loop
- ``arcle_tpu_torch.wrappers``: bbox / point actions, obs flattening
- ``arcle_tpu_torch.models``  : the MLP and GPT policies, the op + bbox
                                distribution, weights carried from flax
- ``arcle_tpu_torch.training``: rollout, GAE, PPO, E-MAML, the training
                                entry points, the run supervisor
- ``arcle_tpu_torch.utils``   : run config, metric logging, checkpoints
"""

__version__ = "0.1.0"

from . import (  # noqa: F401
    core, loaders, ops, envs, wrappers, models, training, utils,
)
