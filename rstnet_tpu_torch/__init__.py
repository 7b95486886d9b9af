"""RSTnet in PyTorch and CUDA: the port of ``rstnet_tpu`` to one NVIDIA H100.

The JAX package ``rstnet_tpu`` stays the reference. This package mirrors its
layout (``ops``, ``modules``, ``quantization``, ``models``, ``inference``,
``serving``, ``data``, ``losses``, ``training``, ``utils``) and its public
tensor layouts, so each module's counterpart is easy to find and the parity
tests compare like with like. It imports ``torch`` and never ``jax``.

Idiom: parameters live in ``nn.Module``s whose ``state_dict()`` keys are the
JAX param pytree paths joined with ``.`` (where the port keeps one module per
layer of a JAX stack, the layer index joins the path: ``backbone.blocks.3``);
streaming state is a plain dict of tensors that each ``step`` updates in
place and returns; randomness enters only through an explicit
``torch.Generator``. The TPU's Pallas kernels on the serving and training
paths are hand-written CUDA kernels under ``csrc/``, built with ``nvcc`` at
first use (``ops/cuda_lib.py``); on CPU tensors their wrappers run the plain
PyTorch version beside them.
"""

__version__ = "0.1.0"
