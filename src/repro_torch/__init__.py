"""PyTorch/CUDA port of ``repro`` (UniPruning) for NVIDIA Hopper.

Module names mirror ``repro``'s, so each module's counterpart is easy to
find.  Parameters are nested dicts of tensors with the reference's layout
and key paths (layers stacked on a leading axis).  Every kernel ``repro``
wrote in Pallas for the TPU becomes a hand-written CUDA kernel under
``csrc/``, built at first use (``kernels/_build.py``); each wrapper runs its
plain PyTorch version for CPU tensors and launches the kernel, or raises,
for CUDA tensors.  Nothing here imports jax or ``repro``.
"""
