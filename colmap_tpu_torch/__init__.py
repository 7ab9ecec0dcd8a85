"""PyTorch/CUDA port of colmap_tpu.

The package keeps colmap_tpu's module paths and public names, so each
function has its counterpart at the same place. Plain code is PyTorch; the
device programs of the ported slice are CUDA C++ kernels written for Hopper
(``colmap_tpu_torch/csrc``), built with nvcc at first use and bound with
ctypes (``colmap_tpu_torch/kernels``).

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
library functions run on the device of their input tensors. A CUDA request
without a card raises. On CPU tensors every kernel wrapper runs its plain
PyTorch version, which is what the CPU tests hold against colmap_tpu.
"""
