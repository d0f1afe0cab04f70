"""Kernels of the decoder slice: CUDA C++ for sm_90a under ``csrc/``,
built at first use and bound with ctypes (``build.py``), each beside its
plain PyTorch version (``ref.py``).  A wrapper given CPU tensors runs the
plain version; given CUDA tensors it launches its kernel or raises."""
