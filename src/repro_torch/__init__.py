"""PyTorch/CUDA port of the TransDot trans-precision DPA serving stack.

`repro_torch` mirrors the JAX package `repro` module for module
(`core`, `kernels`, `models`, `configs`, `serving`, `launch`) and keeps
the JAX function names, so each counterpart is easy to find.  It imports
`torch`, `numpy` and the standard library only — never JAX or anything
of `repro`.

Plain PyTorch code serves tensors on the CPU.  The two Pallas TPU kernels
on the serving path are hand-written CUDA C++ kernels for Hopper
(`csrc/`), built with `nvcc` at first use and bound through `ctypes`
(`kernels/build.py`); a CUDA tensor takes the kernel or raises.
"""
