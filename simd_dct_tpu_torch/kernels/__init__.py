"""Enc-quant and mode32 kernels: the plain PyTorch version (``torch_path``)
and the CUDA kernel wrappers (``cuda_dct``).  Neither builds anything on
import."""
