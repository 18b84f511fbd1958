"""PyTorch/CUDA port of `pbhc_tpu` for NVIDIA Hopper (H100).

Module names mirror `pbhc_tpu/` so each counterpart is easy to find. The
package imports torch, numpy, scipy and the standard library only: no JAX, no
module of `pbhc_tpu`, and none of PyYAML, joblib, lxml or MuJoCo.
"""
