"""qtpu_torch — the PyTorch/CUDA port of qtpu for NVIDIA Hopper (H100).

The JAX package `qtpu` is the reference; this package keeps its byte and
array layouts at every public function so one packed artifact feeds both.
Plain tensor code is PyTorch; every Pallas kernel on the ported path is a
hand-written CUDA kernel under `qtpu_torch/csrc/`, built at first use
(`qtpu_torch.kernels._build`). Entry points run on `cuda` unless the caller
passes `device="cpu"`, where each kernel wrapper takes its plain version.
"""
