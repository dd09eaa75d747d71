"""Hand-written CUDA kernels of the port, each with its plain PyTorch
version and a launch counter (`<wrapper>.launches`):

  K1 dequant_matmul.quantized_matmul   csrc/dequant_matmul.cu
  K2 kv_attention.cache_band_write     csrc/kv_attention.cu
  K3 kv_attention.decode_attention     csrc/kv_attention.cu
  K4 fused_mlp.fused_mlp               csrc/fused_mlp.cu
  K5 flash_attention.flash_attention   csrc/flash_attention.cu
  K6 int8_matmul.w8a8_matmul           csrc/w8a8_matmul.cu
  K7 codebook_matmul.codebook_matmul   csrc/codebook_matmul.cu
  K8 kv_attention.decode_attention_write_bf16   csrc/kv_attention.cu
  K9, K10 moe_matmul.moe_matmul, .moe_gathered_matmul   csrc/moe_matmul.cu
  K11 kv_attention.decode_attention_write        csrc/kv_attention.cu
  K12 kv_attention.decode_attention_flash (and the banded entries)
                                       csrc/kv_flash_decode.cu
  K13 layer_boundary.layer_boundary    csrc/layer_boundary.cu

K1 also takes qtpu's norm_w / resid options (counted again in
`quantized_matmul.norm_launches` / `.resid_launches`).

Modules are imported by their users; nothing here imports triton or builds
at import time.
"""
