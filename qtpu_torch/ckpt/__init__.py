from qtpu_torch.ckpt.io import load_quantized, save_quantized  # noqa: F401
