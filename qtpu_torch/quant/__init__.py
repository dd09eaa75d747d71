from qtpu_torch.quant.apply import (  # noqa: F401
    fold_smooth,
    fuse_packed_sites,
    pack_model,
    quantize_model,
)
