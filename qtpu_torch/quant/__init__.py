from qtpu_torch.quant.apply import fuse_packed_sites, pack_model  # noqa: F401
