from qtpu_torch.quant.rtn import pseudo_quantize, symmetric_fake_quantize  # noqa: F401
from qtpu_torch.quant.pot import pot_quantize_tensor  # noqa: F401
from qtpu_torch.quant.apot import apot_quantize_tensor, generate_apot_levels  # noqa: F401
from qtpu_torch.quant.awq import awq_quantize  # noqa: F401
from qtpu_torch.quant.gptq import gptq_quantize_layer  # noqa: F401
from qtpu_torch.quant.smoothquant import (  # noqa: F401
    compute_smoothing_scales,
    smoothquant_quantize,
)
from qtpu_torch.quant.apply import (  # noqa: F401
    fold_smooth,
    fuse_packed_sites,
    pack_model,
    quantize_model,
)
