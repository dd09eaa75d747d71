from qtpu_torch.core.dtypes import SCALE_DTYPE  # noqa: F401
from qtpu_torch.core.packing import (  # noqa: F401
    PACK_FORMAT,
    QuantizedTensor,
    dequantize,
    pack_int2,
    pack_int4,
    quantize_pack,
    unpack_int2,
    unpack_int4,
)
