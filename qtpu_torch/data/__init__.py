from qtpu_torch.data.pipeline import get_calibration_dataset, get_test_dataset  # noqa: F401
from qtpu_torch.data.synthetic import synthetic_blocks, synthetic_token_stream  # noqa: F401
