from qtpu_torch.calib.stats import CalibStats, collect_calibration_stats  # noqa: F401
