from repro_torch.kernels.ssm_scan.ops import gla_scan

__all__ = ["gla_scan"]
