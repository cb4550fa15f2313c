from distributedkernelshap_tpu_torch.runtime.native import get_lib, masked_fill, weighted_mean  # noqa: F401
