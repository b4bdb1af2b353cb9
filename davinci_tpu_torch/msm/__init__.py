from davinci_tpu_torch.msm.pippenger import msm, msm_host_input, msm_many, sharded_msm

__all__ = ["msm", "msm_host_input", "msm_many", "sharded_msm"]
