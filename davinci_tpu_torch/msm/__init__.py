from davinci_tpu_torch.msm.pippenger import msm
