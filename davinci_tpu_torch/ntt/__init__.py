from davinci_tpu_torch.ntt.ntt import DeviceNTT, get_device_ntt
