from davinci_tpu_torch.ff.mod import DeviceField, get_device_field
