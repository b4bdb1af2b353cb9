from davinci_tpu_torch.ec.weier import DeviceCurve, get_device_curve
