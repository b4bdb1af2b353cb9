from davinci_tpu_torch.hash.poseidon import (
    DevicePoseidon,
    get_device_poseidon,
    poseidon_hash,
    multi_poseidon,
)

__all__ = [
    "DevicePoseidon",
    "get_device_poseidon",
    "poseidon_hash",
    "multi_poseidon",
]
