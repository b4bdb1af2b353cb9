from davinci_tpu_torch.hash.poseidon import multi_poseidon, poseidon_hash

__all__ = ["poseidon_hash", "multi_poseidon"]
