from davinci_tpu_torch.elgamal.bjj import BJJ, bjj_rte
from davinci_tpu_torch.elgamal.core import (
    Ballot,
    DecryptionProof,
    decrypt,
    encrypt_with_k,
    generate_key,
    build_decryption_proof,
    verify_decryption_proof,
)

__all__ = [
    "BJJ",
    "bjj_rte",
    "Ballot",
    "DecryptionProof",
    "decrypt",
    "encrypt_with_k",
    "generate_key",
    "build_decryption_proof",
    "verify_decryption_proof",
]
