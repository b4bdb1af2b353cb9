from davinci_tpu_torch.blobs.kzg import (
    BLOB_CELLS,
    Blob,
    blob_to_commitment,
    compute_evaluation_point,
    compute_kzg_proof,
    evaluate_barycentric,
    split_48b_to_limbs,
    verify_kzg_proof,
    versioned_hash,
)

__all__ = [
    "BLOB_CELLS",
    "Blob",
    "blob_to_commitment",
    "compute_evaluation_point",
    "compute_kzg_proof",
    "evaluate_barycentric",
    "split_48b_to_limbs",
    "verify_kzg_proof",
    "versioned_hash",
]
