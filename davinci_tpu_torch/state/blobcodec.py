"""Blob codec: pack a state batch into an EIP-4844 blob and parse it back.

Role parity: reference state/blobs.go (computeBlobEvalData packing layout
:29-117, ParseBlobData :119+).  Layout: results (32 coords) | votersCount |
per-vote [voteID, address, ballotIndex, weight, 32 reencrypted coords];
cells are 32-byte big-endian.

Parsing is how non-producing sequencers replay state from chain blobs
(reference service/state_sync.go StateSync) — the chain is the durable
checkpoint stream.
"""

from __future__ import annotations

from davinci_tpu_torch import spec
from davinci_tpu_torch.blobs import (
    Blob,
    blob_to_commitment,
    compute_evaluation_point,
    compute_kzg_proof,
)

COORDS = spec.FIELDS_PER_BALLOT * 4
VOTE_CELLS = 4 + COORDS


def pack_batch_blob(pid: int, batch, with_kzg: bool = False) -> dict:
    """BatchResult -> blob (+ optional KZG commitment/eval data)."""
    cells: list[int] = []
    cells += batch.new_results.coords()
    cells.append(batch.voters_count)
    for v in batch.votes:
        cells += [v.vote_id, v.address, v.ballot_index, v.weight]
        cells += v.reencrypted_ballot.coords()
    assert len(cells) <= 4096, "blob overflow"
    blob = Blob(cells)
    out = {"blob_hex": blob.to_bytes().hex(), "n_cells": len(cells)}
    if with_kzg:
        commitment = blob_to_commitment(blob)
        z = compute_evaluation_point(pid, batch.root_before, commitment)
        proof, y = compute_kzg_proof(blob, z)
        out.update(
            {
                "commitment": commitment.hex(),
                "z": z,
                "y": y,
                "kzg_proof": proof.hex(),
            }
        )
    return out


def parse_blob_data(blob_bytes: bytes) -> dict:
    """Blob -> {results coords, voters_count, votes[...]} (reference
    state/blobs.go ParseBlobData)."""
    blob = Blob.from_bytes(blob_bytes)
    results = blob.cells[:COORDS]
    voters_count = blob.cells[COORDS]
    votes = []
    off = COORDS + 1
    for _ in range(voters_count):
        vote_id, address, ballot_index, weight = blob.cells[off : off + 4]
        coords = blob.cells[off + 4 : off + 4 + COORDS]
        votes.append(
            {
                "vote_id": vote_id,
                "address": address,
                "ballot_index": ballot_index,
                "weight": weight,
                "ballot_coords": coords,
            }
        )
        off += VOTE_CELLS
    return {
        "results_coords": results,
        "voters_count": voters_count,
        "votes": votes,
    }
