from davinci_tpu_torch.state.smt import SMT, SMTProof, SMTTransition
from davinci_tpu_torch.state.state import BatchResult, State, Vote, ballot_index_key

__all__ = [
    "SMT",
    "SMTProof",
    "SMTTransition",
    "BatchResult",
    "State",
    "Vote",
    "ballot_index_key",
]
