from davinci_tpu_torch.groth16.r1cs import ConstraintSystem, LinComb
from davinci_tpu_torch.groth16.core import (CommittedProof, Groth16, Proof,
                                            ProveError, ProvingKey,
                                            VerifyingKey)
