from davinci_tpu_torch.sequencer.pipeline import (
    DevStubProvers,
    InMemoryChain,
    Sequencer,
)

__all__ = ["DevStubProvers", "InMemoryChain", "Sequencer"]
