"""The sequencer's state layer: so far its blob codec (`blobcodec`).
Counterpart of `davinci_tpu/state/`."""
