"""davinci-tpu on PyTorch and CUDA: the port of `davinci_tpu` to an
NVIDIA H100.

The package mirrors the reference's module paths.  It imports `torch` and
never `jax` or `davinci_tpu`: the host modules it needs (fields, curves,
towers, pairing, r1cs, the ballot-proof circuit) are carried over as
copies, and every TPU kernel on its path is a CUDA kernel written by hand
(`csrc/`), built with nvcc at first use.  On a CPU tensor each kernel
wrapper runs the kernel's plain PyTorch version instead.
"""
