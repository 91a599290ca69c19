"""OctopusZK on PyTorch and CUDA: the Groth16 (BN254a) proving path with
hand-written Hopper kernels.

Laid out like the JAX package ``octopuszk_tpu`` (the reference this package
is held against, bit for bit), module by module.  Nothing here imports JAX
or the JAX package; ``convert.py`` carries the reference's objects across as
numpy arrays and host ints.
"""

__version__ = "0.1.0"
