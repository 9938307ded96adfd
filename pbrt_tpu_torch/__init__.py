"""pbrt_tpu_torch: the PyTorch + CUDA port of pbrt_tpu.

The JAX package ``pbrt_tpu`` is the reference; this package mirrors its
module names (and their public names) so each counterpart is easy to
find. It imports ``torch`` and never ``jax``. It does what pbrt_tpu does:
the .pbrt parser (``frontend.load_pbrt``), every integrator keyword
through ``integrators.render.render`` (bdpt, mlt and sppm through their
own render functions), every sampler and filter, image I/O
(``utils.imageio``), the ``pbrt`` command line (``python -m
pbrt_tpu_torch.utils.cli scene.pbrt -o out.pfm``), the sharded render
and training step (``parallel``) and the tools. Hand-written CUDA
kernels in ``csrc/`` carry it on a GPU, each with a plain-torch twin for
the CPU: the fused path kernel, brute-force closest hits, the BVH and
kd-tree walks and the traversal experiments.
"""

from pbrt_tpu_torch.core import vecmath, sampling, spectrum, rng  # noqa: F401
