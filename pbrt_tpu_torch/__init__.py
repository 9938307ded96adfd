"""pbrt_tpu_torch: the PyTorch + CUDA port of pbrt_tpu.

The JAX package ``pbrt_tpu`` is the reference; this package mirrors its
module names so each module's counterpart is easy to find. It imports
``torch`` and never ``jax``. Ported so far: ``integrators.render.render``
with the integrators path, mypath, direct, whitted and ao on scenes of
triangles, spheres, aaplanes and disks, the independent and Halton
samplers, the five reconstruction filters and crop windows; the .pbrt
parser (``frontend.load_pbrt``), image I/O (``utils.imageio``) and the
``pbrt`` command line (``python -m pbrt_tpu_torch.utils.cli scene.pbrt -o
out.pfm``). Three hand-written CUDA kernels carry it
on a GPU, each with a plain-torch twin for the CPU: ``csrc/fused_path.cu``
(scenes inside the fused profile), ``csrc/intersect.cu`` (brute-force
closest hits) and ``csrc/bvh_traverse.cu`` (scenes with a BVH).
"""
