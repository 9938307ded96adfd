"""pbrt_tpu_torch: the PyTorch + CUDA port of pbrt_tpu.

The JAX package ``pbrt_tpu`` is the reference; this package mirrors its
module names so each module's counterpart is easy to find. It imports
``torch`` and never ``jax``. The slice ported so far is the renderer's
main path: ``integrators.render.render`` with ``integrator="path"`` on
scenes that carry a fused profile, which run the hand-written CUDA kernel
``csrc/fused_path.cu`` on a GPU and its plain-torch twin on the CPU.
"""
