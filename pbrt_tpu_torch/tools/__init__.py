"""Tools. The kernel-experiment harness: kexp_prep builds trees and ray
sets, kexp_run times one traversal experiment on them, kexp_kernels holds
the wide-BVH traversal kernel's packers, twin and wrapper. The ports of
pbrt_tpu's tools: imgtool (info, diff, convert, cat, assemble, makesky
with the Hošek–Wilkie model of hosek.py), obj2pbrt, cyhair2pbrt and
bsdftest (on the port's materials, on the card unless ``--cpu``). Timing:
kernel_times (the kernels in turns against another checkout),
sharded_times (the sharded render and training step over N ranks),
oracle_spread (a file's bias against noise)."""
