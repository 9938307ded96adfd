"""The kernel-experiment harness: kexp_prep builds trees and ray sets,
kexp_run times one traversal experiment on them, kexp_kernels holds the
wide-BVH traversal kernel's packers, twin and wrapper."""
