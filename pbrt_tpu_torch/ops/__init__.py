"""Hand-written GPU kernels, their plain-torch twins and their build."""
