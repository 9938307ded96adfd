"""Integrators: the render loop and the path integrator's fused path."""
