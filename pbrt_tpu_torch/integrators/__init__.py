"""Integrators: the render loop and the path integrator's fused path.

``render_image`` is ``render.render`` under pbrt_tpu's second name. The
package does not re-export ``render`` itself: ``integrators.render``
stays the module."""

from pbrt_tpu_torch.integrators.render import render_image  # noqa: F401
