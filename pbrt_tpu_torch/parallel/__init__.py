"""Multi-device rendering over torch.distributed (port of
pbrt_tpu/parallel): sample and row sharding over a (dp, sp) mesh of
ranks, one device each; the film merge and the gradient sum are
collectives (parallel/render.py); the process-group set-up and the
multi-host mesh are parallel/multihost.py.
"""

from pbrt_tpu_torch.parallel.render import (make_mesh, render_sharded,  # noqa
                                            inverse_render_step,
                                            make_train_step)
from pbrt_tpu_torch.parallel.multihost import (initialize_multihost,  # noqa
                                               make_multihost_mesh)
