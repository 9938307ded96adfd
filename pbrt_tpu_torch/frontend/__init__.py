"""Front end: the .pbrt scene-description parser driving the port's
SceneBuilder (port of pbrt_tpu/frontend: core/parser.{h,cpp},
core/api.{h,cpp} and core/paramset.{h,cpp}). Host side; ``load_pbrt``
puts the built scene on the card unless asked for the CPU."""

from pbrt_tpu_torch.frontend.parser import (load_pbrt,  # noqa: F401
                                            parse_pbrt_string)
