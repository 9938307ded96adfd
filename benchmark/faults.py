"""Faults planted in the timed path, to show that the comparison deciding
``correct`` catches them (``tests/test_bench_faults.py`` at a tiny size
on the CPU; ``control.py --fault`` at the cells' own sizes on the card).
Each is a subclass of the program's adapter with one step broken:

- ``unchanged``: the training step returns its state unchanged;
- ``half_batch``: half of the samples left out, the mean taken over the
  rest (an image of spp/2; a step rendering spp/2);
- ``altered``: an answer altered where it is produced: each image, or
  each step's new kd, scaled by 1.01.

The exchange between cards left out is planted in the program's
collectives by the sharded test itself.
"""

from __future__ import annotations

from benchmark.systems import Program


class Unchanged(Program):
    def train_step(self, mesh, w, h, spp, seed, params, target, lr):
        _, loss = super().train_step(mesh, w, h, spp, seed, params, target,
                                     lr)
        return {k: v.detach().clone() for k, v in params.items()}, loss


class HalfBatch(Program):
    def render(self, w, h, spp, chunk_spp, seed, progress=None):
        return super().render(w, h, spp // 2, chunk_spp, seed, progress)

    def train_step(self, mesh, w, h, spp, seed, params, target, lr):
        return super().train_step(mesh, w, h, spp // 2, seed, params,
                                  target, lr)


class Altered(Program):
    def render(self, w, h, spp, chunk_spp, seed, progress=None):
        return super().render(w, h, spp, chunk_spp, seed, progress) * 1.01

    def train_step(self, mesh, w, h, spp, seed, params, target, lr):
        new, loss = super().train_step(mesh, w, h, spp, seed, params, target,
                                       lr)
        return dict(new, kd=new["kd"] * 1.01), loss


FAULTS = {"unchanged": Unchanged, "half_batch": HalfBatch,
          "altered": Altered}
