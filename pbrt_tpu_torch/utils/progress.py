"""Progress reporting (port of pbrt_tpu/utils/progress.py,
core/progressreporter.{h,cpp}): an ETA bar on stderr, updated from the
host's spp-chunk loop instead of a detached thread."""

from __future__ import annotations

import sys
import time


class ProgressReporter:
    def __init__(self, total: int, title: str = "Rendering", quiet=False):
        self.total = max(1, total)
        self.title = title
        self.done = 0
        self.t0 = time.time()
        self.quiet = quiet
        self._last_print = 0.0

    def update(self, n: int = 1):
        self.done += n
        now = time.time()
        if self.quiet or (now - self._last_print < 0.25
                          and self.done < self.total):
            return
        self._last_print = now
        frac = self.done / self.total
        elapsed = now - self.t0
        eta = elapsed / max(frac, 1e-6) * (1.0 - frac)
        bar_w = 40
        filled = int(bar_w * frac)
        bar = "+" * filled + "-" * (bar_w - filled)
        sys.stderr.write(f"\r{self.title}: [{bar}] "
                         f"({elapsed:.1f}s|{eta:.1f}s)  ")
        sys.stderr.flush()

    def finish(self):
        self.done = self.total
        if not self.quiet:
            self.update(0)
            sys.stderr.write("\n")
