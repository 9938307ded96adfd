"""Host utilities: image I/O, float files, phase timers, progress, CLI."""
