"""Plain references of the benchmark's configurations: plain torch, no
import of the renderer under test."""
